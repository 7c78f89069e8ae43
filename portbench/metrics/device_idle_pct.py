"""device_idle_pct: the share of the traced stretch in which no kernel,
copy or memset ran on the card (the profiler's device timeline)."""


def read(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0 or not tl.ops:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)

"""frames_per_s: frames whose answers completed in the window over the
window's seconds (host clock, the window closing as its last request's
answers are synchronised)."""


def read(run):
    if run.window_s <= 0 or run.frames <= 0:
        return None
    return run.frames / run.window_s

"""h2d_ms: device milliseconds a request of host-to-device copies
(the profiler's ``Memcpy HtoD`` activities): the staging layer."""


def read(run):
    tl = run.timeline
    if tl is None or tl.requests <= 0:
        return None
    s = tl.seconds(lambda op: op.kind == "gpu_memcpy"
                   and op.name.startswith("Memcpy HtoD"))
    return 1e3 * s / tl.requests if s > 0 else None

"""track_host_ms: ms a request in which the host is in the program's own
code of a ``repro_torch.track`` span (its self time,
``plan_host_ms.self_ms``) and the card runs nothing: the host time of the
tracker's vote (candidates, fragment rects, the paired gather and the
scoring, launched from ``engine.TrackQuery``) that holds the card idle.

As in ``query_host_ms``, the card's busy time (the profiler's device
timeline, ``run.timeline``) is taken out of the self time.  A request
without a tracking query, a run without a device timeline, or a program
without the span, leaves nothing to read."""

from portbench.metrics.plan_host_ms import self_ms
from portbench.timeline import _merge


def read(run):
    tl = getattr(run, "timeline", None)
    if tl is None or not tl.ops:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    busy = _merge([(op.start, op.end) for op in tl.ops])
    return self_ms(trace.records(), ("repro_torch.track",), busy)

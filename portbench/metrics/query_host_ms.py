"""query_host_ms: ms a request in which the host is in the program's own
code of a ``repro_torch.query`` span (its self time,
``plan_host_ms.self_ms``) and the card runs nothing: the analytics' host
time that holds the card idle.

A query's self time alone would hold the host's waits on the card: a
copy from host memory (``torch.as_tensor(..., device=)`` of a NumPy
array) returns only when the card has worked through what came before
it.  So the card's busy time (the profiler's device timeline,
``run.timeline``) is taken out of it.  A request without
queries, or a run without a device timeline, leaves nothing to read."""

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
    return self_ms(trace.records(), ("repro_torch.query",), busy)

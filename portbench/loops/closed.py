"""The closed loop: one client, one request in flight.

A request is timed on the host clock from the hand-over of its host
frames until ``sync()`` returns, its answers synchronised on the card.
With a trace asked for, the profiler covers a whole number of requests
from ``start_at`` for ``stop_after`` seconds, inside a ``TRACE_SPAN``
and each request inside a ``REQUEST_SPAN`` (``timeline.py``).
"""

from __future__ import annotations

import sys
import time

from portbench.timeline import REQUEST_SPAN, TRACE_SPAN


def _profile():
    import torch

    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    span = torch.profiler.record_function(TRACE_SPAN)
    span.__enter__()
    return prof, span


def serve(request, views, sync, *, first=0, count=None, until=None,
          reservoir=None, trace=None):
    """Requests until ``count`` are made or the host clock passes
    ``until``.  Request ``i`` hands over ``views[(first + i) % slots]``,
    so a window goes on where the warm-up stopped.  Returns (latencies,
    failed, last result, host clock at its answers, profile or None);
    ``reservoir.offer(slot, result)`` sees each request."""
    import torch

    slots = len(views)
    lat, failed, res, i = [], 0, None, 0
    prof = span = None
    while True:
        if trace is not None and prof is None and \
                time.perf_counter() >= trace[0]:
            prof, span = _profile()
            traced_from = time.perf_counter()
        slot = (first + i) % slots
        res = None
        req = (torch.profiler.record_function(REQUEST_SPAN)
               if span is not None else None)
        t0 = time.perf_counter()
        if req is not None:
            req.__enter__()
        try:
            res = request(views[slot])
            sync()
        except Exception as exc:        # counted; the run is not correct
            failed += 1
            print(f"portbench request {i} failed: {exc!r}", file=sys.stderr)
        if req is not None:
            req.__exit__(None, None, None)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if reservoir is not None:
            reservoir.offer(slot, res)
        i += 1
        if span is not None and t1 - traced_from >= trace[1]:
            span.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            span, trace = None, None
        if (count is not None and i >= count) or \
                (until is not None and t1 >= until):
            break
    if span is not None:
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    return lat, failed, res, t1, prof

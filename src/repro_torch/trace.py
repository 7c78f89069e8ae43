"""Spans and counters of a request, on the profiler's clock.

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]):
        engine.run(frames, queries)
    for rec in trace.records():
        print(rec.name, rec.parent, (rec.end_ns - rec.start_ns) / 1e6, "ms")

The tracer records only while a ``torch.profiler`` session records on the
calling thread.  ``request`` (the root, ``repro_torch.run`` at the start
of ``HistogramEngine.run``) asks the profiler once a request and leaves
the answer in a thread's flag that the spans under it read.  Off,
``request``, ``span`` and ``leaf`` return one shared no-op context
manager and nothing is stored.  On, each span enters a profiler
``RecordFunction`` under its name, so it sits in the profiler's trace as
a host op (``cpu_op``) beside the device's kernels and copies, and
appends a ``Record`` to one in-memory buffer of at most ``CAP`` records
(``dropped()`` counts the rest).  A record's times are ns on the clock of
the profiler's own events, ns since the epoch as ``time.time_ns`` gives.

The root record carries the request's counters: what ``count`` sets
under it, and ``launches``, each kernel wrapper's ``.launches`` across
the request (``LAUNCH_COUNTERS``).  ``records()`` hands the buffer over
and ``clear()`` empties it, between requests.

One thread records at a time.  The flag and the open spans are the
thread's own, but the buffer is shared, and ``gate_computed`` reads the
process's count of worked-out plan verdicts: two threads recording at
once would interleave their records and could take each other's parent
indices and gate verdicts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import itertools
import threading
import time

import torch

#: Records the buffer holds; ``dropped()`` counts spans past it.
CAP = 65536
#: The root span's name: one ``HistogramEngine.run``.
ROOT = "repro_torch.run"
#: The root's ``launches`` counter: name -> (module under
#: ``repro_torch.kernels``, wrapper whose ``.launches`` it reads).
LAUNCH_COUNTERS = {
    "K1": ("wf_tis", "wf_tis_cuda"),
    "K2": ("fused_rows", "fused_rows_cuda"),
    "K3": ("delta_apply", "delta_apply_cuda"),
    "K4_hscan": ("cw_tis", "cw_tis_hscan_cuda"),
    "K4_vscan": ("cw_tis", "cw_tis_vscan_cuda"),
    "map": ("window_map", "window_map_cuda"),
    "vote": ("track_vote", "track_vote_cuda"),
}


@dataclasses.dataclass(slots=True)
class Record:
    """One span: ``parent`` is the index in ``records()`` of the span it
    opened under (-1 for a root); ``end_ns`` is 0 while it is open."""

    name: str
    request: int
    parent: int
    start_ns: int
    end_ns: int = 0
    attrs: dict = dataclasses.field(default_factory=dict)


class _State(threading.local):
    on = False          # a request of this thread is recorded
    open: list          # buffer indices of the open spans, innermost last
    root: Record | None = None
    request = 0

    def __init__(self):
        self.open = []


_OFF = contextlib.nullcontext()
_state = _State()
_records: list[Record] = []
_dropped = 0
_requests = itertools.count(1)


class _Span:
    """A recorded span; a ``quiet`` one records nothing under it."""

    __slots__ = ("name", "attrs", "quiet", "rec", "fn")

    def __init__(self, name: str, attrs: dict, quiet: bool = False):
        self.name, self.attrs, self.quiet = name, attrs, quiet

    def __enter__(self) -> Record | None:
        global _dropped
        s = _state
        self.rec = None
        if len(_records) < CAP:
            self.rec = Record(self.name, s.request,
                              s.open[-1] if s.open else -1, time.time_ns(),
                              attrs=self.attrs)
            s.open.append(len(_records))
            _records.append(self.rec)
        else:
            _dropped += 1
            s.open.append(-1)
        # The C++ RecordFunction, entered without an operator call:
        # ``torch.profiler.record_function`` makes its event through one,
        # which cost 0.23-0.42 ms a request against this one's 0.15-0.18
        # on an H100 host under the CUDA profiler.
        self.fn = torch._C._profiler._RecordFunctionFast(self.name)
        self.fn.__enter__()
        if self.quiet:
            s.on = False
        return self.rec

    def __exit__(self, *exc) -> bool:
        s = _state
        if self.quiet:
            s.on = True
        self.fn.__exit__(*exc)
        if self.rec is not None:
            self.rec.end_ns = time.time_ns()
        s.open.pop()
        return False


class _Request(_Span):
    """The root: opens the request's recording and closes it."""

    __slots__ = ("launched",)

    def __init__(self):
        super().__init__(ROOT, {})

    def __enter__(self) -> Record | None:
        s = _state
        s.on, s.request = True, next(_requests)
        self.launched = _launches()
        s.root = super().__enter__()
        return s.root

    def __exit__(self, *exc) -> bool:
        s = _state
        try:
            if s.root is not None:
                s.root.attrs["launches"] = dict(zip(LAUNCH_COUNTERS, (
                    b - a for a, b in zip(self.launched, _launches()))))
            super().__exit__(*exc)
        finally:
            s.on, s.root = False, None
        return False


_wrappers: list = []


def _launches() -> list[int]:
    """Each ``LAUNCH_COUNTERS`` wrapper's ``.launches``, in its order (the
    wrappers are looked up on the first traced request)."""
    if not _wrappers:
        for module, wrapper in LAUNCH_COUNTERS.values():
            mod = importlib.import_module(f"repro_torch.kernels.{module}")
            _wrappers.append(getattr(mod, wrapper))
    return [w.launches for w in _wrappers]


def request():
    """The root span of a request, ``ROOT``: recorded with its counters
    while the profiler records, else the shared no-op."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _Request()


def span(name: str, **attrs):
    """A span under the open request, or the shared no-op."""
    return _Span(name, attrs) if _state.on else _OFF


def leaf(name: str, **attrs):
    """A span under which nothing records (the plan gate's abstract
    evaluation of the kernels launches nothing), or the shared no-op."""
    return _Span(name, attrs, quiet=True) if _state.on else _OFF


def enabled() -> bool:
    """Is a request of this thread being recorded?"""
    return _state.on


def count(**counters) -> None:
    """Set counters on the open request's root record (no-op when off)."""
    if _state.root is not None:
        _state.root.attrs.update(counters)


def records() -> list[Record]:
    """The buffered records, in the order their spans opened."""
    return list(_records)


def dropped() -> int:
    """Spans not buffered since the last ``clear()``: the buffer was full."""
    return _dropped


def clear() -> None:
    """Empty the buffer (between requests: an open span's parent index
    would point into the emptied one)."""
    global _dropped
    _records.clear()
    _dropped = 0

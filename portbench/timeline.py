"""What a traced stretch of the window says: the device's operations, its
busy time, its idle gaps and what the host was doing in each.

The harness runs ``torch.profiler`` over a whole number of requests in
the middle of the window, inside a ``portbench.trace`` span, each request
inside a ``portbench.request`` span.  ``summarize`` reduces the
profiler's raw events to a ``Timeline`` that the per-layer metric readers
(``metrics/<name>.py``) read.  Nothing is written to disk.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

TRACE_SPAN = "portbench.trace"
REQUEST_SPAN = "portbench.request"
# Device activities that occupy the card (annotations mirrored onto the
# device's timeline do not).
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
BREAKDOWN_ENTRIES = 10


@dataclasses.dataclass
class Op:
    name: str
    kind: str          # "kernel" | "gpu_memcpy" | "gpu_memset" | host kinds
    start: int         # ns
    end: int           # ns


@dataclasses.dataclass
class Timeline:
    """A traced stretch: ``ops`` are the device's, clipped to it."""

    ops: list
    window_s: float
    busy_s: float
    requests: int
    idle_gaps: list            # [[what the host did, seconds], ...]

    def device_ops(self) -> list:
        """[[name, seconds], ...] summed by name, most first."""
        total = defaultdict(int)
        for op in self.ops:
            total[short_name(op.name)] += op.end - op.start
        ranked = sorted(total.items(), key=lambda kv: -kv[1])
        return [[k, v / 1e9] for k, v in ranked[:BREAKDOWN_ENTRIES]]

    def seconds(self, pick) -> float:
        """Device seconds of the ops for which ``pick(op)`` holds."""
        return sum(op.end - op.start for op in self.ops if pick(op)) / 1e9


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its argument list, at most 96
    characters; an anonymous namespace reads ``{anon}``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)",
                                              "{anon}")
    if not name.startswith(("Memcpy", "Memset")):
        cut = name.find("(")
        if cut > 0:
            name = name[:cut]
    return name[:96]


def _ns(ev, what: str) -> int:
    get = getattr(ev, f"{what}_ns", None)
    if get is not None:
        return int(get())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _kind(ev, device: str) -> str:
    """The event's activity: the profiler's own label where it gives one,
    else from the device and the name (copies and memsets are named so;
    annotations mirrored onto the card carry the span's name)."""
    label = getattr(ev, "activity_type", None)
    if label is not None:
        return str(label())
    if device == "CPU":
        return "cpu_op"
    name = ev.name()
    annotation = getattr(ev, "is_user_annotation", None)
    if (annotation() if annotation is not None
            else name in (TRACE_SPAN, REQUEST_SPAN)):
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def raw_events(prof) -> list:
    """The profiler's events as (name, device type name, activity, start
    ns, end ns, thread)."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        dur = _ns(ev, "duration")
        device = str(ev.device_type()).split(".")[-1]
        out.append((ev.name(), device, _kind(ev, device), start,
                    start + dur, int(ev.start_thread_id())))
    return out


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(host: list, points: list) -> list:
    """For each sorted point, the innermost host op covering it, or None.
    Host ops of one thread nest, so a stack swept in start order holds
    exactly the ops open at the point, innermost on top."""
    host = sorted(host, key=lambda op: (op.start, -op.end))
    out, stack, k = [], [], 0
    for p in points:
        while k < len(host) and host[k].start <= p:
            op = host[k]
            k += 1
            while stack and stack[-1].end <= op.start:
                stack.pop()
            stack.append(op)
        while stack and stack[-1].end <= p:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def summarize(events: list) -> Timeline | None:
    """A ``Timeline`` of the ``portbench.trace`` span in ``events``
    (``raw_events``), or None when there is no such span."""
    spans = [e for e in events if e[0] == TRACE_SPAN and e[1] == "CPU"]
    if not spans:
        return None
    _, _, _, t0, t1, thread = spans[0]
    requests = sum(1 for e in events if e[0] == REQUEST_SPAN
                   and e[1] == "CPU" and t0 <= e[3] and e[4] <= t1)
    ops = [Op(n, kind, max(a, t0), min(b, t1))
           for n, dev, kind, a, b, _ in events
           if dev != "CPU" and kind in DEVICE_KINDS and b > t0 and a < t1]
    busy = _merge([(op.start, op.end) for op in ops])
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    host = [Op(n, kind, a, b) for n, dev, kind, a, b, th in events
            if dev == "CPU" and th == thread and n != TRACE_SPAN
            and b > a and b > t0 and a < t1]
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
    owners = _innermost(host, [m for m, _ in mids])
    idle = defaultdict(int)
    for (_, length), op in zip(mids, owners):
        idle["host:no_traced_op" if op is None else short_name(op.name)] += \
            length
    ranked = sorted(idle.items(), key=lambda kv: -kv[1])
    return Timeline(
        ops=ops, window_s=(t1 - t0) / 1e9,
        busy_s=sum(b - a for a, b in busy) / 1e9, requests=requests,
        idle_gaps=[[k, v / 1e9] for k, v in ranked[:BREAKDOWN_ENTRIES]])

"""plan_host_ms: host ms a request of self time in the program's
``repro_torch.plan`` and ``repro_torch.gate`` spans, the entry and
planner layer.

The spans are ``repro_torch.trace``'s, which the port records while the
traced stretch's profiler runs.  A span's self time is its length less
its child spans'; a request is one ``repro_torch.run`` root, and only
records between the first root's start and the last root's end count.
The planner and the gate make no call to the card, so their self time is
the host's own.  A program without the tracer leaves nothing to read."""

import bisect

ROOT = "repro_torch.run"
SPANS = ("repro_torch.plan", "repro_torch.gate")


def _under(a: int, b: int, busy, starts) -> int:
    """ns of [a, b] that the sorted, disjoint intervals ``busy`` cover
    (``starts`` their starts)."""
    k = max(bisect.bisect_right(starts, a) - 1, 0)
    t = 0
    while k < len(busy) and busy[k][0] < b:
        t += max(0, min(b, busy[k][1]) - max(a, busy[k][0]))
        k += 1
    return t


def self_ms(records, names, busy=None) -> float | None:
    """Self time in ms a request of the spans called ``names`` among
    ``records`` (``repro_torch.trace.records()``), or None without a root
    or such a span.  With ``busy``, sorted disjoint [start, end] ns
    intervals in which the card ran something, only the self time in
    which it ran nothing counts."""
    roots = [r for r in records if r.name == ROOT and r.parent < 0
             and r.end_ns > 0]
    if not roots:
        return None
    lo, hi = roots[0].start_ns, roots[-1].end_ns
    starts = [a for a, _ in busy or ()]

    def length(r):
        n = r.end_ns - r.start_ns
        return n if busy is None else n - _under(r.start_ns, r.end_ns,
                                                 busy, starts)

    children = [0] * len(records)
    for r in records:
        if r.parent >= 0 and r.end_ns > 0:
            children[r.parent] += length(r)
    spent = [length(r) - children[i]
             for i, r in enumerate(records)
             if r.name in names and lo <= r.start_ns and 0 < r.end_ns <= hi]
    if not spent:
        return None
    return sum(spent) / len(roots) / 1e6


def read(run):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    return self_ms(trace.records(), SPANS)

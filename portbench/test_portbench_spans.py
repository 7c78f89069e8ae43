"""The readers of the program's spans, ``plan_host_ms`` and
``query_host_ms``: self time against a hand-built nest of spans, and the
records a profiled ``HistogramEngine.run`` leaves on the CPU, with the
card's busy time taken out of the query's."""

import sys
import types

import numpy as np
import pytest
import torch

from portbench import harness, timeline
from repro_torch import trace

MS = 1_000_000      # ns


def _nest():
    """Two requests: (name, parent index, start ms, end ms)."""
    spans = [
        ("repro_torch.plan", -1, 0, 2),         # before the first root
        ("repro_torch.run", -1, 10, 100),       # index 1
        ("repro_torch.plan", 1, 11, 15),        # self 4
        ("repro_torch.stage", 2, 12, 13),       # ... less 1: self 3
        ("repro_torch.gate", 1, 15, 17),        # self 2
        ("repro_torch.compute", 1, 17, 40),
        ("repro_torch.scan", 5, 18, 39),
        ("repro_torch.query", 1, 40, 60),       # 20
        ("repro_torch.scan", 7, 45, 50),        # less 5
        ("repro_torch.stage", 7, 50, 52),       # less 2: self 13
        ("repro_torch.query", 1, 60, 70),       # self 10
        ("repro_torch.run", -1, 200, 300),      # index 11
        ("repro_torch.plan", 11, 201, 203),     # self 2
        ("repro_torch.gate", 11, 203, 204),     # self 1
        ("repro_torch.query", 11, 210, 215),    # self 5
    ]
    return [trace.Record(n, 0, p, a * MS, b * MS) for n, p, a, b in spans]


# The card's busy time (start ms, end ms), as ops of a device timeline.
BUSY = [(42, 48), (58, 62), (205, 300)]


def _run(busy=BUSY):
    ops = [timeline.Op("k", "kernel", a * MS, b * MS) for a, b in busy]
    return types.SimpleNamespace(timeline=types.SimpleNamespace(ops=ops))


def _read(name, run=None):
    return harness.load_reader(name)(_run() if run is None else run)


def test_self_time_of_a_hand_built_nest():
    from portbench.metrics.plan_host_ms import SPANS, self_ms

    recs = _nest()
    # plan 3 + gate 2 + plan 2 + gate 1 over 2 roots; the plan span
    # before the first root is left out.
    assert self_ms(recs, SPANS) == pytest.approx(4.0)
    # queries 13 + 10 + 5 over 2 roots
    assert self_ms(recs, ("repro_torch.query",)) == pytest.approx(14.0)
    assert self_ms(recs, ("repro_torch.bin",)) is None
    assert self_ms(recs[:1], SPANS) is None


def test_the_cards_busy_time_leaves_the_queries_self_time():
    from portbench.metrics.plan_host_ms import self_ms

    busy = [[a * MS, b * MS] for a, b in BUSY]
    # query 40-60 less scan 45-50 and stage 50-52: idle 40-42 and 52-58;
    # query 60-70: idle 62-70; query 210-215: the card busy throughout.
    assert self_ms(_nest(), ("repro_torch.query",), busy) == \
        pytest.approx((8 + 8 + 0) / 2)
    # A card that never ran leaves the whole self time.
    assert self_ms(_nest(), ("repro_torch.query",), [[0, 1]]) == \
        pytest.approx(14.0)


@pytest.mark.parametrize("name", ["plan_host_ms", "query_host_ms"])
def test_the_readers_read_the_programs_buffer(monkeypatch, name):
    from portbench.metrics.plan_host_ms import SPANS, self_ms

    monkeypatch.setattr(trace, "_records", _nest())
    want = (self_ms(_nest(), SPANS) if name == "plan_host_ms"
            else (8 + 8 + 0) / 2)
    assert _read(name) == pytest.approx(want)


@pytest.mark.parametrize("name", ["plan_host_ms", "query_host_ms"])
def test_nothing_to_read_is_none(monkeypatch, name):
    trace.clear()
    assert _read(name) is None
    monkeypatch.setattr(trace, "_records", _nest())
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "trace")
    assert _read(name) is None       # a program without the tracer


def test_the_readers_on_a_profiled_run():
    from repro_torch.core.engine import HistogramEngine, LikelihoodQuery

    gen = np.random.default_rng(5)
    frames = gen.integers(0, 256, (2, 48, 64), np.uint8)
    target = np.full(8, 1.0 / 8, np.float32)
    eng = HistogramEngine(num_bins=8, device="cpu")
    likemap = [LikelihoodQuery(target, (8, 8), stride=1)]
    trace.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(3):
                eng.run(frames, likemap)
        recs = trace.records()
        roots = [r for r in recs if r.name == "repro_torch.run"]
        assert len(roots) == 3
        by_name = {}
        for i, r in enumerate(recs):
            kids = sum(c.end_ns - c.start_ns for c in recs if c.parent == i)
            by_name.setdefault(r.name, []).append(r.end_ns - r.start_ns
                                                  - kids)
        plan = sum(by_name["repro_torch.plan"] + by_name["repro_torch.gate"])
        assert _read("plan_host_ms") == pytest.approx(plan / 3 / 1e6)
        query = sum(by_name["repro_torch.query"])
        # No card ran during the queries: their whole self time is idle.
        assert _read("query_host_ms", _run([(0, 1)])) == \
            pytest.approx(query / 3 / 1e6)
        assert 0 < _read("plan_host_ms") and 0 < _read("query_host_ms")
        # A run without a device timeline (a CPU run) reads nothing.
        empty = types.SimpleNamespace(timeline=types.SimpleNamespace(ops=[]))
        assert _read("query_host_ms", empty) is None
        trace.clear()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            eng.run(frames, [])
        assert _read("plan_host_ms") > 0
        assert _read("query_host_ms") is None    # no queries to read
    finally:
        trace.clear()

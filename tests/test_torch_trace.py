"""The port's tracer (``repro_torch.trace``): a shared no-op without a
profiler, and under one the spans and counters of ``HistogramEngine.run``
on the profiler's own clock."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.analysis import plancheck
from repro_torch.core.engine import (
    HistogramEngine,
    LikelihoodQuery,
    RegionQuery,
    SlidingWindowQuery,
    TrackQuery,
)

CPU = [torch.profiler.ProfilerActivity.CPU]
H, W, BINS = 48, 64, 8
# The profiler's own event of a span lies inside the span's record, to
# within this many ns.
CLOCK_SLACK_NS = 50_000


@pytest.fixture(autouse=True)
def _empty_buffer():
    trace.clear()
    yield
    trace.clear()


def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


# A fleet tick's query: two cameras, two targets each, 2 x 2 fragments,
# radius 3 (49 candidates).
TRACK = TrackQuery(np.array([[[4, 6, 23, 29], [20, 30, 43, 61]],
                             [[10, 0, 29, 19], [0, 40, 17, 59]]]),
                   np.full(BINS, 1.0, np.float32), radius=3)

# name: (engine options, frame shape, queries, representation,
#        the root's children in order, {span: the names under it})
CASES = {
    "dense": (
        {}, (2, H, W), [], "dense",
        ["plan", "gate", "compute"], {"compute": {"stage", "scan"}}),
    "fused": (
        {}, (H, W), [RegionQuery([[0, 0, 40, 40]])], "fused",
        ["plan", "gate", "compute", "query"],
        {"compute": {"stage", "scan"}, "query": set()}),
    # Two queries on a band stream share one rows() pass, made under
    # compute; one query computes the bands lazily, under itself.
    "banded_two_queries": (
        {"memory_budget_bytes": 20_000}, (H, W),
        [SlidingWindowQuery((8, 8), 4), RegionQuery([[0, 0, 40, 40]])],
        "banded", ["plan", "gate", "compute", "query", "query"],
        {"compute": {"stage", "scan"}, "query": set()}),
    "banded_one_query": (
        {"memory_budget_bytes": 20_000}, (H, W),
        [SlidingWindowQuery((8, 8), 4)], "banded",
        ["plan", "gate", "compute", "query"],
        {"compute": set(), "query": {"stage", "scan"}}),
    # The tracker's vote is a span of its own under its query.
    "track": (
        {}, (2, H, W), [TRACK], "dense",
        ["plan", "gate", "compute", "query"],
        {"compute": {"stage", "scan"}, "query": {"track"}, "track": set()}),
    # The CUDA path on meta tensors: the wrappers run their launch checks
    # and launch nothing, so binning is a step of its own here.
    "cuda_dense_on_meta": (
        {"backend": "cuda", "device": "meta"}, (H, W), [], "dense",
        ["plan", "gate", "compute"], {"compute": {"stage", "bin", "scan"}}),
    "cuda_fused_on_meta": (
        {"backend": "cuda", "device": "meta"}, (H, W),
        [RegionQuery([[0, 0, 40, 40]])], "fused",
        ["plan", "gate", "compute", "query"],
        {"compute": {"stage", "bin", "scan"}}),
}


def _short(rec) -> str:
    return rec.name.removeprefix("repro_torch.")


def _requests(recs) -> list[list[int]]:
    """Indices of each request's records, its root first."""
    out = []
    for i, r in enumerate(recs):
        if r.parent < 0:
            out.append([i])
        else:
            out[-1].append(i)
    return out


def _run_case(name, times=2):
    options, shape, queries, _, _, _ = CASES[name]
    frames = _frames(shape)
    if options.get("device") == "meta":
        frames = torch.from_numpy(frames)
    eng = HistogramEngine(num_bins=BINS, **{"device": "cpu", **options})
    plancheck.clear_caches()
    with torch.profiler.profile(activities=CPU) as prof:
        outs = [eng.run(frames, queries) for _ in range(times)]
    return outs, trace.records(), prof


def test_without_a_profiler_nothing_records():
    off = trace.span("repro_torch.plan")
    assert trace.span("repro_torch.query", kind="x") is off
    assert trace.leaf("repro_torch.gate") is off
    assert trace.request() is off
    eng = HistogramEngine(num_bins=BINS, device="cpu")
    frames = _frames((H, W))
    eng.run(frames, [])
    eng.run(frames, [RegionQuery([[0, 0, 9, 9]])])
    assert trace.records() == []
    assert not trace.enabled()
    with off as rec:
        assert rec is None


@pytest.mark.parametrize("case", list(CASES))
def test_each_step_is_a_span_under_its_request(case):
    _, _, queries, representation, order, under = CASES[case]
    outs, recs, _ = _run_case(case)
    assert outs[0].plan.representation == representation
    requests = _requests(recs)
    assert len(requests) == 2
    ids = set()
    for members in requests:
        root = recs[members[0]]
        assert root.name == trace.ROOT and root.parent == -1
        assert {recs[i].request for i in members} == {root.request}
        ids.add(root.request)
        kids = [_short(recs[i]) for i in members
                if recs[i].parent == members[0]]
        assert kids == order
        for parent, names in under.items():
            got = set()
            for i in members:
                p = recs[i].parent
                if p >= 0 and _short(recs[p]) == parent:
                    got.add(_short(recs[i]))
            assert got == names, parent
        for i in members:
            r = recs[i]
            assert r.start_ns < r.end_ns
            if r.parent >= 0:
                up = recs[r.parent]
                assert up.start_ns <= r.start_ns and r.end_ns <= up.end_ns
    assert len(ids) == 2
    kinds = [recs[i].attrs["kind"] for i in requests[0]
             if _short(recs[i]) == "query"]
    assert kinds == [type(q).__name__ for q in queries]
    scans = {recs[i].attrs["kernel"] for i in requests[0]
             if _short(recs[i]) == "scan"}
    assert scans == ({"K2"} if case == "cuda_fused_on_meta" else
                     {"K1"} if case == "cuda_dense_on_meta" else {"torch"})


@pytest.mark.parametrize("case", list(CASES))
def test_the_root_carries_the_requests_counters(case):
    representation = CASES[case][3]
    outs, recs, _ = _run_case(case)
    roots = [r for r in recs if r.parent < 0]
    rows = outs[0].plan.spec.query_rows
    for root, computed in zip(roots, (1, 0)):
        a = root.attrs
        assert a["representation"] == representation
        assert a["corner_rows"] == (0 if rows is None else len(rows))
        assert a["gate_computed"] == computed
        assert a["launches"] == dict.fromkeys(trace.LAUNCH_COUNTERS, 0)


def test_a_track_query_counts_its_targets_and_rects_on_the_root():
    outs, recs, _ = _run_case("track")
    roots = [r for r in recs if r.parent < 0]
    assert len(roots) == 2
    for root in roots:
        # 2 cameras x 2 targets; each target 49 candidates x 4 fragments
        assert root.attrs["track_targets"] == 4
        assert root.attrs["track_rects"] == 4 * 49 * 4
    for i, r in enumerate(recs):
        if _short(r) == "track":
            assert _short(recs[r.parent]) == "query"
            assert recs[r.parent].attrs["kind"] == "TrackQuery"
    boxes, scores = outs[0].results[0]
    assert boxes.shape == (2, 2, 4) and scores.shape == (2, 2)
    # Without the profiler the same request records nothing.
    trace.clear()
    HistogramEngine(num_bins=BINS, device="cpu").run(_frames((2, H, W)),
                                                     [TRACK])
    assert trace.records() == [] and not trace.enabled()


@pytest.mark.parametrize("case", ["dense", "fused", "banded_two_queries",
                                  "track"])
def test_spans_sit_on_the_profilers_clock(case):
    _, recs, prof = _run_case(case)
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("repro_torch."):
            events.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    mine = {}
    for r in recs:
        mine.setdefault(r.name, []).append((r.start_ns, r.end_ns))
    assert set(events) == set(mine)
    for name, spans in mine.items():
        theirs = sorted(events[name])
        assert len(theirs) == len(spans), name
        for (a, b), (c, d) in zip(sorted(spans), theirs):
            assert a - CLOCK_SLACK_NS <= c <= d <= b + CLOCK_SLACK_NS, name


def test_the_gate_records_nothing_under_it():
    # A new plan's gate evaluates the kernels on meta tensors: no stage,
    # bin or scan span of its own.
    _, recs, _ = _run_case("cuda_dense_on_meta", times=1)
    gate = next(i for i, r in enumerate(recs) if _short(r) == "gate")
    assert recs[0].attrs["gate_computed"] == 1
    assert not [r for r in recs if r.parent == gate]
    assert trace.enabled() is False


def test_a_failed_request_closes_its_spans():
    eng = HistogramEngine(num_bins=BINS, device="cpu")
    with torch.profiler.profile(activities=CPU):
        with pytest.raises(ValueError):
            eng.run(_frames((2, 2, H, W)), [])
        eng.run(_frames((H, W)), [])
    recs = trace.records()
    assert [_short(r) for r in recs if r.parent < 0] == ["run", "run"]
    assert all(r.end_ns > r.start_ns for r in recs)
    assert not trace.enabled()
    second = [i for i, r in enumerate(recs) if r.parent < 0][1]
    assert all(r.parent >= second for r in recs[second + 1:])


def test_a_full_buffer_drops_and_counts(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 5)
    eng = HistogramEngine(num_bins=BINS, device="cpu")
    with torch.profiler.profile(activities=CPU):
        out = eng.run(_frames((H, W)), [LikelihoodQuery(
            np.full(BINS, 1.0 / BINS, np.float32), (8, 8), stride=8)])
    assert out.results[0].shape == (H // 8, W // 8)
    assert len(trace.records()) == 5
    assert trace.dropped() > 0
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0

"""repro_torch's AnalyticsService (serve/service.py) held against the JAX
reference's.

The single-device cases of ``tests/test_serve.py``: the same seeded
frames and requests go through ``repro.serve.AnalyticsService`` over a
``backend="jnp"`` engine and through the port's over a ``device="cpu"``
engine.  Answers are compared bit for bit (maps too: at 8 bins the
metrics sum their bins in the reference's order), and the ``snapshot()``
counters must be equal.
"""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.serve import AnalyticsService as RefService
from repro_torch.core import distances
from repro_torch.core.engine import (
    HistogramEngine,
    LikelihoodQuery,
    RegionQuery,
    SlidingWindowQuery,
)
from repro_torch.serve import AnalyticsService, ServiceOverloaded
from repro_torch.serve.service import _Pending

torch.set_num_threads(1)

RECTS = np.array([2, 2, 10, 10])
# 6 rects at distinct rows -> 12 corner rows > 32/4, so plans stay dense
# (a fused plan never stores H and cannot seed the chain).
DENSE_RECTS = np.array([[3 * i, 2, 3 * i + 1, 10] for i in range(6)])
COUNTERS = ("requests", "completed", "engine_runs", "cache_hits",
            "coalesced", "rejected", "updated", "recomputed", "hit")


@pytest.fixture()
def store():
    rng = np.random.default_rng(20)
    return {i: rng.integers(0, 256, (32, 24), dtype=np.uint8)
            for i in range(6)}


def _video_store(seed=21, n=5, h=32, w=24):
    """Low-motion stream keyed by frame number."""
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (h, w), dtype=np.uint8)]
    for _ in range(n - 1):
        nxt = frames[-1].copy()
        r = int(rng.integers(0, h - 3))
        nxt[r:r + 3] = rng.integers(0, 256, (3, w), dtype=np.uint8)
        frames.append(nxt)
    return {i: f for i, f in enumerate(frames)}


def _probed_engine(**kw):
    """Engine + a counter incremented on every H computation."""
    eng = HistogramEngine(8, device="cpu", **kw)
    calls = []
    orig = eng.compute

    def probe(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    eng.compute = probe
    return eng, calls


def _ref_query(q):
    """The reference's twin of a port query."""
    if isinstance(q, RegionQuery):
        return ref_engine.RegionQuery(q.rects)
    if isinstance(q, SlidingWindowQuery):
        return ref_engine.SlidingWindowQuery(q.window, q.stride)
    from repro.core import distances as ref_dist

    return ref_engine.LikelihoodQuery(q.target, q.window,
                                      ref_dist.intersection, q.stride)


def _same_as_reference(frames, batches, **svc_kw):
    """Serve ``batches`` of (ref, query) through both services; answers and
    snapshot counters must agree.  Returns the port's service."""
    eng_kw = {k: svc_kw.pop(k) for k in ("memory_budget_bytes",)
              if k in svc_kw}
    port = AnalyticsService(HistogramEngine(8, device="cpu", **eng_kw),
                            frames, **svc_kw)
    ref = RefService(ref_engine.HistogramEngine(8, backend="jnp", **eng_kw),
                     frames, **svc_kw)
    for batch in batches:
        got = port.process(batch)
        want = ref.process([(r, _ref_query(q)) for r, q in batch])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ps, rs = port.stats.snapshot(), ref.stats.snapshot()
    assert {k: ps[k] for k in COUNTERS} == {k: rs[k] for k in COUNTERS}
    assert port.cached_frames == ref.cached_frames
    return port


def test_same_frame_queries_coalesce_into_one_run(store):
    eng, calls = _probed_engine()
    svc = AnalyticsService(eng, store)
    batch = [
        (0, RegionQuery(RECTS)),
        (0, SlidingWindowQuery((8, 8), 4)),
        (0, LikelihoodQuery(np.ones(8, np.float32), (8, 8),
                            distances.intersection, 4)),
        (1, RegionQuery(RECTS)),
    ]
    res = svc.process(batch)
    assert len(calls) == 2              # frame 0: ONE run for 3 queries
    assert svc.stats.engine_runs == 2 and svc.stats.coalesced == 2
    direct0 = eng.run(store[0], [RegionQuery(RECTS),
                                 SlidingWindowQuery((8, 8), 4)])
    assert torch.equal(res[0], direct0.results[0])
    assert torch.equal(res[1], direct0.results[1])
    assert torch.equal(res[3], eng.run(store[1],
                                       [RegionQuery(RECTS)]).results[0])
    _same_as_reference(store, [batch])


def test_cache_hit_skips_compute_and_lru_evicts(store):
    eng, calls = _probed_engine()
    svc = AnalyticsService(eng, store, cache_size=2)
    svc.process([(0, RegionQuery(RECTS))])
    svc.process([(0, RegionQuery(RECTS))])          # hit
    assert len(calls) == 1 and svc.stats.cache_hits == 1
    svc.process([(1, RegionQuery(RECTS))])
    svc.process([(2, RegionQuery(RECTS))])          # evicts 0 (LRU)
    assert svc.cached_frames == (1, 2)
    svc.process([(0, RegionQuery(RECTS))])          # miss again
    assert len(calls) == 4
    a = svc.process([(2, RegionQuery(RECTS))])[0]   # hit
    assert torch.equal(a, eng.run(store[2], [RegionQuery(RECTS)]).results[0])
    _same_as_reference(store, [[(r, RegionQuery(RECTS))]
                               for r in (0, 0, 1, 2, 0, 2)], cache_size=2)


def test_cache_disabled(store):
    eng, calls = _probed_engine()
    svc = AnalyticsService(eng, store, cache_size=0)
    svc.process([(0, RegionQuery(RECTS))])
    svc.process([(0, RegionQuery(RECTS))])
    assert len(calls) == 2 and svc.cached_frames == ()
    assert svc.stats.cache_hits == 0


def test_fused_hit_outside_its_rows_reruns_the_engine(store):
    """A fused cache entry holds only its request's corner rows: a hit
    that reads other rows re-runs the engine, as in the reference."""
    _same_as_reference(store, [[(0, RegionQuery(RECTS))],
                               [(0, RegionQuery(RECTS))],
                               [(0, RegionQuery(np.array([5, 1, 20, 9])))]])


def test_banded_engine_cache_hits_replay_the_stream(store):
    budget = 4 * 8 * 24 * 8             # 8-row bands for 32x24 @ 8 bins
    eng, calls = _probed_engine(memory_budget_bytes=budget)
    svc = AnalyticsService(eng, store, cache_size=2)
    qs = [RegionQuery(RECTS), SlidingWindowQuery((8, 8), 4)]
    first = svc.process([(3, q) for q in qs])
    assert eng.last_plan.representation == "banded"
    again = svc.process([(3, q) for q in qs])       # cache hit, 2 queries
    assert len(calls) == 1
    dense = HistogramEngine(8, device="cpu").run(store[3], qs).results
    for got in (first, again):
        for g, want in zip(got, dense):
            assert torch.equal(g, want)
    _same_as_reference(store, [[(3, q) for q in qs]] * 2, cache_size=2,
                       memory_budget_bytes=budget)


def test_threaded_submit_and_futures(store):
    eng, calls = _probed_engine()
    with AnalyticsService(eng, store, cache_size=4) as svc:
        futs = [svc.submit(i % 2, RegionQuery(RECTS), block=True)
                for i in range(10)]
        outs = [f.result(timeout=60) for f in futs]
    assert len(outs) == 10 and len(calls) <= 2
    assert torch.equal(outs[0],
                       eng.run(store[0], [RegionQuery(RECTS)]).results[0])
    snap = svc.stats.snapshot()
    assert snap["completed"] == snap["requests"] == 10
    assert snap["requests_per_s"] > 0
    assert snap["latency_p95_s"] >= snap["latency_p50_s"] >= 0


def test_backpressure_rejects_when_queue_full(store):
    eng, _ = _probed_engine()
    svc = AnalyticsService(eng, store, max_pending=2)
    with pytest.raises(RuntimeError, match="not started"):
        svc.submit(0, RegionQuery(RECTS))
    gate = threading.Event()

    def slow_resolve(ref):
        gate.wait(timeout=60)
        return store[ref]

    svc2 = AnalyticsService(eng, slow_resolve, max_pending=2,
                            max_coalesce=1).start()
    try:
        futs = [svc2.submit(0, RegionQuery(RECTS))]   # worker takes this
        deadline = time.time() + 5
        overloaded = False
        while time.time() < deadline and not overloaded:
            try:
                futs.append(svc2.submit(1, RegionQuery(RECTS)))
            except ServiceOverloaded:
                overloaded = True
        assert overloaded and svc2.stats.rejected >= 1
    finally:
        gate.set()
        svc2.close()
    for f in futs:
        f.result(timeout=60)
    assert svc2._worker is None


def test_close_fails_requests_that_raced_past_the_worker(store):
    eng, _ = _probed_engine()
    svc = AnalyticsService(eng, store).start()
    svc.close()
    p = _Pending(0, RegionQuery(RECTS), 0.0, Future())
    svc._queue.put_nowait(p)             # the race, made deterministic
    svc.close()
    with pytest.raises(RuntimeError, match="closed before"):
        p.future.result(timeout=1)


def test_worker_failure_lands_on_the_future(store):
    eng, _ = _probed_engine()

    def resolve(ref):
        raise KeyError(f"no frame {ref}")

    with AnalyticsService(eng, resolve) as svc:
        fut = svc.submit(99, RegionQuery(RECTS), block=True)
        with pytest.raises(KeyError):
            fut.result(timeout=60)


def test_bad_config_rejected(store):
    eng, _ = _probed_engine()
    for kw in (dict(cache_size=-1), dict(max_pending=0),
               dict(max_coalesce=0), dict(cache_bytes=-1)):
        with pytest.raises(ValueError):
            AnalyticsService(eng, store, **kw)


def test_video_chain_updates_cached_h():
    store = _video_store()
    eng, calls = _probed_engine()
    svc = AnalyticsService(eng, store)
    res = svc.process([(i, RegionQuery(DENSE_RECTS))
                       for i in range(len(store))])
    snap = svc.stats.snapshot()
    assert snap["recomputed"] == 1 and snap["updated"] == len(store) - 1
    assert snap["update_ratio"] == pytest.approx(
        (len(store) - 1) / len(store))
    assert len(calls) == 1              # compute() ran once; rest updated
    for i in range(len(store)):
        want = HistogramEngine(8, device="cpu").run(
            store[i], [RegionQuery(DENSE_RECTS)]).results[0]
        assert torch.equal(res[i], want)
    _same_as_reference(store, [[(i, RegionQuery(DENSE_RECTS))
                                for i in range(len(store))]])


def test_video_chain_disabled_by_predecessor_resolver():
    store = _video_store(n=3)
    svc = _same_as_reference(
        store, [[(i, RegionQuery(DENSE_RECTS)) for i in range(3)]],
        predecessor=lambda ref: None)
    snap = svc.stats.snapshot()
    assert snap["updated"] == 0 and snap["recomputed"] == 3


def test_video_chain_survives_missing_predecessor_frame():
    store = _video_store(n=2)
    eng, _ = _probed_engine()
    svc = AnalyticsService(eng, store)
    svc.process([(0, RegionQuery(DENSE_RECTS))])
    del store[0]
    out = svc.process([(1, RegionQuery(DENSE_RECTS))])
    snap = svc.stats.snapshot()
    assert snap["updated"] == 0 and snap["recomputed"] == 2
    want = HistogramEngine(8, device="cpu").run(
        store[1], [RegionQuery(DENSE_RECTS)]).results[0]
    assert torch.equal(out[0], want)


def test_cache_bytes_bound_evicts_by_size():
    store = _video_store()
    one = 4 * 8 * 32 * 24               # dense H bytes per frame
    svc = _same_as_reference(
        store, [[(i, RegionQuery(DENSE_RECTS)) for i in range(5)]],
        cache_bytes=2 * one)
    assert svc.cached_frames == (3, 4)  # LRU-evicted down to 2 entries
    svc2 = _same_as_reference(store, [[(0, RegionQuery(DENSE_RECTS))]],
                              cache_bytes=one - 1)
    assert svc2.cached_frames == ()


def test_snapshot_counts_hits_beside_update_split():
    store = _video_store(n=2)
    svc = _same_as_reference(store, [[(0, RegionQuery(DENSE_RECTS))],
                                     [(0, RegionQuery(DENSE_RECTS))],
                                     [(1, RegionQuery(DENSE_RECTS))]])
    snap = svc.stats.snapshot()
    assert snap["hit"] == 1 == snap["cache_hits"]
    assert snap["recomputed"] == 1 and snap["updated"] == 1

"""repro_torch's multi-GPU layer (core/distributed.py, ShardedH, the
sharded planner, serve/distributed.py) held against the JAX reference.

Meshes here list the CPU several times (``make_host_mesh(devices=["cpu"]
* D)``), so every sharded path runs in this process with the plain
scans.  The oracle is the reference on ONE device (``backend="jnp"``),
never its sharded paths: H and histograms are compared bit for bit, maps
within rtol 1e-6 / atol 1e-7.  The planner is held against the reference's
``plan()`` fed an object with a mesh's axis names and sizes, all either
planner reads of a mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as ref_dist
from repro.core import engine as ref_engine
from repro.kernels.ops import integral_histogram as ref_ih
from repro.serve import AnalyticsService as RefService
from repro.serve import DistributedAnalyticsService as RefDistService
from repro.serve import HashRing as RefHashRing
from repro.serve import sharded_engine_factory as ref_factory
from repro_torch.core import distributed as dist
from repro_torch.core import engine as port_engine
from repro_torch.core.engine import (
    HistogramEngine,
    LikelihoodQuery,
    MultiScaleQuery,
    RegionQuery,
    SlidingWindowQuery,
    WorkloadSpec,
    plan,
)
from repro_torch.core.hsource import BandedH, DenseH, ShardedH
from repro_torch.core.runtime import (
    FrameRuntime,
    MeshPlacement,
    Placed,
    stage_stream,
)
from repro_torch.device import Mesh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve import (
    DistributedAnalyticsService,
    HashRing,
    sharded_engine_factory,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7
BINS = 16


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _mesh(rows, cols):
    return make_host_mesh((rows, cols), devices=["cpu"] * (rows * cols))


def _frame(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape).astype(np.float32)


def _ref_H(img, bins=BINS, method="wf_tis"):
    return np.array(ref_ih(jnp.asarray(img), bins, method=method,
                             backend="jnp"))


def _assemble(shards):
    """``spatial_sharded_ih``'s [strip][bin shard] grid as one H."""
    return torch.cat([torch.cat(strip, dim=-3) for strip in shards], dim=-2)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
def test_make_host_mesh_shapes_and_repeated_devices():
    m = make_host_mesh((2, 3), devices=["cpu"] * 6)
    assert isinstance(m, Mesh)
    assert dict(m.shape) == {"data": 2, "model": 3}
    assert m.axis_names == ("data", "model") and m.size == 6
    assert all(d == torch.device("cpu") for d in m.devices.ravel())
    assert make_host_mesh(devices=["cpu"] * 4).shape == {"data": 1,
                                                         "model": 4}
    assert m.grid(("model",)).shape == (3,)
    assert m.grid(("model", "data")).shape == (3, 2)
    with pytest.raises(ValueError, match="needs 6 devices"):
        make_host_mesh((2, 3), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="lack"):
        m.grid(("pod",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()


def test_replica_meshes_split_along_the_axis():
    m = _mesh(2, 2)
    groups = dist.replica_meshes(m, "data")
    assert len(groups) == 2
    assert all(dict(g.shape) == {"model": 2} for g in groups)
    assert dist.replica_meshes(m, "pod") == [m]
    one_d = make_host_mesh((3,), axes=("data",), devices=["cpu"] * 3)
    assert dist.replica_meshes(one_d, "data") == [None] * 3


# ---------------------------------------------------------------------------
# the sharded computations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["wf_tis", "cw_tis"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("shape", [(12, 10), (3, 12, 10)])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_bin_sharded_ih_matches_reference(d, shape, dtype, method):
    img = _frame(shape, dtype, seed=d)
    mesh = _mesh(1, d)
    shards = dist.bin_sharded_ih(img, BINS, mesh, method=method)
    assert len(shards) == d
    assert all(s.shape[-3] == BINS // d for s in shards)
    got = torch.cat(shards, dim=-3)
    np.testing.assert_array_equal(_np(got), _ref_H(img, method=method))


@pytest.mark.parametrize("bin_axis", [None, "model"])
@pytest.mark.parametrize("d", [2, 3, 4])
def test_spatial_sharded_ih_both_scans_match_reference(d, bin_axis):
    img = _frame((12, 10), "uint8", seed=10 + d)
    mesh = _mesh(d, 2)
    want = _ref_H(img)
    got = {}
    for impl in ("allgather", "ppermute"):
        shards = dist.spatial_sharded_ih(img, BINS, mesh, bin_axis=bin_axis,
                                         scan_impl=impl)
        assert len(shards) == d
        assert all(len(strip) == (1 if bin_axis is None else 2)
                   for strip in shards)
        got[impl] = _assemble(shards)
    assert torch.equal(got["allgather"], got["ppermute"])
    np.testing.assert_array_equal(_np(got["allgather"]), want)


def test_sharded_ih_refuses_bad_geometry():
    mesh = _mesh(3, 2)
    with pytest.raises(ValueError, match="not divisible by 3 row shards"):
        dist.spatial_sharded_ih(_frame((10, 8), "uint8"), BINS, mesh)
    with pytest.raises(ValueError, match="single-frame"):
        dist.spatial_sharded_ih(_frame((2, 12, 8), "uint8"), BINS, mesh)
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        dist.bin_sharded_ih(_frame((12, 8), "uint8"), BINS,
                            _mesh(1, 3))
    with pytest.raises(ValueError, match="unknown impl"):
        dist.exclusive_axis_scan([torch.zeros(2)], "ring")


@pytest.mark.parametrize("impl", ["allgather", "ppermute"])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 8])
def test_exclusive_axis_scan_matches_numpy(d, impl):
    rng = np.random.default_rng(d)
    xs = rng.integers(0, 1000, (d, 3, 5)).astype(np.float32)
    got = dist.exclusive_axis_scan([torch.as_tensor(x) for x in xs], impl)
    want = np.cumsum(xs, axis=0) - xs
    assert len(got) == d
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), w)


@pytest.mark.parametrize("prefetch", [0, 1])
@pytest.mark.parametrize("sharding,shape", [
    ("bin", (12, 10)), ("bin", (2, 12, 10)), ("spatial", (12, 10)),
])
def test_iter_banded_sharded_ih_matches_reference(sharding, shape, prefetch):
    img = _frame(shape, "uint8", seed=30)
    mesh = _mesh(2, 2)
    bands = list(dist.iter_banded_sharded_ih(
        img, BINS, mesh, sharding=sharding, band_h=4, prefetch=prefetch))
    assert len(bands) == 3
    for b in bands:
        assert isinstance(b.H, ShardedH) and b.H.kind == sharding
        assert len(b.carry) == (2 if sharding == "bin" else 1)
    got = torch.cat([b.H.dense() for b in bands], dim=-2)
    np.testing.assert_array_equal(_np(got), _ref_H(img))
    # the carry handed on is the band's bottom row, one bin shard each
    np.testing.assert_array_equal(
        _np(torch.cat(bands[0].carry, dim=-2)), _ref_H(img)[..., 3, :])


def test_iter_banded_sharded_ih_rounds_bands_to_row_shards():
    img = _frame((12, 10), "uint8", seed=31)
    bands = list(dist.iter_banded_sharded_ih(
        img, BINS, _mesh(2, 2), sharding="spatial", band_h=5))
    assert [(b.r0, b.r1) for b in bands] == [(0, 4), (4, 8), (8, 12)]
    with pytest.raises(ValueError, match="single-frame"):
        next(dist.iter_banded_sharded_ih(
            _frame((2, 12, 10), "uint8"), BINS, _mesh(2, 2),
            sharding="spatial", band_h=4))


# ---------------------------------------------------------------------------
# placement and staging
# ---------------------------------------------------------------------------
def test_band_input_sharding_places_once_per_distinct_device():
    mesh = _mesh(2, 2)
    rep = dist.band_input_sharding(mesh, "bin")
    assert isinstance(rep, MeshPlacement) and rep.grid.shape == (1, 2)
    assert rep.targets() == [(0, torch.device("cpu"))]  # one copy, 2 shards
    rows = dist.band_input_sharding(mesh, "spatial")
    assert rows.grid.shape == (2, 1) and len(rows.targets()) == 2
    img = _frame((8, 6), "uint8")
    placed = rows.place(img)
    assert isinstance(placed, Placed)
    np.testing.assert_array_equal(_np(placed[(1, torch.device("cpu"))]),
                                  img[4:])
    with pytest.raises(ValueError, match="unknown sharding"):
        dist.band_input_sharding(mesh, "tiles")


def test_stage_stream_and_runtime_take_a_mesh_placement():
    mesh = _mesh(2, 1)
    place = dist.band_input_sharding(mesh, "spatial")
    frames = [_frame((8, 6), "uint8", seed=s) for s in range(3)]
    got = list(stage_stream(iter(frames), size=1, device=place))
    assert all(isinstance(p, Placed) and len(p) == 2 for p in got)
    np.testing.assert_array_equal(_np(got[2][(0, torch.device("cpu"))]),
                                  frames[2][:4])
    seen = []
    rt = FrameRuntime(lambda c, s: (seen.append(type(c)) or c, s),
                      device=place, stage_ahead=1)
    outs = list(rt.map_frames(frames))
    assert seen == [Placed] * 3 and len(outs) == 3


# ---------------------------------------------------------------------------
# ShardedH against DenseH
# ---------------------------------------------------------------------------
def _sources(img):
    mesh = _mesh(2, 2)
    yield "bin", ShardedH(dist.bin_sharded_ih(img, BINS, mesh), mesh,
                          kind="bin")
    if np.ndim(img) == 2:
        for bin_axis in (None, "model"):
            yield f"spatial/{bin_axis}", ShardedH(
                dist.spatial_sharded_ih(img, BINS, mesh, bin_axis=bin_axis),
                mesh, kind="spatial")


@pytest.mark.parametrize("shape", [(12, 10), (2, 12, 10)])
def test_sharded_h_rows_and_regions_match_dense_h(shape):
    img = _frame(shape, "uint8", seed=40)
    dense = DenseH(torch.as_tensor(_ref_H(img)))
    rects = np.array([[0, 0, 11, 9], [3, 2, 8, 7], [6, 5, 6, 5]])
    for name, src in _sources(img):
        assert (src.num_bins, src.height, src.width, src.lead) == (
            BINS, 12, 10, tuple(shape[:-2])), name
        assert src.nbytes == dense.nbytes, name
        for rows in ([0, 5, 6, 11], [7], []):
            assert torch.equal(src.rows(rows), dense.rows(rows)), name
        assert torch.equal(src.dense(), dense.dense()), name
        assert torch.equal(src.region_histogram(rects),
                           dense.region_histogram(rects)), name
        assert torch.equal(src.sliding_window_histograms((4, 3), 2),
                           dense.sliding_window_histograms((4, 3), 2)), name
    mesh = _mesh(2, 2)
    H = dist.bin_sharded_ih(img, BINS, mesh)
    assert torch.equal(dist.distributed_region_query(H, rects, mesh),
                       dense.region_histogram(rects))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _queries(bins=BINS):
    target = np.random.default_rng(3).random(bins).astype(np.float32)
    rects = np.array([[3 * i, 2, 3 * i + 1, 10] for i in range(4)])
    return [
        RegionQuery(rects),
        SlidingWindowQuery((4, 6), 2),
        LikelihoodQuery(target, (4, 6), stride=2),
        MultiScaleQuery(target, ((4, 4), (6, 8)), stride=2),
    ], [
        ref_engine.RegionQuery(rects),
        ref_engine.SlidingWindowQuery((4, 6), 2),
        ref_engine.LikelihoodQuery(target, (4, 6), ref_dist.intersection, 2),
        ref_engine.MultiScaleQuery(target, ((4, 4), (6, 8)),
                                   ref_dist.intersection, 2),
    ]


def _same_answers(got, want):
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]),
                               rtol=RTOL, atol=ATOL)
    (g_rect, g_score, g_maps), (w_rect, w_score, w_maps) = got[3], want[3]
    np.testing.assert_array_equal(_np(g_rect), np.asarray(w_rect))
    np.testing.assert_allclose(_np(g_score), np.asarray(w_score),
                               rtol=RTOL, atol=ATOL)
    for g, w in zip(g_maps, w_maps):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("sharding,budget,shape,want_source", [
    ("auto", None, (16, 12), ShardedH),
    ("auto", None, (2, 16, 12), ShardedH),
    ("spatial", None, (16, 12), ShardedH),
    ("auto", 4 * BINS * 12 * 4, (16, 12), BandedH),
    ("spatial", 4 * BINS * 12 * 4, (16, 12), BandedH),
])
def test_engine_on_a_mesh_answers_every_query_like_the_reference(
        sharding, budget, shape, want_source):
    img = _frame(shape, "uint8", seed=50)
    queries, ref_queries = _queries()
    eng = HistogramEngine(BINS, mesh=_mesh(2, 2), sharding=sharding,
                          memory_budget_bytes=budget)
    out = eng.run(img, queries)
    assert out.plan.representation == "sharded"
    assert out.plan.sharding == ("bin" if sharding == "auto" else "spatial")
    assert isinstance(out.source, want_source)
    assert eng.device == "cpu"
    want = ref_engine.HistogramEngine(BINS, backend="jnp").run(
        img, ref_queries)
    _same_answers(out.results, want.results)


def test_engine_on_a_mesh_runs_cw_tis_and_2d_meshes_once_a_shard():
    img = _frame((16, 12), "float32", seed=51)
    queries, ref_queries = _queries()
    want = ref_engine.HistogramEngine(BINS, method="cw_tis",
                                      backend="jnp").run(img, ref_queries)
    eng = HistogramEngine(BINS, method="cw_tis", mesh=_mesh(2, 4))
    out = eng.run(img, queries)
    assert len(out.source.grid[0]) == 4     # 4 bin shards, at data = 0
    _same_answers(out.results, want.results)


def test_engine_on_a_mesh_never_fuses_updates_or_streams():
    img = _frame((16, 12), "uint8", seed=52)
    eng = HistogramEngine(BINS, mesh=_mesh(1, 2))
    rect = [RegionQuery(np.array([[0, 0, 15, 11]]))]
    first = eng.run(img, rect)
    assert first.plan.representation == "sharded"       # not "fused"
    nxt = img.copy()
    nxt[3] = 0
    again = eng.run(nxt, rect, prev=(img, first))
    assert not again.plan.incremental
    np.testing.assert_array_equal(
        _np(again.results[0]),
        np.asarray(ref_engine.HistogramEngine(BINS, backend="jnp").run(
            nxt, [ref_engine.RegionQuery(np.array([[0, 0, 15, 11]]))]
        ).results[0]))
    with pytest.raises(ValueError, match="map_frames streams dense"):
        next(iter(eng.map_frames([img, img])))


class _MeshShape:
    """All either planner reads of a mesh: its axis names and sizes."""

    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


_SPECS = [
    dict(num_bins=16, mesh=dict(data=2, model=4)),
    dict(num_bins=6, mesh=dict(data=2, model=4)),             # spatial
    dict(num_bins=16, mesh=dict(model=4)),
    dict(num_bins=16, mesh=dict(data=4)),                     # no bin axis
    dict(num_bins=16, mesh=dict(data=2, model=4), sharding="spatial"),
    dict(num_bins=16, mesh=dict(data=2, model=4), num_frames=4),
    dict(num_bins=16, mesh=dict(data=2, model=4), num_frames=None),
    dict(num_bins=6, mesh=dict(data=2, model=4), num_frames=None),
    dict(num_bins=16, mesh=dict(data=2, model=4),
         memory_budget_bytes=4 * 16 * 48 * 10),
    dict(num_bins=6, mesh=dict(data=4, model=4),
         memory_budget_bytes=4 * 6 * 48 * 10),
    dict(num_bins=16, mesh=dict(data=2, model=4), query_rows=(3, 7)),
    dict(num_bins=16, mesh=dict(data=2, model=4), dirty_fraction=0.05),
    dict(num_bins=16, mesh=dict(data=2, model=2), bin_axis="data",
         row_axis="model"),
]


@pytest.mark.parametrize("kw", _SPECS)
def test_plan_and_explain_on_a_mesh_match_the_reference(kw):
    kw = dict(kw, mesh=_MeshShape(**kw["mesh"]), height=64, width=48)
    want = ref_engine.plan(ref_engine.WorkloadSpec(backend="jnp", **kw))
    got = plan(WorkloadSpec(device="cpu", **kw))

    def decisions(p):
        bp = p.band_plan
        return (p.representation, p.sharding, p.incremental, p.microbatch,
                None if bp is None else (bp.spans, bp.band_bytes),
                p.layout)

    assert decisions(got)[:-1] == decisions(want)[:-1]
    assert got.layout.describe() == want.layout.describe()
    # every line but the two Queue 3 lists (backend names, bin_block auto)
    skip = ("method/backend", "tile/bin_block")
    lines = [[ln for ln in p.explain().splitlines()
              if ln.split(":")[0].strip() not in skip] for p in (got, want)]
    assert lines[0] == lines[1]


@pytest.mark.parametrize("kw", [
    dict(num_frames=3, sharding="spatial"),
    dict(storage="uint16"),
    dict(sharding="tiles"),
])
def test_planner_errors_on_a_mesh_match_the_reference(kw):
    kw = dict(kw, mesh=_MeshShape(data=2, model=4), height=64, width=48,
              num_bins=16)
    with pytest.raises(ValueError) as want:
        ref_engine.plan(ref_engine.WorkloadSpec(backend="jnp", **kw))
    with pytest.raises(ValueError) as got:
        plan(WorkloadSpec(device="cpu", **kw))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("replicas", [1, 2, 3, 5, 8])
def test_hash_ring_routes_as_the_reference(replicas):
    refs = (list(range(600)) + [f"cam{i % 7}/{i}" for i in range(300)]
            + [("clip", i) for i in range(100)])
    port, ref = HashRing(replicas), RefHashRing(replicas)
    assert [port.lookup(r) for r in refs] == [ref.lookup(r) for r in refs]


def _store(seed=11, h=32, w=24):
    """A low-motion chain 0..4 and independent frames 5..7."""
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (h, w), dtype=np.uint8)]
    for _ in range(4):
        nxt = frames[-1].copy()
        r = int(rng.integers(0, h - 3))
        nxt[r:r + 3] = rng.integers(0, 256, (3, w), dtype=np.uint8)
        frames.append(nxt)
    for _ in range(3):
        frames.append(rng.integers(0, 256, (h, w), dtype=np.uint8))
    return dict(enumerate(frames))


# 10 rects on distinct rows: 20 corner rows > 32 / 4, so one-device plans
# stay dense (H stored) and the chain updates.
_RECTS = np.array([[3 * i, 2, 3 * i + 1, 10] for i in range(10)])
_TRACE = ([(i, "region") for i in range(5)]
          + [(i, "region") for i in (5, 6, 7, 2, 5)] + [(3, "windows")])
_COUNTERS = ("requests", "completed", "engine_runs", "cache_hits",
             "coalesced", "rejected", "updated", "recomputed", "hit",
             "num_replicas", "routed_refs")


def _trace(port: bool):
    """_TRACE as the port's queries or the reference's."""
    mod = port_engine if port else ref_engine
    return [(ref, mod.RegionQuery(_RECTS) if kind == "region"
             else mod.SlidingWindowQuery((8, 8), 4))
            for ref, kind in _TRACE]


@pytest.mark.parametrize("layout", ["3 replicas", "2x2 mesh"])
def test_distributed_service_matches_the_reference(layout):
    store = _store()
    factory = sharded_engine_factory(8, device="cpu")
    if layout == "3 replicas":
        svc = DistributedAnalyticsService(factory, store, num_replicas=3)
        n = 3
    else:
        svc = DistributedAnalyticsService(factory, store, mesh=_mesh(2, 2),
                                          replica_axis="data")
        assert all(dict(r._engine.mesh.shape) == {"model": 2}
                   for r in svc.replicas)
        n = 2
    ref = RefDistService(ref_factory(8, backend="jnp"), store,
                         num_replicas=n)
    single = RefService(ref_engine.HistogramEngine(8, backend="jnp"), store)
    got = svc.process(_trace(True))
    want = ref.process(_trace(False))
    alone = single.process(_trace(False))
    for g, w, a in zip(got, want, alone):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
        np.testing.assert_array_equal(_np(g), np.asarray(a))
    refs = list(store) + [99, "cam0/3"]
    assert [svc.replica_for(r) for r in refs] == \
        [ref.replica_for(r) for r in refs]
    assert len({svc.replica_for(i) for i in range(5)}) == 1  # chain pinned
    ps, rs = svc.snapshot(), ref.snapshot()
    if layout == "3 replicas":
        assert {k: ps[k] for k in _COUNTERS} == {k: rs[k] for k in _COUNTERS}
        for p, r in zip(ps["replicas"], rs["replicas"]):
            assert {k: p[k] for k in _COUNTERS[:-2]} == \
                {k: r[k] for k in _COUNTERS[:-2]}
        assert ps["updated"] == 4      # frames 1..4, all on one replica
    else:
        # sharded groups recompute every frame: no update, the rest equal
        same = [k for k in _COUNTERS if k not in ("updated", "recomputed")]
        assert {k: ps[k] for k in same} == {k: rs[k] for k in same}
        assert ps["updated"] == 0
        assert ps["recomputed"] == rs["engine_runs"]


def test_distributed_service_threads_and_cache_bytes():
    store = _store()
    one = 4 * 8 * 32 * 24
    svc = DistributedAnalyticsService(
        sharded_engine_factory(8, device="cpu"), store, mesh=_mesh(2, 2),
        cache_bytes=2 * one, predecessor=lambda r: None)
    assert all(r.cache_bytes == one for r in svc.replicas)
    with svc:
        futs = [svc.submit(i, RegionQuery(_RECTS)) for i in range(8)]
        outs = [f.result(timeout=60) for f in futs]
    want = RefService(ref_engine.HistogramEngine(8, backend="jnp"),
                      store).process(
        [(i, ref_engine.RegionQuery(_RECTS)) for i in range(8)])
    for g, w in zip(outs, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert sum(len(c) for c in svc.cached_frames) <= 2
    assert svc.snapshot()["completed"] == 8 and svc._inflight == 0


def test_sharded_h_nbytes_is_the_sum_over_shards():
    mesh = _mesh(1, 2)
    f32 = ShardedH([torch.zeros(4, 6, 5), torch.zeros(4, 6, 5)], mesh)
    assert f32.nbytes == 2 * 4 * 6 * 5 * 4
    u16 = ShardedH([torch.zeros(4, 6, 5, dtype=torch.int16)] * 2, mesh)
    assert u16.nbytes == 2 * 4 * 6 * 5 * 2

"""plancheck and the engine's gate, held against the reference.

The same ``WorkloadSpec`` goes through the reference (``backend="jnp"``)
and the port (``backend="torch"``); their verdicts must have the same
check names, statuses and rendered lines, with two differences allowed:
the backend's name, and ``smem`` where the reference says ``vmem`` (the
H100's shared memory in place of the TPU's VMEM).  Then the gate itself:
``run()`` and ``map_frames`` refuse a rejected plan before any kernel
launch, the verdict is cached per plan and the meta evaluations per shape,
and a ``backend="cuda"`` plan, built here without a card, is checked with
its wrappers' own launch checks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core import engine as ref_engine
from repro_torch.analysis import plancheck
from repro_torch.core import engine
from repro_torch.kernels import cw_tis, delta_apply, fused_rows, wf_tis

WRAPPERS = (wf_tis.wf_tis_cuda, fused_rows.fused_rows_cuda,
            delta_apply.delta_apply_cuda, cw_tis.cw_tis_hscan_cuda,
            cw_tis.cw_tis_vscan_cuda)


def _norm(text: str) -> str:
    """The reference's rendering with the port's two allowed words."""
    return text.replace("jnp", "torch").replace("vmem", "smem")


def _pair(bins=32, **kw):
    return (ref_engine.HistogramEngine(bins, backend="jnp", **kw),
            engine.HistogramEngine(bins, device="cpu", **kw))


def _plans(ref, port, shape, **spec_kw):
    rs = dataclasses.replace(ref.spec_for(shape), **spec_kw)
    ps = dataclasses.replace(port.spec_for(shape), **spec_kw)
    return ref_engine.plan(rs), engine.plan(ps)


def _same_verdict(ref, port, rp, pp, queries=()):
    rv, pv = ref.validate(rp, queries), port.validate(pp, queries)
    assert [(c.name.replace("vmem", "smem"), c.status) for c in rv.checks] \
        == [(c.name, c.status) for c in pv.checks]
    assert pv.render() == _norm(rv.render())
    return pv


# ---------------------------------------------------------------------------
# parity: the reference's goldens and rejections
# ---------------------------------------------------------------------------
GOLDEN_640 = """\
plan verdict    : OK (statically feasible)
  OK   representation  dense
  OK   h-shape         (32, 480, 640) float32 via wf_tis/torch
  SKIP carry-chain     single-band plan has no carry
  SKIP memory-budget   no memory budget declared
  SKIP smem-fit        torch backend uses HBM
  OK   count-validity  307200-px frame within fp32 exact range"""


def test_golden_640x480_matches_the_reference():
    ref, port = _pair()
    v = _same_verdict(ref, port, *_plans(ref, port, (480, 640)))
    assert v.ok and v.render() == GOLDEN_640


def test_golden_8192_paper_scale_matches_the_reference():
    ref, port = _pair(128, memory_budget_bytes=256 << 20)
    v = _same_verdict(ref, port, *_plans(ref, port, (8192, 8192)))
    assert v.ok and [c.status for c in v.checks].count("warn") == 1
    assert "128 bands (heights [64])" in v.render()


def test_budget_infeasible_microbatch_matches_the_reference():
    ref, port = _pair()
    plans = [dataclasses.replace(p, microbatch=64, spec=dataclasses.replace(
        p.spec, memory_budget_bytes=1 << 20, num_frames=64))
        for p in _plans(ref, port, (480, 640))]
    v = _same_verdict(ref, port, *plans)
    assert [c.name for c in v.failures] == ["memory-budget"]


def test_uint16_query_matches_the_reference():
    ref, port = _pair(16, storage="uint16", memory_budget_bytes=1 << 20)
    rp, pp = _plans(ref, port, (512, 512))
    big = [ref_engine.RegionQuery(np.array([[0, 0, 400, 400]]))]
    big_t = [engine.RegionQuery(np.array([[0, 0, 400, 400]]))]
    rv, pv = ref.validate(rp, big), port.validate(pp, big_t)
    assert pv.render() == _norm(rv.render())
    assert [c.name for c in pv.failures] == ["query-validity"]
    assert "(uint16 modular arithmetic wraps)" in pv.render()
    ok = [engine.RegionQuery(np.array([[0, 0, 99, 99]]))]
    assert port.validate(pp, ok).ok


def test_incremental_plan_matches_the_reference():
    ref, port = _pair()
    rp, pp = _plans(ref, port, (480, 640), dirty_fraction=0.1)
    assert rp.incremental and pp.incremental
    v = _same_verdict(ref, port, rp, pp)
    assert v.checks[-1].name == "incremental" and v.ok
    # an incremental plan without its dirty fraction is refused by both
    rbad = dataclasses.replace(rp, spec=dataclasses.replace(
        rp.spec, dirty_fraction=None))
    pbad = dataclasses.replace(pp, spec=dataclasses.replace(
        pp.spec, dirty_fraction=None))
    v = _same_verdict(ref, port, rbad, pbad)
    assert [c.name for c in v.failures] == ["incremental"]


def test_sharded_plan_matches_the_reference():
    from repro.launch.mesh import make_host_mesh as ref_mesh
    from repro_torch.launch.mesh import make_host_mesh

    ref = ref_engine.HistogramEngine(32, backend="jnp",
                                     mesh=ref_mesh((1, 1)))
    port = engine.HistogramEngine(32, device="cpu",
                                  mesh=make_host_mesh((1, 1),
                                                      devices=["cpu"]))
    v = _same_verdict(ref, port, *_plans(ref, port, (480, 640)))
    assert v.ok and v.checks[-1].name == "mesh-layout"
    assert v.checks[0].detail == "sharded[bin]: num_bins=32 over 1 devices"


def test_mesh_layout_line_and_a_stranding_layout():
    from repro_torch.launch.mesh import make_host_mesh

    port = engine.HistogramEngine(
        32, device="cpu", mesh=make_host_mesh((2, 2), devices=["cpu"] * 4))
    p = engine.plan(port.spec_for((480, 640)))
    line = port.validate(p).checks[-1]
    assert (line.name, line.status) == ("mesh-layout", "ok")
    assert line.detail == ("2 replica group(s) over 'data' x bin sharding "
                           "over 'model' (2 device(s)/group)")
    stranded = dataclasses.replace(p, layout=dataclasses.replace(
        p.layout, num_groups=1))
    v = port.validate(stranded)
    assert [c.name for c in v.failures] == ["mesh-layout"]
    assert "covers 2 of 4 mesh devices" in v.failures[0].detail


def test_representation_and_count_failures_match_the_reference():
    ref, port = _pair()
    rp, pp = _plans(ref, port, (480, 640))
    v = _same_verdict(ref, port, dataclasses.replace(rp, storage="uint16"),
                      dataclasses.replace(pp, storage="uint16"))
    assert [c.name for c in v.failures] == ["representation"]
    # a spill plan whose frame passes the fp32 exact range (the planner
    # refuses to make one; the gate refuses one all the same)
    ref, port = _pair(4, storage="uint16")
    big = [dataclasses.replace(p, spec=dataclasses.replace(
        p.spec, height=4096, width=4096))
        for p in _plans(ref, port, (64, 64))]
    v = _same_verdict(ref, port, *big)
    assert [c.name for c in v.failures] == ["count-validity"]


def test_broken_method_fails_h_shape_in_both():
    ref, port = _pair(128, memory_budget_bytes=256 << 20)
    rp, pp = _plans(ref, port, (8192, 8192))
    rv = ref.validate(dataclasses.replace(rp, method="no_such_method"))
    pv = port.validate(dataclasses.replace(pp, method="no_such_method"))
    assert [c.name for c in pv.failures] == [c.name for c in rv.failures]
    assert "h-shape" in [c.name for c in pv.failures]


# ---------------------------------------------------------------------------
# the gate: run() and map_frames refuse before any launch
# ---------------------------------------------------------------------------
@pytest.fixture
def no_dispatch(monkeypatch):
    """Launch counters at 0, and any dispatch of the port's engine fails
    the test: the refusal must come before the first launch."""
    for wrapper in WRAPPERS:
        monkeypatch.setattr(wrapper, "launches", 0)

    def dispatched(*a, **k):
        pytest.fail("the engine dispatched a plan the gate must refuse")

    monkeypatch.setattr(engine.HistogramEngine, "compute", dispatched)
    monkeypatch.setattr(engine.HistogramEngine, "compute_dense", dispatched)
    yield
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


def _oversized_planner(mod, monkeypatch):
    """The planner with a microbatch 64 frames wide: what a planner fault
    would hand the gate (``plan()`` itself caps the microbatch by the
    budget)."""
    real = mod.plan
    monkeypatch.setattr(mod, "plan", lambda spec: dataclasses.replace(
        real(spec), microbatch=64))


def test_run_refuses_a_budget_infeasible_microbatch(monkeypatch, no_dispatch):
    frames = np.zeros((2, 64, 64), np.uint8)     # 2 x 512 KiB of H: 1 MiB
    _oversized_planner(ref_engine, monkeypatch)
    with pytest.raises(ref_engine.PlanValidationError, match="memory-budget"):
        ref_engine.HistogramEngine(32, backend="jnp",
                                   memory_budget_bytes=1 << 20).run(frames)
    _oversized_planner(engine, monkeypatch)
    port = engine.HistogramEngine(32, device="cpu",
                                  memory_budget_bytes=1 << 20)
    with pytest.raises(engine.PlanValidationError, match="memory-budget"):
        port.run(frames)
    assert not port.last_verdict.ok
    assert isinstance(engine.PlanValidationError("x"), ValueError)


def test_run_refuses_a_uint16_query_over_65535_px(no_dispatch):
    big = np.array([[0, 0, 400, 400]])           # 160801 px
    ref = ref_engine.HistogramEngine(16, backend="jnp", storage="uint16",
                                     memory_budget_bytes=1 << 20)
    with pytest.raises(ref_engine.PlanValidationError,
                       match="query-validity"):
        ref.run(np.zeros((512, 512), np.uint8), [ref_engine.RegionQuery(big)])
    port = engine.HistogramEngine(16, device="cpu", storage="uint16",
                                  memory_budget_bytes=1 << 20)
    with pytest.raises(engine.PlanValidationError, match="query-validity"):
        port.run(np.zeros((512, 512), np.uint8), [engine.RegionQuery(big)])


def test_map_frames_refuses_before_the_first_launch(monkeypatch,
                                                    no_dispatch):
    frames = [np.zeros((64, 64), np.uint8)] * 3
    _oversized_planner(engine, monkeypatch)
    port = engine.HistogramEngine(32, device="cpu",
                                  memory_budget_bytes=1 << 20)
    with pytest.raises(engine.PlanValidationError, match="memory-budget"):
        port.map_frames(frames)
    assert port.last_runtime is None


def test_map_frames_and_run_keep_their_verdict():
    port = engine.HistogramEngine(8, device="cpu")
    outs = list(port.map_frames([np.zeros((16, 16), np.uint8)] * 2))
    assert len(outs) == 2 and port.last_verdict.ok
    assert port.last_verdict.checks[-1].name == "kernel-checks"
    out = port.run(np.zeros((32, 48), np.uint8),
                   [engine.RegionQuery(np.array([[0, 0, 7, 7]]))])
    text = port.explain()
    assert "plan verdict    : OK" in text and "query-validity" in text
    assert "plan verdict" not in out.plan.explain()
    assert out.plan.explain(port.last_verdict).endswith(
        port.last_verdict.render().replace("\n", "\n  "))


def test_service_requests_go_through_the_gate():
    from repro_torch.serve.service import AnalyticsService

    eng = engine.HistogramEngine(8, device="cpu")
    store = {0: np.arange(32 * 48, dtype=np.uint8).reshape(32, 48)}
    svc = AnalyticsService(eng, store)
    svc.process([(0, engine.RegionQuery(np.array([[0, 0, 7, 7]])))])
    assert eng.last_verdict is not None and eng.last_verdict.ok
    assert any(c.name == "kernel-checks" for c in eng.last_verdict.checks)


# ---------------------------------------------------------------------------
# cuda plans, checked without a card
# ---------------------------------------------------------------------------
def _cuda(p):
    return dataclasses.replace(p, backend="cuda")


def test_wide_frame_cuda_plan_fails_h_shape_with_the_wrappers_message():
    """Once refused (the wrappers raised past 16,384 columns), a 1 x 20000
    frame now passes the gate on the card: its h-shape line holds through
    K1's column strips and kernelcheck proves the launches it adds."""
    port = engine.HistogramEngine(32, device="cpu")
    p = engine.plan(port.spec_for((1, 20000)))
    assert port.validate(p, deep=True).ok        # the torch plan runs it
    v = port.validate(_cuda(p), deep=True)
    assert v.ok, v.render()
    line = next(c for c in v.checks if c.name == "h-shape")
    assert line.status == "ok" and "via wf_tis/cuda" in line.detail
    from repro_torch.analysis import kernelcheck

    specs = kernelcheck.specs_for(kernelcheck.plan_method(p),
                                  kernelcheck.plan_geometry(p))
    assert [sp.name for sp in specs] == ["wf_tis/rows", "wf_tis/scan"]
    # ops is not gated: the torch path still takes the frame directly
    from repro_torch.kernels import ops

    H = ops.integral_histogram(np.zeros((1, 20000), np.uint8), 4,
                               device="cpu")
    assert tuple(H.shape) == (4, 1, 20000)


def test_cuda_plans_of_every_representation_prove():
    port = engine.HistogramEngine(32, device="cpu")
    dense = engine.plan(port.spec_for((16, 480, 640)))
    fused = engine.plan(dataclasses.replace(
        port.spec_for((480, 640)), query_rows=(7, 99, 219)))
    banded = engine.plan(engine.HistogramEngine(
        128, device="cpu", memory_budget_bytes=512 << 20).spec_for(
            (2160, 3840)))
    cw = engine.plan(engine.HistogramEngine(
        32, device="cpu", method="cw_tis").spec_for((16, 480, 640)))
    video = engine.plan(dataclasses.replace(port.spec_for((480, 640)),
                                            dirty_fraction=0.1))
    for p, rep in ((dense, "dense"), (fused, "fused"), (banded, "banded"),
                   (cw, "dense"), (video, "dense")):
        assert p.representation == rep
        v = port.validate(_cuda(p), deep=True)
        assert v.ok, v.render()
        assert [c.status for c in v.checks if c.name.startswith(
            "kernel-")] == ["ok"] * 4
        assert "via " + p.method in v.render() or rep == "fused"


# ---------------------------------------------------------------------------
# caching
# ---------------------------------------------------------------------------
def test_structural_verdict_is_cached_per_plan():
    port = engine.HistogramEngine(8, device="cpu")
    p = engine.plan(port.spec_for((64, 64)))
    plancheck.clear_caches()
    port.validate(p)
    before = plancheck._plan_checks.cache_info().hits
    port.validate(p)
    assert plancheck._plan_checks.cache_info().hits == before + 1


def test_incremental_plans_share_their_meta_evaluation():
    """Each video frame's plan carries its own dirty fraction; only the
    incremental line reads it, and the rest of the verdict is cached on
    the plan without it."""
    port = engine.HistogramEngine(8, device="cpu")
    base = port.spec_for((64, 64))
    plancheck.clear_caches()
    verdicts = [port.validate(engine.plan(dataclasses.replace(
        base, dirty_fraction=df)), deep=True) for df in (0.05, 0.1, 0.2)]
    info = plancheck._plan_checks.cache_info()
    assert (info.misses, info.hits) == (1, 2)
    assert plancheck._abstract_eval.cache_info().misses == 1
    assert [c.detail.split(":")[0] for v in verdicts for c in v.checks
            if c.name == "incremental"] == [
        "dirty fraction 0.05", "dirty fraction 0.10", "dirty fraction 0.20"]
    plancheck.clear_caches()
    cold = port.validate(engine.plan(dataclasses.replace(
        base, dirty_fraction=0.2)), deep=True)
    assert cold.render() == verdicts[-1].render()


@pytest.mark.parametrize("method", ["wf_tis", "cw_tis"])
def test_fused_plans_with_new_rows_reuse_meta_eval_and_proofs(method):
    """A fused plan is new with every set of corner rows (a tracker's box
    that moves, new rects): its meta evaluation is keyed on the number of
    rows and the early cut, its kernel proofs on the canonical geometry,
    and each verdict equals the one an uncached call gives."""
    from repro_torch.analysis import kernelcheck

    port = engine.HistogramEngine(32, device="cpu", method=method)
    base = port.spec_for((480, 640))
    plans = [_cuda(engine.plan(dataclasses.replace(
        base, query_rows=(99 + d, 219 + d, 279 + d)))) for d in range(6)]
    assert all(p.representation == "fused" for p in plans)
    plancheck.clear_caches()
    warm = [port.validate(p, deep=True) for p in plans]
    assert all(v.ok for v in warm), warm[0].render()
    assert plancheck._plan_checks.cache_info().misses == len(plans)
    assert plancheck._abstract_eval.cache_info().misses == 1
    assert kernelcheck._proofs.cache_info().misses == 1
    for p, v in zip(plans, warm):
        plancheck.clear_caches()
        assert port.validate(p, deep=True).render() == v.render()


def test_fused_plan_with_bad_rows_fails_h_shape_with_the_wrappers_message():
    port = engine.HistogramEngine(32, device="cpu")
    base = port.spec_for((480, 640))
    good = _cuda(engine.plan(dataclasses.replace(base, query_rows=(7, 99))))
    port.validate(good, deep=True)                # warm the shared caches
    bad = dataclasses.replace(good, spec=dataclasses.replace(
        good.spec, query_rows=(99, 7)))
    v = port.validate(bad, deep=True)
    line = next(c for c in v.checks if c.name == "h-shape")
    assert line.status == "fail"
    assert "row_ids must be sorted unique rows within [0, 480)" in line.detail


def test_queries_are_checked_fresh_on_a_cached_plan():
    port = engine.HistogramEngine(8, device="cpu")
    p = engine.plan(port.spec_for((64, 64)))
    small = port.validate(p, [engine.RegionQuery(np.array([[0, 0, 3, 3]]))])
    large = port.validate(p, [engine.RegionQuery(
        np.array([[0, 0, 4095, 4095]]))])
    assert small.ok and not large.ok
    assert small.checks[-1].detail.startswith("largest region 16 px")

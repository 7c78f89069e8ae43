"""repro_torch's incremental video path held against the JAX reference.

The same numpy frames, made from a seed, go through ``repro`` on the CPU
(``backend="jnp"``, and the Pallas ``delta_apply`` kernel with
``interpret=True``) and through ``repro_torch`` with ``device="cpu"``,
where ``delta_apply_cuda`` runs its plain version.  Updated H, spilled
bands, carries, dirty reports and histograms are compared bit for bit;
maps within rtol 1e-6 / atol 1e-7.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta as ref_delta
from repro.core import engine as ref_engine
from repro.core.bands import plan_bands as ref_plan_bands
from repro.kernels import ops as ref_ops
from repro_torch.core import delta, engine
from repro_torch.core.bands import iter_banded_ih, plan_bands
from repro_torch.core.hsource import BandedH, DenseH
from repro_torch.kernels import ops
from repro_torch.kernels.delta_apply import delta_apply_cuda

torch.set_num_threads(1)

H, W, BINS = 32, 24, 8
RTOL, ATOL = 1e-6, 1e-7


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _frame(seed, shape=(H, W)):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _mutate(frame, seed, r0, r1):
    """A low-motion successor: rows [r0, r1) rewritten, rest identical."""
    nxt = frame.copy()
    nxt[..., r0:r1, :] = np.random.default_rng(seed).integers(
        0, 256, frame[..., r0:r1, :].shape, np.uint8)
    return nxt


def _full(frame):
    return ops.integral_histogram(frame, BINS, device="cpu")


def _recompute(band_rows, carry):
    return ops.integral_histogram(band_rows, BINS, carry_in=carry,
                                  device="cpu")


def _ref_recompute(band_rows, carry):
    return ref_ops.integral_histogram(
        jnp.asarray(band_rows), BINS, backend="jnp",
        carry_in=None if carry is None else jnp.asarray(carry))


# ---------------------------------------------------------------------------
# diff_bands: the detector
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("as_tensor", [False, True])
def test_diff_bands_matches_reference_on_frames(as_tensor):
    f0 = _frame(1)
    f1 = _mutate(f0, 2, 5, 9)                       # straddles bands 0, 1
    conv = torch.as_tensor if as_tensor else (lambda x: x)
    for spans in (plan_bands(H, W, BINS, band_h=8),
                  [(0, 5), (5, 16), (16, H)], [(0, H)]):
        ref_spans = getattr(spans, "spans", spans)
        got = delta.diff_bands(conv(f0), conv(f1), spans)
        want = ref_delta.diff_bands(f0, f1, ref_spans)
        assert (got.spans, got.dirty, got.frame_h) == (want.spans, want.dirty,
                                                       want.frame_h)
        assert (got.dirty_rows, got.dirty_fraction, got.num_dirty,
                got.all_clean) == (want.dirty_rows, want.dirty_fraction,
                                   want.num_dirty, want.all_clean)
    # a tensor beside a numpy frame is compared on the tensor's device
    mixed = delta.diff_bands(f0, torch.as_tensor(f1), [(0, 16), (16, H)])
    assert mixed.dirty == (True, False)
    assert delta.diff_bands(conv(f0), conv(f0), [(0, H)]).all_clean
    for mod in (delta, ref_delta):
        with pytest.raises(ValueError, match="shapes differ"):
            mod.diff_bands(f0, f1[:-1], [(0, H)])
        with pytest.raises(ValueError, match="do not tile"):
            mod.diff_bands(f0, f1, [(0, 5), (6, H)])
        with pytest.raises(ValueError, match="do not tile"):
            mod.diff_bands(f0, f1, [(0, H - 1)])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_diff_bands_on_frame_stacks(as_tensor):
    clip0 = np.stack([_frame(3), _frame(4)])
    clip1 = clip0.copy()
    clip1[1, 20:22] = 0                              # dirty in ONE frame
    bp = plan_bands(H, W, BINS, band_h=8)
    conv = torch.as_tensor if as_tensor else (lambda x: x)
    got = delta.diff_bands(conv(clip0), conv(clip1), bp)
    want = ref_delta.diff_bands(clip0, clip1, ref_plan_bands(H, W, BINS,
                                                             band_h=8))
    assert got.dirty == want.dirty == (False, False, True, False)


def test_merged_runs_match_reference():
    spans = ((0, 4), (4, 8), (8, 12), (12, 20), (20, 32))
    for dirty in [(False,) * 5, (True, True, False, True, False),
                  (False, True, True, True, False), (True,) * 5]:
        rep = delta.DirtyReport(spans=spans, dirty=dirty, frame_h=H)
        ref = ref_delta.DirtyReport(spans=spans, dirty=dirty, frame_h=H)
        assert delta._merged_runs(rep) == ref_delta._merged_runs(ref)
    assert delta.DEFAULT_DIRTY_THRESHOLD == ref_delta.DEFAULT_DIRTY_THRESHOLD


# ---------------------------------------------------------------------------
# update_dense_ih: both branches, every dirty position
# ---------------------------------------------------------------------------
def _plain_k3(slab, d, out=None):
    """The wrapper of K3 on a CPU tensor: its plain version."""
    return ops.delta_apply(slab, d, out=out, device="cpu")


@pytest.mark.parametrize("apply_fn", [None, _plain_k3],
                         ids=["assemble", "k3_walk"])
@pytest.mark.parametrize("span", [(0, 4), (13, 18), (28, 32), (0, 32),
                                  (3, 4)])
def test_update_dense_ih_matches_reference(apply_fn, span):
    f0 = _frame(5)
    f1 = _mutate(f0, 6, *span)
    spans = [(0, 5), (5, 16), (16, 23), (23, H)]    # uneven on purpose
    rep = delta.diff_bands(f0, f1, spans)
    got = delta.update_dense_ih(_full(f0), f1, rep, recompute=_recompute,
                                apply_fn=apply_fn)
    want = ref_delta.update_dense_ih(
        np.asarray(ref_ops.integral_histogram(jnp.asarray(f0), BINS,
                                              backend="jnp")),
        f1, ref_delta.diff_bands(f0, f1, spans), recompute=_ref_recompute)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(got), _np(_full(f1)))


def test_update_dense_ih_k3_walk_writes_into_the_new_h():
    """The K3 walk allocates the new H once: every repaired run is written
    by ``apply_fn`` straight into its rows of it, with no joining copy."""
    f0 = _frame(5)
    f1 = _mutate(f0, 6, 13, 18)
    rep = delta.diff_bands(f0, f1, [(0, 5), (5, 16), (16, 23), (23, H)])
    H0 = _full(f0)
    outs = []

    def k3(slab, d, out=None):
        outs.append(out)
        return _plain_k3(slab, d, out=out)

    got = delta.update_dense_ih(H0, f1, rep, recompute=_recompute,
                                apply_fn=k3)
    assert len(outs) == 1
    base = got.untyped_storage().data_ptr()
    assert outs[0].untyped_storage().data_ptr() == base
    assert outs[0].data_ptr() == got[..., 23:, :].data_ptr()
    assert base != H0.untyped_storage().data_ptr()     # out of place
    np.testing.assert_array_equal(_np(got), _np(_full(f1)))


@pytest.mark.parametrize("apply_fn", [None, _plain_k3],
                         ids=["assemble", "k3_walk"])
def test_update_dense_ih_two_dirty_runs_and_stacks(apply_fn):
    clip0 = np.stack([_frame(7), _frame(8)])
    clip1 = _mutate(_mutate(clip0, 9, 4, 6), 10, 20, 22)
    rep = delta.diff_bands(clip0, clip1, plan_bands(H, W, BINS, band_h=4))
    got = delta.update_dense_ih(_full(clip0), clip1, rep,
                                recompute=_recompute, apply_fn=apply_fn)
    np.testing.assert_array_equal(_np(got), _np(_full(clip1)))
    # a numpy H (e.g. from the reference) becomes a host tensor
    got_np = delta.update_dense_ih(_np(_full(clip0)), clip1, rep,
                                   recompute=_recompute, apply_fn=apply_fn)
    assert isinstance(got_np, torch.Tensor)
    np.testing.assert_array_equal(_np(got_np), _np(got))
    clean = delta.diff_bands(clip0, clip0, [(0, H)])
    H0 = _full(clip0)
    assert delta.update_dense_ih(H0, clip0, clean, recompute=_recompute,
                                 apply_fn=apply_fn) is not None


# ---------------------------------------------------------------------------
# update_banded_factory and update_spilled_ih
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("span", [(3, 6), (26, 30)])
def test_update_banded_factory_matches_fresh_stream(span):
    f0 = _frame(11)
    f1 = _mutate(f0, 12, *span)
    bp = plan_bands(H, W, BINS, band_h=8)
    rep = delta.diff_bands(f0, f1, bp)

    def factory():
        return iter_banded_ih(f0, BINS, plan=bp, device="cpu")

    new = delta.update_banded_factory(factory, f1, rep, recompute=_recompute)
    fresh = list(iter_banded_ih(f1, BINS, plan=bp, device="cpu"))
    got = list(new())
    assert len(got) == len(fresh) == 4
    for g, f in zip(got, fresh):
        assert (g.index, g.r0, g.r1) == (f.index, f.r0, f.r1)
        np.testing.assert_array_equal(_np(g.H), _np(f.H))
        np.testing.assert_array_equal(_np(g.carry), _np(f.carry))
    bad = delta.diff_bands(f0, f1, [(0, 16), (16, H)])
    with pytest.raises(ValueError, match="one band plan"):
        list(delta.update_banded_factory(factory, f1, bad,
                                         recompute=_recompute)())


@pytest.mark.parametrize("storage", ["float32", "uint32", "uint16"])
def test_update_spilled_ih_matches_reference(storage):
    f0 = _frame(13)
    f1 = _mutate(f0, 14, 9, 12)
    budget = 4 * BINS * W * 8                        # 8-row bands
    src = engine.HistogramEngine(BINS, storage=storage,
                                 memory_budget_bytes=budget,
                                 device="cpu").run(f0).source
    ref_src = ref_engine.HistogramEngine(BINS, backend="jnp",
                                         storage=storage,
                                         memory_budget_bytes=budget).run(
        f0).source
    rep = delta.diff_bands(f0, f1, src.spans)
    got = delta.update_spilled_ih(src, f1, rep, recompute=_recompute)
    want = ref_delta.update_spilled_ih(
        ref_src, f1, ref_delta.diff_bands(f0, f1, ref_src.spans),
        recompute=_ref_recompute)
    for g, w in zip(got.bands, want.bands):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got.carries, want.carries):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="carr"):
        delta.update_spilled_ih(dataclasses.replace(src, carries=None), f1,
                                rep, recompute=_recompute)
    with pytest.raises(ValueError, match="spans"):
        delta.update_spilled_ih(src, f1, delta.diff_bands(f0, f1, [(0, H)]),
                                recompute=_recompute)


# ---------------------------------------------------------------------------
# K3: delta_apply's plain version against the TPU kernel
# ---------------------------------------------------------------------------
def test_plain_k3_matches_pallas_interpret():
    rng = np.random.default_rng(15)
    slab = rng.integers(0, 1000, (BINS, 40, 56)).astype(np.float32)
    d = rng.integers(-50, 50, (BINS, 56)).astype(np.float32)
    want = np.asarray(ref_ops.delta_apply(jnp.asarray(slab), jnp.asarray(d),
                                          backend="pallas", interpret=True))
    np.testing.assert_array_equal(_np(ops.delta_apply(slab, d, device="cpu")),
                                  want)
    got = delta_apply_cuda(torch.as_tensor(slab)[None],
                           torch.as_tensor(d)[None])
    np.testing.assert_array_equal(_np(got[0]), want)
    slab4, d4 = np.stack([slab, 2 * slab]), np.stack([d, -d])
    want4 = np.asarray(ref_ops.delta_apply(jnp.asarray(slab4),
                                           jnp.asarray(d4), backend="pallas",
                                           interpret=True))
    np.testing.assert_array_equal(
        _np(ops.delta_apply(slab4, d4, device="cpu")), want4)
    # out= takes a row band of another H
    big = torch.zeros((2, BINS, 50, 56))
    res = ops.delta_apply(torch.as_tensor(slab4), torch.as_tensor(d4),
                          out=big[:, :, 5:45], device="cpu")
    assert res.data_ptr() == big[:, :, 5:45].data_ptr()
    np.testing.assert_array_equal(_np(big[:, :, 5:45]), want4)


def test_delta_apply_validation():
    slab = np.zeros((BINS, 8, 8), np.float32)
    for mod, kw in ((ops, dict(device="cpu")), (ref_ops, {})):
        with pytest.raises(ValueError):
            mod.delta_apply(slab, np.zeros((BINS + 1, 8), np.float32), **kw)
        with pytest.raises(ValueError):
            mod.delta_apply(np.zeros((8,), np.float32),
                            np.zeros((8, 8), np.float32), **kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.delta_apply(slab, np.zeros((BINS, 8), np.float32),
                        backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="delta must be"):
        delta_apply_cuda(torch.zeros((1, 2, 3, 4)), torch.zeros((1, 2, 5)))
    with pytest.raises(ValueError, match="out must be"):
        delta_apply_cuda(torch.zeros((1, 2, 3, 4)), torch.zeros((1, 2, 4)),
                         out=torch.zeros((1, 2, 3, 5)))


# ---------------------------------------------------------------------------
# the planner gate and the engine path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(dirty_fraction=0.2),
    dict(dirty_fraction=0.35),
    dict(dirty_fraction=0.5),
    dict(dirty_fraction=0.2, query_rows=(3, 7)),
    dict(dirty_fraction=0.2, memory_budget_bytes=4 * BINS * W * 8),
    dict(dirty_fraction=0.2, storage="uint16", num_frames=3),
    dict(dirty_fraction=0.0, num_frames=None),
])
def test_plan_incremental_matches_reference(kw):
    base = dict(height=H, width=W, num_bins=BINS)
    got = engine.plan(engine.WorkloadSpec(device="cpu", **base, **kw))
    want = ref_engine.plan(ref_engine.WorkloadSpec(backend="jnp", **base,
                                                   **kw))
    bp = None if got.band_plan is None else got.band_plan.spans
    wbp = None if want.band_plan is None else want.band_plan.spans
    assert (got.representation, got.incremental, got.microbatch, bp) == (
        want.representation, want.incremental, want.microbatch, wbp)
    line = [ln for ln in got.explain().splitlines() if "incremental" in ln]
    want_line = [ln for ln in want.explain().splitlines()
                 if "incremental" in ln]
    assert line == want_line
    with pytest.raises(ValueError, match="dirty_fraction"):
        engine.plan(engine.WorkloadSpec(device="cpu", dirty_fraction=1.5,
                                        **base))


def _stream(seed, n=5, motion=((1, 4), (25, 28), (17, 20), (10, 13))):
    # Each edit lies inside one 8-row band: a quarter of the frame dirty.
    frames = [_frame(seed)]
    for i, span in enumerate(motion[:n - 1]):
        frames.append(_mutate(frames[-1], seed + 1 + i, *span))
    return frames


@pytest.mark.parametrize("config", [
    dict(),
    dict(memory_budget_bytes=4 * BINS * W * 8),
    dict(memory_budget_bytes=4 * BINS * W * 8, storage="float32"),
    dict(memory_budget_bytes=4 * BINS * W * 8, storage="uint16"),
], ids=["dense", "banded", "spilled_f32", "spilled_u16"])
def test_five_frame_stream_matches_reference(config):
    frames = _stream(16)
    target = np.bincount(frames[0][4:20, 4:20].ravel().astype(np.int64)
                         * BINS // 256, minlength=BINS).astype(np.float32)

    def queries(mod):
        return [mod.LikelihoodQuery(target, (8, 8), stride=2),
                mod.RegionQuery(np.array([[0, 0, 31, 23], [4, 5, 20, 17]]))]

    eng = engine.HistogramEngine(BINS, device="cpu", **config)
    ref = ref_engine.HistogramEngine(BINS, backend="jnp", **config)
    prev = ref_prev = None
    for t, f in enumerate(frames):
        got = eng.run(f, queries(engine),
                      prev=None if prev is None else (frames[t - 1], prev))
        want = ref.run(f, queries(ref_engine),
                       prev=None if ref_prev is None
                       else (frames[t - 1], ref_prev))
        assert got.plan.incremental == want.plan.incremental == (t > 0)
        assert got.plan.representation == want.plan.representation
        np.testing.assert_allclose(_np(got.results[0]),
                                   np.asarray(want.results[0]), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(_np(got.results[1]),
                                      np.asarray(want.results[1]))
        np.testing.assert_array_equal(_np(got.source.dense()),
                                      _np(_full(f)))
        np.testing.assert_array_equal(_np(got.source.dense()),
                                      np.asarray(want.source.dense()))
        prev, ref_prev = got, want
    if "storage" in config:
        for g, w in zip(prev.source.bands, ref_prev.source.bands):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_incremental_sources_keep_their_representation():
    frames = _stream(17, n=2)
    dense = engine.HistogramEngine(BINS, device="cpu")
    out = dense.run(frames[1], prev=(frames[0], dense.run(frames[0])))
    assert out.plan.incremental and isinstance(out.source, DenseH)
    assert "incremental" in out.plan.explain()
    banded = engine.HistogramEngine(BINS, memory_budget_bytes=4 * BINS * W * 8,
                                    device="cpu")
    out = banded.run(frames[1], prev=(frames[0], banded.run(frames[0])))
    assert out.plan.incremental and isinstance(out.source, BandedH)


def test_fused_predecessor_falls_back_to_recompute():
    """A fused H never materializes, so it cannot seed an update."""
    f0 = _frame(18)
    f1 = _mutate(f0, 19, 6, 9)
    for mod, kw in ((engine, dict(device="cpu")),
                    (ref_engine, dict(backend="jnp"))):
        eng = mod.HistogramEngine(BINS, **kw)
        q = mod.RegionQuery(np.array([2, 2, 10, 10]))
        prev = eng.run(f0, [q])
        assert prev.plan.representation == "fused"
        out = eng.run(f1, [q], prev=(f0, prev))
        assert not out.plan.incremental
        assert out.plan.representation == "fused"
        np.testing.assert_array_equal(_np(out.results[0]),
                                      _np(eng.run(f1, [q]).results[0]))


@pytest.mark.parametrize("case", ["high_motion", "shape", "bins",
                                  "single_shot", "policy"])
def test_fallbacks_recompute_as_the_reference(case):
    f0 = _frame(20)
    f1 = _mutate(f0, 21, 6, 9)
    budget = 4 * BINS * W * 8
    prev_kw, kw = {}, {}
    if case == "high_motion":
        f1 = _frame(22)                              # wholly dirty
    elif case == "shape":
        f1 = _frame(23, (H + 8, W))
    elif case == "bins":
        prev_kw = dict(num_bins=4)
    elif case == "single_shot":
        kw = prev_kw = dict(memory_budget_bytes=budget)
    elif case == "policy":
        prev_kw = dict(memory_budget_bytes=budget, storage="uint16")
        kw = dict(memory_budget_bytes=budget, storage="float32")

    def run(mod, dev_kw):
        nb = prev_kw.get("num_bins", BINS)
        pk = {k: v for k, v in prev_kw.items() if k != "num_bins"}
        prev = mod.HistogramEngine(nb, **pk, **dev_kw).run(f0)
        if case == "single_shot":
            stream = iter(list(prev.source._take_stream()))
            prev = type(prev.source)(stream)
        return mod.HistogramEngine(BINS, **kw, **dev_kw).run(
            f1, prev=(f0, prev))

    got = run(engine, dict(device="cpu"))
    want = run(ref_engine, dict(backend="jnp"))
    assert not got.plan.incremental and not want.plan.incremental
    assert got.plan.representation == want.plan.representation
    np.testing.assert_array_equal(_np(got.source.dense()),
                                  np.asarray(want.source.dense()))

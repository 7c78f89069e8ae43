"""repro_torch's band streaming, host spill and CW-TiS kernels held against
the JAX reference.

The same numpy frames, made from a seed, go through ``repro`` on the CPU
(``backend="jnp"``, or the Pallas kernels with ``interpret=True``) and
through ``repro_torch`` with ``device="cpu"``, where every kernel wrapper
runs its plain version.  H, histograms, rows, spilled bands and carries
are compared bit for bit (all counts are integers below 2^24 held in
fp32, or the modular values of an integer spill); maps and scores within
rtol 1e-6 / atol 1e-7.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bands as ref_bands
from repro.core import distances as ref_distances
from repro.core import engine as ref_engine
from repro.core import region_query as ref_rq
from repro.core.binning import PAD_BIN, bin_indices as ref_bin_indices
from repro.core.integral_histogram import IntegralHistogram as RefIH
from repro.kernels import ops as ref_ops
from repro.kernels.cw_tis import cw_tis_pallas
from repro_torch.core import bands, distances, engine
from repro_torch.core import region_query as rq
from repro_torch.core.binning import bin_indices
from repro_torch.core.hsource import BandedH, as_hsource
from repro_torch.core.integral_histogram import IntegralHistogram
from repro_torch.kernels import ops
from repro_torch.kernels.cw_tis import (
    cw_tis_cuda,
    cw_tis_hscan_cuda,
    cw_tis_vscan_cuda,
    hscan_shape,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7
BINS = 8


def _img(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _carry(seed, shape, bins):
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, 1000, shape[:-2] + (bins, shape[-1])).astype(
        np.float32)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# band planning and the storage policies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(h=37, w=100, num_bins=8, memory_budget_bytes=10_000),
    dict(h=37, w=100, num_bins=8, memory_budget_bytes=10_000, num_frames=3),
    dict(h=20, w=10, num_bins=4, band_h=64),
    dict(h=20, w=10, num_bins=4, band_h=8, row_multiple=3),
    dict(h=2160, w=3840, num_bins=128, memory_budget_bytes=512 << 20),
    dict(h=480, w=640, num_bins=32),
])
def test_plan_bands_spans_match_reference(kw):
    h, w, nb = kw.pop("h"), kw.pop("w"), kw.pop("num_bins")
    got = bands.plan_bands(h, w, nb, **kw)
    want = ref_bands.plan_bands(h, w, nb, **kw)
    assert (got.spans, got.band_h, got.band_bytes, got.full_h_bytes,
            got.num_bands) == (want.spans, want.band_h, want.band_bytes,
                               want.full_h_bytes, want.num_bands)


def test_plan_bands_and_policies_refuse_as_the_reference():
    for mod in (bands, ref_bands):
        with pytest.raises(ValueError, match="below one"):
            mod.plan_bands(37, 100, 8, memory_budget_bytes=100)
        with pytest.raises(ValueError, match="unknown storage"):
            mod.validate_storage_policy("float16", 10, 10)
        # The paper's 8192x8192 frame cannot be spilled exactly.
        with pytest.raises(ValueError, match=r"2\*\*24"):
            mod.validate_storage_policy("uint16", 8192, 8192)
        mod.validate_storage_policy("uint16", 300, 300)
    assert bands.STORAGE_POLICIES == ref_bands.STORAGE_POLICIES
    assert bands.FP32_EXACT_COUNT == ref_bands.FP32_EXACT_COUNT


# ---------------------------------------------------------------------------
# the band stream: iter_banded_ih / banded_integral_histogram / reduce
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["wf_tis", "cw_tis"])
@pytest.mark.parametrize("shape", [(37, 23), (2, 37, 23)])
def test_iter_banded_ih_matches_reference_with_carry_in(method, shape):
    img = _img(1, *shape)
    carry = _carry(1, shape, BINS)
    want = list(ref_bands.iter_banded_ih(
        img, BINS, band_h=10, method=method, backend="jnp",
        carry_in=jnp.asarray(carry)))
    got = list(bands.iter_banded_ih(img, BINS, band_h=10, method=method,
                                    carry_in=carry, device="cpu"))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert (g.index, g.num_bands, g.r0, g.r1, g.frame_h) == (
            w.index, w.num_bands, w.r0, w.r1, w.frame_h)
        np.testing.assert_array_equal(_np(g.H), np.asarray(w.H))
        np.testing.assert_array_equal(_np(g.carry), np.asarray(w.carry))
        assert g.nbytes == _np(g.H).nbytes
    full = bands.banded_integral_histogram(img, BINS, band_h=10,
                                           method=method, carry_in=carry,
                                           device="cpu")
    np.testing.assert_array_equal(
        _np(full), np.asarray(ref_bands.banded_integral_histogram(
            img, BINS, band_h=10, method=method, backend="jnp",
            carry_in=jnp.asarray(carry))))
    np.testing.assert_array_equal(
        _np(full), _np(ops.integral_histogram(img, BINS, method=method,
                                              carry_in=carry, device="cpu")))


def test_reduce_banded_and_budget_banding():
    img = _img(2, 2, 40, 24)

    def total(acc, band):
        s = float(band.H.sum()) if isinstance(band.H, torch.Tensor) \
            else float(np.asarray(band.H).sum())
        return (acc or 0.0) + s

    assert bands.reduce_banded_ih(img, BINS, total, band_h=7,
                                  device="cpu") == \
        ref_bands.reduce_banded_ih(img, BINS, total, band_h=7, backend="jnp")
    budget = 4 * 2 * BINS * 24 * 6                # 6-row bands
    got = ops.integral_histogram(img, BINS, memory_budget_bytes=budget,
                                 device="cpu")
    want = ref_ops.integral_histogram(jnp.asarray(img), BINS, backend="jnp",
                                      memory_budget_bytes=budget)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_prefetch_and_unknown_stream_raise():
    """``prefetch >= 1`` stages band slices through the frame runtime (no
    longer refused) and equals the reference's prefetching stream; an
    unknown stream still raises."""
    img = _img(3, 16, 16)
    want = [np.asarray(b.H) for b in ref_bands.iter_banded_ih(
        img, 4, band_h=4, backend="jnp", prefetch=1)]
    got = [b.H for b in bands.iter_banded_ih(img, 4, band_h=4, prefetch=1,
                                             device="cpu")]
    got_ih = [b.H for b in IntegralHistogram(num_bins=4, device="cpu")
              .map_bands(img, band_h=4, prefetch=2)]
    assert len(got) == len(got_ih) == len(want) == 4
    for g, gi, w in zip(got, got_ih, want):
        np.testing.assert_array_equal(_np(g), w)
        np.testing.assert_array_equal(_np(gi), w)
    with pytest.raises(TypeError, match="cannot interpret"):
        as_hsource(3.0)


def test_iter_banded_ih_device_names_where_bands_compute():
    """``device`` means what it means at every port entry point: where the
    bands compute.  A placement that is neither a torch device nor the
    port's ``MeshPlacement`` (the reference's jax ``Device`` or
    ``Sharding``) is refused instead of being taken for a device."""
    import jax

    img = _img(3, 16, 16)
    for device in ("cpu", torch.device("cpu")):
        got = list(bands.iter_banded_ih(img, 4, band_h=4, device=device))
        assert len(got) == 4
        assert all(b.H.device.type == b.carry.device.type == "cpu"
                   for b in got)
    with pytest.raises(TypeError, match="MeshPlacement"):
        next(bands.iter_banded_ih(img, 4, band_h=4,
                                  device=jax.devices("cpu")[0]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(bands.iter_banded_ih(img, 4, band_h=4))


def test_map_bands_matches_reference():
    img = _img(4, 48, 32)
    got = IntegralHistogram(num_bins=BINS, device="cpu").map_bands(
        img, band_h=13)
    want = RefIH(num_bins=BINS, backend="jnp").map_bands(img, band_h=13)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g.H), np.asarray(w.H))
    budget = 4 * BINS * 32 * 10
    got = IntegralHistogram(num_bins=BINS, device="cpu").map_bands(
        img, memory_budget_bytes=budget)
    assert [(b.r0, b.r1) for b in got] == [
        (b.r0, b.r1) for b in RefIH(num_bins=BINS, backend="jnp").map_bands(
            img, memory_budget_bytes=budget)]


# ---------------------------------------------------------------------------
# BandedH and the deprecated banded_* shims
# ---------------------------------------------------------------------------
def test_banded_h_rows_dense_and_replay():
    img = _img(5, 2, 45, 30)
    full = ops.integral_histogram(img, BINS, device="cpu")
    src = BandedH(lambda: bands.iter_banded_ih(img, BINS, band_h=11,
                                               device="cpu"))
    assert (src.num_bins, src.height, src.width, src.lead) == (BINS, 45, 30,
                                                               (2,))
    rows = np.array([0, 10, 11, 30, 44])
    np.testing.assert_array_equal(_np(src.rows(rows)),
                                  _np(full[..., rows, :]))
    assert src.last_stream_stats == {"num_bands": 5,
                                     "band_bytes": 4 * 2 * BINS * 11 * 30}
    np.testing.assert_array_equal(_np(src.dense()), _np(full))   # replays
    # A single-shot stream answers one query, then says how to replay.
    once = as_hsource(bands.iter_banded_ih(img, BINS, band_h=11,
                                           device="cpu"))
    assert isinstance(once, BandedH) and once.height == 45
    once.rows([3])
    with pytest.raises(RuntimeError, match="single-shot"):
        once.rows([3])
    with pytest.raises(RuntimeError, match="single-shot"):
        once.update_bands(img, None, recompute=None)


def test_banded_queries_match_reference():
    img = _img(6, 2, 60, 44)
    target = np.bincount(img[0, 10:34, 8:32].ravel().astype(np.int64)
                         * BINS // 256, minlength=BINS).astype(np.float32)
    got_src = as_hsource(lambda: bands.iter_banded_ih(img, BINS, band_h=17,
                                                      device="cpu"))
    from repro.core.hsource import as_hsource as ref_as_hsource

    want_src = ref_as_hsource(lambda: ref_bands.iter_banded_ih(
        img, BINS, band_h=17, backend="jnp"))
    rects = np.array([[0, 0, 59, 43], [7, 3, 41, 30], [59, 43, 59, 43]])
    np.testing.assert_array_equal(
        _np(got_src.region_histogram(rects)),
        np.asarray(want_src.region_histogram(rects)))
    got_stats, want_stats = {}, {}
    np.testing.assert_array_equal(
        _np(got_src.sliding_window_histograms((12, 9), 3, stats=got_stats)),
        np.asarray(want_src.sliding_window_histograms((12, 9), 3,
                                                      stats=want_stats)))
    assert got_stats == want_stats
    np.testing.assert_allclose(
        _np(got_src.likelihood_map(target, (24, 24), distances.intersection,
                                   4)),
        np.asarray(want_src.likelihood_map(target, (24, 24),
                                           ref_distances.intersection, 4)),
        rtol=RTOL, atol=ATOL)
    (rect, score, _), (w_rect, w_score, _) = (
        got_src.multi_scale_search(target, ((16, 16), (24, 24)),
                                   distances.intersection, 4),
        want_src.multi_scale_search(target, ((16, 16), (24, 24)),
                                    ref_distances.intersection, 4))
    np.testing.assert_array_equal(_np(rect), np.asarray(w_rect))
    np.testing.assert_allclose(_np(score), np.asarray(w_score), rtol=RTOL,
                               atol=ATOL)


def test_banded_shims_warn_and_match_reference():
    img = _img(7, 48, 32)
    rects = np.array([[0, 0, 47, 31], [5, 5, 30, 20]])
    target = np.full(BINS, 10.0, np.float32)

    def stream():
        return bands.iter_banded_ih(img, BINS, band_h=13, device="cpu")

    def ref_stream():
        return ref_bands.iter_banded_ih(img, BINS, band_h=13, backend="jnp")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = [
            ref_rq.banded_region_histogram(ref_stream(), rects),
            ref_rq.banded_sliding_window_histograms(ref_stream(), (8, 8), 4),
            ref_rq.banded_likelihood_map(ref_stream(), target, (8, 8),
                                         ref_distances.intersection, 4),
        ]
    with pytest.warns(DeprecationWarning, match="2.0"):
        got = [rq.banded_region_histogram(stream(), rects)]
    with pytest.warns(DeprecationWarning, match="BandedH"):
        got.append(rq.banded_sliding_window_histograms(stream(), (8, 8), 4))
    with pytest.warns(DeprecationWarning):
        got.append(rq.banded_likelihood_map(stream(), target, (8, 8),
                                            distances.intersection, 4))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]), rtol=RTOL,
                               atol=ATOL)
    ih = IntegralHistogram(num_bins=BINS, device="cpu")
    with pytest.warns(DeprecationWarning):
        np.testing.assert_array_equal(
            _np(ih.banded_query(ih.map_bands(img, band_h=13), rects)),
            np.asarray(want[0]))


def test_banded_stride_one_windows_warn_like_the_reference():
    img = _img(8, 24, 16)
    src = as_hsource(lambda: bands.iter_banded_ih(img, 4, band_h=8,
                                                  device="cpu"))
    with pytest.warns(UserWarning, match="monolithic H"):
        src.sliding_window_histograms((2, 2), 1)


# ---------------------------------------------------------------------------
# the host spill, all three policies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("storage", ["float32", "uint32", "uint16"])
def test_spill_banded_ih_matches_reference(storage):
    img = _img(9, 2, 60, 44)
    got = bands.spill_banded_ih(img, BINS, band_h=17, storage=storage,
                                device="cpu")
    want = ref_bands.spill_banded_ih(img, BINS, band_h=17, backend="jnp",
                                     storage=storage)
    assert (got.spans, got.lead, got.storage, got.height, got.width) == (
        want.spans, want.lead, want.storage, want.height, want.width)
    for g, w in zip(got.bands, want.bands):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got.carries, want.carries):
        np.testing.assert_array_equal(g, w)
    assert got.nbytes == want.nbytes
    assert got.exact_region_bound == want.exact_region_bound
    np.testing.assert_array_equal(got.assemble(), want.assemble())
    np.testing.assert_array_equal(_np(got.dense()), np.asarray(want.dense()))
    rects = np.array([[0, 0, 59, 43], [7, 3, 41, 30], [59, 43, 59, 43]])
    np.testing.assert_array_equal(_np(got.region_histogram(rects)),
                                  np.asarray(want.region_histogram(rects)))
    np.testing.assert_array_equal(
        _np(got.sliding_window_histograms((10, 10), 5)),
        np.asarray(want.sliding_window_histograms((10, 10), 5)))


def test_uint16_spill_wraps_and_stays_exact():
    """uint16 H values wrap past 65535; the port does the four-corner
    arithmetic in int64 and reduces modulo 2^16, so every region of at
    most 65535 px reads back as the reference's modular uint16 arithmetic
    does, and a larger one is refused by both."""
    img = _img(10, 300, 300)
    img[:250] = 0                           # bin 0 counts up to 75000
    got = bands.spill_banded_ih(img, 4, band_h=64, storage="uint16",
                                device="cpu")
    want = ref_bands.spill_banded_ih(img, 4, band_h=64, backend="jnp",
                                     storage="uint16")
    full = ops.integral_histogram(img, 4, device="cpu")
    assert float(full.max()) > 65535         # the wrap happens
    rows = got.rows(np.array([10, 200, 299]))
    assert rows.dtype == torch.int64 and int(rows.max()) <= 65535
    np.testing.assert_array_equal(_np(rows),
                                  want.rows(np.array([10, 200, 299])))
    rects = np.array([[0, 0, 199, 299], [100, 100, 250, 250]])  # <= 60000 px
    np.testing.assert_array_equal(_np(got.region_histogram(rects)),
                                  np.asarray(want.region_histogram(rects)))
    np.testing.assert_array_equal(_np(got.region_histogram(rects)),
                                  _np(rq.region_histogram(full, rects)))
    np.testing.assert_array_equal(
        _np(got.sliding_window_histograms((200, 300), 50)),
        np.asarray(want.sliding_window_histograms((200, 300), 50)))
    for src in (got, want):
        with pytest.raises(ValueError, match="exceeds the uint16"):
            src.region_histogram(np.array([[0, 0, 299, 299]]))   # 90000 px


# ---------------------------------------------------------------------------
# the planner and engine on banded and spilled plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("budget,storage,num_frames", [
    (4 * BINS * 44 * 8, None, 1),          # banded, 8-row bands
    (4 * 2 * BINS * 44 * 8, None, 2),      # banded stack
    (1 << 30, None, 1),                    # one band fits: dense
    (4 * BINS * 44 * 8, "uint16", 1),      # spilled
    (None, "float32", 2),                  # spilled, one band
])
def test_engine_plans_banded_and_spilled_as_the_reference(budget, storage,
                                                          num_frames):
    kw = dict(height=60, width=44, num_bins=BINS, num_frames=num_frames,
              memory_budget_bytes=budget, storage=storage)
    got = engine.plan(engine.WorkloadSpec(device="cpu", **kw))
    want = ref_engine.plan(ref_engine.WorkloadSpec(backend="jnp", **kw))
    bp = None if got.band_plan is None else got.band_plan.spans
    wbp = None if want.band_plan is None else want.band_plan.spans
    assert (got.representation, got.microbatch, got.storage, bp) == (
        want.representation, want.microbatch, want.storage, wbp)
    keys = ("representation", "bands", "storage", "microbatch")
    assert [ln for ln in got.explain().splitlines()
            if ln.split(":")[0].strip() in keys] == [
        ln for ln in want.explain().splitlines()
        if ln.split(":")[0].strip() in keys]


@pytest.mark.parametrize("storage", [None, "uint16"])
def test_engine_run_banded_and_spilled_match_reference(storage):
    frames = _img(11, 2, 60, 44)
    target = np.bincount(frames[0, 8:32, 4:28].ravel().astype(np.int64)
                         * BINS // 256, minlength=BINS).astype(np.float32)
    budget = 4 * 2 * BINS * 44 * 8

    def queries(mod):
        return [mod.RegionQuery(np.array([[0, 0, 59, 43], [5, 6, 40, 30]])),
                mod.SlidingWindowQuery((6, 6), 2),
                mod.LikelihoodQuery(target, (24, 24), stride=4)]

    got = engine.HistogramEngine(BINS, memory_budget_bytes=budget,
                                 storage=storage, device="cpu").run(
        frames, queries(engine))
    want = ref_engine.HistogramEngine(BINS, backend="jnp",
                                      memory_budget_bytes=budget,
                                      storage=storage).run(
        frames, queries(ref_engine))
    rep = "spilled" if storage else "banded"
    assert got.plan.representation == want.plan.representation == rep
    for i in (0, 1):
        np.testing.assert_array_equal(_np(got.results[i]),
                                      np.asarray(want.results[i]))
    np.testing.assert_allclose(_np(got.results[2]),
                               np.asarray(want.results[2]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(_np(got.source.dense()),
                                  np.asarray(want.source.dense()))


def test_multi_query_banded_request_streams_once(monkeypatch):
    frames = _img(12, 60, 44)
    calls = []
    real = bands.iter_banded_ih

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(bands, "iter_banded_ih", counting)
    eng = engine.HistogramEngine(BINS, memory_budget_bytes=4 * BINS * 44 * 8,
                                 device="cpu")
    out = eng.run(frames, [engine.RegionQuery(np.array([[0, 0, 59, 43]])),
                           engine.SlidingWindowQuery((6, 6), 2)])
    assert out.plan.representation == "banded"
    assert len(calls) == 1                   # one stream for both queries


# ---------------------------------------------------------------------------
# K4: the CW-TiS kernels' plain versions
# ---------------------------------------------------------------------------
def test_k4_semantics_match_pallas_interpret_on_padded_ids():
    """K4's wrappers (their plain versions on a CPU tensor) against the TPU
    kernels themselves, run in interpret mode on ids padded to the tile
    with PAD_BIN, carry-in included: the padding matches no bin, so the
    unpadded H is the padded one cut to size."""
    img = _img(13, 2, 50, 70)
    nb, tile = 16, 32
    carry = _carry(13, img.shape, nb)
    ids = np.asarray(ref_bin_indices(jnp.asarray(img), nb))
    hp, wp = -(-50 // tile) * tile, -(-70 // tile) * tile
    padded = np.full((2, hp, wp), PAD_BIN, np.int32)
    padded[:, :50, :70] = ids
    carry_p = np.zeros((2, nb, wp), np.float32)
    carry_p[..., :70] = carry
    want = np.asarray(cw_tis_pallas(jnp.asarray(padded), nb, tile=tile,
                                    bin_block=8, interpret=True,
                                    carry=jnp.asarray(carry_p)))
    got_padded = cw_tis_cuda(torch.as_tensor(padded), nb,
                             carry=torch.as_tensor(carry_p))
    np.testing.assert_array_equal(_np(got_padded), want)
    idx = bin_indices(torch.as_tensor(img), nb)
    assert np.array_equal(_np(idx), ids)
    got = cw_tis_cuda(idx.contiguous(), nb, carry=torch.as_tensor(carry))
    np.testing.assert_array_equal(_np(got), want[..., :50, :70])
    # The two passes the card runs, composed, are the same function.
    hh = cw_tis_hscan_cuda(idx.contiguous(), nb)
    np.testing.assert_array_equal(
        _np(cw_tis_vscan_cuda(hh, torch.as_tensor(carry))), want[..., :50, :70])


def test_k4_launch_shape_and_checks():
    # One warp a (frame, row, bin block), 8 warps a CTA, at any width.
    assert hscan_shape(32) == (8, 8)
    assert hscan_shape(3) == (2, 8)
    assert hscan_shape(32, bin_block=1)[0] == 1
    with pytest.raises(ValueError, match="bin_block"):
        hscan_shape(32, bin_block=3)
    assert hscan_shape(8) == (8, 8)
    assert hscan_shape(8, bin_block=2)[0] == 2
    with pytest.raises(ValueError, match="int32"):
        cw_tis_hscan_cuda(torch.zeros((1, 4, 4), dtype=torch.int64), 4)
    with pytest.raises(ValueError, match="float32"):
        cw_tis_vscan_cuda(torch.zeros((1, 2, 4, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="carry"):
        cw_tis_vscan_cuda(torch.zeros((1, 2, 4, 4)), torch.zeros((1, 3, 4)))


@pytest.mark.parametrize("shape,rows,with_carry", [
    ((50, 70), (0, 7, 31, 49), False),
    ((3, 97, 41), (10, 20, 33, 60), True),
])
def test_cw_tis_fused_corner_rows_stream_bands(shape, rows, with_carry):
    """fused_corner_rows(method="cw_tis") streams tile-high bands through
    the CW-TiS scan with the carry, as the reference does off its fused
    kernel."""
    img = _img(14, *shape)
    carry = _carry(14, shape, BINS) if with_carry else None
    want = ref_ops.fused_corner_rows(
        jnp.asarray(img), BINS, np.asarray(rows), method="cw_tis",
        backend="jnp", tile=16,
        carry_in=None if carry is None else jnp.asarray(carry))
    got = ops.fused_corner_rows(img, BINS, rows, method="cw_tis", tile=16,
                                carry_in=carry, device="cpu")
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    with pytest.raises(ValueError, match="no CUDA kernel"):
        ops.fused_corner_rows(img, BINS, rows, method="cw_sts",
                              backend="cuda", device="cpu")


def test_cw_tis_engine_matches_wf_tis_engine():
    frames = _img(15, 2, 64, 48)
    queries = [engine.SlidingWindowQuery((4, 4), 2),
               engine.RegionQuery(np.array([[0, 0, 63, 47], [9, 9, 30, 40]]))]
    cw = engine.HistogramEngine(BINS, method="cw_tis", device="cpu").run(
        frames, queries)
    wf = engine.HistogramEngine(BINS, device="cpu").run(frames, queries)
    assert cw.plan.method == "cw_tis" and cw.plan.representation == "dense"
    for a, b in zip(cw.results, wf.results):
        np.testing.assert_array_equal(_np(a), _np(b))
    ref = ref_engine.HistogramEngine(BINS, method="cw_tis",
                                     backend="jnp").run(
        frames, [ref_engine.SlidingWindowQuery((4, 4), 2)])
    np.testing.assert_array_equal(_np(cw.results[0]),
                                  np.asarray(ref.results[0]))

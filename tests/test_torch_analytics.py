"""repro_torch's O(1) analytics held against the JAX reference.

H is computed once by the reference (numpy out of JAX) and handed to both
packages: that is how state crosses between them, since this system has
no weights.  Histograms are integer-valued fp32 and must match bit for
bit.  Likelihood maps and scores are compared with rtol 1e-6 / atol 1e-7
where the reference runs under ``jax.jit`` (one compile per shape instead
of one per eager op), which may fuse the metrics into another order.  The
port's metrics sum their bins in order, as XLA:CPU does up to 32 bins, so
against the eager reference they are bit-equal there
(``test_distances_bit_exact_up_to_32_bins``, the multi-scale near-tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as ref_dist
from repro.core import hsource as ref_hs
from repro.core import region_query as ref_rq
from repro.kernels import ops as ref_ops
from repro_torch.core import distances, hsource, region_query
from repro_torch.kernels import ops

torch.set_num_threads(1)

ref_region = jax.jit(ref_rq.region_histogram)
ref_windows = jax.jit(ref_rq.sliding_window_histograms,
                      static_argnums=(1, 2), static_argnames=("impl",))
ref_lmap = jax.jit(ref_rq.likelihood_map, static_argnums=(2, 3, 4))
ref_search = jax.jit(ref_rq.multi_scale_search, static_argnums=(2, 3, 4))

METRICS = ("intersection", "bhattacharyya", "chi2", "l1", "l2")
RTOL, ATOL = 1e-6, 1e-7


def _metric(pkg, name):
    return getattr(pkg, name)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _H(shape, bins, seed=0):
    """(frames, reference H as numpy, the port's DenseH of it)."""
    img = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    H = np.array(ref_ops.integral_histogram(jnp.asarray(img), bins,
                                            backend="jnp"))
    return img, H, hsource.DenseH(H, device="cpu")


RECTS = np.array([[0, 0, 31, 47], [3, 4, 20, 40], [0, 5, 0, 5],
                  [10, 0, 31, 0], [7, 9, 8, 47]])


@pytest.mark.parametrize("shape,bins", [((32, 48), 8), ((3, 32, 48), 32)])
def test_region_histogram_bit_exact(shape, bins):
    _, H, _ = _H(shape, bins)
    want = ref_region(jnp.asarray(H), jnp.asarray(RECTS))
    got = region_query.region_histogram(torch.as_tensor(H), RECTS)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    # (2, 2, 4)-shaped rects keep their leading axes.
    rects = RECTS[:4].reshape(2, 2, 4)
    np.testing.assert_array_equal(
        _np(region_query.region_histogram(torch.as_tensor(H), rects)),
        np.asarray(ref_region(jnp.asarray(H), jnp.asarray(rects))))


def test_out_of_range_rect_is_clamped_like_the_reference():
    _, H, _ = _H((32, 48), 8)
    rect = np.array([[0, 0, 100, 200]])
    want = np.asarray(ref_region(jnp.asarray(H), jnp.asarray(rect)))
    got = _np(region_query.region_histogram(torch.as_tensor(H), rect))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], H[:, -1, -1])     # whole frame


@pytest.mark.parametrize("impl", ["slice", "gather"])
@pytest.mark.parametrize("window,stride", [
    ((1, 1), 1), ((9, 5), 3), ((40, 8), 2),
])
def test_sliding_windows_bit_exact(impl, window, stride):
    _, H, _ = _H((3, 32, 48), 8)
    want = ref_windows(jnp.asarray(H), window, stride, impl=impl)
    got = region_query.sliding_window_histograms(torch.as_tensor(H), window,
                                                 stride, impl=impl)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("metric", METRICS)
def test_likelihood_maps_close(metric):
    _, H, src = _H((2, 32, 48), 16)
    target = np.random.default_rng(1).integers(0, 50, 16).astype(np.float32)
    want = ref_lmap(jnp.asarray(H), jnp.asarray(target), (8, 12),
                    _metric(ref_dist, metric), 2)
    got = region_query.likelihood_map(torch.as_tensor(H), target, (8, 12),
                                      _metric(distances, metric), 2)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # per-frame targets (n, b) broadcast over the window grid
    targets = np.stack([target, target[::-1]])
    want = ref_lmap(jnp.asarray(H), jnp.asarray(targets), (8, 12),
                    _metric(ref_dist, metric), 2)
    got = src.likelihood_map(targets, (8, 12), _metric(distances, metric), 2)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _template_case():
    """A noise frame and the histogram of one of its patches: no other
    window ties with it, so the best rect is unambiguous."""
    img, H, src = _H((2, 48, 64), 32, seed=3)
    patch = np.array([16, 24, 31, 39])                  # 16x16 at (16, 24)
    target = np.array(ref_region(jnp.asarray(H[0]), jnp.asarray(patch)))
    return H, src, target


def test_multi_scale_search_matches_reference():
    H, src, target = _template_case()
    windows = ((8, 8), (16, 16), (64, 64))    # the last one never fits
    want_rect, want_score, want_maps = ref_search(
        jnp.asarray(H), jnp.asarray(target), windows, ref_dist.intersection, 8)
    for source in (torch.as_tensor(H), src):
        rect, score, maps = region_query.multi_scale_search(
            source, target, windows, distances.intersection, 8)
        np.testing.assert_array_equal(_np(rect), np.asarray(want_rect))
        assert _np(rect)[0].tolist() == [16, 24, 31, 39]
        np.testing.assert_allclose(_np(score), np.asarray(want_score),
                                   rtol=RTOL, atol=ATOL)
        for g, w in zip(maps, want_maps):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL,
                                       atol=ATOL)


def test_generic_corner_row_path_matches_reference():
    """The HSource generic (rows()-based) analytics, through a
    PrefetchedRowsH, against the reference's own generic path."""
    H, src, target = _template_case()
    rows = np.arange(H.shape[-2])
    ref_src = ref_hs.PrefetchedRowsH(ref_hs.DenseH(H), rows, H)
    got_src = hsource.PrefetchedRowsH(src, rows, torch.as_tensor(H))
    np.testing.assert_array_equal(
        _np(got_src.region_histogram(RECTS)),
        np.asarray(ref_src.region_histogram(RECTS)))
    np.testing.assert_array_equal(
        _np(got_src.sliding_window_histograms((9, 5), 3)),
        np.asarray(ref_src.sliding_window_histograms((9, 5), 3)))
    want_rect, want_score, _ = ref_src.multi_scale_search(
        target, ((8, 8), (16, 16)), ref_dist.intersection, 8)
    rect, score, _ = got_src.multi_scale_search(
        target, ((8, 8), (16, 16)), distances.intersection, 8)
    np.testing.assert_array_equal(_np(rect), np.asarray(want_rect))
    np.testing.assert_allclose(_np(score), np.asarray(want_score),
                               rtol=RTOL, atol=ATOL)
    # the generic path equals the dense fast path bit for bit
    np.testing.assert_array_equal(
        _np(got_src.sliding_window_histograms((16, 16), 8)),
        _np(src.sliding_window_histograms((16, 16), 8)))


def test_fused_rows_source_and_missing_rows():
    img, H, _ = _H((2, 40, 30), 8, seed=4)
    rows = np.array([4, 9, 19, 39])
    R = ops.fused_corner_rows(img, 8, rows, device="cpu")
    src = hsource.FusedRowsH(rows, R, height=40, width=30)
    np.testing.assert_array_equal(_np(src.rows([9, 39])), H[..., [9, 39], :])
    rects = np.array([[5, 0, 9, 29], [10, 3, 19, 7], [0, 0, 39, 29]])
    np.testing.assert_array_equal(_np(src.region_histogram(rects)),
                                  _np(hsource.DenseH(H, "cpu")
                                      .region_histogram(rects)))
    with pytest.raises(hsource.MissingRowsError):
        src.rows([5])
    with pytest.raises(hsource.MissingRowsError):
        src.dense()
    with pytest.raises(hsource.MissingRowsError):
        hsource.PrefetchedRowsH(src, rows, R).rows([3])
    assert src.nbytes == 4 * R.numel()


@pytest.mark.parametrize("metric", ["intersection", "chi2"])
def test_fused_likelihood_map_matches_reference(metric):
    img = np.random.default_rng(5).integers(0, 256, (2, 48, 40), np.uint8)
    model = np.random.default_rng(6).integers(1, 9, 8).astype(np.float32)
    want = ref_ops.fused_likelihood_map(
        jnp.asarray(img), jnp.asarray(model), _metric(ref_dist, metric),
        window=(12, 10), stride=4, backend="jnp", tile=16)
    stats = {}
    got = ops.fused_likelihood_map(img, model, _metric(distances, metric),
                                   window=(12, 10), stride=4, tile=16,
                                   stats=stats, device="cpu")
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert stats["rows_bytes"] < stats["full_h_bytes"]


def test_compressed_queries_and_corner_rows():
    _, H, _ = _H((2, 32, 48), 8)
    rects = np.array([[3, 4, 20, 40], [0, 0, 31, 47], [21, 1, 30, 2]])
    needed = ref_rq.corner_rows(rects)
    np.testing.assert_array_equal(region_query.corner_rows(rects), needed)
    Hc = H[..., needed, :]
    want = ref_rq.compressed_region_histogram(
        jnp.asarray(Hc), jnp.asarray(needed), jnp.asarray(rects))
    got = region_query.compressed_region_histogram(torch.as_tensor(Hc),
                                                   needed, rects)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_reduce_scale_maps_matches_reference():
    rng = np.random.default_rng(7)
    maps = [rng.random((2, 4, 5)).astype(np.float32),
            np.zeros((2, 0, 3), np.float32),
            rng.random((2, 3, 3)).astype(np.float32)]
    windows = ((4, 4), (90, 90), (8, 8))
    want = ref_rq.reduce_scale_maps([jnp.asarray(m) for m in maps], windows,
                                    4, (2,))
    got = region_query.reduce_scale_maps([torch.as_tensor(m) for m in maps],
                                         windows, 4, (2,))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("metric", METRICS)
def test_distances_match_reference(metric):
    rng = np.random.default_rng(8)
    a = rng.integers(0, 20, (3, 4, 16)).astype(np.float32)
    b = rng.integers(0, 20, 16).astype(np.float32)
    want = _metric(ref_dist, metric)(jnp.asarray(a), jnp.asarray(b))
    got = _metric(distances, metric)(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_bhattacharyya_bounds_at_128_bins():
    h = torch.zeros(128)
    h[3] = 5.0
    other = torch.zeros(128)
    other[7] = 2.0
    assert float(distances.bhattacharyya(h, h)) <= 1.0
    assert float(distances.bhattacharyya(h, other)) == 0.0


def test_as_hsource_and_dense_h():
    _, H, src = _H((32, 48), 8)
    assert hsource.as_hsource(src) is src
    dense = hsource.as_hsource(H, device="cpu")
    assert isinstance(dense, hsource.DenseH)
    assert (dense.num_bins, dense.height, dense.width, dense.lead) == (
        8, 32, 48, ())
    np.testing.assert_array_equal(_np(dense.rows([0, 31])), H[:, [0, 31]])
    with pytest.raises(TypeError):
        hsource.as_hsource(object())


@pytest.mark.parametrize("bins", [8, 16, 32])
@pytest.mark.parametrize("metric", METRICS)
def test_distances_bit_exact_up_to_32_bins(metric, bins):
    """Every metric equals the eager reference bit for bit: bins are summed
    in order, 0 to b - 1, as XLA:CPU sums them, and square roots are
    correctly rounded."""
    rng = np.random.default_rng(bins)
    a = rng.random((50, 40, bins)).astype(np.float32)
    counts = rng.integers(0, 50, (50, 40, bins)).astype(np.float32)
    target = rng.random(bins).astype(np.float32)
    for x in (a, counts):
        want = _metric(ref_dist, metric)(jnp.asarray(x), jnp.asarray(target))
        got = _metric(distances, metric)(torch.as_tensor(x),
                                         torch.as_tensor(target))
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    h = rng.random((7, bins)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(distances.normalize(torch.as_tensor(h))),
        np.asarray(ref_dist.normalize(jnp.asarray(h))))


def test_multi_scale_near_tie_picks_the_reference_rect():
    """Frame 5 of the 480x640 clip, a random 32-bin target, windows 16, 32
    and 48 at stride 1: two positions of the 48x48 map differ by one ulp.
    Summed in another order they swapped and the rect moved one column;
    summed in XLA's order the maps are bit-equal and the rect is the
    reference's."""
    from repro.core.engine import HistogramEngine as RefEngine
    from repro.core.engine import MultiScaleQuery as RefMultiScale
    from repro_torch.core.engine import HistogramEngine, MultiScaleQuery
    from repro_torch.data import video_frames

    frame = video_frames(480, 640, 8)[5]
    target = np.random.default_rng(1).random(32).astype(np.float32)
    windows = ((16, 16), (32, 32), (48, 48))
    want_rect, want_score, want_maps = RefEngine(
        num_bins=32, backend="jnp").run(
            frame, [RefMultiScale(target, windows)]).results[0]
    rect, score, maps = HistogramEngine(num_bins=32, device="cpu").run(
        frame, [MultiScaleQuery(target, windows)]).results[0]
    assert _np(rect).tolist() == [265, 171, 312, 218]
    np.testing.assert_array_equal(_np(rect), np.asarray(want_rect))
    np.testing.assert_array_equal(_np(score), np.asarray(want_score))
    for g, w in zip(maps, want_maps):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_multi_scale_above_32_bins_scores_within_rtol_of_the_best():
    """At 64 bins XLA sums in another order, so a near-tie may pick another
    rect.  The contract: the port's rect scores, in the reference's own
    map, within rtol 1e-6 of the reference's best."""
    img, H, src = _H((2, 64, 80), 64, seed=9)
    target = np.random.default_rng(2).random(64).astype(np.float32)
    windows = ((8, 8), (16, 16), (24, 24))
    want_rect, want_score, want_maps = ref_search(
        jnp.asarray(H), jnp.asarray(target), windows, ref_dist.intersection, 1)
    rect, score, maps = region_query.multi_scale_search(
        src, target, windows, distances.intersection, 1)
    sizes = [wh for wh, _ in windows]
    for f in range(H.shape[0]):
        r0, c0, r1, _ = _np(rect)[f].tolist()
        ref_map = np.asarray(want_maps[sizes.index(r1 - r0 + 1)])[f]
        best = float(np.asarray(want_score)[f])
        assert ref_map[r0, c0] >= best * (1 - 1e-6)
    for g, w in zip(maps, want_maps):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)

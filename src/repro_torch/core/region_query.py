"""O(1) region-histogram queries over an integral histogram (paper Eq. 2).

Port of ``repro/core/region_query.py``:

h(R, b) = H(r1, c1, b) - H(r0-1, c1, b) - H(r1, c0-1, b) + H(r0-1, c0-1, b)

for the inclusive region R = [r0..r1] x [c0..c1]; corners with index -1
read as 0.  Every entry point is rank-polymorphic over leading frame axes
of H ``(..., b, h, w)`` and also accepts an ``HSource``
(core/hsource.py).  Corner indices past the frame are clamped to its
last row or column, as JAX's gather clamps them, so an oversized rect
reads the whole frame.  The ``banded_*`` entry points are the reference's
deprecated shims over ``BandedH`` and the unified functions.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.device import as_tensor


def _maybe_hsource(H):
    """Return H as an HSource when it is one, else None (raw tensor path)."""
    from repro_torch.core import hsource  # hsource imports this module

    return H if isinstance(H, hsource.HSource) else None


def _index(x, device) -> torch.Tensor:
    return as_tensor(x, device).to(torch.int64)


def _corner(H: torch.Tensor, r, c) -> torch.Tensor:
    """H[..., :, r, c] with r/c == -1 reading as 0 and indices past the
    frame clamped to its edge.  Returns shape (..., *S, b)."""
    r = _index(r, H.device)
    c = _index(c, H.device)
    h, w = H.shape[-2:]
    rc, cc = torch.broadcast_tensors(r.clamp(0, h - 1), c.clamp(0, w - 1))
    vals = H[..., rc, cc]                               # (..., b, *S)
    if rc.ndim:
        vals = torch.movedim(vals, -(rc.ndim + 1), -1)  # (..., *S, b)
    valid = ((r >= 0) & (c >= 0)).to(H.dtype)
    return vals * valid[..., None]


def region_histogram(H, rects) -> torch.Tensor:
    """Histograms of inclusive regions.

    Args:
      H: (b, h, w) integral histogram, a stack (..., b, h, w), or an
        ``HSource``.
      rects: (..., 4) int [r0, c0, r1, c1], inclusive coordinates.

    Returns:
      (*H_lead, *rects_lead, b) region histograms.
    """
    src = _maybe_hsource(H)
    if src is not None:
        return src.region_histogram(rects)
    rects = _index(rects, H.device)
    r0, c0, r1, c1 = (rects[..., i] for i in range(4))
    return (
        _corner(H, r1, c1)
        - _corner(H, r0 - 1, c1)
        - _corner(H, r1, c0 - 1)
        + _corner(H, r0 - 1, c0 - 1)
    )


def _sliding_windows_gather(H, window, stride):
    """One Eq.-2 gather per window position."""
    h, w = H.shape[-2:]
    wh, ww = window
    r0 = torch.arange(0, h - wh + 1, stride, device=H.device)[:, None]
    c0 = torch.arange(0, w - ww + 1, stride, device=H.device)[None, :]
    rects = torch.stack(
        torch.broadcast_tensors(r0, c0, r0 + wh - 1, c0 + ww - 1), dim=-1)
    return region_histogram(H, rects)


def _sliding_windows_slice(H, window, stride):
    """Strided-slice four-corner arithmetic over the regular window grid:
    every Eq.-2 corner of every window lies on a strided slice of H, and
    the virtual zero row/column is one zero strip prepended."""
    h, w = H.shape[-2:]
    wh, ww = window
    n_r = (h - wh) // stride + 1
    n_c = (w - ww) // stride + 1

    def zrow(x):  # prepend the virtual zero row (window row i = 0)
        z = x.new_zeros(x.shape[:-2] + (1,) + x.shape[-1:])
        return torch.cat([z, x], dim=-2)

    def zcol(x):  # prepend the virtual zero column (window col j = 0)
        z = x.new_zeros(x.shape[:-1] + (1,))
        return torch.cat([z, x], dim=-1)

    s = stride
    d = H[..., wh - 1 :: s, ww - 1 :: s][..., :n_r, :n_c]
    b = zrow(H[..., s - 1 :: s, ww - 1 :: s][..., : n_r - 1, :n_c])
    c = zcol(H[..., wh - 1 :: s, s - 1 :: s][..., :n_r, : n_c - 1])
    a = zrow(zcol(H[..., s - 1 :: s, s - 1 :: s][..., : n_r - 1, : n_c - 1]))
    # Same association order as the gather path (d - b - c + a).
    return torch.movedim(d - b - c + a, -3, -1)       # (..., n_r, n_c, b)


def sliding_window_histograms(
    H,
    window: tuple[int, int],
    stride: int = 1,
    *,
    impl: str = "slice",
    stats: dict | None = None,
) -> torch.Tensor:
    """Histograms of every (wh, ww) window at the given stride.

    Returns (..., n_rows, n_cols, b).  ``impl`` selects the strided-slice
    path (default) or the per-window gather; both are bit-exact."""
    if impl not in ("slice", "gather"):
        raise ValueError(f"unknown impl {impl!r} (want 'slice' or 'gather')")
    src = _maybe_hsource(H)
    if src is not None:
        return src.sliding_window_histograms(window, stride, stats=stats)
    if stats is not None:
        nbytes = 4 * H.numel()
        stats.update(num_bands=1, band_bytes=nbytes, slab_bytes=0,
                     peak_bytes=nbytes, full_h_bytes=nbytes)
    h, w = H.shape[-2:]
    n_r = (h - window[0]) // stride + 1
    n_c = (w - window[1]) // stride + 1
    if n_r <= 0 or n_c <= 0:
        return H.new_zeros(
            H.shape[:-3] + (max(n_r, 0), max(n_c, 0), H.shape[-3]))
    if impl == "slice":
        return _sliding_windows_slice(H, window, stride)
    return _sliding_windows_gather(H, window, stride)


def _target(target_hist, like: torch.Tensor) -> torch.Tensor:
    """(b,) or (..., b) target on ``like``'s device, broadcast over the
    window grid."""
    t = as_tensor(target_hist, like.device).to(like.dtype)
    return t[..., None, None, :] if t.ndim > 1 else t


def likelihood_map(H, target_hist, window: tuple[int, int], metric,
                   stride: int = 1, *, stats: dict | None = None):
    """Per-position similarity of the window histogram to the target.

    ``target_hist`` is (b,) or carries H's leading frame axes.  Returns
    (..., n_rows, n_cols).  H may be any ``HSource``."""
    src = _maybe_hsource(H)
    if src is not None:
        return src.likelihood_map(target_hist, window, metric, stride,
                                  stats=stats)
    hists = sliding_window_histograms(H, window, stride, stats=stats)
    return metric(hists, _target(target_hist, hists))


def reduce_scale_maps(maps, windows, stride: int, lead: tuple):
    """Per-frame argmax across a list of per-scale likelihood maps
    (shared by the dense path and the ``HSource`` generic)."""
    device = maps[0].device if maps else None
    best_rect = torch.zeros(lead + (4,), dtype=torch.int32, device=device)
    best_score = torch.full(lead, -torch.inf, device=device)
    for (wh, ww), scores in zip(windows, maps):
        if scores.shape[-2] == 0 or scores.shape[-1] == 0:
            continue                # window exceeds the frame at this scale
        flat = scores.reshape(lead + (-1,))
        idx = torch.argmax(flat, dim=-1)
        score = torch.take_along_dim(flat, idx[..., None], dim=-1)[..., 0]
        n_cols = scores.shape[-1]
        r0 = torch.div(idx, n_cols, rounding_mode="floor") * stride
        c0 = (idx % n_cols) * stride
        rect = torch.stack(
            [r0, c0, r0 + wh - 1, c0 + ww - 1], dim=-1).to(torch.int32)
        better = score > best_score
        best_rect = torch.where(better[..., None], rect, best_rect)
        best_score = torch.maximum(score, best_score)
    return best_rect, best_score


def multi_scale_search(H, target_hist, windows, metric, stride: int = 1):
    """Best-matching window across scales, per frame.

    Returns (best_rect, best_score, per_scale_maps); ``metric`` is a
    similarity (higher = better)."""
    src = _maybe_hsource(H)
    if src is not None:
        return src.multi_scale_search(target_hist, windows, metric, stride)
    lead = tuple(H.shape[:-3])
    maps = [likelihood_map(H, target_hist, wnd, metric, stride)
            for wnd in windows]
    best_rect, best_score = reduce_scale_maps(maps, windows, stride, lead)
    return best_rect, best_score, maps


def compressed_region_histogram(Hc, row_ids, rects) -> torch.Tensor:
    """Eq.-2 queries against a row-compressed H: ``Hc`` (..., b, k, w)
    holds only the full-frame rows ``row_ids`` (sorted).  Every corner row
    (r0 - 1 and r1) must be in ``row_ids`` or be -1."""
    row_ids = _index(row_ids, Hc.device)
    rects = _index(rects, Hc.device)
    r0, c0, r1, c1 = (rects[..., i] for i in range(4))

    def m(r):  # a frame row's slot in Hc; -1 stays virtual
        return torch.where(r >= 0, torch.searchsorted(row_ids, r.contiguous()), -1)

    return (
        _corner(Hc, m(r1), c1)
        - _corner(Hc, m(r0 - 1), c1)
        - _corner(Hc, m(r1), c0 - 1)
        + _corner(Hc, m(r0 - 1), c0 - 1)
    )


def corner_rows(rects) -> np.ndarray:
    """The distinct full-frame H rows Eq. 2 reads for ``rects``: r0 - 1
    and r1 per rect, deduplicated, the virtual -1 row dropped."""
    rects = np.asarray(rects)
    needed = np.unique(
        np.concatenate([(rects[..., 0] - 1).ravel(), rects[..., 2].ravel()])
    )
    return needed[needed >= 0].astype(np.int64)


def _deprecated_banded(name: str, replacement: str):
    warnings.warn(
        f"{name} is deprecated and will be removed in 2.0: wrap the band "
        f"stream in an HSource and use the unified entry point instead — "
        f"{replacement} — or drive the whole request through "
        "repro_torch.core.engine.HistogramEngine",
        DeprecationWarning,
        stacklevel=3,
    )


def banded_region_histogram(bands, rects) -> torch.Tensor:
    """Deprecated shim: ``region_histogram(BandedH(bands), rects)``.
    Streams the bands once, keeping only the corner rows the rects
    touch."""
    from repro_torch.core.hsource import as_hsource

    _deprecated_banded("banded_region_histogram",
                       "region_histogram(BandedH(bands), rects)")
    return region_histogram(as_hsource(bands), rects)


def banded_sliding_window_histograms(
    bands, window: tuple[int, int], stride: int = 1, *,
    stats: dict | None = None,
) -> torch.Tensor:
    """Deprecated shim:
    ``sliding_window_histograms(BandedH(bands), window, stride)``; peak
    memory is one band plus the corner-row slabs (``stats`` receives the
    proxy)."""
    from repro_torch.core.hsource import as_hsource

    _deprecated_banded(
        "banded_sliding_window_histograms",
        "sliding_window_histograms(BandedH(bands), window, stride)")
    return sliding_window_histograms(as_hsource(bands), window, stride,
                                     stats=stats)


def banded_likelihood_map(
    bands, target_hist, window: tuple[int, int], metric, stride: int = 1,
    *, stats: dict | None = None,
):
    """Deprecated shim:
    ``likelihood_map(BandedH(bands), target, window, metric, stride)``."""
    from repro_torch.core.hsource import as_hsource

    _deprecated_banded(
        "banded_likelihood_map",
        "likelihood_map(BandedH(bands), target, window, metric)")
    return likelihood_map(as_hsource(bands), target_hist, window, metric,
                          stride, stats=stats)

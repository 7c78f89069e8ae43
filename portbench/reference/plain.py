"""The plain reference: integral-histogram answers restated in plain torch.

Imports nothing of the port and takes nothing the port made: it works
from the frames and queries the harness hands to both sides.  Counts are
exact integers (int32 one-hot, int32/int64 cumulative sums), so an exact
comparison with the port's fp32 counts is possible below 2^24.

* ``bin_ids``: Eq. 1, floor(v * num_bins / value_range) of uint8 pixels.
* ``h_rows``: rows of the inclusive integral histogram H (..., b, k, w),
  from a one-hot of the bins, summed down the rows and then across.
* ``window_counts``: every (wh, ww) window at a stride, from a zero-padded
  integral image in int32 (the four-corner rule).
* ``intersection``: histogram intersection of normalized histograms in
  fp32, each sum over the bins taken in order, bin 0 first.
* ``likelihood_map``: the window grid scored against the target.

Every function takes ``h_dtype``: ``None`` keeps counts exact; a float
type rounds the integral histogram to it before any answer is read from
it.  That is the control, which computes the same answers with H held in
a narrower type than the configuration states.

Work runs in blocks of frames and bins, so the reference fits beside
nothing else on the card.
"""

from __future__ import annotations

import torch

_EPS = 1e-8
_BLOCK_ELEMENTS = 1 << 28        # one-hot elements a block


def bin_ids(frames: torch.Tensor, num_bins: int,
            value_range: int) -> torch.Tensor:
    """int64 bin ids of uint8 pixels."""
    return (frames.to(torch.int64) * num_bins // value_range).clamp_(
        0, num_bins - 1)


def _blocks(n: int, nb: int, h: int, w: int):
    """(frame block, bin block) sizes whose one-hot stays within a block."""
    per_frame = nb * h * w
    if per_frame <= _BLOCK_ELEMENTS:
        return max(1, _BLOCK_ELEMENTS // per_frame), nb
    return 1, max(1, _BLOCK_ELEMENTS // (h * w))


def _one_hot(ids: torch.Tensor, b0: int, b1: int) -> torch.Tensor:
    """(f, b1 - b0, h, w) int32 one-hot of bins b0..b1-1."""
    bins = torch.arange(b0, b1, device=ids.device).view(1, -1, 1, 1)
    return (ids[:, None] == bins).to(torch.int32)


def _round(x: torch.Tensor, h_dtype) -> torch.Tensor:
    """Counts as fp32, rounded through ``h_dtype`` when one is given."""
    if h_dtype is None:
        return x
    return x.to(h_dtype).to(torch.float32)


def h_rows(ids: torch.Tensor, num_bins: int, rows,
           h_dtype=None) -> torch.Tensor:
    """H at ``rows`` (sorted): (n, b, k, w), int64, or fp32 through
    ``h_dtype``.  ``ids`` is (n, h, w)."""
    n, h, w = ids.shape
    rows_t = torch.as_tensor(rows, dtype=torch.int64, device=ids.device)
    last = int(rows_t.max()) + 1
    fb, bb = _blocks(n, num_bins, last, w)
    dtype = torch.int64 if h_dtype is None else torch.float32
    out = torch.empty((n, num_bins, rows_t.numel(), w), dtype=dtype,
                      device=ids.device)
    for f0 in range(0, n, fb):
        part = ids[f0:f0 + fb, :last]
        for b0 in range(0, num_bins, bb):
            b1 = min(num_bins, b0 + bb)
            down = torch.cumsum(_one_hot(part, b0, b1), dim=2,
                                dtype=torch.int32)
            out[f0:f0 + fb, b0:b1] = _round(torch.cumsum(
                down[:, :, rows_t], dim=3, dtype=torch.int64), h_dtype)
            del down
    return out


def window_counts(ids: torch.Tensor, num_bins: int, window, stride: int,
                  h_dtype=None) -> torch.Tensor:
    """(n, n_r, n_c, b): every (wh, ww) window at ``stride``, int64 (fp32
    through ``h_dtype``)."""
    n, h, w = ids.shape
    wh, ww = window
    n_r = (h - wh) // stride + 1
    n_c = (w - ww) // stride + 1
    fb, bb = _blocks(n, num_bins, h, w)
    dtype = torch.int64 if h_dtype is None else torch.float32
    out = torch.empty((n, n_r, n_c, num_bins), dtype=dtype,
                      device=ids.device)
    rs = slice(0, (n_r - 1) * stride + 1, stride)
    cs = slice(0, (n_c - 1) * stride + 1, stride)
    for f0 in range(0, n, fb):
        part = ids[f0:f0 + fb]
        for b0 in range(0, num_bins, bb):
            b1 = min(num_bins, b0 + bb)
            f = part.shape[0]
            H = torch.zeros((f, b1 - b0, h + 1, w + 1), dtype=torch.int32,
                            device=ids.device)
            H[:, :, 1:, 1:] = torch.cumsum(
                torch.cumsum(_one_hot(part, b0, b1), dim=2,
                             dtype=torch.int32), dim=3, dtype=torch.int32)
            H = _round(H, h_dtype)
            top, bot = H[:, :, rs], H[:, :, wh:wh + (n_r - 1) * stride + 1:
                                     stride]
            win = (bot[..., ww:ww + (n_c - 1) * stride + 1:stride]
                   - top[..., ww:ww + (n_c - 1) * stride + 1:stride]
                   - bot[..., cs] + top[..., cs])
            out[f0:f0 + f, ..., b0:b1] = win.movedim(1, -1).to(dtype)
            del H, win
    return out


def _bin_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in order, bin 0 first, in x's dtype."""
    acc = x[..., 0].clone()
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (_bin_sum(x)[..., None] + _EPS)


def intersection(hists: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Swain-Ballard intersection of normalized histograms, fp32."""
    return _bin_sum(torch.minimum(_normalize(hists.to(torch.float32)),
                                  _normalize(target.to(torch.float32))))


def likelihood_map(ids: torch.Tensor, num_bins: int, target, window,
                   stride: int, h_dtype=None) -> torch.Tensor:
    """(n, n_r, n_c) fp32: every window scored against ``target``."""
    t = torch.as_tensor(target, dtype=torch.float32, device=ids.device)
    n = ids.shape[0]
    fb = max(1, _BLOCK_ELEMENTS // (num_bins * ids.shape[1] * ids.shape[2]))
    maps = [intersection(window_counts(ids[f0:f0 + fb], num_bins, window,
                                       stride, h_dtype), t)
            for f0 in range(0, n, fb)]
    return torch.cat(maps)

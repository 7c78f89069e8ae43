"""Plain torch oracle for the integral-histogram kernels.

Port of ``repro/kernels/ref.py``:

H(b, x, y) = sum_{r<=x} sum_{c<=y} Q(I(r, c), b)        (paper Eq. 1)

inclusive on both spatial axes (Algorithm 1 of the paper).
"""

from __future__ import annotations

import torch

from repro_torch.core.binning import bin_indices, one_hot_bins


def integral_histogram_ref(
    image: torch.Tensor,
    num_bins: int,
    value_range: int = 256,
    dtype=torch.float32,
) -> torch.Tensor:
    """Oracle: (..., h, w) image -> (..., num_bins, h, w) inclusive H."""
    idx = bin_indices(image, num_bins, value_range)
    q = one_hot_bins(idx, num_bins, dtype=dtype)
    return torch.cumsum(torch.cumsum(q, dim=-2), dim=-1)


def region_histogram_ref(
    image: torch.Tensor,
    num_bins: int,
    r0: int,
    c0: int,
    r1: int,
    c1: int,
    value_range: int = 256,
) -> torch.Tensor:
    """Direct (no integral image) histogram of the inclusive region
    [r0..r1] x [c0..c1] — the ground truth for Eq. (2) queries."""
    patch = image[r0 : r1 + 1, c0 : c1 + 1]
    idx = bin_indices(patch, num_bins, value_range)
    return one_hot_bins(idx, num_bins).sum(dim=(1, 2))

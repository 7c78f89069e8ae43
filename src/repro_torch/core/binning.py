"""Binning function Q(I, b) of the integral histogram (paper Eq. 1).

Port of ``repro/core/binning.py``.  ``bin_indices`` maps each pixel to its
bin id; the one-hot expansion is either materialized (``one_hot_bins``,
used by the oracle and the plain scans) or formed inside the CUDA scan
kernels (kernels/csrc/wf_tis_scan.cuh), where it never reaches device
memory.
"""

from __future__ import annotations

import torch

# Pixels mapped to this sentinel never match any bin: padding contributes 0.
PAD_BIN: int = -1


def bin_indices(
    image: torch.Tensor, num_bins: int, value_range: int | None = 256
) -> torch.Tensor:
    """Map pixel values to int32 bin ids in [0, num_bins).

    Integer images lie in [0, value_range), float images in [0, 1);
    out-of-range values are clipped into the valid bin range.  Floats bin
    as ``floor(x * num_bins)`` in the image's own float type (callers hand
    float64 over as float32, as JAX does).  ``value_range=None`` means the
    input already holds bin indices (PAD_BIN allowed).
    """
    if value_range is None:
        return image.to(torch.int32)
    if (image.dtype == torch.uint8 and value_range == 256
            and 2 <= num_bins <= 256 and num_bins & (num_bins - 1) == 0):
        # A byte's floor(x * b / 256) for b a power of two is its top
        # log2(b) bits, always in [0, b): one pass instead of four.
        out = torch.empty(image.shape, dtype=torch.int32, device=image.device)
        return torch.bitwise_right_shift(image, 9 - num_bins.bit_length(),
                                         out=out)
    if image.is_floating_point():
        # Clamp before the cast so huge values saturate like XLA's convert.
        idx = torch.floor(image * num_bins).clamp_(0, num_bins - 1)
        return idx.to(torch.int32)
    idx = torch.div(image.to(torch.int32) * num_bins, value_range,
                    rounding_mode="floor")
    return idx.clamp_(0, num_bins - 1)


def one_hot_bins(idx: torch.Tensor, num_bins: int,
                 dtype=torch.float32) -> torch.Tensor:
    """Materialized Q: (..., h, w) int -> (..., b, h, w) {0, 1}.

    The bin axis goes just before the two spatial axes."""
    b = torch.arange(num_bins, dtype=idx.dtype, device=idx.device)
    return (idx[..., None, :, :] == b[:, None, None]).to(dtype)

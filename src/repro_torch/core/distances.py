"""Histogram similarity/distance metrics used by the analytics layers.

Port of ``repro/core/distances.py``.  All metrics broadcast over leading
axes: (..., b) vs (b,) -> (...).
Similarities (higher = better): intersection, bhattacharyya.
Distances (lower = better): chi2, l1, l2.

Every sum over the bin axis adds the bins in order, bin 0 to b - 1, in
float32: the order XLA:CPU reduces a bin axis of up to 32 bins in, so the
metrics equal the reference's bit for bit there (a best window picked by
``argmax`` then never flips on a one-ulp near-tie).  Above 32 bins XLA
takes another order and the metrics agree within float32 rounding.
Square roots are correctly rounded (torch's CPU ``sqrt`` is not).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def bin_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(-1)`` with the bins added in order, 0 to b - 1, in x's dtype.

    On the card it is one ``cumsum`` down the bin axis moved first: the
    CUDA scan over a dimension that is not the innermost one walks it in
    order, one thread per element, accumulating in the input's dtype
    (``chip_smoke.py`` holds it against the plain loop).  Each bin's plane
    is then contiguous, so the walk reads every line once.  A lone column
    is widened to two: torch scans a single row with a parallel scan.
    On the CPU, where ``cumsum`` accumulates in float64, the loop itself.
    """
    b = x.shape[-1]
    if b == 0:
        return x.sum(dim=-1)
    if x.device.type != "cuda":
        acc = x[..., 0]
        for i in range(1, b):
            acc = acc + x[..., i]
        return acc
    planes = x.movedim(-1, 0).reshape(b, -1)
    n = planes.shape[1]
    if n == 1:
        planes = planes.expand(b, 2)
    return torch.cumsum(planes, dim=0)[-1, :n].reshape(x.shape[:-1])


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root: the float64 root of a float32
    rounds to the float32 one exactly."""
    return torch.sqrt(x.double()).to(x.dtype)


def normalize(h: torch.Tensor) -> torch.Tensor:
    return h / (bin_sum(h)[..., None] + _EPS)


def intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Swain-Ballard histogram intersection on normalized histograms."""
    return bin_sum(torch.minimum(normalize(a), normalize(b)))


def bhattacharyya(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bhattacharyya coefficient (similarity in [0, 1]).

    sqrt(a) * sqrt(b) instead of sqrt(a * b + eps): an eps inside the
    sqrt adds ~sqrt(eps) per empty bin, pushing identical histograms
    above 1 and disjoint ones above 0."""
    return bin_sum(_sqrt(normalize(a)) * _sqrt(normalize(b)))


def chi2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    an, bn = normalize(a), normalize(b)
    return 0.5 * bin_sum((an - bn) ** 2 / (an + bn + _EPS))


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return bin_sum((normalize(a) - normalize(b)).abs())


def l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _sqrt(bin_sum((normalize(a) - normalize(b)) ** 2))


SIMILARITIES = {"intersection": intersection, "bhattacharyya": bhattacharyya}
DISTANCES = {"chi2": chi2, "l1": l1, "l2": l2}

"""Histogram similarity/distance metrics used by the analytics layers.

Port of ``repro/core/distances.py``.  All metrics broadcast over leading
axes: (..., b) vs (b,) -> (...).
Similarities (higher = better): intersection, bhattacharyya.
Distances (lower = better): chi2, l1, l2.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def normalize(h: torch.Tensor) -> torch.Tensor:
    return h / (h.sum(dim=-1, keepdim=True) + _EPS)


def intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Swain-Ballard histogram intersection on normalized histograms."""
    return torch.minimum(normalize(a), normalize(b)).sum(dim=-1)


def bhattacharyya(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bhattacharyya coefficient (similarity in [0, 1]).

    sqrt(a) * sqrt(b) instead of sqrt(a * b + eps): an eps inside the
    sqrt adds ~sqrt(eps) per empty bin, pushing identical histograms
    above 1 and disjoint ones above 0."""
    return (torch.sqrt(normalize(a)) * torch.sqrt(normalize(b))).sum(dim=-1)


def chi2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    an, bn = normalize(a), normalize(b)
    return 0.5 * ((an - bn) ** 2 / (an + bn + _EPS)).sum(dim=-1)


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (normalize(a) - normalize(b)).abs().sum(dim=-1)


def l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(((normalize(a) - normalize(b)) ** 2).sum(dim=-1))


SIMILARITIES = {"intersection": intersection, "bhattacharyya": bhattacharyya}
DISTANCES = {"chi2": chi2, "l1": l1, "l2": l2}

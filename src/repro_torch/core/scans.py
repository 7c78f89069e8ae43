"""The paper's four integral-histogram strategies as plain torch.

Port of ``repro/core/scans.py``; these are the ``"torch"`` backend.

CW-B    — cross-weave baseline: per-bin scan / transpose / scan.
CW-STS  — one batched scan -> materialized transpose -> scan.
CW-TiS  — tiled horizontal strip scan, then tiled vertical strip scan;
          the CUDA kernels are kernels/cw_tis.py.
WF-TiS  — strip-by-strip scan with the (b, w) column carry threaded
          between strips; the CUDA kernel is kernels/wf_tis.py.

Every method takes a frame ``(h, w)`` -> ``(b, h, w)`` or a stack
``(n, h, w)`` -> ``(n, b, h, w)``.  All arithmetic is integer-valued fp32,
so every method equals kernels/ref.py bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.binning import PAD_BIN, bin_indices, one_hot_bins


def apply_carry(H: torch.Tensor, carry_in: torch.Tensor | None) -> torch.Tensor:
    """Compose a band's local H (..., b, bh, w) with the (..., b, w)
    aggregate of everything above the band (``None`` = topmost band)."""
    if carry_in is None:
        return H
    return H + carry_in.to(H.dtype)[..., :, None, :]


def cw_b(image: torch.Tensor, num_bins: int, value_range: int = 256) -> torch.Tensor:
    idx = bin_indices(image, num_bins, value_range)
    outs = []
    for b in range(num_bins):  # one scan chain per bin (Algorithm 2)
        q = (idx == b).to(torch.float32)
        h_scanned = torch.cumsum(q, dim=-1)
        t = h_scanned.transpose(-2, -1).contiguous()
        v_scanned = torch.cumsum(t, dim=-1)
        outs.append(v_scanned.transpose(-2, -1))
    return torch.stack(outs, dim=-3)


def cw_sts(image: torch.Tensor, num_bins: int, value_range: int = 256) -> torch.Tensor:
    idx = bin_indices(image, num_bins, value_range)
    q = one_hot_bins(idx, num_bins)
    h_scanned = torch.cumsum(q, dim=-1)
    transposed = h_scanned.transpose(-2, -1).contiguous()
    v_scanned = torch.cumsum(transposed, dim=-1)
    return v_scanned.transpose(-2, -1)


def _blocked_cumsum_last(x: torch.Tensor, tile: int) -> torch.Tensor:
    *lead, n = x.shape
    if n % tile:
        raise ValueError(f"axis {n} not divisible by tile {tile}")
    xt = x.reshape(*lead, n // tile, tile)
    local = torch.cumsum(xt, dim=-1)
    totals = local[..., -1]
    carry = torch.cumsum(totals, dim=-1) - totals
    return (local + carry[..., None]).reshape(*lead, n)


def _pad_idx(idx: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Pad the spatial axes to tile multiples with PAD_BIN."""
    h, w = idx.shape[-2:]
    ph, pw = (-h) % th, (-w) % tw
    if ph or pw:
        idx = F.pad(idx, (0, pw, 0, ph), value=PAD_BIN)
    return idx


def cw_tis(
    image: torch.Tensor, num_bins: int, value_range: int = 256, tile: int = 128
) -> torch.Tensor:
    return cw_tis_ids(bin_indices(image, num_bins, value_range), num_bins,
                      tile)


def cw_tis_ids(idx: torch.Tensor, num_bins: int,
               tile: int = 128) -> torch.Tensor:
    """``cw_tis`` on bin ids; an id outside ``[0, num_bins)`` matches no
    bin.  This is the plain version of the CUDA kernels K4."""
    h, w = idx.shape[-2:]
    th, tw = min(tile, h), min(tile, w)
    q = one_hot_bins(_pad_idx(idx, th, tw), num_bins)
    h_scanned = _blocked_cumsum_last(q, tw)
    v_scanned = _blocked_cumsum_last(h_scanned.transpose(-2, -1), th)
    return v_scanned.transpose(-2, -1)[..., :h, :w]


def wf_tis(
    image: torch.Tensor,
    num_bins: int,
    value_range: int = 256,
    tile: int = 128,
    carry_in: torch.Tensor | None = None,
) -> torch.Tensor:
    """Strip scan: each ``tile``-high strip is scanned on its own and
    seeded with the column carry (the bottom row of everything above,
    ``carry_in`` for the first strip)."""
    return wf_tis_ids(bin_indices(image, num_bins, value_range), num_bins,
                      tile, carry_in)


def wf_tis_ids(
    idx: torch.Tensor,
    num_bins: int,
    tile: int = 128,
    carry_in: torch.Tensor | None = None,
) -> torch.Tensor:
    """``wf_tis`` on bin ids; an id outside ``[0, num_bins)`` matches no
    bin.  This is the plain version of the CUDA kernel K1."""
    h, w = idx.shape[-2:]
    th = min(tile, h) if h else 1
    lead = idx.shape[:-2]
    col = (torch.zeros(lead + (num_bins, w), dtype=torch.float32,
                       device=idx.device)
           if carry_in is None else carry_in.to(torch.float32))
    strips = []
    for r0 in range(0, h, th):
        q = one_hot_bins(idx[..., r0 : r0 + th, :], num_bins)
        out = torch.cumsum(torch.cumsum(q, dim=-1), dim=-2) + col[..., None, :]
        col = out[..., -1, :]
        strips.append(out)
    if not strips:
        return torch.zeros(lead + (num_bins, 0, w), dtype=torch.float32,
                           device=idx.device)
    return torch.cat(strips, dim=-2)


METHODS = {"cw_b": cw_b, "cw_sts": cw_sts, "cw_tis": cw_tis, "wf_tis": wf_tis}

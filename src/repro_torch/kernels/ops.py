"""Public entry points of the integral-histogram kernels.

Port of ``repro/kernels/ops.py``.  ``integral_histogram`` bins the image,
dispatches to the chosen method and backend, and returns H.  Input rank
is polymorphic over a frame axis:

  (h, w)    -> (num_bins, h, w)
  (n, h, w) -> (n, num_bins, h, w)    one kernel launch for the stack

Backends:
  "cuda"   — the hand-written kernels (K1 ``wf_tis``, K2 ``fused_rows``).
  "torch"  — the plain torch scans of core/scans.py.
  "auto"   — "cuda" for a CUDA tensor, "torch" for a CPU tensor.

An explicit "cuda" on a CPU tensor raises ``ValueError``.  ``cw_tis`` on
the card raises ``NotImplementedError`` (its kernel, K4, is ROADMAP 1.4)
unless ``backend="torch"`` asks for the plain scan by name: "auto" never
runs a plain scan on the card in place of an unported kernel.  ``cw_b``
and ``cw_sts`` have no kernel in the reference either and run as torch.

Inputs may be numpy arrays or tensors; ``device=None`` means the card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import scans
from repro_torch.core.binning import bin_indices
from repro_torch.device import as_tensor
from repro_torch.kernels.fused_rows import check_rows, fused_rows_cuda
from repro_torch.kernels.wf_tis import wf_tis_cuda

BACKENDS = ("auto", "cuda", "torch")
CUDA_METHODS = ("wf_tis",)


def resolve_backend(backend: str, method: str, device) -> str:
    """"cuda" or "torch" for ``method`` on ``device``, or raise."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (want {BACKENDS})")
    if method not in scans.METHODS:
        raise ValueError(f"unknown method {method!r}")
    on_card = torch.device(device).type == "cuda"
    if backend == "torch":
        return backend
    if backend == "cuda" and not on_card:
        raise ValueError(
            "backend='cuda' needs a CUDA tensor; use backend='auto' or "
            "'torch' on the CPU")
    if not on_card:
        return "torch"
    if method == "cw_tis":
        raise NotImplementedError(
            "the cw_tis kernel (K4) is not ported yet (ROADMAP 1.4); pass "
            "backend='torch' to run the plain scan on the card")
    if method in CUDA_METHODS:
        return "cuda"
    if backend == "cuda":
        raise ValueError(
            f"method {method!r} has no CUDA kernel (CUDA methods: "
            f"{list(CUDA_METHODS)}); use backend='auto' or 'torch'")
    return "torch"


def _check_carry(carry_in, frames_shape, num_bins, device):
    if carry_in is None:
        return None
    carry = as_tensor(carry_in, device).to(torch.float32)
    want = tuple(frames_shape[:-2]) + (num_bins, frames_shape[-1])
    if tuple(carry.shape) != want:
        raise ValueError(
            f"carry_in shape {tuple(carry.shape)} != {want} "
            "(leading frame axes, num_bins, width)")
    return carry


def integral_histogram(
    image,
    num_bins: int,
    *,
    method: str = "wf_tis",
    backend: str = "auto",
    tile: int = 128,
    bin_block: int | None = None,
    value_range: int | None = 256,
    carry_in=None,
    memory_budget_bytes: int | None = None,
    device=None,
) -> torch.Tensor:
    """Inclusive integral histogram of a frame or an (n, h, w) stack.

    ``tile`` is the strip height of the plain scans; ``bin_block`` the
    bins per CTA of the kernel (``None`` picks it from the shape).
    ``carry_in`` (``([n,] num_bins, w)``) seeds the scan with the bottom
    row of everything above the slice.
    """
    if memory_budget_bytes is not None:
        raise NotImplementedError(
            "memory_budget_bytes (banded H) is not ported yet (ROADMAP 1.2)")
    x = as_tensor(image, device)
    if x.ndim not in (2, 3):
        raise ValueError(f"expected (h, w) or (n, h, w), got {tuple(x.shape)}")
    backend = resolve_backend(backend, method, x.device)
    carry = _check_carry(carry_in, x.shape, num_bins, x.device)

    if backend == "torch":
        if method == "wf_tis":
            return scans.wf_tis(x, num_bins, value_range, tile=tile,
                                carry_in=carry)
        kw = {} if method in ("cw_b", "cw_sts") else {"tile": tile}
        H = scans.METHODS[method](x, num_bins, value_range, **kw)
        return scans.apply_carry(H, carry)

    squeeze = x.ndim == 2
    idx = bin_indices(x, num_bins, value_range).contiguous()
    if squeeze:
        idx = idx[None]
        carry = None if carry is None else carry[None]
    out = wf_tis_cuda(idx, num_bins, bin_block=bin_block,
                      carry=None if carry is None else carry.contiguous())
    return out[0] if squeeze else out


def fused_corner_rows(
    image,
    num_bins: int,
    row_ids,
    *,
    method: str = "wf_tis",
    backend: str = "auto",
    tile: int = 128,
    bin_block: int | None = None,
    value_range: int | None = 256,
    carry_in=None,
    stats: dict | None = None,
    device=None,
) -> torch.Tensor:
    """Corner rows of H for a known request, without materializing H.

    Runs the scan and emits only ``row_ids`` (sorted unique rows in
    ``[0, h)``), in that order; nothing below the tile-high band that holds
    the last requested row is scanned.  ``stats`` receives
    ``bands_computed`` / ``bands_total`` (``tile``-high bands scanned vs in
    the frame), ``rows_bytes``, ``full_h_bytes`` and the resolved
    ``backend``.

    Returns (..., num_bins, K, w) fp32, equal bit for bit to dense H at
    those rows.
    """
    x = as_tensor(image, device)
    if x.ndim not in (2, 3):
        raise ValueError(f"expected (h, w) or (n, h, w), got {tuple(x.shape)}")
    squeeze = x.ndim == 2
    frames = x[None] if squeeze else x
    n, h, w = frames.shape
    rows = check_rows(row_ids, h)
    if backend == "cuda" and method != "wf_tis":
        raise ValueError(
            f"the fused kernel runs the wf_tis scan; method {method!r} has "
            "no fused CUDA path — use backend='auto' or 'torch'")
    backend = resolve_backend(backend, method, frames.device)
    carry = carry_in
    if squeeze and carry is not None and np.ndim(carry) == 2:
        carry = carry[None]
    carry = _check_carry(carry, frames.shape, num_bins, frames.device)

    # Early exit: nothing below the last requested row feeds any output.
    bands_total = -(-h // tile)
    bands_needed = int(rows[-1]) // tile + 1
    h_cut = min(h, bands_needed * tile)
    frames = frames[:, :h_cut]

    if backend == "cuda":
        idx = bin_indices(frames, num_bins, value_range).contiguous()
        R = fused_rows_cuda(
            idx, num_bins, rows, bin_block=bin_block,
            carry=None if carry is None else carry.contiguous())
    else:
        # Stream tile-high bands through the scan, carry threaded between
        # them; keep only the requested rows of each band.
        kept = []
        for b in range(bands_needed):
            band = frames[:, b * tile:(b + 1) * tile]
            Hb = integral_histogram(
                band, num_bins, method=method, backend="torch", tile=tile,
                value_range=value_range, carry_in=carry, device=band.device)
            carry = Hb[..., -1, :]
            local = rows[(rows >= b * tile) & (rows < (b + 1) * tile)]
            if local.size:
                kept.append(Hb[..., torch.as_tensor(local - b * tile), :])
        R = torch.cat(kept, dim=-2)

    if stats is not None:
        stats.update(
            bands_computed=bands_needed,
            bands_total=bands_total,
            rows_bytes=n * num_bins * rows.size * w * 4,
            full_h_bytes=n * num_bins * h * w * 4,
            backend=backend,
        )
    return R[0] if squeeze else R


def fused_likelihood_map(
    image,
    model,
    metric,
    *,
    window: tuple[int, int],
    stride: int = 1,
    num_bins: int | None = None,
    stats: dict | None = None,
    **kwargs,
):
    """Likelihood map straight off the fused scan: the two corner-row
    lattices the (window, stride) grid reads come out of
    ``fused_corner_rows`` and every window is scored against ``model``.
    Dense H is never built.  Returns the (..., out_h, out_w) map of
    ``HSource.likelihood_map``."""
    from repro_torch.core.hsource import FusedRowsH  # hsource imports us

    nb = int(np.shape(model)[-1]) if num_bins is None else num_bins
    h, w = np.shape(image)[-2:]
    probe = FusedRowsH(row_ids=(0,), R=torch.zeros((nb, 1, w)),
                       height=h, width=w)
    _, _, bot, top = probe._window_lattices(window, stride)
    rows = np.unique(np.concatenate([bot, top[top >= 0]]))
    R = fused_corner_rows(image, nb, rows, stats=stats, **kwargs)
    source = FusedRowsH(row_ids=rows, R=R, height=h, width=w)
    return source.likelihood_map(model, window, metric, stride)

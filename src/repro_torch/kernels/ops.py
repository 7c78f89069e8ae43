"""Public entry points of the integral-histogram kernels.

Port of ``repro/kernels/ops.py``.  ``integral_histogram`` bins the image,
dispatches to the chosen method and backend, and returns H.  Input rank
is polymorphic over a frame axis:

  (h, w)    -> (num_bins, h, w)
  (n, h, w) -> (n, num_bins, h, w)    one kernel launch for the stack

Backends:
  "cuda"   — the hand-written kernels: K1 ``wf_tis``, K2 ``fused_rows``,
             K3 ``delta_apply``, K4 ``cw_tis`` (hscan + vscan), and K5
             ``ssd_scan`` (the Mamba-2 SSD scan behind ``ssd_scan``) with
             its backward, K5-bwd.
  "torch"  — the plain torch scans of core/scans.py.
  "auto"   — "cuda" for a CUDA tensor, "torch" for a CPU tensor.

An explicit "cuda" on a CPU tensor raises ``ValueError``.  ``cw_b`` and
``cw_sts`` have no kernel in the reference either: "auto" runs them as
torch, an explicit "cuda" raises.  On a meta tensor "cuda" evaluates the
kernels abstractly: each wrapper runs its launch's checks and returns a
meta result, and nothing launches (plancheck's counterpart of
``jax.eval_shape``).

``KERNEL_SPECS`` maps each method with CUDA kernels to the builder of its
launches' ``KernelSpec``s (kernels/specs.py), which kernelcheck proves.

``memory_budget_bytes`` hands the frame to the planner
(core/engine.py): when its H breaks the budget it is computed band by
band through the kernels' carry-in (core/bands.py) and reassembled.

Inputs may be numpy arrays or tensors; ``device=None`` means the card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import scans
from repro_torch.core.binning import bin_indices
from repro_torch.device import as_tensor
from repro_torch.kernels import cw_tis as _cw_tis
from repro_torch.kernels import delta_apply as _delta_apply
from repro_torch.kernels import fused_rows as _fused_rows
from repro_torch.kernels import wf_tis as _wf_tis
from repro_torch.kernels.cw_tis import cw_tis_cuda
from repro_torch.kernels.delta_apply import (
    delta_apply_cuda,
    delta_apply_plain,
)
from repro_torch.kernels.fused_rows import check_rows, fused_rows_cuda
from repro_torch.kernels.ssd_scan import (
    SSDScanFunction, ssd_scan_cuda, ssd_scan_plain,
)
from repro_torch.kernels.wf_tis import wf_tis_cuda

BACKENDS = ("auto", "cuda", "torch")
CUDA_METHODS = ("wf_tis", "cw_tis")

#: method -> builder of its launches' KernelSpecs (the kernelcheck
#: registry; K5 has none, as in the reference).
KERNEL_SPECS = {
    "wf_tis": _wf_tis.kernel_specs,
    "cw_tis": _cw_tis.kernel_specs,
    "fused_rows": _fused_rows.kernel_specs,
    "delta_apply": _delta_apply.kernel_specs,
}


def kernel_backend(backend: str, device) -> str:
    """"cuda" or "torch" for a function that has one CUDA kernel, on
    ``device``: "auto" takes the kernel for a CUDA tensor and the plain
    version otherwise; an explicit "cuda" off the card raises, except on
    meta tensors (abstract evaluation)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (want {BACKENDS})")
    if backend == "torch":
        return backend
    kind = torch.device(device).type
    if backend == "cuda" and kind not in ("cuda", "meta"):
        raise ValueError(
            "backend='cuda' needs a CUDA tensor; use backend='auto' or "
            "'torch' on the CPU")
    return "cuda" if kind == "cuda" or backend == "cuda" else "torch"


def resolve_backend(backend: str, method: str, device) -> str:
    """"cuda" or "torch" for the scan ``method`` on ``device``, or raise."""
    resolved = kernel_backend(backend, device)
    if method not in scans.METHODS:
        raise ValueError(f"unknown method {method!r}")
    if resolved == "torch" or method in CUDA_METHODS:
        return resolved
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
    row of everything above the slice.  ``memory_budget_bytes`` caps the
    H of one launch: the planner bands the frame when its H breaks it.
    """
    with trace.span("repro_torch.stage"):
        x = as_tensor(image, device)
    if x.ndim not in (2, 3):
        raise ValueError(f"expected (h, w) or (n, h, w), got {tuple(x.shape)}")
    backend = resolve_backend(backend, method, x.device)
    carry = _check_carry(carry_in, x.shape, num_bins, x.device)

    if memory_budget_bytes is not None:
        # The banding decision lives in the planner; this entry point just
        # executes the plan it hands back.
        from repro_torch.core import bands, engine  # both import us

        h, w = x.shape[-2:]
        p = engine.plan(engine.WorkloadSpec(
            height=h, width=w, num_bins=num_bins,
            num_frames=1 if x.ndim == 2 else x.shape[0], method=method,
            backend=backend, tile=tile, bin_block=bin_block,
            value_range=value_range, memory_budget_bytes=memory_budget_bytes,
            device=str(x.device)))
        if p.band_plan is not None:
            return bands.banded_integral_histogram(
                x, num_bins, plan=p.band_plan, carry_in=carry, method=method,
                backend=p.backend, tile=tile, bin_block=bin_block,
                value_range=value_range, device=x.device)

    if backend == "torch":
        # The plain scans bin inside: one span for both.
        with trace.span("repro_torch.scan", kernel="torch"):
            if method == "wf_tis":
                return scans.wf_tis(x, num_bins, value_range, tile=tile,
                                    carry_in=carry)
            kw = {} if method in ("cw_b", "cw_sts") else {"tile": tile}
            H = scans.METHODS[method](x, num_bins, value_range, **kw)
            return scans.apply_carry(H, carry)

    squeeze = x.ndim == 2
    with trace.span("repro_torch.bin"):
        idx = bin_indices(x, num_bins, value_range).contiguous()
    if squeeze:
        idx = idx[None]
        carry = None if carry is None else carry[None]
    kernel, name = ((cw_tis_cuda, "K4") if method == "cw_tis"
                    else (wf_tis_cuda, "K1"))
    with trace.span("repro_torch.scan", kernel=name):
        out = kernel(idx, num_bins, bin_block=bin_block,
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

    Only ``wf_tis`` has a fused kernel (K2).  On the card ``cw_tis``
    streams the tile-high bands through its own kernels (K4) with the
    carry, as the reference computes it off its fused kernel; the TPU
    reference refuses that ``"pallas"`` plan instead.

    Returns (..., num_bins, K, w) fp32, equal bit for bit to dense H at
    those rows.
    """
    with trace.span("repro_torch.stage"):
        x = as_tensor(image, device)
    if x.ndim not in (2, 3):
        raise ValueError(f"expected (h, w) or (n, h, w), got {tuple(x.shape)}")
    squeeze = x.ndim == 2
    frames = x[None] if squeeze else x
    n, h, w = frames.shape
    rows = check_rows(row_ids, h)
    if backend == "cuda" and method not in CUDA_METHODS:
        raise ValueError(
            f"the fused kernel runs the wf_tis scan; method {method!r} has "
            "no CUDA kernel — use backend='auto' or 'torch'")
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

    if backend == "cuda" and method == "wf_tis":
        with trace.span("repro_torch.bin"):
            idx = bin_indices(frames, num_bins, value_range).contiguous()
        with trace.span("repro_torch.scan", kernel="K2"):
            R = fused_rows_cuda(
                idx, num_bins, rows, bin_block=bin_block,
                carry=None if carry is None else carry.contiguous())
    else:
        # Stream tile-high bands through the scan (K4 for cw_tis on the
        # card), carry threaded between them; keep only the requested rows
        # of each band.
        kept = []
        for b in range(bands_needed):
            band = frames[:, b * tile:(b + 1) * tile]
            Hb = integral_histogram(
                band, num_bins, method=method, backend=backend, tile=tile,
                bin_block=bin_block, value_range=value_range, carry_in=carry,
                device=band.device)
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


def delta_apply(
    H,
    delta,
    *,
    backend: str = "auto",
    out=None,
    device=None,
) -> torch.Tensor:
    """Repair a clean H slab with a broadcast carry delta.

    The incremental video path (core/delta.py): when rows above a slab
    were edited, the slab's whole correction is one ``(..., num_bins, w)``
    delta — the dirty band's new bottom row minus its old one — added to
    every row.  Integer-valued fp32, so the result equals recomputing the
    slab bit for bit.

    Args:
      H: (num_bins, h, w) or (n, num_bins, h, w) fp32 clean slab (a row
        band of a larger H is taken in place).
      delta: (num_bins, w) or (n, num_bins, w), frame axis matching ``H``.
      backend: "cuda" runs K3 (``kernels/delta_apply.py``), "torch" the
        broadcast add; "auto" takes K3 for a CUDA tensor.
      out: optional destination of H's shape (e.g. a row band of the H
        being assembled); K3 writes into it.

    Returns:
      ``H + delta`` broadcast over the row axis, same logical shape as H.
    """
    H = as_tensor(H, device) if not isinstance(H, torch.Tensor) else H
    if H.ndim not in (3, 4):
        raise ValueError(
            f"expected (num_bins, h, w) or (n, num_bins, h, w), got "
            f"{tuple(H.shape)}")
    backend = kernel_backend(backend, H.device)
    squeeze = H.ndim == 3
    slab = H[None] if squeeze else H
    d = as_tensor(delta, H.device).to(torch.float32)
    d = d[None] if squeeze and d.ndim == 2 else d
    n, nb, h, w = slab.shape
    if tuple(d.shape) != (n, nb, w):
        raise ValueError(
            f"delta shape {tuple(np.shape(delta))} incompatible with "
            f"{(n, nb, w)} (frames, num_bins, width)")
    dst = None if out is None else (out[None] if squeeze else out)
    if backend == "torch":
        res = delta_apply_plain(slab, d)
        if dst is not None:
            dst.copy_(res)
            res = dst
    else:
        res = delta_apply_cuda(slab.to(torch.float32), d.contiguous(),
                               out=dst)
    return res[0] if squeeze else res


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


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int, h0=None,
             backend: str = "auto"):
    """The Mamba-2 SSD chunked scan, ``models/ssm.ssd_chunked``'s inner loop.

    Args:
      x: (B, S, H, P) float32 values; dt: (B, S, H) positive step sizes;
        A: (H,) negative decay rates; Bm / Cm: (B, S, G, N); all float32.
      chunk: chunk length; S must be a multiple of it (``ssd_chunked``
        pads with dt = 0, identity steps).
      h0: optional (B, H, N, P) initial state (prefill into a state).
      backend: "cuda" runs K5 (``kernels/ssd_scan.py``, G = 1 only),
        "torch" the plain chunk loop; "auto" takes K5 for a CUDA tensor.
        An explicit "cuda" on a CPU tensor raises ``ValueError``.  Where
        autograd wants a gradient of a "cuda" scan, it runs through
        ``SSDScanFunction``: K5 forward, K5-bwd backward; under
        ``torch.no_grad()`` K5 alone.

    Returns:
      (y (B, S, H, P), h_last (B, H, N, P)) fp32.  The reference's
      ``ssd_scan`` returns y alone and always starts from zero.
    """
    backend = kernel_backend(backend, x.device)
    if backend != "cuda":
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, Bm, Cm, h0)):
        return SSDScanFunction.apply(x, dt, A, Bm, Cm, h0, chunk)
    return ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)

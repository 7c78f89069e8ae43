"""K3: the carry-delta broadcast of the incremental video path, as a
hand-written CUDA kernel.

Replaces ``repro/kernels/delta_apply.py::delta_apply_pallas`` (body
``_delta_apply_kernel``).  Source: ``csrc/delta_apply.cu``, built for
``sm_90a`` by ``kernels/_build.py``.

``out = H + delta[..., None, :]`` for an (n, b, h, w) fp32 slab and an
(n, b, w) fp32 delta: when rows above a clean slab were edited, its whole
correction is one broadcast row (core/delta.py).

What bounds it on an H100: bytes — each slab element is read once and
written once with one add.  The design moves 16 bytes per access, reads
each thread's four delta values once for eight rows, and takes the slab
where it lies: rows inside a (frame, bin) plane are ``w`` apart, planes
may be further apart than ``h * w``, so a row band of a larger H is read
in place and ``out=`` may be a row band of another H.  The TPU kernel's
padding to (8, 128) tiles is gone; the ragged edge is masked.

``delta_apply_cuda`` launches the kernel for a CUDA tensor and runs
``delta_apply_plain`` (the broadcast add) only for a CPU tensor.
``delta_apply_cuda.launches`` counts kernel launches.  ``kernel_specs``
states the launch for kernelcheck.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels.specs import (
    KernelGeometry,
    KernelSpec,
    Operand,
    cdiv,
)

_MAX_BLOCKS = 132 * 16          # grid-stride cap: 16 CTAs per H100 SM
_THREADS = 256                  # threads a CTA (csrc kThreads)
_ROWS = 8                       # rows a work item (csrc kRows)


def delta_apply_plain(H: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Plain torch K3: the broadcast add."""
    return H + delta[..., None, :]


def _plane_stride(x: torch.Tensor, what: str) -> int:
    """Element distance between consecutive (frame, bin) planes of an
    (n, b, rows, w) tensor whose rows are dense and ``w`` apart, or
    ValueError."""
    n, nb, rows, w = x.shape
    dense_rows = ((x.stride(-1) == 1 or w == 1)
                  and (x.stride(-2) == w or rows == 1))
    uniform = True
    if n == 1 and nb == 1:
        ps = rows * w                   # one plane: its stride is unused
    elif nb == 1:
        ps = x.stride(0)
    else:
        ps = x.stride(1)
        uniform = n == 1 or x.stride(0) == nb * ps
    if not (dense_rows and uniform and ps >= rows * w):
        raise ValueError(
            f"{what} {tuple(x.shape)} with strides {x.stride()} is not a "
            "stack of (rows, w) planes with dense rows; pass a contiguous "
            "tensor or a row band of one")
    return ps


def check_inputs(H: torch.Tensor, delta: torch.Tensor,
                 out: torch.Tensor | None) -> None:
    """The kernel's input contract, checked before any pointer is passed."""
    if H.ndim != 4 or H.dtype != torch.float32:
        raise ValueError(
            f"H must be an (n, b, h, w) float32 tensor, got "
            f"{tuple(H.shape)} {H.dtype}")
    n, nb, _, w = H.shape
    if (tuple(delta.shape) != (n, nb, w) or delta.dtype != torch.float32
            or not delta.is_contiguous() or delta.device != H.device):
        raise ValueError(
            f"delta must be a contiguous float32 {(n, nb, w)} tensor on "
            f"{H.device}, got {tuple(delta.shape)} {delta.dtype} on "
            f"{delta.device}")
    if out is not None and (out.shape != H.shape or out.dtype != H.dtype
                            or out.device != H.device):
        raise ValueError(
            f"out must be a float32 {tuple(H.shape)} tensor on {H.device}, "
            f"got {tuple(out.shape)} {out.dtype} on {out.device}")


def _lib():
    from repro_torch.kernels import _build

    lib = _build.library("delta_apply.cu")
    fn = lib.delta_apply_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def delta_apply_cuda(H: torch.Tensor, delta: torch.Tensor, *,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """``H + delta[..., None, :]``, out of place.

    Args:
      H: (n, b, h, w) float32; rows dense and ``w`` apart, e.g. a
        contiguous H or a row band ``H[:, :, r0:r1]`` of one.
      delta: (n, b, w) contiguous float32.
      out: optional destination of H's shape with the same layout rule,
        e.g. a row band of the H being assembled.  Allocated if ``None``.

    Returns:
      ``out``.  A CPU tensor runs ``delta_apply_plain``.
    """
    check_inputs(H, delta, out)
    if not H.is_cuda:
        res = delta_apply_plain(H, delta)
        if out is None:
            return res
        out.copy_(res)
        return out
    if out is None:
        out = torch.empty(H.shape, dtype=torch.float32, device=H.device)
    n, nb, rows, w = H.shape
    if H.numel() == 0:
        return out
    h_plane = _plane_stride(H, "H")
    o_plane = _plane_stride(out, "out")
    fn = _lib()
    with torch.cuda.device(H.device):
        err = fn(H.data_ptr(), h_plane, delta.data_ptr(), out.data_ptr(),
                 o_plane, n * nb, rows, w, _MAX_BLOCKS,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"delta_apply kernel launch failed: CUDA error {err}")
    delta_apply_cuda.launches += 1
    return out


delta_apply_cuda.launches = 0


def resolve_geometry(geom: KernelGeometry) -> KernelGeometry:
    """``geom`` (``h`` the slab's rows, ``num_bins`` its planes a frame)
    with K3's launch filled in: work items of ``_ROWS`` rows and 4
    columns, ``_THREADS`` threads a CTA, at most ``_MAX_BLOCKS`` CTAs."""
    if geom.max_blocks is not None:
        return geom
    return dataclasses.replace(geom, strip_rows=_ROWS, col_block=4,
                               max_blocks=_MAX_BLOCKS,
                               stride_threads=_THREADS)


def kernel_specs(geom: KernelGeometry) -> tuple[KernelSpec, ...]:
    """K3's launch at ``geom`` (csrc/delta_apply.cu): ``delta_apply_kernel``
    on min(ceil(items / threads), max_blocks) CTAs, a grid-stride loop over
    the work items (plane, group of rows, 4 columns); each item is read and
    written once, no value crosses items."""
    g = resolve_geometry(geom)
    T = g.stride_threads
    items = g.n * g.num_bins * cdiv(g.h, g.strip_rows) * cdiv(g.w, 4)
    B = min(cdiv(items, T), g.max_blocks)

    def item_block(p):
        return (p["cta"] + p["stride"] * B,)

    return (KernelSpec(
        name="delta_apply", kernel="delta_apply_kernel",
        grid=(("cta", B),), loops=(("stride", cdiv(items, B * T)),),
        threads=T, geometry=g,
        active=lambda p: item_block(p)[0] * T < items,
        in_specs=(Operand("H", (items,), (T,), item_block, (True,)),),
        out_specs=(Operand("out", (items,), (T,), item_block, (True,)),)),)

"""K4: the CW-TiS integral histogram as two hand-written CUDA kernels.

Replaces ``repro/kernels/cw_tis.py::cw_tis_pallas`` (bodies
``_hscan_kernel`` and ``_vscan_kernel``, one ``pallas_call`` each).
Source: ``csrc/cw_tis.cu``, built for ``sm_90a`` by ``kernels/_build.py``.

The paper's CW-TiS (§3.4): a horizontal scan of the one-hot histogram
along each row writes the intermediate ``hh``; a vertical scan down each
column reads it and writes H.  Four passes over H-sized data where WF-TiS
(K1) makes two — the gap the paper measures — so the two launches are
kept apart on purpose.

What bounds it on an H100: bytes.  ``hscan`` reads the int32 ids and
writes ``hh`` (one CTA per frame, bin block and group of 8 rows; each row
scanned across the width by the CTA with warp shuffles); ``vscan`` reads
``hh`` and writes H (one thread per frame, bin and 4 columns, walking the
rows with its running sum seeded from the carry-in).  The TPU kernels'
carries between grid steps (``row_carry``, ``col_carry``) become these
in-CTA and in-thread loop carries, because CTAs run in no order.

``cw_tis_hscan_cuda`` / ``cw_tis_vscan_cuda`` launch one kernel each for
a CUDA tensor and run their plain versions only for a CPU tensor (a meta
tensor gets the launch's checks and a meta result, no launch); each keeps
its own ``.launches`` count.  ``cw_tis_cuda`` is the two in turn.
``kernel_specs`` states the two launches for kernelcheck.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core import scans
from repro_torch.core.binning import one_hot_bins
from repro_torch.kernels.specs import (
    KernelGeometry,
    KernelSpec,
    Operand,
    cdiv,
)
from repro_torch.kernels.wf_tis import check_inputs, launch_shape

_MAX_VSCAN_BLOCKS = 132 * 16     # grid-stride cap: 16 CTAs per H100 SM
_ROWS_PER_CTA = 8                # hscan rows per CTA (csrc kRowsPerCta)
_VSCAN_THREADS = 256             # vscan threads a CTA (csrc kVThreads)


def cw_tis_hscan_plain(idx: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Plain torch hscan: (n, h, w) ids -> (n, num_bins, h, w) row prefix
    counts of the one-hot (ids outside [0, num_bins) match no bin)."""
    return torch.cumsum(one_hot_bins(idx, num_bins), dim=-1)


def cw_tis_vscan_plain(hh: torch.Tensor,
                       carry: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch vscan: the column prefix of ``hh`` plus the carry."""
    return scans.apply_carry(torch.cumsum(hh, dim=-2), carry)


def cw_tis_plain(idx: torch.Tensor, num_bins: int,
                 carry: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch K4: ``core/scans.py``'s tiled CW-TiS on bin ids, plus
    the carry — the scan behind ``backend="torch"``."""
    return scans.apply_carry(scans.cw_tis_ids(idx, num_bins), carry)


def hscan_shape(w: int, num_bins: int,
                bin_block: int | None = None) -> tuple[int, int, int]:
    """(bin_block, threads, chunks) of the hscan launch: K1's column split
    (``4 * chunks`` columns a thread, at most 16,384 columns) and, unless
    given, the largest bin block of 1, 2, 4, 8 that ``num_bins`` fills."""
    _, threads, chunks, _ = launch_shape(w, num_bins, 1, 1)
    if bin_block is None:
        bin_block = next(bb for bb in (8, 4, 2, 1) if bb <= num_bins)
    elif bin_block not in (1, 2, 4, 8):
        raise ValueError(f"bin_block must be one of (8, 4, 2, 1), "
                         f"got {bin_block}")
    return bin_block, threads, chunks


def _lib():
    from repro_torch.kernels import _build

    lib = _build.library("cw_tis.cu")
    h_fn, v_fn = lib.cw_tis_hscan_launch, lib.cw_tis_vscan_launch
    if h_fn.argtypes is None:
        h_fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        h_fn.restype = ctypes.c_int
        v_fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        v_fn.restype = ctypes.c_int
    return h_fn, v_fn


def cw_tis_hscan_cuda(idx: torch.Tensor, num_bins: int, *,
                      bin_block: int | None = None) -> torch.Tensor:
    """The horizontal pass: (n, h, w) contiguous int32 ids ->
    (n, num_bins, h, w) fp32 ``hh``.  A CPU tensor runs
    ``cw_tis_hscan_plain``."""
    check_inputs(idx, num_bins, None)
    if not (idx.is_cuda or idx.is_meta):
        return cw_tis_hscan_plain(idx, num_bins)
    n, h, w = idx.shape
    hh = torch.empty((n, num_bins, h, w), dtype=torch.float32,
                     device=idx.device)
    if hh.numel() == 0:
        return hh
    if -(-h // _ROWS_PER_CTA) > 65535:
        raise NotImplementedError(
            f"height {h} exceeds the {65535 * _ROWS_PER_CTA} rows of one "
            "hscan launch")
    bb, threads, chunks = hscan_shape(w, num_bins, bin_block)
    if not idx.is_cuda:     # meta: the launch's checks ran, nothing launches
        return hh
    h_fn, _ = _lib()
    with torch.cuda.device(idx.device):
        err = h_fn(idx.data_ptr(), hh.data_ptr(), n, h, w, num_bins, bb,
                   threads, chunks, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cw_tis hscan launch failed: CUDA error {err}")
    cw_tis_hscan_cuda.launches += 1
    return hh


def cw_tis_vscan_cuda(hh: torch.Tensor,
                      carry: torch.Tensor | None = None) -> torch.Tensor:
    """The vertical pass: (n, b, h, w) contiguous fp32 ``hh`` and an
    optional (n, b, w) contiguous fp32 carry-in -> H.  A CPU tensor runs
    ``cw_tis_vscan_plain``."""
    if hh.ndim != 4 or hh.dtype != torch.float32 or not hh.is_contiguous():
        raise ValueError(
            f"hh must be a contiguous (n, b, h, w) float32 tensor, got "
            f"{tuple(hh.shape)} {hh.dtype}")
    n, nb, h, w = hh.shape
    if carry is not None and (
            tuple(carry.shape) != (n, nb, w) or carry.dtype != torch.float32
            or not carry.is_contiguous() or carry.device != hh.device):
        raise ValueError(
            f"carry must be a contiguous float32 {(n, nb, w)} tensor on "
            f"{hh.device}, got {tuple(carry.shape)} {carry.dtype} on "
            f"{carry.device}")
    if not (hh.is_cuda or hh.is_meta):
        return cw_tis_vscan_plain(hh, carry)
    out = torch.empty_like(hh)
    if out.numel() == 0 or not hh.is_cuda:
        return out
    _, v_fn = _lib()
    with torch.cuda.device(hh.device):
        err = v_fn(hh.data_ptr(), None if carry is None else carry.data_ptr(),
                   out.data_ptr(), n * nb, h, w, _MAX_VSCAN_BLOCKS,
                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cw_tis vscan launch failed: CUDA error {err}")
    cw_tis_vscan_cuda.launches += 1
    return out


cw_tis_hscan_cuda.launches = 0
cw_tis_vscan_cuda.launches = 0


def cw_tis_cuda(idx: torch.Tensor, num_bins: int, *,
                bin_block: int | None = None,
                carry: torch.Tensor | None = None) -> torch.Tensor:
    """Inclusive integral histogram of (n, h, w) int32 bin ids by CW-TiS:
    hscan, then vscan seeded with ``carry`` ((n, num_bins, w) fp32).
    Returns (n, num_bins, h, w) fp32, equal to K1 bit for bit.  A CPU
    tensor runs ``cw_tis_plain``."""
    check_inputs(idx, num_bins, carry)
    if not (idx.is_cuda or idx.is_meta):
        return cw_tis_plain(idx, num_bins, carry)
    hh = cw_tis_hscan_cuda(idx, num_bins, bin_block=bin_block)
    return cw_tis_vscan_cuda(hh, carry)


def resolve_geometry(geom: KernelGeometry) -> KernelGeometry:
    """``geom`` with K4's launches filled in as ``cw_tis_cuda`` picks them
    (``hscan_shape``; vscan on at most ``_MAX_VSCAN_BLOCKS`` CTAs of
    ``_VSCAN_THREADS``)."""
    if geom.threads is not None:
        return geom
    bb, threads, chunks = hscan_shape(geom.w, geom.num_bins, geom.bin_block)
    return dataclasses.replace(
        geom, bin_block=bb, threads=threads, chunks=chunks,
        strip_rows=_ROWS_PER_CTA, col_block=4, max_blocks=_MAX_VSCAN_BLOCKS,
        stride_threads=_VSCAN_THREADS)


def kernel_specs(geom: KernelGeometry) -> tuple[KernelSpec, ...]:
    """K4's two launches at ``geom`` (csrc/cw_tis.cu): ``hscan_kernel``,
    grid (n, ceil(nb / bin_block), ceil(h / 8)), each CTA scanning its rows
    across the width, no value carried between rows; then
    ``vscan_kernel``, a grid-stride loop over (plane, 4 columns) items,
    each walking every row with its running sum and reading hscan's rows
    (edges to the earlier launch)."""
    g = resolve_geometry(geom)
    n, h, w, nb = g.n, g.h, g.w, g.num_bins
    bb, R = g.bin_block, g.strip_rows
    cols = g.threads * 4 * g.chunks
    hscan = KernelSpec(
        name="cw_tis/hscan", kernel="hscan_kernel",
        grid=(("f", n), ("bb", cdiv(nb, bb)), ("group", cdiv(h, R))),
        loops=(("row", R),), threads=g.threads, geometry=g,
        smem_static=4 * 2 * bb * 32,            # warp_tot[2 * BB * 32]
        active=lambda p: p["group"] * R + p["row"] < h,
        in_specs=(Operand(
            "idx", (n, h, w), (1, 1, cols),
            lambda p: (p["f"], p["group"] * R + p["row"], 0),
            (False, False, True)),),
        out_specs=(Operand(
            "hh", (n, nb, h, w), (1, bb, 1, cols),
            lambda p: (p["f"], p["bb"], p["group"] * R + p["row"], 0),
            (False, True, False, True)),),
        carry_writes=lambda p: [("hh", p["f"], p["bb"],
                                 p["group"] * R + p["row"])])

    T, ncol = g.stride_threads, cdiv(w, 4)
    items = n * nb * ncol
    B = min(cdiv(items, T), g.max_blocks)

    def item_block(p):
        return p["cta"] + p["stride"] * B

    def v_reads(p):
        r = p["row"]
        reads = ([(("acc", p["cta"]), {"cta": p["cta"],
                                       "stride": p["stride"], "row": r - 1})]
                 if r > 0 else [])
        a = item_block(p) * T
        b = min(items, a + T)
        for plane in range(a // ncol, (b - 1) // ncol + 1):
            f, bin_ = divmod(plane, nb)
            reads.append((("hh", f, bin_ // bb, r), {
                "pass": hscan.name, "f": f, "bb": bin_ // bb,
                "group": r // R, "row": r % R}))
        return reads

    vscan = KernelSpec(
        name="cw_tis/vscan", kernel="vscan_kernel",
        grid=(("cta", B),), loops=(("stride", cdiv(items, B * T)), ("row", h)),
        threads=T, geometry=g,
        active=lambda p: item_block(p) * T < items,
        in_specs=(Operand(
            "carry", (items,), (T,),
            lambda p: (item_block(p),) if p["row"] == 0 else None, (True,)),),
        out_specs=(Operand("out", (h, items), (1, T),
                           lambda p: (p["row"], item_block(p)),
                           (False, True)),),
        carry_reads=v_reads, carry_writes=lambda p: [("acc", p["cta"])])
    return hscan, vscan

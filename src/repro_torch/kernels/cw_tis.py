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
writes ``hh``: one warp per (frame, row, block of up to 8 bins) walks the
row in warp-striped chunks of 128 columns (4 a lane), scanning each chunk
across the warp with shuffles and keeping each bin's row total in a
register from chunk to chunk; a CTA holds a few such warps and nothing
else (no shared memory, no barrier).  ``vscan`` reads ``hh`` and writes H
(one thread per frame, bin and 4 columns, walking the rows with its
running sum seeded from the carry-in).  The TPU kernels' carries between
grid steps (``row_carry``, ``col_carry``) become these in-warp and
in-thread loop carries, because CTAs run in no order.

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
    abstract_launch,
    cdiv,
)
from repro_torch.kernels.wf_tis import _GRID_X_LIMIT, check_inputs

_MAX_VSCAN_BLOCKS = 132 * 16     # grid-stride cap: 16 CTAs per H100 SM
_VSCAN_THREADS = 256             # vscan threads a CTA (csrc kVThreads)
HSCAN_CHUNK = 128                # hscan columns a warp takes at a time
                                 # (csrc kChunk): 4 a lane
HSCAN_WARPS = 8                  # hscan warps (units) a CTA, at most 16
                                 # (csrc kMaxWarps)


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


def hscan_shape(num_bins: int,
                bin_block: int | None = None) -> tuple[int, int]:
    """(bin_block, warps) of the hscan launch at any width and height:
    unless given, the largest bin block of 1, 2, 4, 8 that ``num_bins``
    fills (a lane holds 4 x bin_block floats of output, 32 at 8, and
    ptxas spills none at any block), and ``HSCAN_WARPS`` warps a CTA, one
    unit each.  Swept by ``scripts/hscan_variants.py`` (H100 80GB HBM3 at
    700 W): at 4 x 480 x 32,768 x 32 blocks 8, 4, 2, 1 took 3.0863,
    3.0686, 3.1068, 3.1098 ms and at 16 x 480 x 640 x 32 0.2358, 0.2333,
    0.2335, 0.2311 ms, within 1.4% of each other, so the block that reads
    the ids fewest times is kept; 4 and 16 warps a CTA read within 1.5% of
    8."""
    if bin_block is None:
        bin_block = next(bb for bb in (8, 4, 2, 1) if bb <= num_bins)
    elif bin_block not in (1, 2, 4, 8):
        raise ValueError(f"bin_block must be one of (8, 4, 2, 1), "
                         f"got {bin_block}")
    return bin_block, HSCAN_WARPS


def hscan_ctas(n: int, h: int, num_bins: int, bin_block: int,
               warps: int) -> int:
    """CTAs of the hscan launch: one warp a (frame, row, bin block)."""
    return cdiv(n * h * cdiv(num_bins, bin_block), warps)


def _lib():
    from repro_torch.kernels import _build

    lib = _build.library("cw_tis.cu")
    h_fn, v_fn = lib.cw_tis_hscan_launch, lib.cw_tis_vscan_launch
    if h_fn.argtypes is None:
        h_fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        h_fn.restype = ctypes.c_int
        v_fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        v_fn.restype = ctypes.c_int
    return h_fn, v_fn


def cw_tis_hscan_work(n: int, h: int, w: int, num_bins: int) -> dict:
    """What the hscan's function must do: the ids read once, ``hh``
    written once; a compare and an add per element of ``hh``."""
    px = n * h * w
    return {"bytes": 4 * px + 4 * px * num_bins, "flops": 2 * px * num_bins}


def cw_tis_vscan_work(n: int, num_bins: int, h: int, w: int, *,
                      carry: bool = False) -> dict:
    """What the vscan's function must do: ``hh`` (and the carry) read
    once, H written once; one add per element."""
    el = n * num_bins * h * w
    return {"bytes": 2 * 4 * el + (4 * n * num_bins * w if carry else 0),
            "flops": el}


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
    bb, warps = hscan_shape(num_bins, bin_block)
    if hscan_ctas(n, h, num_bins, bb, warps) > _GRID_X_LIMIT:
        raise NotImplementedError(
            f"{n} frames of {h} rows at {num_bins} bins exceed the hscan "
            f"grid's {_GRID_X_LIMIT} CTAs")
    if not idx.is_cuda:     # meta: the launch's checks ran, nothing launches
        abstract_launch("cw_tis_hscan", cw_tis_hscan_work(n, h, w, num_bins))
        return hh
    h_fn, _ = _lib()
    with torch.cuda.device(idx.device):
        err = h_fn(idx.data_ptr(), hh.data_ptr(), n, h, w, num_bins, bb,
                   warps, torch.cuda.current_stream().cuda_stream)
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
    if out.numel() == 0:
        return out
    if not hh.is_cuda:      # meta: the launch's checks ran, nothing launches
        abstract_launch("cw_tis_vscan", cw_tis_vscan_work(
            n, nb, h, w, carry=carry is not None))
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
    (``hscan_shape``: ``HSCAN_WARPS`` warps a CTA, chunks of
    ``HSCAN_CHUNK`` columns; vscan on at most ``_MAX_VSCAN_BLOCKS`` CTAs
    of ``_VSCAN_THREADS``)."""
    if geom.threads is not None:
        return geom
    bb, warps = hscan_shape(geom.num_bins, geom.bin_block)
    return dataclasses.replace(
        geom, bin_block=bb, threads=32 * warps, col_block=HSCAN_CHUNK,
        max_blocks=_MAX_VSCAN_BLOCKS, stride_threads=_VSCAN_THREADS)


def kernel_specs(geom: KernelGeometry) -> tuple[KernelSpec, ...]:
    """K4's two launches at ``geom`` (csrc/cw_tis.cu): ``hscan_kernel``,
    grid x over CTAs of ``threads / 32`` warps, each warp one unit
    (frame, row, bin block; the bin blocks of a row adjacent), walking its
    row chunk by chunk with each bin's row total carried from one chunk
    to the next in the warp's registers, nothing between warps and no
    shared memory; then ``vscan_kernel``, a grid-stride loop over (plane,
    4 columns) items, each walking every row with its running sum and
    reading the hscan's chunks of the row (edges to the earlier
    launch)."""
    g = resolve_geometry(geom)
    n, h, w, nb = g.n, g.h, g.w, g.num_bins
    bb, C, W = g.bin_block, g.col_block, g.threads // 32
    nbb = cdiv(nb, bb)
    units = n * h * nbb

    def unit(p):                    # (frame, bin block, row) of a warp
        rest, blk = divmod(p["x"] * W + p["warp"], nbb)
        f, r = divmod(rest, h)
        return f, blk, r

    def h_reads(p):
        if p["chunk"] == 0:
            return []
        return [(("run", p["x"], p["warp"]),
                 {"x": p["x"], "warp": p["warp"], "chunk": p["chunk"] - 1})]

    def h_writes(p):
        f, blk, r = unit(p)
        return [("run", p["x"], p["warp"]), ("hh", f, blk, r, p["chunk"])]

    def h_in(p):
        f, _, r = unit(p)
        return f, r, p["chunk"]

    def h_out(p):
        f, blk, r = unit(p)
        return f, blk, r, p["chunk"]

    hscan = KernelSpec(
        name="cw_tis/hscan", kernel="hscan_kernel",
        grid=(("x", cdiv(units, W)),), warps=(("warp", W),),
        loops=(("chunk", cdiv(w, C)),), threads=g.threads, geometry=g,
        active=lambda p: p["x"] * W + p["warp"] < units,
        in_specs=(Operand("idx", (n, h, w), (1, 1, C), h_in,
                          (False, False, True)),),
        out_specs=(Operand("hh", (n, nb, h, w), (1, bb, 1, C), h_out,
                           (False, True, False, True)),),
        carry_reads=h_reads, carry_writes=h_writes)

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
            c0 = max(a, plane * ncol) - plane * ncol
            c1 = min(b, (plane + 1) * ncol) - plane * ncol
            x, warp = divmod((f * h + r) * nbb + bin_ // bb, W)
            reads += [(("hh", f, bin_ // bb, r, k), {
                "pass": hscan.name, "x": x, "warp": warp, "chunk": k})
                for k in range(4 * c0 // C, 4 * (c1 - 1) // C + 1)]
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

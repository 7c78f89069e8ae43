"""K1: the WF-TiS integral histogram as a hand-written CUDA kernel.

Replaces ``repro/kernels/wf_tis.py::wf_tis_pallas`` (body
``_wf_tis_kernel``).  Source: ``csrc/wf_tis.cu`` over the scan in
``csrc/wf_tis_scan.cuh``, built for ``sm_90a`` by ``kernels/_build.py``.

What bounds it on an H100: bytes.  Per pixel it reads a 4-byte bin id
and writes ``num_bins`` fp32 counts, a few adds each, so at 32 bins the
least time is the H write over the 3.35 TB/s of device memory.  The
design writes H once and reads nothing back: one CTA per (frame, bin
block, strip of rows) walks its rows, keeps the column counts in shared
memory, forms the one-hot in registers, and scans each row across the
frame with warp shuffles.  The TPU kernel's carries between grid steps
become carries along that loop, because CTAs run in no order.  Where the
frames and bin blocks leave the card's SMs idle (one frame), the rows are
cut into strips (``launch_shape``) and a pre-pass counts each strip's
columns, from which every strip seeds its walk: two CUDA launches in one
call.  Shapes that fill the card, and short frames, keep one walk.

``wf_tis_cuda`` launches the kernel for a CUDA tensor and runs
``wf_tis_plain`` (the strip scan of ``core/scans.py``: one-hot, two
cumsums per strip, the carry) only for a CPU tensor; a meta tensor gets
the launch's checks and a meta H, no launch (plancheck's abstract
evaluation).  ``wf_tis_cuda.launches`` counts calls that launched the
kernel.  ``kernel_specs`` states the launches for kernelcheck.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch

from repro_torch.core import scans
from repro_torch.kernels.specs import (
    SMEM_DEFAULT_BYTES,
    SMEM_LIMIT_BYTES,
    KernelGeometry,
    KernelSpec,
    Operand,
    cdiv,
)

_MAX_THREADS = 1024
_MAX_CHUNKS = 4                 # 4-column chunks per thread (template Q)
_BIN_BLOCKS = (8, 4, 2, 1)      # instantiated bin blocks (template BB)
_SMS = 132                      # streaming multiprocessors of an H100 SXM
_FILL_WARPS = 8 * _SMS          # warps in flight that keep one strip
_STRIP_CTAS = 4 * _SMS          # CTAs a strip cut aims for
_MIN_STRIP_ROWS = 4
# Below this height one CTA's walk (about half a microsecond a row) is
# shorter than what strips add: the pre-pass's launch and its host steps.
# chip_smoke's strip sweep (a 640-column run at 32 bins with a carry, on
# an H100 80GB HBM3 at 700 W, PERF.md): by the median of five sweeps,
# strips are slower at 80 rows and faster from 96.
_STRIP_MIN_HEIGHT = 96
_GRID_LIMIT = 65535             # CUDA's cap on grid dims y and z
_COUNT_BINS = 8                 # pre-pass bins a thread (csrc kCountBins)
_COUNT_THREADS = 128            # pre-pass threads a CTA (csrc kCountThreads)


def wf_tis_plain(idx: torch.Tensor, num_bins: int,
                 carry: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch K1: (n, h, w) bin ids -> (n, num_bins, h, w) fp32, the
    strip scan behind ``backend="torch"``."""
    return scans.wf_tis_ids(idx, num_bins, carry_in=carry)


class LaunchShape(NamedTuple):
    """How the scan is cut: ``bin_block`` bins and ``threads`` threads a
    CTA, each thread ``4 * chunks`` columns, each CTA ``strip_rows`` rows
    (0: the whole walk, for callers that give no height)."""
    bin_block: int
    threads: int
    chunks: int
    strip_rows: int

    def strips(self, h: int) -> int:
        return -(-h // self.strip_rows) if self.strip_rows else 1

    def ctas(self, n: int, num_bins: int, h: int) -> int:
        return n * -(-num_bins // self.bin_block) * self.strips(h)


def scan_smem_bytes(bin_block: int, threads: int, chunks: int) -> int:
    """Dynamic shared memory of one strip-scan CTA (wf_tis_scan.cuh's
    ``smem_bytes``): the column counts of ``bin_block`` bins over the
    CTA's columns, and two buffers of per-warp totals."""
    return 4 * (bin_block * threads * 4 * chunks + 2 * bin_block * 32)


def strip_rows_for(h: int, ctas: int) -> int:
    """The strip height that turns ``ctas`` CTAs of whole walks (frames x
    bin blocks) into about ``_STRIP_CTAS``, at least ``_MIN_STRIP_ROWS``
    rows (the pre-pass costs more than thinner strips gain)."""
    return min(max(h, 1), max(_MIN_STRIP_ROWS, h // -(-_STRIP_CTAS // ctas)))


@functools.lru_cache(maxsize=256)
def launch_shape(w: int, num_bins: int, n: int,
                 bin_block: int | None = None, *, h: int | None = None,
                 strip_rows: int | None = None) -> LaunchShape:
    """The launch for ``n`` frames ``w`` wide (and ``h`` high, for K1).

    Each thread owns ``4 * chunks`` contiguous columns.  ``bin_block=None``
    takes the largest block that still gives two CTAs per SM of an H100
    (132 SMs) and fits shared memory.  With ``h`` given, a shape whose
    frames and bin blocks put 8 warps on every SM keeps one strip (no
    pre-pass): the clip, 1080p and a band of the 4K frame, where strips
    measured no faster; so does one lower than ``_STRIP_MIN_HEIGHT`` rows
    (a dirty run of a video frame).  Any other (one frame) is cut into
    strips (``strip_rows_for``).  ``strip_rows`` given fixes the cut."""
    chunks = 1
    while _MAX_THREADS * 4 * chunks < w:
        chunks *= 2
    threads = 32 * max(1, -(-w // (128 * chunks)))
    if chunks > _MAX_CHUNKS:
        raise NotImplementedError(
            f"width {w} exceeds the {_MAX_THREADS * 4 * _MAX_CHUNKS} columns "
            "one CTA scans; wider frames need column strips with a row-carry "
            "pre-pass (not ported yet)")

    def smem(bb: int) -> int:
        return scan_smem_bytes(bb, threads, chunks)

    if bin_block is None:
        fits = [bb for bb in _BIN_BLOCKS if smem(bb) <= SMEM_LIMIT_BYTES]
        if not fits:
            raise NotImplementedError(f"width {w} exceeds shared memory")
        busy = [bb for bb in fits if n * -(-num_bins // bb) >= 2 * _SMS]
        bin_block = busy[0] if busy else fits[-1]
    elif bin_block not in _BIN_BLOCKS:
        raise ValueError(f"bin_block must be one of {_BIN_BLOCKS}, "
                         f"got {bin_block}")
    elif smem(bin_block) > SMEM_LIMIT_BYTES:
        raise ValueError(f"bin_block {bin_block} at width {w} needs "
                         f"{smem(bin_block)} B of shared memory")
    if h is None:
        rows = 0
    elif strip_rows is not None:
        if strip_rows < 1:
            raise ValueError(f"strip_rows must be positive, got {strip_rows}")
        rows = min(strip_rows, max(h, 1))
    else:
        ctas = n * -(-num_bins // bin_block)
        if ctas * threads // 32 >= _FILL_WARPS or h < _STRIP_MIN_HEIGHT:
            rows = max(h, 1)
        else:
            rows = strip_rows_for(h, ctas)
    if h is not None and -(-h // rows) > _GRID_LIMIT:
        raise NotImplementedError(
            f"{-(-h // rows)} strips of {rows} rows exceed the grid")
    return LaunchShape(bin_block, threads, chunks, rows)


def check_inputs(idx: torch.Tensor, num_bins: int,
                 carry: torch.Tensor | None) -> None:
    """The kernels' input contract, checked before any pointer is passed."""
    if idx.ndim != 3 or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError(
            f"idx must be a contiguous (n, h, w) int32 tensor, got "
            f"{tuple(idx.shape)} {idx.dtype}")
    if num_bins < 1:
        raise ValueError(f"num_bins must be positive, got {num_bins}")
    if carry is not None:
        n, _, w = idx.shape
        if (tuple(carry.shape) != (n, num_bins, w)
                or carry.dtype != torch.float32 or not carry.is_contiguous()
                or carry.device != idx.device):
            raise ValueError(
                f"carry must be a contiguous float32 {(n, num_bins, w)} "
                f"tensor on {idx.device}, got {tuple(carry.shape)} "
                f"{carry.dtype} on {carry.device}")


def _lib():
    from repro_torch.kernels import _build

    lib = _build.library("wf_tis.cu")
    fn = lib.wf_tis_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(idx: torch.Tensor, num_bins: int, shape: LaunchShape,
           carry: torch.Tensor | None = None) -> torch.Tensor:
    """K1 on a CUDA tensor with the given ``shape`` (from
    ``launch_shape(..., h=h)``): the pre-pass when it cuts strips, then
    the scan.  ``wf_tis_cuda`` picks the shape and counts its calls; tests
    pin strip boundaries through this.  Returns (n, num_bins, h, w)."""
    check_inputs(idx, num_bins, carry)
    if not idx.is_cuda:
        raise ValueError("launch runs K1 on a CUDA tensor only")
    n, h, w = idx.shape
    out = torch.empty((n, num_bins, h, w), dtype=torch.float32,
                      device=idx.device)
    if out.numel() == 0:
        return out
    rows = shape.strip_rows or h
    strips = -(-h // rows)
    counts = None
    if strips > 1:
        counts = torch.empty((n, num_bins, strips - 1, w),
                             dtype=torch.float32, device=idx.device)
    fn = _lib()
    with torch.cuda.device(idx.device):
        err = fn(idx.data_ptr(),
                 None if carry is None else carry.data_ptr(),
                 None if counts is None else counts.data_ptr(),
                 out.data_ptr(), n, h, w, num_bins, shape.bin_block,
                 shape.threads, shape.chunks, rows,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"wf_tis kernel launch failed: CUDA error {err}")
    return out


def wf_tis_cuda(idx: torch.Tensor, num_bins: int, *,
                bin_block: int | None = None,
                carry: torch.Tensor | None = None) -> torch.Tensor:
    """Inclusive integral histogram of bin ids.

    Args:
      idx: (n, h, w) contiguous int32 bin ids; any value outside
        [0, num_bins) (PAD_BIN) matches no bin.  No padding is needed.
      num_bins: number of bins.
      bin_block: bins per CTA (1, 2, 4 or 8), ``None`` to pick from the
        shape.
      carry: optional (n, num_bins, w) fp32 band carry-in.

    Returns:
      (n, num_bins, h, w) fp32.  A CPU tensor runs ``wf_tis_plain``.
    """
    check_inputs(idx, num_bins, carry)
    if not (idx.is_cuda or idx.is_meta):
        return wf_tis_plain(idx, num_bins, carry)
    n, h, w = idx.shape
    if n * h * w * num_bins == 0:
        return torch.empty((n, num_bins, h, w), dtype=torch.float32,
                           device=idx.device)
    shape = launch_shape(w, num_bins, n, bin_block, h=h)
    if not idx.is_cuda:     # meta: the launch's checks ran, nothing launches
        return torch.empty((n, num_bins, h, w), dtype=torch.float32,
                           device=idx.device)
    out = launch(idx, num_bins, shape, carry)
    wf_tis_cuda.launches += 1
    return out


wf_tis_cuda.launches = 0


def resolve_geometry(geom: KernelGeometry) -> KernelGeometry:
    """``geom`` with K1's launch filled in as ``wf_tis_cuda`` picks it
    (``launch_shape(..., h=h)``: a ``bin_block`` of ``None`` by the busy
    rule, ``strip_rows`` of ``None`` by the strip cut)."""
    if geom.threads is not None:
        return geom
    shape = launch_shape(geom.w, geom.num_bins, geom.n, geom.bin_block,
                         h=geom.h, strip_rows=geom.strip_rows)
    return dataclasses.replace(
        geom, bin_block=shape.bin_block, threads=shape.threads,
        chunks=shape.chunks, strip_rows=shape.strip_rows,
        col_block=4 * _COUNT_THREADS)


def kernel_specs(geom: KernelGeometry) -> tuple[KernelSpec, ...]:
    """K1's launches at ``geom`` (csrc/wf_tis.cu ``wf_tis_launch``): with
    more than one strip, the count pre-pass ``count_kernel``, grid
    (n * ceil(nb / 8), ceil(w / 512), strips - 1), a CTA's rows counted
    along its row loop; then ``scan_kernel``, grid (n, ceil(nb / bin_block),
    strips), walking its strip's rows with the column counts carried in
    shared memory and seeded at row 0 from the carry and the pre-pass's
    counts of the strips above (edges to the earlier launch)."""
    g = resolve_geometry(geom)
    n, h, w, nb = g.n, g.h, g.w, g.num_bins
    bb, R, cb = g.bin_block, g.strip_rows, g.col_block
    cols = g.threads * 4 * g.chunks
    strips, nbb = cdiv(h, R), cdiv(nb, bb)
    groups, ncb = cdiv(nb, _COUNT_BINS), cdiv(w, cb)
    specs = []
    if strips > 1:
        def count_cta(p):
            return {"x": p["x"], "y": p["y"], "z": p["z"]}

        def count_out(p):
            if p["row"] != R - 1:
                return None
            f, grp = divmod(p["x"], groups)
            return (f, grp, p["z"], p["y"])

        def count_reads(p):
            if p["row"] == 0:
                return []
            return [(("cnt", p["x"], p["y"], p["z"]),
                     {**count_cta(p), "row": p["row"] - 1})]

        def count_writes(p):
            cells = [("cnt", p["x"], p["y"], p["z"])]
            if p["row"] == R - 1:
                f, grp = divmod(p["x"], groups)
                cells.append(("counts", f, grp, p["z"], p["y"]))
            return cells

        specs.append(KernelSpec(
            name="wf_tis/count", kernel="count_kernel",
            grid=(("x", n * groups), ("y", ncb), ("z", strips - 1)),
            loops=(("row", R),), threads=_COUNT_THREADS, geometry=g,
            in_specs=(Operand(
                "idx", (n, h, w), (1, 1, cb),
                lambda p: (p["x"] // groups, p["z"] * R + p["row"], p["y"]),
                (False, False, True)),),
            out_specs=(Operand(
                "counts", (n, nb, strips - 1, w), (1, _COUNT_BINS, 1, cb),
                count_out, (False, True, False, True)),),
            carry_reads=count_reads, carry_writes=count_writes))

    def scan_reads(p):
        f, y, z, r = p["x"], p["y"], p["z"], p["row"]
        if r > 0:
            return [(("V", f, y, z), {"x": f, "y": y, "z": z, "row": r - 1})]
        g0, g1 = y * bb // _COUNT_BINS, (min(nb, (y + 1) * bb) - 1) \
            // _COUNT_BINS
        return [(("counts", f, grp, s, cy),
                 {"pass": "wf_tis/count", "x": f * groups + grp, "y": cy,
                  "z": s, "row": R - 1})
                for s in range(z) for grp in range(g0, g1 + 1)
                for cy in range(ncb)]

    dynamic = scan_smem_bytes(bb, g.threads, g.chunks)
    specs.append(KernelSpec(
        name="wf_tis/scan", kernel="scan_kernel",
        grid=(("x", n), ("y", nbb), ("z", strips)), loops=(("row", R),),
        threads=g.threads, geometry=g, smem_dynamic=dynamic,
        smem_opt_in=dynamic > SMEM_DEFAULT_BYTES,     # launch_bbq sets it
        active=lambda p: p["z"] * R + p["row"] < h,
        in_specs=(
            Operand("idx", (n, h, w), (1, 1, cols),
                    lambda p: (p["x"], p["z"] * R + p["row"], 0),
                    (False, False, True)),
            Operand("carry", (n, nb, w), (1, bb, cols),
                    lambda p: (p["x"], p["y"], 0) if p["row"] == 0 else None,
                    (False, True, True)),
        ),
        out_specs=(Operand(
            "out", (n, nb, h, w), (1, bb, 1, cols),
            lambda p: (p["x"], p["y"], p["z"] * R + p["row"], 0),
            (False, True, False, True)),),
        carry_reads=scan_reads,
        carry_writes=lambda p: [("V", p["x"], p["y"], p["z"])]))
    return tuple(specs)

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
call.  Shapes that fill the card, and short frames, keep one walk.  A
frame wider than one CTA's 16,384 columns is cut into column strips
(``column_split``), and another pre-pass counts each row's hits in every
column strip but the last, which the strips to its right add to their
rows: the row strips turned on their side.

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
    abstract_launch,
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
_GRID_X_LIMIT = 2**31 - 1       # and on grid dim x
_COUNT_BINS = 8                 # pre-pass bins a thread (csrc kCountBins)
_COUNT_THREADS = 128            # pre-pass threads a CTA (csrc kCountThreads)
_COL_BLOCK = 4 * _COUNT_THREADS     # columns a count CTA (csrc kColBlock)
_MAX_COLS = _MAX_THREADS * 4 * _MAX_CHUNKS  # columns one CTA scans
_ROW_WARPS = 8                  # rows a row-count CTA (csrc kRowWarps)


def wf_tis_plain(idx: torch.Tensor, num_bins: int,
                 carry: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch K1: (n, h, w) bin ids -> (n, num_bins, h, w) fp32, the
    strip scan behind ``backend="torch"``."""
    return scans.wf_tis_ids(idx, num_bins, carry_in=carry)


class LaunchShape(NamedTuple):
    """How the scan is cut: ``bin_block`` bins and ``threads`` threads a
    CTA, each thread ``4 * chunks`` columns, each CTA ``strip_rows`` rows
    (0: the whole walk, for callers that give no height) of
    ``strip_cols`` columns (the whole width, or a column strip)."""
    bin_block: int
    threads: int
    chunks: int
    strip_rows: int
    strip_cols: int

    def strips(self, h: int) -> int:
        return -(-h // self.strip_rows) if self.strip_rows else 1

    def col_strips(self, w: int) -> int:
        return max(1, -(-w // self.strip_cols))

    def ctas(self, n: int, num_bins: int, h: int, w: int) -> int:
        return (n * -(-num_bins // self.bin_block) * self.strips(h)
                * self.col_strips(w))


def column_split(w: int) -> tuple[int, int, int]:
    """``(strip_cols, threads, chunks)``: the columns a CTA scans and how
    its threads hold them, ``4 * chunks`` contiguous columns a thread.  A
    frame of at most 16,384 columns is one strip; a wider one is cut into
    the fewest strips of at most 16,384, of near-equal width rounded up to
    whole 512-column blocks (the count pre-pass's, whose totals give a
    strip's corner), the last ragged."""
    strips = cdiv(w, _MAX_COLS)
    if strips <= 1:
        cols = max(w, 1)
    else:
        cols = cdiv(cdiv(w, strips), _COL_BLOCK) * _COL_BLOCK
    chunks = 1
    while _MAX_THREADS * 4 * chunks < cols:
        chunks *= 2
    threads = 32 * max(1, -(-cols // (128 * chunks)))
    return cols, threads, chunks


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

    The columns are cut by ``column_split``: each thread owns ``4 *
    chunks`` contiguous columns of a CTA's ``strip_cols``, and a CTA of
    every column strip counts as one below.  ``bin_block=None`` takes the
    largest block that still gives two CTAs per SM of an H100 (132 SMs) and
    fits shared memory.  With ``h`` given, a shape whose frames, column
    strips and bin blocks put 8 warps on every SM keeps one row strip (no
    row pre-pass): the clip, 1080p and a band of the 4K frame, where
    strips measured no faster; so does one lower than
    ``_STRIP_MIN_HEIGHT`` rows (a dirty run of a video frame).
    Any other (one frame) is cut into strips (``strip_rows_for``).
    ``strip_rows`` given fixes the cut, and only it can ask for more row
    strips than the grid holds (``NotImplementedError``)."""
    cols, threads, chunks = column_split(w)
    col_strips = max(1, cdiv(w, cols))

    def smem(bb: int) -> int:
        return scan_smem_bytes(bb, threads, chunks)

    if bin_block is None:
        fits = [bb for bb in _BIN_BLOCKS if smem(bb) <= SMEM_LIMIT_BYTES]
        if not fits:
            raise NotImplementedError(f"width {w} exceeds shared memory")
        busy = [bb for bb in fits
                if n * col_strips * -(-num_bins // bb) >= 2 * _SMS]
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
        ctas = n * col_strips * -(-num_bins // bin_block)
        if ctas * threads // 32 >= _FILL_WARPS or h < _STRIP_MIN_HEIGHT:
            rows = max(h, 1)
        else:
            rows = strip_rows_for(h, ctas)
    strips = -(-h // rows) if h is not None else 1
    grid = [(f"row strips of {rows} rows", strips, _GRID_LIMIT),
            ("bin blocks", -(-num_bins // bin_block), _GRID_LIMIT),
            ("frames x column strips", n * col_strips, _GRID_X_LIMIT)]
    if strips > 1:          # the count pre-pass: a CTA a column block
        grid.append(("column blocks", -(-w // _COL_BLOCK), _GRID_LIMIT))
    for what, size, limit in grid:
        if size > limit:
            raise NotImplementedError(
                f"{size} {what} exceed the grid's {limit}")
    return LaunchShape(bin_block, threads, chunks, rows, cols)


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
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(idx: torch.Tensor, num_bins: int, shape: LaunchShape,
           carry: torch.Tensor | None = None) -> torch.Tensor:
    """K1 on a CUDA tensor with the given ``shape`` (from
    ``launch_shape(..., h=h)``): the row-count pre-pass when it cuts
    column strips, the column-count pre-pass when it cuts row strips, then
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
    cols = min(shape.strip_cols, w)
    strips, col_strips = -(-h // rows), -(-w // cols)

    def scratch(*size):
        return torch.empty((n, num_bins) + size, dtype=torch.float32,
                           device=idx.device)

    counts = corners = rowcnt = None
    if strips > 1:
        counts = scratch(strips - 1, w)
        if col_strips > 1:
            corners = scratch(strips - 1, -(-w // _COL_BLOCK))
    if col_strips > 1:
        rowcnt = scratch(h, col_strips - 1)
    fn = _lib()
    with torch.cuda.device(idx.device):
        err = fn(*(None if t is None else t.data_ptr()
                   for t in (idx, carry, counts, corners, rowcnt, out)),
                 n, h, w, num_bins, shape.bin_block, shape.threads,
                 shape.chunks, rows, cols,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"wf_tis kernel launch failed: CUDA error {err}")
    return out


def wf_tis_work(n: int, h: int, w: int, num_bins: int, *,
                carry: bool = False) -> dict:
    """What K1's function must do: the ids (and the carry) read once and H
    written once (a pre-pass's second read of the ids is the kernel's
    cost, not the function's); two operations per element of H, the
    one-hot compare and the scan's add."""
    px = n * h * w
    return {"bytes": 4 * px * (num_bins + 1)
            + (4 * n * num_bins * w if carry else 0),
            "flops": 2 * px * num_bins}


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
        abstract_launch("wf_tis", wf_tis_work(n, h, w, num_bins,
                                              carry=carry is not None))
        return torch.empty((n, num_bins, h, w), dtype=torch.float32,
                           device=idx.device)
    out = launch(idx, num_bins, shape, carry)
    wf_tis_cuda.launches += 1
    return out


wf_tis_cuda.launches = 0


def resolve_geometry(geom: KernelGeometry) -> KernelGeometry:
    """``geom`` with K1's launch filled in as ``wf_tis_cuda`` picks it
    (``launch_shape(..., h=h)``: a ``bin_block`` of ``None`` by the busy
    rule, ``strip_rows`` of ``None`` by the strip cut, ``strip_cols`` by
    ``column_split``)."""
    if geom.threads is not None:
        return geom
    shape = launch_shape(geom.w, geom.num_bins, geom.n, geom.bin_block,
                         h=geom.h, strip_rows=geom.strip_rows)
    return dataclasses.replace(
        geom, bin_block=shape.bin_block, threads=shape.threads,
        chunks=shape.chunks, strip_rows=shape.strip_rows,
        strip_cols=shape.strip_cols, col_block=_COL_BLOCK)


def kernel_specs(geom: KernelGeometry) -> tuple[KernelSpec, ...]:
    """K1's launches at ``geom`` (csrc/wf_tis.cu ``wf_tis_launch``), in
    stream order.  With more than one column strip, the row-count pre-pass
    ``row_count_kernel``, grid x folding (column strip but the last,
    frame, bin group of 8, tile of 8 rows), a warp's row walked along the
    strip in 512-column chunks with its counts carried.  With more than
    one row strip, the count pre-pass ``count_kernel``, grid (n *
    ceil(nb / 8), ceil(w / 512), strips - 1), a CTA's rows counted along
    its row loop (with column strips, its block's totals too).  Then
    ``scan_kernel``, grid (n * column strips, ceil(nb / bin_block),
    strips), walking its strip's rows with the column counts carried in
    shared memory, seeded at row 0 from the carry and the count pre-pass's
    counts of the strips above (and, right of the first column strip, the
    block totals above and to the left), adding at each row the row
    counts of the column strips to its left: edges to the earlier
    launches only."""
    g = resolve_geometry(geom)
    n, h, w, nb = g.n, g.h, g.w, g.num_bins
    bb, R, cb, sc = g.bin_block, g.strip_rows, g.col_block, g.strip_cols
    strips, nbb, ncs = cdiv(h, R), cdiv(nb, bb), cdiv(w, sc)
    groups, ncb = cdiv(nb, _COUNT_BINS), cdiv(w, cb)
    tiles, chunks = cdiv(h, _ROW_WARPS), sc // cb
    specs = []
    if ncs > 1:
        def row_cta(x):
            x, tile = divmod(x, tiles)
            x, grp = divmod(x, groups)
            cs, f = divmod(x, n)
            return cs, f, grp, tile

        def row_of(p):
            return row_cta(p["x"])[3] * _ROW_WARPS + p["row"]

        def rows_out(p):
            if p["chunk"] != chunks - 1:
                return None
            cs, f, grp, _ = row_cta(p["x"])
            return (f, grp, row_of(p), cs)

        def rows_reads(p):
            if p["chunk"] == 0:
                return []
            return [(("rc", p["x"], p["row"]),
                     {"x": p["x"], "row": p["row"], "chunk": p["chunk"] - 1})]

        def rows_writes(p):
            cells = [("rc", p["x"], p["row"])]
            if p["chunk"] == chunks - 1:
                cs, f, grp, _ = row_cta(p["x"])
                cells.append(("rowcnt", f, grp, row_of(p), cs))
            return cells

        specs.append(KernelSpec(
            name="wf_tis/rows", kernel="row_count_kernel",
            grid=(("x", (ncs - 1) * n * groups * tiles),),
            loops=(("row", _ROW_WARPS), ("chunk", chunks)),
            threads=32 * _ROW_WARPS, geometry=g,
            active=lambda p: row_of(p) < h,
            in_specs=(Operand(
                "idx", (n, h, w), (1, 1, cb),
                lambda p: (row_cta(p["x"])[1], row_of(p),
                           row_cta(p["x"])[0] * chunks + p["chunk"]),
                (False, False, True)),),
            out_specs=(Operand(
                "rowcnt", (n, nb, h, ncs - 1), (1, _COUNT_BINS, 1, 1),
                rows_out, (False, True, False, False)),),
            carry_reads=rows_reads, carry_writes=rows_writes))

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
                if ncs > 1:
                    cells.append(("corners", f, grp, p["z"], p["y"]))
            return cells

        outs = (Operand(
            "counts", (n, nb, strips - 1, w), (1, _COUNT_BINS, 1, cb),
            count_out, (False, True, False, True)),)
        if ncs > 1:
            outs += (Operand(
                "corners", (n, nb, strips - 1, ncb), (1, _COUNT_BINS, 1, 1),
                count_out, (False, True, False, False)),)
        specs.append(KernelSpec(
            name="wf_tis/count", kernel="count_kernel",
            grid=(("x", n * groups), ("y", ncb), ("z", strips - 1)),
            loops=(("row", R),), threads=_COUNT_THREADS, geometry=g,
            # part[kCountBins][kCountThreads / 32], for the block totals
            smem_static=4 * _COUNT_BINS * _COUNT_THREADS // 32,
            in_specs=(Operand(
                "idx", (n, h, w), (1, 1, cb),
                lambda p: (p["x"] // groups, p["z"] * R + p["row"], p["y"]),
                (False, False, True)),),
            out_specs=outs,
            carry_reads=count_reads, carry_writes=count_writes))

    def scan_cta(p):
        cs, f = divmod(p["x"], n)
        return f, cs

    def scan_reads(p):
        f, cs = scan_cta(p)
        y, z, r = p["y"], p["z"], p["row"]
        reads = []
        if r > 0:
            reads.append((("V", p["x"], y, z),
                          {"x": p["x"], "y": y, "z": z, "row": r - 1}))
        grps = range(y * bb // _COUNT_BINS,
                     (min(nb, (y + 1) * bb) - 1) // _COUNT_BINS + 1)

        def counted(cell, s, grp, cy):
            return ((cell, f, grp, s, cy),
                    {"pass": "wf_tis/count", "x": f * groups + grp, "y": cy,
                     "z": s, "row": R - 1})

        if r == 0:
            c_lo, c_hi = cs * sc, min(w, (cs + 1) * sc)
            reads += [counted("counts", s, grp, cy) for s in range(z)
                      for grp in grps
                      for cy in range(c_lo // cb, cdiv(c_hi, cb))]
            reads += [counted("corners", s, grp, cy) for s in range(z)
                      for grp in grps for cy in range(c_lo // cb)]
        row = z * R + r
        reads += [(("rowcnt", f, grp, row, j),
                   {"pass": "wf_tis/rows",
                    "x": ((j * n + f) * groups + grp) * tiles
                    + row // _ROW_WARPS,
                    "row": row % _ROW_WARPS, "chunk": chunks - 1})
                  for j in range(cs) for grp in grps]
        return reads

    dynamic = scan_smem_bytes(bb, g.threads, g.chunks)
    specs.append(KernelSpec(
        name="wf_tis/scan", kernel="scan_kernel",
        grid=(("x", n * ncs), ("y", nbb), ("z", strips)),
        loops=(("row", R),), threads=g.threads, geometry=g,
        smem_dynamic=dynamic,
        smem_opt_in=dynamic > SMEM_DEFAULT_BYTES,     # launch_bbq sets it
        active=lambda p: p["z"] * R + p["row"] < h,
        in_specs=(
            Operand("idx", (n, h, w), (1, 1, sc),
                    lambda p: (scan_cta(p)[0], p["z"] * R + p["row"],
                               scan_cta(p)[1]),
                    (False, False, True)),
            Operand("carry", (n, nb, w), (1, bb, sc),
                    lambda p: ((scan_cta(p)[0], p["y"], scan_cta(p)[1])
                               if p["row"] == 0 else None),
                    (False, True, True)),
        ),
        out_specs=(Operand(
            "out", (n, nb, h, w), (1, bb, 1, sc),
            lambda p: (scan_cta(p)[0], p["y"], p["z"] * R + p["row"],
                       scan_cta(p)[1]),
            (False, True, False, True)),),
        carry_reads=scan_reads,
        carry_writes=lambda p: [("V", p["x"], p["y"], p["z"])]))
    return tuple(specs)

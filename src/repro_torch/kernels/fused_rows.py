"""K2: the query-fused integral histogram — only the requested rows of H.

Replaces ``repro/kernels/fused_rows.py::fused_rows_pallas`` (body
``_fused_rows_kernel``, host ``slot_plan``).  Source:
``csrc/fused_rows.cu``, built for ``sm_90a`` by ``kernels/_build.py``.

What bounds it on an H100: bytes, once nothing walks.  It reads the bin
ids of the rows down to the last requested one and writes ``num_bins *
len(rows) * w`` floats, usually a small fraction of H.  A walk down those
rows (the TPU kernel's sequential grid, and this port's first K2) costs
about half a microsecond a row whatever it emits, so the design has none.
A row scan is linear: row ``rows[i]`` of H is the carry row plus the sum,
over row chunks above it, of each chunk's row-scanned column counts.  The
host cuts the rows into chunks that end at every requested row
(``chunk_plan``, cached by the rows, copied with the launch from pageable
memory without a stream sync); pass A counts and row-scans every chunk at
once (one CTA per frame, chunk and bin block), pass B sums them down the
chunk axis (one thread per frame, bin and 4 columns) from the carry and
writes the requested rows: two CUDA launches a call, no CTA waiting on
another.  The TPU kernel's per-strip slot slabs and one-hot selection
matmul exist only because a TPU has no dynamic sublane gather; here each
chunk carries the output slot of the row it ends.

``fused_rows_cuda`` launches the kernels for a CUDA tensor and runs
``fused_rows_plain`` (K1's plain version, then the rows) only for a CPU
tensor; a meta tensor gets the launch's checks and a meta result, no
launch.  ``fused_rows_cuda.launches`` counts calls that launched them.
``kernel_specs`` states the two launches for kernelcheck.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import wf_tis
from repro_torch.kernels.specs import (
    KernelGeometry,
    KernelSpec,
    Operand,
    abstract_launch,
    cdiv,
)
from repro_torch.kernels.wf_tis import check_inputs, wf_tis_plain

_BIN_BLOCKS = (8, 4, 2, 1)      # instantiated bin blocks (template BB)
_MAX_THREADS = 512  # pass A threads (csrc kMaxThreads): 2048 columns a slab
_FILL_CTAS = 2 * wf_tis._SMS    # pass A CTAs a chunk cut aims for
_MAX_CHUNK_ROWS = 255           # pass A counts a chunk's hits in one byte
_SUM_THREADS = 64               # pass B threads a CTA (csrc kSumThreads)
# K1 scans at most this many columns; K2 keeps the same limit so that a
# fused and a dense plan take the same frames.
_MAX_WIDTH = wf_tis._MAX_THREADS * 4 * wf_tis._MAX_CHUNKS


def check_rows(row_ids, h: int) -> np.ndarray:
    """``row_ids`` as a host int64 array, or ValueError unless they are
    sorted unique rows in ``[0, h)``."""
    # analysis: allow-host-sync(row ids are host data, a sequence, numpy array or CPU tensor: no device readback)
    rows = np.asarray(row_ids, np.int64).reshape(-1)
    if (rows.size == 0 or np.any(np.diff(rows) <= 0) or rows[0] < 0
            or rows[-1] >= h):
        raise ValueError(
            f"row_ids must be sorted unique rows within [0, {h}), got {rows}")
    return rows


class ChunkShape(NamedTuple):
    """How a K2 call is cut: ``bin_block`` bins a pass-A CTA, ``threads``
    threads of 4 columns each, chunks of at most ``chunk_rows`` rows."""
    bin_block: int
    threads: int
    chunk_rows: int


@functools.lru_cache(maxsize=256)
def chunk_shape(w: int, num_bins: int, n: int, num_rows: int, h_run: int,
                bin_block: int | None = None) -> ChunkShape:
    """The launch for ``num_rows`` requested rows, the last ``h_run - 1``,
    of ``n`` frames ``w`` wide.

    ``bin_block=None`` takes 8, or the smallest block that holds
    ``num_bins``: eight bins fit pass A's 64 registers a thread (two
    registers of byte counts a column) and read a chunk's ids a quarter as
    often as two bins would; the width is taken slab by slab.  Chunks stay
    whole segments between requested rows (``chunk_rows = h_run``) where
    those already give pass A two CTAs an SM; otherwise ``chunk_rows`` is
    cut so that the chunks do (``chunk_plan`` makes at least ``h_run //
    chunk_rows``).  Either way a chunk holds at most 255 rows, the most
    pass A counts in a byte."""
    if w > _MAX_WIDTH:
        raise NotImplementedError(
            f"width {w} exceeds the {_MAX_WIDTH} columns one CTA scans; "
            "wider frames need column strips with a row-carry pre-pass (not "
            "ported yet)")
    if bin_block is None:
        bin_block = min(bb for bb in _BIN_BLOCKS
                        if bb >= min(num_bins, _BIN_BLOCKS[0]))
    elif bin_block not in _BIN_BLOCKS:
        raise ValueError(f"bin_block must be one of {_BIN_BLOCKS}, "
                         f"got {bin_block}")
    threads = min(_MAX_THREADS, 32 * max(1, -(-w // 128)))
    ctas = n * -(-num_bins // bin_block)
    if ctas * num_rows >= _FILL_CTAS:
        rows = h_run
    else:
        rows = max(1, h_run // -(-_FILL_CTAS // ctas))
    return ChunkShape(bin_block, threads, min(rows, _MAX_CHUNK_ROWS))


def chunk_plan(rows: np.ndarray, chunk_rows: int) -> tuple[np.ndarray,
                                                           np.ndarray]:
    """Cut rows ``[0, rows[-1]]`` into chunks that end at every requested
    row and hold at most ``chunk_rows`` rows.

    Each segment between requested rows is split into as few chunks as
    that allows, of near-equal length.  Returns int32 ``first`` (M,), each
    chunk's first row, and ``slot`` (M,): ``i`` for the chunk that ends at
    ``rows[i]``, -1 for the others."""
    start = np.concatenate(([0], rows[:-1] + 1))
    length = rows - start + 1
    pieces = -(-length // chunk_rows)
    seg = np.repeat(np.arange(rows.size), pieces)
    k = np.arange(seg.size) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    first = start[seg] + length[seg] * k // pieces[seg]
    slot = np.where(k == pieces[seg] - 1, seg, -1)
    return first.astype(np.int32), slot.astype(np.int32)


@functools.lru_cache(maxsize=256)
def _host_plan(rows_key: bytes, chunk_rows: int) -> np.ndarray:
    """``chunk_plan`` as one int32 array, ``first`` then ``slot``, cached by
    the rows' bytes: a stream asks for the same rows frame after frame."""
    plan = np.concatenate(chunk_plan(np.frombuffer(rows_key, np.int64),
                                     chunk_rows))
    plan.flags.writeable = False        # every caller shares this array
    return plan


def fused_rows_plain(idx: torch.Tensor, num_bins: int, row_ids,
                     carry: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch K2: K1's plain H, then the requested rows in order."""
    rows = torch.as_tensor(row_ids, dtype=torch.int64, device=idx.device)
    return wf_tis_plain(idx, num_bins, carry)[..., rows, :]


def _lib():
    from repro_torch.kernels import _build

    lib = _build.library("fused_rows.cu")
    fn = lib.fused_rows_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(idx: torch.Tensor, num_bins: int, rows: np.ndarray,
           shape: ChunkShape, carry: torch.Tensor | None = None
           ) -> torch.Tensor:
    """K2 on a CUDA tensor with the given ``shape`` (from ``chunk_shape``):
    the plan's copy, pass A, pass B.  ``fused_rows_cuda`` picks the shape
    and counts its calls; tests pin chunk cuts through this.  ``rows`` are
    checked int64 rows (``check_rows``).  Returns (n, num_bins, len(rows),
    w)."""
    check_inputs(idx, num_bins, carry)
    if not idx.is_cuda:
        raise ValueError("launch runs K2 on a CUDA tensor only")
    if not 1 <= shape.chunk_rows <= _MAX_CHUNK_ROWS:
        raise ValueError(f"chunk_rows must be in [1, {_MAX_CHUNK_ROWS}], got "
                         f"{shape.chunk_rows}")
    n, h, w = idx.shape
    out = torch.empty((n, num_bins, rows.size, w), dtype=torch.float32,
                      device=idx.device)
    if out.numel() == 0:
        return out
    plan = _host_plan(np.ascontiguousarray(rows, np.int64).tobytes(),
                      shape.chunk_rows)
    chunks = plan.size // 2
    plan_dev = torch.empty(plan.shape, dtype=torch.int32, device=idx.device)
    # Where every chunk ends a requested row, pass A writes the output and
    # pass B sums it in place.
    P = out if chunks == rows.size else torch.empty(
        (n, num_bins, chunks, w), dtype=torch.float32, device=idx.device)
    fn = _lib()
    with torch.cuda.device(idx.device):
        err = fn(idx.data_ptr(),
                 None if carry is None else carry.data_ptr(),
                 plan.ctypes.data, plan_dev.data_ptr(), P.data_ptr(),
                 out.data_ptr(), n, h, int(rows[-1]) + 1, w, num_bins,
                 chunks, rows.size, shape.bin_block, shape.threads,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            f"fused_rows kernel launch failed: CUDA error {err}")
    return out


def fused_rows_work(n: int, w: int, num_bins: int, row_ids, *,
                    carry: bool = False) -> dict:
    """What K2's function must do: the ids of rows [0, row_ids[-1]] (and
    the carry) read once, the requested rows written once; one add per
    element of the scanned run's H and one per emitted element."""
    h_run, k = int(row_ids[-1]) + 1, len(row_ids)
    return {"bytes": 4 * n * w * (h_run + num_bins * k)
            + (4 * n * num_bins * w if carry else 0),
            "flops": n * num_bins * h_run * w + n * num_bins * k * w}


def fused_rows_cuda(idx: torch.Tensor, num_bins: int, row_ids, *,
                    bin_block: int | None = None,
                    carry: torch.Tensor | None = None) -> torch.Tensor:
    """The rows ``row_ids`` of the integral histogram, in that order.

    Args:
      idx: (n, h, w) contiguous int32 bin ids (any value outside
        [0, num_bins) matches no bin).
      row_ids: sorted unique rows in [0, h), on the host (a sequence, a
        numpy array or a CPU tensor): they are checked and cut into the
        kernels' chunk plan, whose copy does not wait on the card.
      bin_block: bins a pass-A CTA counts (1, 2, 4 or 8), ``None`` to pick.
      carry: optional (n, num_bins, w) fp32 band carry-in.

    Returns:
      (n, num_bins, len(row_ids), w) fp32.  A CPU tensor runs
      ``fused_rows_plain``.
    """
    check_inputs(idx, num_bins, carry)
    n, h, w = idx.shape
    rows = check_rows(row_ids, h)
    if not (idx.is_cuda or idx.is_meta):
        return fused_rows_plain(idx, num_bins, rows, carry)
    shape = chunk_shape(w, num_bins, n, rows.size, int(rows[-1]) + 1,
                        bin_block)
    if not idx.is_cuda:     # meta: the launch's checks ran, nothing launches
        abstract_launch("fused_rows", fused_rows_work(
            n, w, num_bins, rows, carry=carry is not None))
        return torch.empty((n, num_bins, rows.size, w), dtype=torch.float32,
                           device=idx.device)
    out = launch(idx, num_bins, rows, shape, carry)
    fused_rows_cuda.launches += 1
    return out


fused_rows_cuda.launches = 0


def resolve_geometry(geom: KernelGeometry) -> KernelGeometry:
    """``geom`` (with its requested ``rows``) with K2's launch filled in
    as ``fused_rows_cuda`` picks it (``chunk_shape``)."""
    if geom.threads is not None:
        return geom
    rows = check_rows(geom.rows, geom.h)
    shape = chunk_shape(geom.w, geom.num_bins, geom.n, rows.size,
                        int(rows[-1]) + 1, geom.bin_block)
    # analysis: allow-host-sync(check_rows gives a host numpy array: no device readback)
    rows = tuple(rows.tolist())
    return dataclasses.replace(
        geom, rows=rows, bin_block=shape.bin_block,
        threads=shape.threads, strip_rows=shape.chunk_rows,
        col_block=4 * shape.threads)


def kernel_specs(geom: KernelGeometry) -> tuple[KernelSpec, ...]:
    """K2's two launches at ``geom`` (csrc/fused_rows.cu): pass A
    ``chunk_kernel``, one CTA per (frame, chunk, bin block) on grid x,
    walking its column slabs and, in each, the chunk's rows (counts carried
    along the rows, slab totals along the slabs), writing P; pass B
    ``sum_kernel``, one thread per (frame, bin, 4 columns), walking the
    chunks with its running sum and reading each chunk's P (edges to pass
    A) to write the requested rows.  The chunks are ``chunk_plan``'s."""
    g = resolve_geometry(geom)
    n, h, w, nb = g.n, g.h, g.w, g.num_bins
    bb, T, slab = g.bin_block, g.threads, g.col_block
    # analysis: allow-host-sync(the spec's rows are a host tuple; kernelcheck builds specs off the launch path)
    rows = np.asarray(g.rows, np.int64)
    # The wrapper's own cached chunk plan: a gate that builds this spec
    # just before the launch leaves the launch a cache hit.
    plan = _host_plan(rows.tobytes(), g.strip_rows)
    M, K = plan.size // 2, rows.size
    # analysis: allow-host-sync(the chunk plan is a host numpy array: no device readback)
    first, slot = plan[:M].tolist(), plan[M:].tolist()
    lens = [e - b for b, e in zip(first, first[1:] + [int(rows[-1]) + 1])]
    blocks, S = cdiv(nb, bb), cdiv(w, slab)

    def cta(x):
        fm, bblk = divmod(x, blocks)
        f, m = divmod(fm, M)
        return f, m, bblk

    def last_row(p):
        return p["row"] == lens[cta(p["x"])[1]] - 1

    def a_reads(p):
        x, s, r = p["x"], p["slab"], p["row"]
        reads = []
        if r > 0:
            reads.append((("pk", x), {"x": x, "slab": s, "row": r - 1}))
        if s > 0 and last_row(p):
            reads.append((("before", x), {"x": x, "slab": s - 1,
                                          "row": p["row"]}))
        return reads

    def a_writes(p):
        cells = [("pk", p["x"])]
        if last_row(p):
            f, m, bblk = cta(p["x"])
            cells += [("before", p["x"]), ("P", f, bblk, m, p["slab"])]
        return cells

    def a_out(p):
        if not last_row(p):
            return None
        f, m, bblk = cta(p["x"])
        return (f, bblk, m, p["slab"])

    pass_a = KernelSpec(
        name="fused_rows/chunks", kernel="chunk_kernel",
        grid=(("x", n * M * blocks),),
        loops=(("slab", S), ("row", max(lens))), threads=T, geometry=g,
        smem_static=4 * 2 * bb * 32,            # warp_tot[2 * BB * 32]
        active=lambda p: p["row"] < lens[cta(p["x"])[1]],
        in_specs=(Operand(
            "idx", (n, h, w), (1, 1, slab),
            lambda p: (cta(p["x"])[0], first[cta(p["x"])[1]] + p["row"],
                       p["slab"]),
            (False, False, True)),),
        out_specs=(Operand("P", (n, nb, M, w), (1, bb, 1, slab), a_out,
                           (False, True, False, True)),),
        carry_reads=a_reads, carry_writes=a_writes)

    ncol = cdiv(w, 4)
    items = n * nb * ncol

    def b_reads(p):
        x, m = p["x"], p["chunk"]
        reads = [(("acc", x), {"x": x, "chunk": m - 1})] if m > 0 else []
        a, b = x * _SUM_THREADS, min(items, (x + 1) * _SUM_THREADS)
        for plane in range(a // ncol, (b - 1) // ncol + 1):
            f, bin_ = divmod(plane, nb)
            c0 = max(a, plane * ncol) - plane * ncol
            c1 = min(b, (plane + 1) * ncol) - plane * ncol
            for s in range(4 * c0 // slab, (4 * (c1 - 1)) // slab + 1):
                reads.append((("P", f, bin_ // bb, m, s), {
                    "pass": pass_a.name, "x": (f * M + m) * blocks
                    + bin_ // bb, "slab": s, "row": lens[m] - 1}))
        return reads

    pass_b = KernelSpec(
        name="fused_rows/sum", kernel="sum_kernel",
        grid=(("x", cdiv(items, _SUM_THREADS)),), loops=(("chunk", M),),
        threads=_SUM_THREADS, geometry=g,
        in_specs=(Operand(
            "carry", (items,), (_SUM_THREADS,),
            lambda p: (p["x"],) if p["chunk"] == 0 else None, (True,)),),
        out_specs=(Operand(
            "out", (K, items), (1, _SUM_THREADS),
            lambda p: ((slot[p["chunk"]], p["x"]) if slot[p["chunk"]] >= 0
                       else None), (False, True)),),
        carry_reads=b_reads, carry_writes=lambda p: [("acc", p["x"])])
    return pass_a, pass_b

"""Declarative launch contracts of the CUDA kernels: what kernelcheck proves.

Port of ``repro/kernels/specs.py``, restated for CUDA.  The reference's
model is a sequential grid whose last dimension runs innermost, and its
kernels carry values in VMEM from one grid step to the next.  On a GPU the
CTAs of a launch run in parallel and in no order, so this model separates
what runs in parallel from what runs in order:

  * ``grid``: the CUDA grid, dimensions x, y, z.  Unordered.
  * ``warps``: where a CTA's warps each take a unit of their own with no
    barrier between them (K4's hscan), the warps of one CTA.  Unordered,
    like the grid; not part of the CUDA grid.
  * ``loops``: the serial loops inside one CTA, outer first: K1's row walk
    down its strip, K2's walk over column slabs and the rows of its chunk,
    the grid-stride loops of K3 and K4's vscan.
  * ``threads`` and the static and dynamic shared bytes of the launch, and
    whether the launch opts in to more than 48 KiB of dynamic shared memory
    (``cudaFuncAttributeMaxDynamicSharedMemorySize``).
  * A method with two launches is a tuple of specs in stream order: K1's
    count pre-pass, then its strips; K2's pass A, then pass B; K4's hscan,
    then vscan.  A later launch may read what an earlier one wrote.

A step is one CTA (a grid point; with ``warps``, one warp of it) at one
iteration of its loops.  Operands are in element units over the logical,
unpadded shapes: nothing is padded to tiles.  A block is what one step
touches; a dimension is ``guarded`` when the kernel masks the ragged last
block (``c < w`` and the like).  An index map returns the block a step
touches, or ``None`` where the step does not touch the operand.
``active`` is the kernel's own loop bound (``r < r_end``, ``t < total``):
inactive steps do nothing.

Grid-stride kernels (K3, K4's vscan, K2's pass B) give each thread one
work item at a time; their operands are declared over the flat item space
(``(items,)`` with a block of one CTA's threads), and the item index
decomposes mixed-radix into (plane, rows, 4 columns), so an item covered
once is an element range covered once.

Carry edges are ``(cell, producer)`` pairs: the value step ``g`` consumes
and the step whose write it must be.  A producer is a point of the same
CTA at an earlier iteration of its loops, or, with a ``"pass"`` key, a
point of an earlier launch of the method.  ``kernelcheck`` fails an edge
whose producer is another CTA of the same launch: CTAs have no order.

Stdlib only: a spec is data and plain callables.  Each kernel module builds
its specs in ``kernel_specs(geom)`` from the functions its wrapper launches
with, so the spec has no second formula to drift.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Mapping, Sequence

#: shared memory one CTA of an H100 may use, with the opt-in (227 KiB).
SMEM_LIMIT_BYTES = 232_448
#: dynamic shared memory a launch may take without the opt-in.
SMEM_DEFAULT_BYTES = 48 * 1024
#: 32-bit registers of one streaming multiprocessor.
REGISTERS_PER_SM = 65_536

#: Observers of abstract launches.  A kernel's wrapper given meta tensors
#: runs its launch's checks, returns meta results and, instead of
#: launching, calls ``abstract_launch`` with the kernel's name and its work
#: (the ``*_work`` function beside the wrapper): how the dry run's counting
#: mode (launch/analysis.py) counts a kernel as the kernel, not as aten ops.
ABSTRACT_LAUNCH_OBSERVERS: list = []


def abstract_launch(name: str, work: dict) -> None:
    """Tell every observer that kernel ``name`` would have launched doing
    ``work`` ({"bytes": ..., "flops": ...})."""
    for observer in ABSTRACT_LAUNCH_OBSERVERS:
        observer(name, work)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _clamp_extent(size: int, block: int, max_blocks: int,
                  new_block: int | None = None) -> int:
    """An extent of at most ``max_blocks`` blocks of ``new_block`` (default
    ``block``) that keeps a ragged last block ragged."""
    nb = new_block or block
    count = min(cdiv(size, block), max_blocks)
    ragged = size % block
    last = min(ragged, nb - 1) if ragged and nb > 1 else nb
    return (count - 1) * nb + max(last, 1)


@dataclasses.dataclass(frozen=True)
class KernelGeometry:
    """The logical shape of one call and its resolved launch.

    ``n``/``h``/``w``/``num_bins`` are the call's sizes.  The launch fields
    are ``None`` until a kernel module's ``kernel_specs`` resolves them
    with the same functions its wrapper launches with (K1's
    ``launch_shape``, K2's ``chunk_shape``, K4's ``hscan_shape``):

      * ``bin_block``, ``threads``, ``chunks``: bins and threads a CTA,
        4-column chunks a thread (K1; K2's pass A and K4's hscan take
        ``bin_block`` and ``threads``).
      * ``strip_rows``: rows one CTA walks (K1's strips, K3's rows a work
        item, K2's longest chunk).
      * ``rows``: K2's requested rows.
      * ``col_block``: columns of the launch's column blocks (K1's count
        pre-pass, K2's slabs, K4's hscan chunks, 4 for the grid-stride
        kernels' items).
      * ``strip_cols``: columns one CTA scans at a time (K1's column
        strips; the width where one CTA spans it).
      * ``max_blocks``, ``stride_threads``: CTAs and threads of a
        grid-stride launch (K3, K4's vscan).
    """

    n: int
    h: int
    w: int
    num_bins: int
    bin_block: int | None = None
    threads: int | None = None
    chunks: int | None = None
    strip_rows: int | None = None
    rows: tuple[int, ...] | None = None
    col_block: int | None = None
    max_blocks: int | None = None
    stride_threads: int | None = None
    strip_cols: int | None = None

    def canonical(self, max_blocks: int = 3) -> "KernelGeometry":
        """The reduced geometry that enumeration runs on (a resolved one
        in, a resolved one out): the frame count pinned to 2 (a second
        frame exercises every per-frame offset), at most ``max_blocks``
        blocks along every grid dimension (bin blocks, strips, column
        blocks, grid-stride CTAs) and along every serial loop (rows a CTA
        walks, K2's chunks; grid-stride CTAs of 4 threads, so that the
        stride loop turns), ragged last blocks kept ragged.  The launch's
        own block sizes stay: K1's CTA still spans ``threads * 4 *
        chunks`` columns.  Column strips are the exception: a geometry
        cut into them keeps two or three, each two column blocks wide,
        so that an edge from one strip to the next stays in view.
        Enumeration then takes O(100) steps at any frame size."""
        bb = self.bin_block or 1
        sr = self.strip_rows
        rows = self.rows
        if rows is not None:
            # Keep the first three requested rows with their gaps cut to at
            # most two chunks and a row: a gap still splits into chunks.
            sr_c = min(sr or 1, max_blocks)
            out, prev, prev_c = [], -1, -1
            for r in rows[:max_blocks]:
                gap = min(r - prev, 2 * sr_c + 1)
                prev_c += gap
                out.append(prev_c)
                prev = r
            h = out[-1] + 1 + (1 if self.h > rows[-1] + 1 else 0)
            rows, sr = tuple(out), sr_c
        elif sr is not None:
            h = _clamp_extent(self.h, sr, max_blocks, min(sr, max_blocks))
            sr = min(sr, max_blocks)
        else:
            h = min(self.h, max_blocks)
        w, sc = self.w, self.strip_cols
        if sc is not None and sc < self.w:
            new_sc = 2 * (self.col_block or 1)
            w = _clamp_extent(self.w, sc, max_blocks, new_sc)
            sc = new_sc
        elif self.col_block is not None:
            w = _clamp_extent(self.w, self.col_block, max_blocks)
        return dataclasses.replace(
            self, n=2, h=h, w=w, num_bins=min(self.num_bins, max_blocks * bb),
            strip_rows=sr, rows=rows, strip_cols=sc,
            max_blocks=(None if self.max_blocks is None
                        else min(self.max_blocks, max_blocks)),
            stride_threads=(None if self.stride_threads is None
                            else min(self.stride_threads, 4)))

    def describe(self) -> str:
        parts = [f"{k.replace('_', ' ')} {v}" for k, v in (
            ("bin_block", self.bin_block), ("threads", self.threads),
            ("chunks", self.chunks), ("strip_rows", self.strip_rows),
            ("strip_cols", self.strip_cols),
            ("max_blocks", self.max_blocks)) if v is not None]
        if self.rows is not None:
            parts.append(f"{len(self.rows)} row(s)")
        return ", ".join(parts) or "unresolved"


@dataclasses.dataclass(frozen=True)
class Operand:
    """One operand a launch reads or writes, in element units.

    ``index_map(point)`` gives the block index a step touches (or
    ``None``); ``guarded[d]`` says the kernel masks a ragged last block
    along dimension ``d``."""

    name: str
    shape: tuple[int, ...]
    block: tuple[int, ...]
    index_map: Callable[[Mapping[str, int]], tuple[int, ...] | None]
    guarded: tuple[bool, ...] = ()

    def is_guarded(self, dim: int) -> bool:
        return dim < len(self.guarded) and self.guarded[dim]


#: a carry cell key: hashable, first element names the buffer.
Cell = tuple
#: carry reads at one step: (cell, producer point) pairs; a producer of an
#: earlier launch carries that launch's spec name under "pass".
CarryReads = Callable[[Mapping[str, int]], Sequence[tuple[Cell, Mapping]]]
#: carry writes at one step: cells (re)written.
CarryWrites = Callable[[Mapping[str, int]], Sequence[Cell]]


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """The declarative contract of one CUDA launch.

    ``kernel`` is the CUDA function's name as a profiler trace shows it;
    ``grid`` its grid dimensions x, y, z as ``(name, size)`` pairs;
    ``warps`` a CTA's independent warps, if each walks a unit of its own;
    ``loops`` the serial loops of one CTA (or warp), outer first.
    ``geometry`` is the resolved geometry the spec was built at."""

    name: str
    kernel: str
    grid: tuple[tuple[str, int], ...]
    loops: tuple[tuple[str, int], ...]
    threads: int
    in_specs: tuple[Operand, ...]
    out_specs: tuple[Operand, ...]
    geometry: KernelGeometry
    warps: tuple[tuple[str, int], ...] = ()
    smem_static: int = 0
    smem_dynamic: int = 0
    smem_opt_in: bool = False
    active: Callable[[Mapping[str, int]], bool] | None = None
    carry_reads: CarryReads | None = None
    carry_writes: CarryWrites | None = None

    @functools.cached_property
    def dim_names(self) -> tuple[str, ...]:
        return tuple(name for name, _ in self.grid)

    @functools.cached_property
    def unit_names(self) -> tuple[str, ...]:
        """The indices of one walker, which runs in no order with the
        others: grid dimensions, then warps."""
        return self.dim_names + tuple(name for name, _ in self.warps)

    @functools.cached_property
    def loop_names(self) -> tuple[str, ...]:
        return tuple(name for name, _ in self.loops)

    @functools.cached_property
    def step_names(self) -> tuple[str, ...]:
        """The names of a step's indices: grid dimensions, warps, then
        loops."""
        return self.unit_names + self.loop_names

    @property
    def cuda_grid(self) -> tuple[int, int, int]:
        sizes = [size for _, size in self.grid]
        return tuple(sizes + [1] * (3 - len(sizes)))

    @property
    def ctas(self) -> int:
        return math.prod(size for _, size in self.grid)

    def smem_bytes(self) -> int:
        """Shared memory one CTA takes: static plus dynamic."""
        return self.smem_static + self.smem_dynamic

    def smem_detail(self) -> str:
        return (f"{self.smem_static} B static + {self.smem_dynamic} B dynamic"
                + (", opt-in set" if self.smem_opt_in else ""))

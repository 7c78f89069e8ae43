"""The dense likelihood map as one hand-written CUDA kernel launch.

Replaces no TPU kernel: the reference computes a likelihood map with XLA
ops (``repro/core/region_query.py::likelihood_map`` over
``repro/core/distances.py::intersection``).  Source: ``csrc/window_map.cu``,
built for ``sm_90a`` by ``kernels/_build.py``.

``window_map_cuda(H, target, window, stride)`` is
``intersection(sliding_window_histograms(H, window, stride), target)``
over a stored fp32 H: every (wh, ww) window's four-corner counts,
normalised, intersected with the normalised target and summed over the
bins, bins in order.  The plain path builds the whole window field
(frames x rows x cols x bins) and passes over it some fifteen times; the
kernel reads H once and writes only the map.  Where H holds integer counts
below 2^24, as every exact integral histogram does, the two are equal bit
for bit (the source's header says why).

What bounds it on an H100: bytes, H read once.  A lane owns an output
column and walks a chain of output rows ``q`` apart.  Where the window
height is a multiple of the stride (``q = wh // stride``) a step's bottom
corner row is the next step's top one, kept in registers, so each H row is
read once per column strip.  At stride 1 with up to ``REG_BINS`` bins
(``Launch.rows``) a CTA stages each corner row of every bin in shared
memory with 16-byte asynchronous copies; otherwise each warp loads its own
corners (the walk kernel).  ``launch_shape`` makes the choice from the
call's shapes.

``window_map_cuda`` launches the kernel for a CUDA tensor and runs
``window_map_plain`` for any other.  A host target (NumPy or a
CPU tensor) reaches the card through pinned memory, with no wait on the
card.  ``window_map_cuda.launches`` counts kernel launches.
``kernel_specs`` states the launch for kernelcheck.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.specs import (
    SMEM_DEFAULT_BYTES,
    SMEM_LIMIT_BYTES,
    KernelGeometry,
    KernelSpec,
    Operand,
    cdiv,
)

ROW_THREADS = 128        # rows kernel: output columns (threads) a CTA
ROW_STAGES = 2           # rows kernel: corner rows in flight (csrc kStages)
WARPS = 4                # walk kernel: chains a CTA, one warp each
LANES = 32               # walk kernel: output columns a chain
MAX_STEPS = 32           # output rows a chain walks at most
REG_BINS = 32            # bins the kernels keep in registers
_GRID_YZ_LIMIT = 65535   # CUDA's limit on grid dimensions y and z


class Launch(NamedTuple):
    """How one call is cut.  ``units`` chains of at most ``steps`` output
    rows ``q`` apart cover the map's rows once (unit ``piece * q + rho``
    walks rows ``rho + (piece * steps + k) * q``); ``reuse``: a step's
    bottom corner row is the next step's top one.  ``rows``: the rows
    kernel, one chain and ``ROW_THREADS`` columns a CTA, each corner row
    of a bin ``span`` floats in shared memory; else the walk kernel,
    ``WARPS`` chains of ``LANES`` columns a CTA."""

    rows: bool
    q: int
    steps: int
    units: int
    reuse: bool
    span: int

    def grid(self, n: int, n_c: int) -> tuple[int, int, int]:
        if self.rows:
            return cdiv(n_c, ROW_THREADS), self.units, n
        return cdiv(n_c, LANES), cdiv(self.units, WARPS), n

    @property
    def threads(self) -> int:
        return ROW_THREADS if self.rows else WARPS * LANES

    def smem_bytes(self, num_bins: int) -> int:
        """The normalised target and its NaN flag in whole 16-byte chunks,
        then (rows kernel) ``ROW_STAGES`` corner rows of every bin."""
        tpad = (num_bins + 4) // 4 * 4
        return 4 * (tpad + (ROW_STAGES * num_bins * self.span
                            if self.rows else 0))


def window_map_plain(H: torch.Tensor, target, window, stride: int = 1
                     ) -> torch.Tensor:
    """Plain torch map: the strided-slice window histograms scored by
    ``distances.intersection`` (``region_query.likelihood_map``'s plain
    path)."""
    from repro_torch.core import distances
    from repro_torch.core import region_query as rq

    hists = rq.sliding_window_histograms(H, window, stride)
    return distances.intersection(hists, rq._target(target, hists))


def map_shape(h: int, w: int, window, stride: int) -> tuple[int, int]:
    """(rows, cols) of the window grid; either is at most 0 when the window
    is larger than the frame."""
    return (h - window[0]) // stride + 1, (w - window[1]) // stride + 1


def launch_shape(n_r: int, window, stride: int, num_bins: int, w: int, *,
                 aligned: bool = True) -> Launch:
    """The launch over ``n_r`` output rows of a ``w``-column H.

    Where the bins fit the registers and ``stride`` divides the window
    height, chains step ``q = wh // stride`` rows and carry their corner
    row; otherwise ``q = 1`` and each step loads all four corners.  The
    rows kernel takes stride 1, bins in registers, rows of whole 16-byte
    chunks (``w % 4 == 0`` and an ``aligned`` H) and corner rows that fit
    shared memory."""
    wh, ww = window
    reuse = num_bins <= REG_BINS and wh % stride == 0
    q = wh // stride if reuse else 1
    chain = cdiv(n_r, q)
    steps = min(chain, MAX_STEPS)
    units = q * cdiv(chain, steps)
    span = (ROW_THREADS + ww + 6 + 3) // 4 * 4
    rows = Launch(True, q, steps, units, reuse, span)
    if (reuse and stride == 1 and w % 4 == 0 and aligned
            and units <= _GRID_YZ_LIMIT
            and rows.smem_bytes(num_bins) <= SMEM_LIMIT_BYTES):
        return rows
    return Launch(False, q, steps, units, reuse, 0)


def window_map_work(n: int, num_bins: int, h: int, w: int, n_r: int,
                    n_c: int) -> dict:
    """What the map must do: H read once, the map written once; a bin of a
    window takes three corner adds, its share of N, a product, a minimum
    and an add."""
    return {"bytes": 4 * (n * num_bins * h * w + n * n_r * n_c),
            "flops": 7 * n * n_r * n_c * num_bins}


def check_inputs(H: torch.Tensor, window, stride: int) -> None:
    """The kernel's input contract, checked before any pointer is passed."""
    if H.ndim < 3 or H.dtype != torch.float32:
        raise ValueError(
            f"H must be a (..., b, h, w) float32 tensor, got "
            f"{tuple(H.shape)} {H.dtype}")
    if not H.is_contiguous():
        raise ValueError(
            f"H {tuple(H.shape)} with strides {H.stride()} is not "
            "contiguous")
    wh, ww = window
    if not all(isinstance(v, (int, np.integer)) and v > 0
               for v in (wh, ww, stride)):
        raise ValueError(
            f"window {tuple(window)} and stride {stride!r} must be positive "
            "integers")


def _broadcastable(shape, to) -> bool:
    return len(shape) <= len(to) and all(
        a in (1, b) for a, b in zip(reversed(shape), reversed(to)))


def _target_on(target, H: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The target as fp32 on H's device: (b,) with frame stride 0, or one
    row a frame (H's leading axes flattened) with stride b.  A host target
    goes through pinned memory and an asynchronous copy, so the host does
    not wait on the card's queue."""
    lead, nb = tuple(H.shape[:-3]), H.shape[-3]
    t = torch.as_tensor(target)
    if not (t.ndim >= 1 and t.shape[-1] == nb
            and _broadcastable(t.shape, lead + (nb,))):
        raise ValueError(
            f"target {tuple(t.shape)} is neither ({nb},) nor broadcast to "
            f"H's frames {lead + (nb,)}")
    t = t.to(torch.float32)
    if t.ndim > 1:
        t = t.broadcast_to(lead + (nb,)).reshape(-1, nb)
    t = t.contiguous()
    if t.device != H.device:
        if H.is_cuda:
            t = t.pin_memory().to(H.device, non_blocking=True)
        else:
            t = t.to(H.device)
    return t, 0 if t.ndim == 1 else nb


def _lib():
    from repro_torch.kernels import _build

    fn = _build.library("window_map.cu").window_map_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_void_p] + [ctypes.c_int] * 14
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def window_map_cuda(H: torch.Tensor, target, window, stride: int = 1
                    ) -> torch.Tensor:
    """Likelihood map of every (wh, ww) window at ``stride`` against
    ``target`` by histogram intersection.

    Args:
      H: (..., b, h, w) contiguous float32 integral histogram.
      target: (b,) or a target a frame, (..., b) with H's leading axes (or
        broadcast to them); a tensor or anything ``torch.as_tensor`` takes.
      window: (wh, ww); stride: positive int.

    Returns:
      (..., n_rows, n_cols) float32, equal to ``window_map_plain`` bit for
      bit where H holds integer counts below 2^24; empty where the window
      is larger than the frame.  A tensor off the card runs
      ``window_map_plain``.
    """
    check_inputs(H, window, stride)
    if not H.is_cuda:
        return window_map_plain(H, target, window, stride)
    lead, (nb, h, w) = tuple(H.shape[:-3]), H.shape[-3:]
    n = int(np.prod(lead, dtype=np.int64))
    n_r, n_c = map_shape(h, w, window, stride)
    t, t_stride = _target_on(target, H)
    if n_r <= 0 or n_c <= 0 or n == 0:
        return torch.zeros(lead + (max(n_r, 0), max(n_c, 0)),
                           dtype=torch.float32, device=H.device)
    shape = launch_shape(n_r, window, stride, nb, w,
                         aligned=H.data_ptr() % 16 == 0)
    _, gy, gz = shape.grid(n, n_c)
    if max(gy, gz) > _GRID_YZ_LIMIT \
            or shape.smem_bytes(nb) > SMEM_DEFAULT_BYTES and not shape.rows:
        raise ValueError(
            f"{n} frames, {shape.units} row chains or {nb} bins exceed the "
            f"launch's limits ({_GRID_YZ_LIMIT} CTAs along grid y and z, "
            f"the target in {SMEM_DEFAULT_BYTES} B of shared memory)")
    out = torch.empty(lead + (n_r, n_c), dtype=torch.float32,
                      device=H.device)
    fn = _lib()
    with torch.cuda.device(H.device):
        err = fn(H.data_ptr(), t.data_ptr(), t_stride, out.data_ptr(), n,
                 nb, h, w, window[0], window[1], stride, n_r, n_c, shape.q,
                 shape.steps, shape.units, int(shape.reuse), shape.span,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            f"window_map kernel launch failed: CUDA error {err}")
    window_map_cuda.launches += 1
    return out


window_map_cuda.launches = 0


def kernel_specs(geom: KernelGeometry, window, stride: int = 1
                 ) -> tuple[KernelSpec, ...]:
    """The launch at ``geom`` (``n`` frames of an aligned (b, h, w) H) for
    ``window`` and ``stride`` (csrc/window_map.cu), grid (column strips,
    chains, frames):

      * ``window_map_rows_kernel``: a CTA walks its chain's loads, the top
        corner row of its first output, then each output's bottom one; at
        load ``l`` it reads the stage buffer load ``l - 1`` filled (and
        fills the other with load ``l + 1``), reads each lane's top corners
        from its registers, writes output ``l - 1`` of its ``ROW_THREADS``
        columns and carries the row to the next load.  A load reads whole
        16-byte chunks of every bin's row from the chunk holding column
        ``j0 - 1`` (the first and last columns declared).
      * ``window_map_walk_kernel``: each lane of ``WARPS`` warps an
        unordered walker of its column down its chain's steps, reading four
        corners of every bin a step (block (1, b, 1, 1)), or, with
        ``reuse``, the bottom two, the top two carried in its registers
        from its previous step; one map element a step.

    A launch has chains of at most ``MAX_STEPS`` steps and ``LANES`` lanes
    a warp; the tests shorten both to enumerate a small geometry.
    """
    n, h, w, nb = geom.n, geom.h, geom.w, geom.num_bins
    wh, ww = window
    s = stride
    n_r, n_c = map_shape(h, w, window, s)
    if n_r <= 0 or n_c <= 0:
        raise ValueError(f"window {tuple(window)} does not fit {h}x{w}: "
                         "the map is empty and nothing launches")
    shape = launch_shape(n_r, window, s, nb, w)
    q, steps, units, lanes = shape.q, shape.steps, shape.units, LANES
    smem = shape.smem_bytes(nb)
    g = dataclasses.replace(geom, threads=shape.threads, strip_rows=steps,
                            col_block=ROW_THREADS if shape.rows else lanes)
    if shape.rows:
        return (_rows_spec(g, window, shape, smem),)
    walker = ("x", "y", "z", "warp", "lane")

    def unit(p):
        return p["y"] * WARPS + p["warp"]

    def row(p):                     # the output row of a step
        u = unit(p)
        return u % q + (u // q * steps + p["step"]) * q

    def col(p):
        return p["x"] * lanes + p["lane"]

    def active(p):
        return unit(p) < units and col(p) < n_c and row(p) < n_r

    def corner(bottom, right):
        def index(p):
            i, j = row(p), col(p)
            r = i * s + wh - 1 if bottom else i * s - 1
            c = j * s + ww - 1 if right else j * s - 1
            if r < 0 or c < 0 or (not bottom and shape.reuse
                                  and p["step"] > 0):
                return None         # a virtual corner, or carried
            return p["z"], 0, r, c
        return index

    def carry_reads(p):
        if p["step"] == 0:
            return []
        me = {d: p[d] for d in walker}
        return [(("top",) + tuple(me.values()), {**me, "step": p["step"] - 1})]

    def carry_writes(p):
        return [("top",) + tuple(p[d] for d in walker)]

    corners = tuple(
        Operand(f"H {'bottom' if b else 'top'} {'right' if r else 'left'}",
                (n, nb, h, w), (1, nb, 1, 1), corner(b, r))
        for b in (True, False) for r in (True, False))
    return (KernelSpec(
        name="window_map", kernel="window_map_walk_kernel",
        grid=(("x", cdiv(n_c, lanes)), ("y", cdiv(units, WARPS)), ("z", n)),
        warps=(("warp", WARPS), ("lane", lanes)),
        loops=(("step", steps),), threads=WARPS * lanes, geometry=g,
        smem_dynamic=smem, smem_opt_in=smem > SMEM_DEFAULT_BYTES,
        active=active, in_specs=corners,
        out_specs=(Operand("map", (n, n_r, n_c), (1, 1, 1),
                           lambda p: (p["z"], row(p), col(p))),),
        carry_reads=carry_reads if shape.reuse else None,
        carry_writes=carry_writes if shape.reuse else None),)


def _rows_spec(g: KernelGeometry, window, shape: Launch,
               smem: int) -> KernelSpec:
    """``kernel_specs``' rows kernel (stride 1)."""
    n, h, w, nb = g.n, g.h, g.w, g.num_bins
    wh, ww = window
    n_r, n_c = map_shape(h, w, window, 1)
    q, steps = shape.q, shape.steps
    cta = ("x", "y", "z")

    def output(p, load):            # the output row of a load's chain step
        u = p["y"]
        return u % q + (u // q * steps + load) * q

    def corner_row(p):              # the row a load brings in
        i = output(p, max(p["load"] - 1, 0))
        return i - 1 if p["load"] == 0 else i + wh - 1

    def active(p):                  # a chain's first output, then each one
        return output(p, max(p["load"] - 1, 0)) < n_r

    def cols(p):                    # a0 .. a1 - 1, the columns the lanes need
        j0 = p["x"] * ROW_THREADS
        return (j0 - 1) // 4 * 4, min(w, j0 + ROW_THREADS + ww - 1)

    def first_col(p):
        r = corner_row(p)
        return None if r < 0 else (p["z"], 0, r, max(cols(p)[0], 0))

    def last_col(p):                # the end of the last whole chunk
        r = corner_row(p)
        a0, a1 = cols(p)
        return None if r < 0 else (p["z"], 0, r, a0 + 4 * cdiv(a1 - a0, 4) - 1)

    def written(p):
        return None if p["load"] == 0 else (
            p["z"], output(p, p["load"] - 1), p["x"])

    def carry_reads(p):
        if p["load"] == 0:
            return []
        me = {d: p[d] for d in cta}
        prev = {**me, "load": p["load"] - 1}
        return [(("top",) + tuple(me.values()), prev),
                (("stage", p["load"] % ROW_STAGES) + tuple(me.values()),
                 prev)]

    def carry_writes(p):
        me = tuple(p[d] for d in cta)
        return [("top",) + me,
                ("stage", (p["load"] + 1) % ROW_STAGES) + me]

    return KernelSpec(
        name="window_map", kernel="window_map_rows_kernel",
        grid=tuple(zip(cta, shape.grid(n, n_c))),
        loops=(("load", steps + 1),), threads=ROW_THREADS, geometry=g,
        smem_dynamic=smem, smem_opt_in=smem > SMEM_DEFAULT_BYTES,
        active=active,
        in_specs=(Operand("H first column", (n, nb, h, w), (1, nb, 1, 1),
                          first_col),
                  Operand("H last column", (n, nb, h, w), (1, nb, 1, 1),
                          last_col)),
        out_specs=(Operand("map", (n, n_r, n_c), (1, 1, ROW_THREADS),
                           written, (False, False, True)),),
        carry_reads=carry_reads, carry_writes=carry_writes)


"""The fragments tracker's vote as one hand-written CUDA kernel launch.

Replaces no TPU kernel: the reference votes with XLA ops
(``repro/core/tracking.py``).  Source: ``csrc/track_vote.cu``, built for
``sm_90a`` by ``kernels/_build.py``.

``track_vote_cuda(H, boxes, ref, fragments, radius)`` steps t targets in
each of n frames at once, each on its own frame of a stored fp32 H
(n, b, h, w): every candidate of the search square is scored by the median
of its fragments' intersections with the reference fragments, and the
first best candidate wins.  It returns (the new boxes (n, t, 4) int32,
their scores (n, t) fp32), equal bit for bit to ``tracking.vote_plain``,
the plain torch vote (the kernel's header says why).

Why a kernel: the plain vote is some forty torch launches a tick, and it
writes every candidate's fragment histograms several times over; at a
fleet's tick (32 frames of 480 x 640 at 32 bins, 4 targets each, radius
12) an H100 host takes longer to launch them than the card takes to run
them, so the host sets the tick's pace.  The kernel is one launch: a CTA
a target, a thread a candidate, the corner lattice of each bin read
straight from H, twice (the fragments' sums, then their intersections).

``track_vote_cuda`` launches the kernel for an H on the card, after
``check_inputs`` has held the call to the kernel's limits (it raises
``ValueError`` naming the limit a call breaks), and runs
``tracking.vote_plain`` for an H off the card; ``track_vote_cuda.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

MAX_GRID = 4             # fragment rows or columns the kernel unrolls
MAX_RADIUS = 511
MAX_SMEM_BYTES = 160 * 1024


def check_inputs(H: torch.Tensor, ref: torch.Tensor, fragments,
                 radius: int) -> None:
    """The kernel's limits, checked before any pointer is passed: an fp32
    H (n, b, h, w), an fp32 reference, a grid of at most ``MAX_GRID`` x
    ``MAX_GRID`` fragments, a radius of at most ``MAX_RADIUS``, and a
    target's normalised reference in ``MAX_SMEM_BYTES`` of shared memory.
    Raises ``ValueError`` naming the limit a call breaks."""
    gr, gc = fragments
    if H.ndim != 4 or H.dtype != torch.float32:
        raise ValueError(
            f"the vote kernel reads an (n, b, h, w) float32 H, got "
            f"{tuple(H.shape)} {H.dtype}")
    if ref.dtype != torch.float32:
        raise ValueError(
            f"the vote kernel reads a float32 reference, got {ref.dtype}")
    if not (1 <= gr <= MAX_GRID and 1 <= gc <= MAX_GRID):
        raise ValueError(
            f"the vote kernel takes grids of 1 to {MAX_GRID} fragments a "
            f"side, got {gr} x {gc}")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(
            f"the vote kernel takes a radius of 0 to {MAX_RADIUS}, got "
            f"{radius}")
    if 4 * gr * gc * H.shape[1] > MAX_SMEM_BYTES:
        raise ValueError(
            f"{gr} x {gc} fragments of {H.shape[1]} bins need "
            f"{4 * gr * gc * H.shape[1]} B of shared memory, above the "
            f"kernel's {MAX_SMEM_BYTES}")


def _lib():
    from repro_torch.kernels import _build

    fn = _build.library("track_vote.cu").track_vote_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def track_vote_cuda(H: torch.Tensor, boxes: torch.Tensor, ref: torch.Tensor,
                    fragments, radius: int):
    """Step every target once.

    Args:
      H: (n, b, h, w) float32 integral histogram, one frame a camera.
      boxes: (n, t, 4) int [r0, c0, r1, c1] inside the frame, on H's
        device.
      ref: the reference fragment histograms, (n, t, gr gc, b) or a shape
        that broadcasts to it, float32, on H's device.
      fragments: (gr, gc); radius: candidate offsets per axis.

    Returns:
      (boxes (n, t, 4) int32, scores (n, t) float32).  An H off the card
      runs ``tracking.vote_plain``; on the card a call past the kernel's
      limits raises ``ValueError`` (``check_inputs``).
    """
    gr, gc = (int(g) for g in fragments)
    if not H.is_cuda:
        from repro_torch.core import tracking

        return tracking.vote_plain(H, boxes, ref, (gr, gc), radius)
    check_inputs(H, ref, (gr, gc), radius)
    n, nb, h, w = H.shape
    if boxes.ndim != 3 or boxes.shape[0] != n or boxes.shape[2] != 4:
        raise ValueError(f"boxes {tuple(boxes.shape)} are not (n, t, 4) for "
                         f"{n} frames")
    t = boxes.shape[1]
    H = H.contiguous()
    boxes = boxes.to(torch.int32).contiguous()
    ref = ref.broadcast_to((n, t, gr * gc, nb))
    out_box = torch.empty((n, t, 4), dtype=torch.int32, device=H.device)
    out_score = torch.empty((n, t), dtype=torch.float32, device=H.device)
    if n * t == 0:
        return out_box, out_score
    fn = _lib()
    with torch.cuda.device(H.device):
        err = fn(H.data_ptr(), boxes.data_ptr(), ref.data_ptr(),
                 *ref.stride(), out_box.data_ptr(), out_score.data_ptr(), n,
                 t, nb, h, w, gr, gc, int(radius),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"track_vote kernel launch failed: CUDA error "
                           f"{err}")
    track_vote_cuda.launches += 1
    return out_box, out_score


track_vote_cuda.launches = 0


def track_vote_work(n: int, t: int, num_bins: int, fragments,
                    radius: int) -> dict:
    """Least bytes and operations of a vote: each candidate's corner lattice
    of every bin read once (4 B a corner), the boxes and scores written
    once; a fragment's four-corner count, its share of the sum, its
    quotient, minimum and share of the similarity a bin."""
    gr, gc = fragments
    cands = n * t * (2 * radius + 1) ** 2
    corners = cands * (gr + 1) * (gc + 1) * num_bins
    return {"bytes": 4 * corners + n * t * 20,
            "ops": cands * gr * gc * num_bins * 7}


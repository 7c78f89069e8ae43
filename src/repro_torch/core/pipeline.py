"""Double-buffered frame pipeline: paper §4.4 (dual-buffering, Fig. 12-14).

Port of ``repro/core/pipeline.py``.  The paper overlaps (host -> device),
kernel execution and (device -> host) across a frame sequence with two
CUDA streams and page-locked memory; ``core/runtime.py`` is that
scheduler.  This module keeps the historical entry points as thin
adapters over it:

  * ``DoubleBufferedExecutor``: ``depth`` dispatches in flight,
    ``batch_size`` frames stacked per dispatch; depth=1 is synchronous
    (the "no dual-buffering" baseline of Fig. 13).
  * ``prefetch_to_device`` / ``prefetch_row_bands``: the staging half of
    the overlap, for consumers that drive their own compute.

Microbatch sizing lives in the planner (``core/engine.py``), which owns
``auto_batch_size``; it is re-exported here.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator

from repro_torch.core.engine import auto_batch_size  # noqa: F401
from repro_torch.core.runtime import FrameRuntime, stack_chunks, stage_stream

__all__ = [
    "DoubleBufferedExecutor",
    "auto_batch_size",
    "stack_chunks",
    "prefetch_to_device",
    "iter_row_bands",
    "prefetch_row_bands",
]


class DoubleBufferedExecutor:
    """Apply ``fn`` over a stream of host frames with dispatch-ahead.

    Args:
      fn: with ``batch_size > 1`` it must accept stacked (k, *frame_shape)
        inputs and return outputs whose leading axis is the frame axis
        (``integral_histogram`` and ``IntegralHistogram`` both do).
      depth: number of dispatches kept in flight (1 = synchronous).
      device: where frames are staged and ``fn`` runs (``None`` = the
        card).
      batch_size: frames stacked per dispatch; the last chunk of a stream
        may be smaller.
    """

    def __init__(
        self, fn: Callable, depth: int = 2, device=None, batch_size: int = 1
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.fn = fn
        self.depth = depth
        self.batch_size = batch_size
        self.device = device

    def map(self, frames: Iterable) -> Iterator:
        """Yield fn(frame) per input frame, in order, ``depth`` dispatches
        in flight (each covering ``batch_size`` frames)."""
        return FrameRuntime(
            FrameRuntime.stateless(self.fn), depth=self.depth,
            microbatch=self.batch_size, device=self.device,
        ).map_frames(frames)


def prefetch_to_device(frames: Iterable, size: int = 2,
                       device=None) -> Iterator:
    """Stage host arrays onto the device ahead of consumption.  Exactly
    ``size`` frames are staged before the first yield and at most
    ``size`` are ever resident beyond the one in the consumer's hands;
    for ``k`` copies overlapping the consumer's compute, pass
    ``size=k + 1``."""
    return stage_stream(frames, size=size, device=device)


def iter_row_bands(image, spans) -> Iterator:
    """Host-side row-band slices ``image[..., r0:r1, :]`` of a frame or
    stack, one per (r0, r1) span (core/bands.py plans the spans)."""
    for r0, r1 in spans:
        yield image[..., r0:r1, :]


def prefetch_row_bands(image, spans, size: int = 2, device=None) -> Iterator:
    """Stage the next band's image slice onto the device while the current
    band's kernel runs: the §4.4 overlap inside one large frame.  Device
    commitment is bounded by ``size`` band slices (plus the one the
    consumer holds); the full frame never leaves the host."""
    return stage_stream(iter_row_bands(image, spans), size=size,
                        device=device)

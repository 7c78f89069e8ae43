"""One asynchronous frame runtime behind every streaming loop of the port.

Port of ``repro/core/runtime.py``.  Paper §4.4 overlaps (host -> device),
kernel execution and (device -> host) across a frame sequence with two
CUDA streams and page-locked memory.  This module is the scheduler that
``pipeline.DoubleBufferedExecutor``, ``IntegralHistogram.map_frames``,
``HistogramEngine.map_frames``, ``bands.iter_banded_ih`` and
``FragmentTracker.track`` are thin adapters over:

    FrameSource -> [microbatch] -> [H2D stage] -> [step] -> Sink
                        ^                ^           ^
                   fixed | adaptive   stage_ahead   depth-k in-flight
                                                    window + carry

  * **Bounded in-flight window**: up to ``depth`` dispatches are enqueued
    before the oldest is retired (``depth=1`` is synchronous, the "no
    dual-buffering" baseline of Fig. 13).
  * **Microbatching**: ``microbatch`` frames are stacked per dispatch;
    ``adaptive=True`` retunes the size online from measured per-dispatch
    latency (``AdaptiveMicrobatch``).
  * **Carry threading**: ``step(chunk, carry) -> (out, carry)``; the band
    loop's (b, w) bottom row and the tracker's state ride between
    dispatches as device tensors, so dispatch-ahead still overlaps.
  * **Staging on the card** (``Stager``): a host chunk is copied into one
    of a ring of pinned host buffers, then to the card with
    ``non_blocking=True`` on a copy stream of its own, and an event
    recorded after the copy; the compute stream waits on that event just
    before the chunk's ``step``.  ``stage_ahead >= 1`` keeps that many
    chunks staged beyond the dispatch window.  A pinned buffer is refilled
    only after its copy's event has completed.  Tensors already on the
    card are sliced, not copied.

Results retire in order.  ``block=True`` waits on the oldest dispatch's
own event, recorded on the compute stream just after its ``step``: not a
``torch.cuda.synchronize()``, which would also wait on the copies staged
ahead.  That wait gives backpressure and the latencies the adaptive
controller feeds on.  ``block=False`` hands back tensors with no wait.

On the CPU (``device="cpu"``) staging is a plain tensor conversion and
there is nothing to wait for.  ``device`` may also be a ``MeshPlacement``
(the reference's ``NamedSharding``, from
``distributed.band_input_sharding``): each chunk is then staged as the
sharded compute reads it, one ``Stager`` per (row strip, device) it
lands on, and a step receives a ``Placed``.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch.device import as_tensor, resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class MeshPlacement:
    """How a frame or band is laid out over a mesh before a sharded
    compute reads it (``distributed.band_input_sharding`` builds one):
    ``grid[r, j]`` is the device of shard ``j`` of row strip ``r``.  One
    strip is the whole frame, replicated over its shards (bin sharding);
    more cut the rows into equal strips (spatial sharding).  A strip is
    placed once per distinct device that reads it, not once per logical
    shard."""

    grid: np.ndarray                    # (strips, shards) of torch.device

    @property
    def strips(self) -> int:
        return self.grid.shape[0]

    @property
    def devices(self) -> list:
        """The distinct devices, in grid order."""
        return list(dict.fromkeys(self.grid.ravel()))

    def targets(self) -> list:
        """Every distinct ``(strip, device)`` a piece is placed at."""
        return [(r, d) for r in range(self.strips)
                for d in dict.fromkeys(self.grid[r])]

    def strip(self, x, r: int):
        """Rows of strip ``r`` of ``x`` (``(..., h, w)``)."""
        if self.strips == 1:
            return x
        h = x.shape[-2]
        if h % self.strips:
            raise ValueError(
                f"height {h} not divisible by {self.strips} row shards")
        hs = h // self.strips
        return x[..., r * hs:(r + 1) * hs, :]

    def place(self, x) -> "Placed":
        """``x`` laid out on the mesh with plain copies (no staging)."""
        return Placed({(r, d): as_tensor(self.strip(x, r), d)
                       for r, d in self.targets()})


class Placed(dict):
    """A frame or band laid out by a ``MeshPlacement``: ``(strip,
    device) -> tensor``."""


def check_placement(device) -> None:
    """Refuse a placement that is neither a torch device nor a
    ``MeshPlacement`` (a jax ``Device`` or ``Sharding``, say)."""
    if device is not None and not isinstance(
            device, (str, int, torch.device, MeshPlacement)):
        raise TypeError(
            f"device={device!r} is neither a torch device nor a "
            "MeshPlacement (core/distributed.band_input_sharding)")


def _card_devices(device) -> list:
    """The CUDA devices a runtime on ``device`` dispatches to."""
    devs = device.devices if isinstance(device, MeshPlacement) else [device]
    return [d for d in devs if d.type == "cuda"]


# ---------------------------------------------------------------------------
# chunking
# ---------------------------------------------------------------------------
def _stack(buf: list):
    """One (k, ...) chunk of a list of frames: tensors stack as tensors
    (on their device), anything else as a host numpy array."""
    if isinstance(buf[0], torch.Tensor):
        return torch.stack(buf)
    # analysis: allow-host-sync(host frames stacked on the host before staging, not a device readback)
    return np.stack([np.asarray(f) for f in buf])


def stack_chunks(frames: Iterable, batch_size: int) -> Iterator:
    """Group a frame stream into stacked (<= batch_size, ...) chunks
    (ragged final chunk included)."""
    buf: list = []
    for frame in frames:
        buf.append(frame)
        if len(buf) == batch_size:
            yield _stack(buf)
            buf = []
    if buf:
        yield _stack(buf)


def iter_chunks(frames, batch_size: int) -> Iterator:
    """Chunk a clip or stream: an array or tensor (n, ...) is sliced (a
    tensor on the card stays there); any other iterable is stacked via
    ``stack_chunks``."""
    if hasattr(frames, "shape") and hasattr(frames, "ndim"):
        for s in range(0, frames.shape[0], batch_size):
            yield frames[s : s + batch_size]
        return
    yield from stack_chunks(frames, batch_size)


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------
class Stager:
    """Stage host chunks onto ``device``.

    On the card: a ring of ``slots`` pinned host buffers, each sized to
    the chunk it holds, and a copy stream.  ``stage`` fills the next
    buffer (after waiting on the event of the copy that last read it),
    enqueues its copy to a tensor allocated on the copy stream and
    records an event; ``ready`` makes the current stream wait on that
    event and ``record_stream``s the tensor to it, so the caching
    allocator does not reuse it while the current stream still reads it.
    Pinning errors propagate: there is no fallback to pageable copies.
    ``buffers`` and ``copies`` say what was staged.

    On the CPU, ``stage`` converts the chunk to a tensor and ``ready``
    hands it back."""

    def __init__(self, device, slots: int):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.buffers: list = [None] * slots
        self.copies = 0
        self._events: list = [None] * slots
        self._next = 0
        self._stream = torch.cuda.Stream(self.device) if self.on_card \
            else None

    def stage(self, chunk):
        """(tensor, event or None); the tensor is usable after ``ready``."""
        if not self.on_card:
            return as_tensor(chunk, self.device), None
        if isinstance(chunk, torch.Tensor) and chunk.device.type == "cuda":
            return chunk.to(self.device), None   # a copy from another card
        host = as_tensor(chunk, "cpu")
        i = self._next
        self._next = (i + 1) % len(self.buffers)
        if self._events[i] is not None:
            # analysis: allow-host-sync(waits only for the copy that last used this pinned buffer of the ring, before it is overwritten)
            self._events[i].synchronize()
        buf = self.buffers[i]
        if buf is None or buf.shape != host.shape or buf.dtype != host.dtype:
            buf = self.buffers[i] = torch.empty(host.shape, dtype=host.dtype,
                                                pin_memory=True)
        buf.copy_(host)
        with torch.cuda.stream(self._stream):
            staged = torch.empty(host.shape, dtype=host.dtype,
                                 device=self.device)
            staged.copy_(buf, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._events[i] = event
        self.copies += 1
        return staged, event

    def ready(self, staged) -> torch.Tensor:
        tensor, event = staged
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            tensor.record_stream(stream)
        return tensor


class MeshStager:
    """``Stager``'s counterpart for a ``MeshPlacement``: one ``Stager``
    per (strip, device) target, each staging its strip of every chunk;
    ``ready`` hands back the chunk as a ``Placed``."""

    def __init__(self, placement: MeshPlacement, slots: int):
        self.placement = placement
        self.stagers = {t: Stager(t[1], slots)
                        for t in placement.targets()}

    def stage(self, chunk):
        return [(t, s.stage(self.placement.strip(chunk, t[0])))
                for t, s in self.stagers.items()]

    def ready(self, staged) -> Placed:
        return Placed({t: self.stagers[t].ready(s) for t, s in staged})


def make_stager(device, slots: int):
    """A ``Stager`` for a torch device, a ``MeshStager`` for a
    ``MeshPlacement``."""
    if isinstance(device, MeshPlacement):
        return MeshStager(device, slots)
    return Stager(device, slots)


def stage_stream(items: Iterable, size: int = 2, device=None) -> Iterator:
    """Stage host arrays onto the device ahead of consumption.  Exactly
    ``size`` items are staged before the first yield and at most ``size``
    are ever resident beyond the one in the consumer's hands.  ``device``
    is a torch device (``None`` = the card) or a ``MeshPlacement``, which
    yields each item as a ``Placed``."""
    check_placement(device)
    if not isinstance(device, MeshPlacement):
        device = resolve_device(device)
    stager = make_stager(device, size + 1)
    queue: collections.deque = collections.deque()
    for item in items:
        queue.append(stager.stage(item))
        # yield once exactly `size` items are staged
        if len(queue) >= size:
            yield stager.ready(queue.popleft())
    while queue:
        yield stager.ready(queue.popleft())


# ---------------------------------------------------------------------------
# adaptive microbatch controller
# ---------------------------------------------------------------------------
class AdaptiveMicrobatch:
    """Online microbatch tuner: hill-climb the size against measured
    throughput (frames per second of dispatch completion).

    The controller holds a size for ``settle`` completed dispatches,
    records the best observed throughput at that size, then moves one
    multiplicative step (x2 / /2) in the current direction; a move that
    measures worse than the best size seen so far reverses direction
    once, then locks in the best size.  Deterministic given the observed
    latencies: the same latencies make the same moves as the reference's
    controller."""

    def __init__(self, initial: int, max_size: int = 64, settle: int = 2):
        if initial < 1 or max_size < 1:
            raise ValueError("batch sizes must be >= 1")
        self.size = min(initial, max_size)
        self.max_size = max_size
        self.settle = settle
        self._counts: dict[int, int] = {}
        self._throughput: dict[int, float] = {}
        self._direction = 2.0            # multiplicative step, up first
        self._reversed = False
        self.locked = False

    def _best(self) -> tuple[int, float]:
        return max(self._throughput.items(), key=lambda kv: kv[1])

    def observe(self, count: int, seconds: float,
                size: int | None = None) -> None:
        """Feed one completed dispatch (count frames in ``seconds``).

        ``size`` is the batch size the dispatch was BUILT with: in a
        depth-k window dispatches retire after the controller may have
        moved, so the sample is keyed by the size that produced it.
        Defaults to the current size."""
        if size is None:
            size = self.size
        if self.locked or seconds <= 0.0:
            return
        thr = count / seconds
        self._throughput[size] = max(self._throughput.get(size, 0.0), thr)
        self._counts[size] = self._counts.get(size, 0) + 1
        # Only settled samples of the CURRENT size steer; lagged samples
        # of earlier sizes are recorded above and never decide.
        if size != self.size or self._counts[size] < self.settle:
            return
        best_size, best_thr = self._best()
        if self._throughput[self.size] < best_thr:
            # the last move made things worse: go back to the best size
            # and either try the other direction or stop searching
            if self._reversed:
                self.size = best_size
                self.locked = True
                return
            self._reversed = True
            self._direction = 1.0 / self._direction
            self.size = best_size
        nxt = int(self.size * self._direction)
        nxt = max(1, min(nxt, self.max_size))
        if nxt == self.size or nxt in self._throughput:
            self.size = self._best()[0]
            self.locked = True
        else:
            self.size = nxt


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DispatchResult:
    """One retired dispatch: ``out`` covers ``count`` source items."""

    index: int
    count: int
    out: Any
    carry: Any
    meta: Any = None
    latency_s: float | None = None      # dispatch -> retire (block=True)


@dataclasses.dataclass
class RuntimeStats:
    """What one ``run()`` did, filled as dispatches retire."""

    items: int = 0
    dispatches: int = 0
    batch_sizes: list = dataclasses.field(default_factory=list)
    latencies_s: list = dataclasses.field(default_factory=list)
    wall_s: float = 0.0

    @property
    def items_per_s(self) -> float:
        return self.items / self.wall_s if self.wall_s > 0 else 0.0


class FrameRuntime:
    """The one streaming scheduler (the module docstring has the map).

    Args:
      step: ``step(chunk, carry) -> (out, carry)``.  Stateless computes
        wrap as ``FrameRuntime.stateless(fn)``.
      depth: dispatches kept in flight (1 = synchronous).
      microbatch: frames stacked per dispatch; with ``adaptive=True`` the
        starting size, which the controller retunes online.
      adaptive: retune the microbatch from measured completion latency.
      carry_in: initial carry (``None`` for stateless pipelines); the
        final carry lands in ``self.last_carry`` when the run drains.
      device: where chunks are staged and steps run, a torch device
        (``None`` = the card) or a ``MeshPlacement`` (steps then receive
        ``Placed`` chunks, and a dispatch retires on an event of each of
        its cards).
      stage_inputs: stage each chunk (``Stager``) before ``step``.
      stage_ahead: chunks staged beyond the dispatch window.
      block: wait on each dispatch's event as it retires.  Required by
        ``adaptive`` (that is where latency is measured).
      clock: injectable time source (tests script it).

    ``last_stager`` is the last run's ``Stager`` (``None`` when inputs
    are not staged).
    """

    def __init__(
        self,
        step: Callable,
        *,
        depth: int = 2,
        microbatch: int = 1,
        adaptive: bool = False,
        max_microbatch: int = 64,
        carry_in=None,
        device=None,
        stage_inputs: bool = True,
        stage_ahead: int = 0,
        block: bool = True,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if microbatch < 1:
            raise ValueError("microbatch must be >= 1")
        if stage_ahead < 0:
            raise ValueError("stage_ahead must be >= 0")
        if adaptive and not block:
            raise ValueError(
                "adaptive microbatching needs block=True (latency is "
                "measured where a dispatch retires)")
        check_placement(device)
        self.step = step
        self.depth = depth
        self.microbatch = microbatch
        self.adaptive = adaptive
        self.controller = (
            AdaptiveMicrobatch(microbatch, max_size=max_microbatch)
            if adaptive else None)
        self.carry_in = carry_in
        self.device = (device if isinstance(device, MeshPlacement)
                       else resolve_device(device))
        self.stage_inputs = stage_inputs
        self.stage_ahead = stage_ahead
        self.block = block
        self.clock = clock
        self.last_carry = carry_in
        self.last_stats = RuntimeStats()
        self.last_stager: Stager | None = None

    @staticmethod
    def stateless(fn: Callable) -> Callable:
        """Lift a carry-free compute into the step signature."""
        return lambda chunk, carry: (fn(chunk), carry)

    # -- source -> chunks ---------------------------------------------------
    def _chunk_size(self) -> int:
        return self.controller.size if self.controller else self.microbatch

    def _chunks(self, items: Iterable, batched: bool) -> Iterator:
        """(count, chunk, built_size) triples; the size is re-read per
        chunk so the adaptive controller's moves take effect mid-stream.
        ``built_size`` is the size the chunk was requested at (count is
        smaller on the ragged tail): the key the controller files the
        dispatch's latency under."""
        if not batched:
            for item in items:
                yield 1, item, 1
            return
        if hasattr(items, "shape") and hasattr(items, "ndim"):
            s = 0
            n = items.shape[0]
            while s < n:
                k = self._chunk_size()
                yield min(k, n - s), items[s : s + k], k
                s += k
            return
        it = iter(items)
        buf: list = []
        while True:
            k = self._chunk_size()
            while len(buf) < k:
                try:
                    buf.append(next(it))
                except StopIteration:
                    if buf:
                        yield len(buf), _stack(buf), k
                    return
            yield k, _stack(buf), k
            buf = []

    def _staged(self, chunks: Iterator) -> Iterator:
        if not self.stage_inputs:
            yield from chunks
            return
        stager = self.last_stager = make_stager(
            self.device, self.depth + self.stage_ahead + 1)
        queue: collections.deque = collections.deque()
        # the deque holds staged chunks the dispatch loop has not taken
        # yet; each waits on its copy only as it is dispatched
        for count, chunk, built in chunks:
            queue.append((count, stager.stage(chunk), built))
            if len(queue) > self.stage_ahead:
                count, staged, built = queue.popleft()
                yield count, stager.ready(staged), built
        while queue:
            count, staged, built = queue.popleft()
            yield count, stager.ready(staged), built

    # -- the scheduler core -------------------------------------------------
    def run(
        self, items: Iterable, *, batched: bool | None = None,
        meta: Callable | None = None,
    ) -> Iterator[DispatchResult]:
        """Drive ``items`` through the pipeline; yield retired dispatches
        in order.

        ``batched=None`` infers: stack/slice into microbatches unless the
        runtime is fixed at ``microbatch == 1`` and not adaptive (items
        then pass through unstacked, each keeping its own rank).
        ``meta(index, count, chunk)`` optionally computes a per-dispatch
        tag carried onto the ``DispatchResult`` (band spans use this)."""
        if batched is None:
            batched = self.adaptive or self.microbatch > 1
        stats = RuntimeStats()
        self.last_stats = stats
        self.last_stager = None
        cards = _card_devices(self.device)
        t_run = self.clock()
        inflight: collections.deque = collections.deque()
        carry = self.carry_in

        def retire(d):
            if self.block:
                for event in d._done:
                    # analysis: allow-host-sync(retire-time sync is the depth-k window contract; dispatch stays async)
                    event.synchronize()
                d.latency_s = self.clock() - d._t0
                stats.latencies_s.append(d.latency_s)
                if self.controller is not None:
                    # keyed by the size the dispatch was BUILT with: in a
                    # depth-k window the controller may have moved since
                    self.controller.observe(d.count, d.latency_s,
                                            size=d._built)
            stats.items += d.count
            stats.dispatches += 1
            stats.batch_sizes.append(d.count)
            stats.wall_s = self.clock() - t_run
            return d

        for index, (count, chunk, built) in enumerate(
            self._staged(self._chunks(items, batched))
        ):
            tag = meta(index, count, chunk) if meta is not None else None
            t0 = self.clock()
            out, carry = self.step(chunk, carry)
            d = DispatchResult(index=index, count=count, out=out,
                               carry=carry, meta=tag)
            d._done = []
            if self.block:
                for card in cards:
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(card))
                    d._done.append(event)
            d._t0 = t0
            d._built = built
            inflight.append(d)
            if len(inflight) >= self.depth:
                yield retire(inflight.popleft())
        while inflight:
            yield retire(inflight.popleft())
        self.last_carry = carry

    # -- sinks --------------------------------------------------------------
    def map_frames(self, frames: Iterable) -> Iterator:
        """Yield one result per input frame, in order: batched dispatches
        are unstacked into per-frame views of their output."""
        batched = self.adaptive or self.microbatch > 1
        for d in self.run(frames, batched=batched):
            if batched:
                for i in range(d.out.shape[0]):
                    yield d.out[i]
            else:
                yield d.out

    def fold(self, frames: Iterable, *, batched: bool | None = None):
        """Every dispatch output and the final carry: ``(outs,
        last_carry)``, the tracker's chunked-loop sink."""
        outs = [d.out for d in self.run(frames, batched=batched)]
        return outs, self.last_carry

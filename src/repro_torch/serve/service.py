"""`AnalyticsService`: a serving facade over `HistogramEngine`.

Port of ``repro/serve/service.py``.  The engine (core/engine.py) answers
one request at a time; this module adds the request-level scheduler on
top:

  * **Same-frame coalescing** — requests landing on the same
    ``frame_ref`` are grouped and answered by ONE engine run.  The
    engine already unions the corner rows of a multi-query request into
    a single ``rows()`` pass (``prefetch_rows``), so k queries on one
    frame cost one H computation and one band stream, not k.
  * **HSource LRU cache** — computed representations are kept keyed by
    ``frame_ref`` (``cache_size`` frames, and optionally ``cache_bytes``
    of accumulated ``HSource.nbytes`` — evicted LRU-first when either
    bound is exceeded).  A hit on a dense or spilled source answers with
    no H computation at all; a hit on a *banded* source caches the
    replayable stream factory, so it skips planning and re-streams the
    bands for the hit's corner-row union — bounded memory (full H still
    never materializes), not zero kernel work.  ``stats.cache_hits``
    counts requests served from the cache either way; ``engine_runs``
    counts plan+compute dispatches through the engine.
  * **Video-delta chaining** — a miss on frame ``t+1`` whose
    *predecessor* frame ``t`` is still cached hands the pair to the
    engine (``run(..., prev=(frame_t, source_t))``): for low-motion
    streams the engine *updates* the cached H in place of a full
    recompute (core/delta.py), bit-exactly.  The chain is keyed by
    ``predecessor`` (default: integer refs decrement, so a store indexed
    by frame number chains for free).  ``stats.updated`` vs
    ``stats.recomputed`` splits the engine runs by which path ran.
  * **Backpressure** — the submit queue is bounded
    (``max_pending``); a full queue rejects with ``ServiceOverloaded``
    instead of growing without bound.
  * **Stats** — per-request latency (p50/p95), throughput,
    cache hit rate, coalescing ratio, engine-run count
    (``service.stats.snapshot()``).  On the card a request's latency
    ends when its answers are on the card: a group's futures resolve,
    and its latency samples are taken, only after an event recorded
    after the group's results has completed.

Two entry points share all of that logic:

  * ``process(requests)`` — synchronous batch mode: coalesce + answer a
    list of ``(frame_ref, query)`` pairs in submission order
    (deterministic; what the tests pin down).
  * ``submit(frame_ref, query) -> Future`` — concurrent mode: a worker
    thread drains the queue greedily, so whatever accumulated since the
    last drain coalesces naturally under load (the adaptive-batching
    effect of Koppaka et al., here at the request level: the batch grows
    exactly when the service is behind).

The mesh-scale layer, one of these a replica group, is
``DistributedAnalyticsService`` (serve/distributed.py).
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device


class ServiceOverloaded(RuntimeError):
    """Submit queue is full (``max_pending``) — shed load upstream."""


@dataclasses.dataclass
class ServiceStats:
    """Counters + latency samples; ``snapshot()`` derives the rates."""

    requests: int = 0
    engine_runs: int = 0            # H computations (cache misses)
    cache_hits: int = 0             # requests answered from the LRU
    coalesced: int = 0              # requests that shared another's run
    rejected: int = 0               # backpressure rejections
    updated: int = 0                # engine runs via incremental update
    recomputed: int = 0             # engine runs via full recompute
    latencies_s: list = dataclasses.field(default_factory=list)
    started_at: float = dataclasses.field(default_factory=time.perf_counter)

    def observe(self, latency_s: float) -> None:
        self.latencies_s.append(latency_s)

    def snapshot(self) -> dict:
        lat = np.sort(np.asarray(self.latencies_s, np.float64))
        wall = time.perf_counter() - self.started_at
        done = len(lat)
        return {
            "requests": self.requests,
            "completed": done,
            "engine_runs": self.engine_runs,
            "cache_hits": self.cache_hits,
            "cache_hit_rate": self.cache_hits / max(self.requests, 1),
            "coalesced": self.coalesced,
            "rejected": self.rejected,
            # engine-run split under video-delta chaining ("hit" is the
            # third outcome: answered with no engine run at all)
            "updated": self.updated,
            "recomputed": self.recomputed,
            "hit": self.cache_hits,
            "update_ratio": self.updated / max(self.engine_runs, 1),
            "requests_per_s": done / wall if wall > 0 else 0.0,
            "latency_p50_s": float(lat[int(0.50 * (done - 1))]) if done else 0.0,
            "latency_p95_s": float(lat[int(0.95 * (done - 1))]) if done else 0.0,
        }


def _int_predecessor(frame_ref):
    """Default frame-chain resolver: integer refs decrement (frame ``t``
    follows ``t - 1``); anything else has no known predecessor."""
    if isinstance(frame_ref, bool):
        return None
    if isinstance(frame_ref, (int, np.integer)):
        return frame_ref - 1
    return None


@dataclasses.dataclass
class _Pending:
    """One queued request (threaded mode carries a Future)."""

    frame_ref: Any
    query: Any
    t_submit: float
    future: Future | None = None


class AnalyticsService:
    """Serve ``(frame_ref, query)`` requests against one engine.

    Two requests on the same frame coalesce into ONE engine run (and,
    when their corner-row union is small, the planner fuses them into
    the scan so H is never stored):

    >>> import numpy as np
    >>> from repro_torch.core.engine import HistogramEngine, RegionQuery
    >>> frames = {"f0": np.arange(64, dtype=np.uint8).reshape(8, 8) % 4}
    >>> svc = AnalyticsService(
    ...     HistogramEngine(num_bins=4, value_range=4, device="cpu"),
    ...     frames)
    >>> out = svc.process([("f0", RegionQuery([[0, 0, 7, 7]])),
    ...                    ("f0", RegionQuery([[0, 0, 3, 7]]))])
    >>> [float(v) for v in out[0].ravel()]
    [16.0, 16.0, 16.0, 16.0]
    >>> svc.stats.engine_runs       # both queries rode one engine run
    1
    >>> svc._engine.last_plan.representation
    'fused'

    Args:
      engine: a ``HistogramEngine`` — plans/computes/queries; the
        service never touches representations directly.
      frames: ``frame_ref -> frame`` resolver — a mapping (frame store)
        or a callable (decoder / fetcher).  Only cache *misses* resolve.
      cache_size: HSource LRU entries kept (0 disables caching).
      cache_bytes: optional bound on the cache's accumulated
        ``HSource.nbytes`` (planner size estimates for banded-factory
        entries); LRU entries are evicted until the total fits.
      max_pending: bound on queued submits before ``ServiceOverloaded``.
      max_coalesce: most requests the worker drains into one batch.
      predecessor: ``frame_ref -> prev_ref | None`` — names the frame a
        ref follows, seeding the engine's incremental video-delta path
        when the predecessor's H is still cached.  Defaults to integer
        decrement; pass ``lambda ref: None`` to disable chaining.
    """

    # Shared mutable state and the methods that mutate it: writes to
    # these attributes outside `with self._lock:` race the worker thread
    # against process()/submit() callers (the close()/drain race class).
    _LOCK_PROTECTED = ("_cache", "stats")
    _LOCK_PROTECTED_MUTATORS = ("observe",)

    def __init__(
        self,
        engine,
        frames: Mapping | Callable,
        *,
        cache_size: int = 8,
        cache_bytes: int | None = None,
        max_pending: int = 64,
        max_coalesce: int = 32,
        predecessor: Callable | None = None,
    ):
        if cache_size < 0 or max_pending < 1 or max_coalesce < 1:
            raise ValueError(
                "cache_size >= 0, max_pending >= 1, max_coalesce >= 1"
            )
        if cache_bytes is not None and cache_bytes < 0:
            raise ValueError("cache_bytes must be >= 0")
        self._engine = engine
        dev = resolve_device(engine.device)
        self._card = dev if dev.type == "cuda" else None
        self._resolve = (
            frames.__getitem__ if hasattr(frames, "__getitem__") else frames
        )
        self.cache_size = cache_size
        self.cache_bytes = cache_bytes
        self.max_coalesce = max_coalesce
        self._predecessor = (
            predecessor if predecessor is not None else _int_predecessor
        )
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self.stats = ServiceStats()
        self._queue: queue.Queue = queue.Queue(maxsize=max_pending)
        self._worker: threading.Thread | None = None
        self._closing = False

    # -- the one serving core (both entry points call this) -----------------
    def _evict_locked(self) -> None:
        """LRU eviction under both bounds; caller holds ``self._lock``
        (hence the pragmas: the rule cannot see a caller's lock)."""
        while len(self._cache) > self.cache_size:
            # analysis: allow-lock-discipline(caller holds self._lock)
            self._cache.popitem(last=False)
        if self.cache_bytes is not None:
            total = sum(
                getattr(s, "nbytes", 0) for s in self._cache.values())
            while self._cache and total > self.cache_bytes:
                # analysis: allow-lock-discipline(caller holds self._lock)
                _, dropped = self._cache.popitem(last=False)
                total -= getattr(dropped, "nbytes", 0)

    def _source_for(self, frame_ref, queries):
        """(source, results-or-None, hit): the cached HSource, or one
        engine run answering ``queries`` directly on a miss."""
        with self._lock:
            cached = self._cache.get(frame_ref)
            if cached is not None:
                self._cache.move_to_end(frame_ref)
            prev_ref = prev_src = None
            if cached is None:
                try:
                    prev_ref = self._predecessor(frame_ref)
                except Exception:
                    prev_ref = None
                if prev_ref is not None:
                    prev_src = self._cache.get(prev_ref)
        if cached is not None:
            return cached, None, True
        frame = self._resolve(frame_ref)
        prev = None
        if prev_src is not None:
            try:
                prev = (self._resolve(prev_ref), prev_src)
            except Exception:  # predecessor frame gone from the store
                prev = None
        # ONE compute, k queries — updated in place when the planner
        # takes the incremental path off the cached predecessor H
        out = self._engine.run(frame, queries, prev=prev)
        incremental = getattr(out.plan, "incremental", False)
        with self._lock:
            self.stats.engine_runs += 1
            if incremental:
                self.stats.updated += 1
            else:
                self.stats.recomputed += 1
            if self.cache_size:
                self._cache[frame_ref] = out.source
                self._cache.move_to_end(frame_ref)
                self._evict_locked()
        return out.source, out.results, False

    def _answer_group(self, frame_ref, group: list[_Pending]) -> list:
        """Answer every request of one frame group; returns results in
        group order."""
        from repro_torch.core.engine import prefetch_rows
        from repro_torch.core.hsource import BandedH, MissingRowsError

        queries = [p.query for p in group]
        source, results, hit = self._source_for(frame_ref, queries)
        if results is None:
            # Cache hit: apply the queries to the cached source, sharing
            # one corner-row prefetch when the source streams (the same
            # union the engine does for a fresh multi-query run).
            target = source
            if len(queries) > 1 and isinstance(source, BandedH):
                target = prefetch_rows(source, queries) or source
            try:
                results = [q.apply(target) for q in queries]
            except MissingRowsError:
                # A fused cache entry holds ONLY its own request's corner
                # rows; a hit that reads outside that set has no H to
                # fall back on.  Re-run the engine (it re-plans with the
                # new row union — fused again if still small) and refresh
                # the cache.  Not a cache hit.
                hit = False
                out = self._engine.run(self._resolve(frame_ref), queries)
                results = out.results
                with self._lock:
                    self.stats.engine_runs += 1
                    self.stats.recomputed += 1
                    if self.cache_size:
                        self._cache[frame_ref] = out.source
                        self._cache.move_to_end(frame_ref)
                        self._evict_locked()
        with self._lock:
            self.stats.requests += len(group)
            if hit:
                self.stats.cache_hits += len(group)
            self.stats.coalesced += len(group) - 1
        return results

    def _process_batch(self, batch: list[_Pending]) -> list:
        """Coalesce a drained batch by frame_ref and answer every group.
        Results come back in submission order."""
        groups: collections.OrderedDict = collections.OrderedDict()
        for i, p in enumerate(batch):
            groups.setdefault(p.frame_ref, []).append((i, p))
        results: list = [None] * len(batch)
        for frame_ref, members in groups.items():
            group = [p for _, p in members]
            outs = self._answer_group(frame_ref, group)
            if self._card is not None:
                # the answers are done when the card is: wait on an event
                # recorded after them, not on work queued since
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self._card))
                ready.synchronize()
            done = time.perf_counter()
            for (i, p), out in zip(members, outs):
                results[i] = out
                with self._lock:
                    self.stats.observe(done - p.t_submit)
                if p.future is not None:
                    p.future.set_result(out)
        return results

    # -- synchronous batch mode ---------------------------------------------
    def process(self, requests: Iterable[tuple]) -> list:
        """Answer ``(frame_ref, query)`` pairs; one engine run per
        distinct uncached frame in the batch, results in input order."""
        now = time.perf_counter()
        batch = [_Pending(ref, q, now) for ref, q in requests]
        return self._process_batch(batch)

    # -- concurrent mode -----------------------------------------------------
    def start(self) -> "AnalyticsService":
        if self._worker is None:
            self._closing = False
            self._worker = threading.Thread(
                target=self._drain_loop, name="analytics-service", daemon=True
            )
            self._worker.start()
        return self

    def submit(self, frame_ref, query, *, block: bool = False) -> Future:
        """Enqueue one request; returns a Future.  A full queue raises
        ``ServiceOverloaded`` (``block=True`` waits instead — caller-side
        backpressure)."""
        if self._worker is None:
            raise RuntimeError("service not started — use start() or "
                               "`with AnalyticsService(...) as svc:`")
        p = _Pending(frame_ref, query, time.perf_counter(), Future())
        try:
            self._queue.put(p, block=block)
        except queue.Full:
            with self._lock:
                self.stats.rejected += 1
            raise ServiceOverloaded(
                f"submit queue full ({self._queue.maxsize} pending)"
            ) from None
        return p.future

    def _drain_loop(self) -> None:
        while True:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._closing:
                    return
                continue
            batch = [first]
            # greedy drain: whatever accumulated while the last batch
            # computed coalesces into this one
            while len(batch) < self.max_coalesce:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            try:
                self._process_batch(batch)
            except Exception as e:  # fail the batch's futures, keep serving
                for p in batch:
                    if p.future is not None and not p.future.done():
                        p.future.set_exception(e)

    def close(self) -> None:
        """Drain outstanding requests, then stop the worker.

        A submit racing with close can land on the queue after the
        worker's final drain; those futures are failed here rather than
        left to hang forever."""
        if self._worker is not None:
            self._closing = True
            self._worker.join()
            self._worker = None
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            if p.future is not None and not p.future.done():
                p.future.set_exception(
                    RuntimeError("service closed before request ran"))

    def __enter__(self) -> "AnalyticsService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- introspection -------------------------------------------------------
    @property
    def cached_frames(self) -> tuple:
        with self._lock:
            return tuple(self._cache)

    def clear_cache(self) -> None:
        """Drop every cached HSource (benchmarks call this after their
        compile warm-up so measured hit rates start cold)."""
        with self._lock:
            self._cache.clear()

"""`DistributedAnalyticsService`: the planner's replica x shard mesh
layout (core/engine.MeshLayout) run as a serving system — paper §4.6's
"4 GPUs behind a task queue" generalized to a mesh.

Port of ``repro/serve/distributed.py``.  The mesh is a ``device.Mesh``
(``launch.mesh.make_host_mesh``), and one process drives every group.

One `AnalyticsService` per frame-parallel **replica group**
(`core/distributed.replica_meshes` slices the mesh along
``replica_axis``); within each group the engine shards bins or row
strips over the group's submesh exactly as a single-service deployment
would over the whole mesh.  A group whose submesh is one device gets a
plain single-device engine (``engine_factory(None)``), which keeps the
query-fused (K2) and incremental video-delta (K3) paths alive — mesh
plans recompute whole.

On top of the per-group services this facade owns exactly three things:

  * **Consistent-hash routing with chain stickiness** — a frame ref is
    routed by a hash ring over the replica groups, EXCEPT when one of
    its recent predecessors (the ``predecessor`` chain of the video-delta
    path) was already routed: then the frame follows its chain.  Incremental
    updates need the predecessor's H in the *local* cache, so a video
    chain that straddled two replicas would silently degrade every
    frame to a full recompute.  Routes are memoized (bounded LRU), so
    chains stay put for as long as the ring remembers them.
  * **Aggregate backpressure** — ``max_pending`` bounds the
    *total* outstanding submits across all replicas; a hot replica
    cannot hide behind idle ones.  Rejections raise the same
    ``ServiceOverloaded`` the single service does.
  * **Aggregate stats** — ``snapshot()`` sums the counters, recomputes
    the rates over the union, and keeps the per-replica snapshots under
    ``"replicas"`` (the load-balance view: routing skew shows up as
    per-replica request counts, chain pinning as one replica owning all
    the ``updated`` runs).

The per-replica HSource caches split one aggregate byte budget:
``cache_bytes`` is divided evenly across groups, so the deployment's
total cache residency is bounded no matter how traffic skews.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Iterable, Mapping

import numpy as np

from repro_torch.serve.service import (
    AnalyticsService,
    ServiceOverloaded,
    _int_predecessor,
)


def _ring_hash(token: str) -> int:
    """Stable 64-bit point on the ring (blake2b — never Python's
    ``hash``, which is salted per process and would re-route every
    frame on restart)."""
    return int.from_bytes(
        hashlib.blake2b(token.encode(), digest_size=8).digest(), "big"
    )


class HashRing:
    """Consistent hashing over replica indices with virtual nodes.

    ``weight`` virtual nodes per replica smooth the load split; lookup
    is a binary search over the sorted ring.  Deterministic across
    processes and instances, and equal to the reference's ring: the same
    refs route to the same replicas."""

    def __init__(self, num_replicas: int, weight: int = 64):
        if num_replicas < 1 or weight < 1:
            raise ValueError("num_replicas >= 1, weight >= 1")
        points = []
        for idx in range(num_replicas):
            for v in range(weight):
                points.append((_ring_hash(f"replica:{idx}:{v}"), idx))
        points.sort()
        self._points = np.asarray([p for p, _ in points], np.uint64)
        self._owners = [i for _, i in points]

    def lookup(self, frame_ref) -> int:
        h = _ring_hash(f"frame:{frame_ref!r}")
        pos = int(np.searchsorted(self._points, np.uint64(h), side="left"))
        return self._owners[pos % len(self._owners)]


class DistributedAnalyticsService:
    """Serve ``(frame_ref, query)`` traffic across replica groups.

    Args:
      engine_factory: ``submesh -> HistogramEngine`` — called once per
        replica group with that group's submesh (a ``device.Mesh`` over
        the non-replica axes), or ``None`` for a bare single-device
        group.  ``serve.sharded_engine_factory`` covers the common case.
      frames: frame resolver, shared by every replica (a mapping or a
        callable, as in ``AnalyticsService``).
      mesh: the full device mesh.  ``None`` (with ``num_replicas``) runs
        N single-device replica groups on the factory's device — the
        degenerate frame-parallel layout.
      replica_axis: the mesh axis replicated over frames; every other
        axis shards within the group.  An axis absent from the mesh
        means one group spanning the whole mesh.
      num_replicas: group count when ``mesh`` is None.
      cache_size: per-replica HSource LRU entries.
      cache_bytes: AGGREGATE byte budget, split evenly across groups.
      max_pending: AGGREGATE bound on outstanding submits.
      max_coalesce / predecessor: forwarded to every replica service;
        ``predecessor`` also drives chain-sticky routing here.
      ring_weight: virtual nodes per replica on the hash ring.
      chain_depth: how many predecessors the router walks looking for an
        already-routed chain member before falling back to the ring.
    """

    # Routing memo + aggregate backpressure counters are shared between
    # submit() callers and the replicas' worker threads (via the future
    # done-callbacks); the lock-discipline rule enforces the declaration.
    _LOCK_PROTECTED = ("_routes", "_inflight", "_rejected")

    def __init__(
        self,
        engine_factory: Callable,
        frames: Mapping | Callable,
        *,
        mesh=None,
        replica_axis: str = "data",
        num_replicas: int | None = None,
        cache_size: int = 8,
        cache_bytes: int | None = None,
        max_pending: int = 64,
        max_coalesce: int = 32,
        predecessor: Callable | None = None,
        ring_weight: int = 64,
        chain_depth: int = 8,
        max_routes: int = 4096,
    ):
        if mesh is not None and num_replicas is not None:
            raise ValueError("pass mesh or num_replicas, not both")
        if mesh is None:
            groups: list = [None] * (num_replicas or 1)
        else:
            from repro_torch.core.distributed import replica_meshes

            groups = replica_meshes(mesh, replica_axis)
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        n = len(groups)
        per_bytes = None if cache_bytes is None else cache_bytes // n
        self._predecessor = (
            predecessor if predecessor is not None else _int_predecessor
        )
        self.replicas: list[AnalyticsService] = []
        for sub in groups:
            if sub is not None and _mesh_devices(sub) == 1:
                # A 1-device submesh plans exactly like no mesh but
                # disables the incremental path; hand the factory None
                # so single-device groups keep video-delta updates.
                sub = None
            self.replicas.append(
                AnalyticsService(
                    engine_factory(sub), frames,
                    cache_size=cache_size, cache_bytes=per_bytes,
                    max_pending=max_pending, max_coalesce=max_coalesce,
                    predecessor=predecessor,
                )
            )
        self.max_pending = max_pending
        self._ring = HashRing(n, weight=ring_weight)
        self._chain_depth = chain_depth
        self._max_routes = max_routes
        self._routes: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self._inflight = 0
        self._rejected = 0
        self._started = False
        self._started_at = time.perf_counter()

    # -- routing ------------------------------------------------------------
    def replica_for(self, frame_ref) -> int:
        """The replica group ``frame_ref`` routes to (memoized).

        A ref whose recent predecessor chain already routed follows the
        chain — the locality incremental updates need; otherwise
        the consistent-hash ring decides."""
        with self._lock:
            hit = self._routes.get(frame_ref)
            if hit is not None:
                self._routes.move_to_end(frame_ref)
                return hit
        idx = None
        cur = frame_ref
        for _ in range(self._chain_depth):
            try:
                prev = self._predecessor(cur)
            except Exception:
                prev = None
            if prev is None or prev == cur:
                break
            with self._lock:
                hit = self._routes.get(prev)
            if hit is not None:
                idx = hit
                break
            cur = prev
        if idx is None:
            idx = self._ring.lookup(frame_ref)
        with self._lock:
            self._routes[frame_ref] = idx
            self._routes.move_to_end(frame_ref)
            while len(self._routes) > self._max_routes:
                self._routes.popitem(last=False)
        return idx

    # -- synchronous batch mode ---------------------------------------------
    def process(self, requests: Iterable[tuple]) -> list:
        """Route and answer ``(frame_ref, query)`` pairs; results in
        input order.  Groups are answered replica by replica (each
        replica coalesces its own share exactly like a standalone
        service), so results are bit-exact against a single-device
        service fed the same trace."""
        reqs = list(requests)
        buckets: OrderedDict = OrderedDict()
        for i, (ref, q) in enumerate(reqs):
            buckets.setdefault(self.replica_for(ref), []).append((i, ref, q))
        results: list = [None] * len(reqs)
        for idx, items in buckets.items():
            outs = self.replicas[idx].process(
                [(ref, q) for _, ref, q in items])
            for (i, _, _), out in zip(items, outs):
                results[i] = out
        return results

    # -- concurrent mode -----------------------------------------------------
    def start(self) -> "DistributedAnalyticsService":
        for r in self.replicas:
            r.start()
        self._started = True
        return self

    def submit(self, frame_ref, query, *, block: bool = False):
        """Enqueue one request on its routed replica; returns a Future.

        The admission check is AGGREGATE: total outstanding submits
        across every replica stay within ``max_pending`` (a hot replica
        cannot hide behind idle ones).  ``block=True`` still blocks on
        the replica's own queue once admitted."""
        if not self._started:
            raise RuntimeError(
                "service not started — use start() or "
                "`with DistributedAnalyticsService(...) as svc:`")
        with self._lock:
            if self._inflight >= self.max_pending:
                self._rejected += 1
                admitted = False
            else:
                self._inflight += 1
                admitted = True
        if not admitted:
            raise ServiceOverloaded(
                f"aggregate submit window full ({self.max_pending} "
                "pending across replicas)")
        idx = self.replica_for(frame_ref)
        try:
            fut = self.replicas[idx].submit(frame_ref, query, block=block)
        except BaseException:
            with self._lock:
                self._inflight -= 1
            raise
        fut.add_done_callback(self._retire)
        return fut

    def _retire(self, _fut) -> None:
        with self._lock:
            self._inflight -= 1

    def close(self) -> None:
        self._started = False
        for r in self.replicas:
            r.close()

    def __enter__(self) -> "DistributedAnalyticsService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> dict:
        """Aggregate counters/rates + per-replica snapshots."""
        per = [r.stats.snapshot() for r in self.replicas]
        lat = np.sort(np.concatenate(
            [np.asarray(list(r.stats.latencies_s), np.float64)
             for r in self.replicas]
        )) if self.replicas else np.zeros(0)
        done = len(lat)
        wall = time.perf_counter() - self._started_at
        agg: dict = {
            k: sum(p[k] for p in per)
            for k in ("requests", "completed", "engine_runs", "cache_hits",
                      "coalesced", "updated", "recomputed")
        }
        with self._lock:
            rejected = self._rejected
            routes = len(self._routes)
        agg["rejected"] = rejected + sum(p["rejected"] for p in per)
        agg["hit"] = agg["cache_hits"]
        agg["cache_hit_rate"] = agg["cache_hits"] / max(agg["requests"], 1)
        agg["update_ratio"] = agg["updated"] / max(agg["engine_runs"], 1)
        agg["requests_per_s"] = done / wall if wall > 0 else 0.0
        agg["latency_p50_s"] = (
            float(lat[int(0.50 * (done - 1))]) if done else 0.0)
        agg["latency_p95_s"] = (
            float(lat[int(0.95 * (done - 1))]) if done else 0.0)
        agg["num_replicas"] = len(self.replicas)
        agg["routed_refs"] = routes
        agg["replicas"] = per
        return agg

    @property
    def cached_frames(self) -> tuple:
        """Per-replica cached frame refs (a tuple of tuples)."""
        return tuple(r.cached_frames for r in self.replicas)

    def clear_cache(self) -> None:
        for r in self.replicas:
            r.clear_cache()
        with self._lock:
            self._routes.clear()


def _mesh_devices(mesh) -> int:
    n = 1
    for v in dict(mesh.shape).values():
        n *= v
    return n


def sharded_engine_factory(num_bins: int, **engine_kwargs) -> Callable:
    """The ``engine_factory`` for the common case: each replica group
    gets a ``HistogramEngine`` sharded over its submesh (or a plain
    single-device engine for 1-device groups, which keeps the fused and
    incremental paths)."""
    from repro_torch.core.engine import HistogramEngine

    def factory(submesh):
        return HistogramEngine(num_bins, mesh=submesh, **engine_kwargs)

    return factory

"""Plan/execute engine over the dense, banded, spilled, mesh-sharded and
query-fused representations.

Port of ``repro/core/engine.py``:

    spec = WorkloadSpec(height=480, width=640, num_bins=32,
                        memory_budget_bytes=64 << 20)
    p = plan(spec)            # deterministic, inspectable, testable
    print(p.explain())        # why this representation

``HistogramEngine`` composes plan -> compute -> query: ``engine.run``
returns an ``HSource`` (core/hsource.py) plus the results of its queries.
Every decision of the reference is ported: incremental updates of a
cached predecessor (-1; K1 or K4 on the dirty rows, K3 on the clean rows
below), query fusion (0; K2), sharding over a ``device.Mesh`` (1; K1 or
K4 a shard, core/distributed.py), band streaming (2) and host spill (3)
under a memory budget or storage policy, dense H (4; K1, or K4 for
``cw_tis``).  A tuned-config priors file of the port's own
(core/autotune.py, ``$REPRO_TORCH_TUNED_CONFIGS``) may set K1's bin block
and the dirty-fraction threshold (0.35 without one); the reference's
TPU-tuned file is never read.  ``map_frames`` streams dense per-frame H's
through the runtime (core/runtime.py) with the planner's microbatch,
fixed or adaptive.  Every ``run`` and ``map_frames`` validates its plan
before the first launch (``validate(..., deep=True)``: analysis/plancheck.py
and the kernels' proofs in analysis/kernelcheck.py) and raises
``PlanValidationError`` on a rejected plan; a ``run`` that repeats the
engine's last request takes that request's plan and verdict.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import autotune
from repro_torch.core import delta as delta_mod
from repro_torch.core.bands import (
    STORAGE_POLICIES,
    BandPlan,
    SpilledIH,
    plan_bands,
    validate_storage_policy,
)
from repro_torch.core.hsource import (
    BandedH,
    DenseH,
    FusedRowsH,
    HSource,
    PrefetchedRowsH,
    ShardedH,
)
from repro_torch.device import (
    as_tensor,
    dtype_name,
    resolve_device,
    stage_async,
)

REPRESENTATIONS = ("dense", "banded", "spilled", "sharded", "fused")

# Fuse the queries into the scan (never store H) when the request's
# corner-row union is at most 1/_FUSE_ROW_FRACTION of the frame height.
_FUSE_ROW_FRACTION = 4

# Dirty-row fraction above which an incremental update of a cached
# predecessor H stops paying and plan() recomputes.
_DELTA_DIRTY_THRESHOLD = delta_mod.DEFAULT_DIRTY_THRESHOLD

# Auto microbatching targets this per-dispatch output footprint.
_AUTO_BATCH_BYTES = 4 << 20


class PlanValidationError(ValueError):
    """A plan failed static validation (repro_torch.analysis.plancheck):
    the dispatch would have failed or silently produced invalid counts."""


def auto_batch_size(num_bins: int, h: int, w: int) -> int:
    """Frames per dispatch from the per-frame (num_bins, h, w) fp32 H
    footprint: small frames batch deep, full frames stay near 1."""
    per_frame_bytes = 4 * num_bins * h * w
    return max(1, min(16, _AUTO_BATCH_BYTES // per_frame_bytes))


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Everything the planner needs to know about a request.

    ``num_frames`` is frames per call, ``None`` for an open stream.
    ``memory_budget_bytes`` bounds the live H footprint (banding);
    ``storage`` selects a host spill policy (core/bands.py
    STORAGE_POLICIES) and implies the spilled representation.
    ``mesh`` (a ``device.Mesh``) switches to the sharded mappings over
    ``bin_axis`` or ``row_axis`` (``sharding``: "auto", "bin" or
    "spatial").  ``query_rows`` is the corner-row union of the request's
    queries and ``dirty_fraction`` the share of frame rows in dirty bands
    against a cached predecessor (``engine.run`` fills both).  ``device``
    is where the request runs (``None`` = the GPU); it decides what
    backend ``"auto"`` means.  ``adaptive_microbatch`` makes the plan's microbatch
    the starting size of the runtime's online controller."""

    height: int
    width: int
    num_bins: int = 32
    num_frames: int | None = 1
    dtype: str = "uint8"
    value_range: int | None = 256
    method: str = "wf_tis"
    backend: str = "auto"
    tile: int = 128
    bin_block: int | None = None
    memory_budget_bytes: int | None = None
    storage: str | None = None
    adaptive_microbatch: bool = False   # retune batch size online
    mesh: object | None = None          # device.Mesh
    sharding: str = "auto"              # "auto" | "bin" | "spatial"
    bin_axis: str = "model"
    row_axis: str = "data"
    query_rows: tuple[int, ...] | None = None
    dirty_fraction: float | None = None
    device: str | None = None

    @property
    def per_frame_h_bytes(self) -> int:
        """The (num_bins, h, w) fp32 H footprint of one frame."""
        return 4 * self.num_bins * self.height * self.width


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """The planner's 2-D serving layout over a mesh (paper §4.6 run as a
    serving system): frame-parallel **replica groups** along every mesh
    axis the shard mapping does not consume, times bin or spatial
    sharding within each group.  ``explain()`` renders it and
    ``serve.DistributedAnalyticsService`` runs it, one ``AnalyticsService``
    a replica group (``distributed.replica_meshes``)."""

    kind: str                        # "bin" | "spatial" (within-group)
    shard_axis: str                  # mesh axis the shard mapping uses
    shards_per_group: int            # devices per replica group
    replica_axes: tuple              # frame-parallel axes (may be empty)
    num_groups: int                  # product of the replica axes' sizes

    def describe(self) -> str:
        over = (" x ".join(repr(a) for a in self.replica_axes)
                or "(no free axis)")
        return (
            f"{self.num_groups} replica group(s) over {over} x "
            f"{self.kind} sharding over {self.shard_axis!r} "
            f"({self.shards_per_group} device(s)/group)")


def choose_layout(mesh, kind: str, *, bin_axis: str = "model",
                  row_axis: str = "data") -> MeshLayout:
    """The replica x shard layout from the mesh's shape: the shard mapping
    consumes one axis (bins or row strips); every other axis is
    frame-parallel replication."""
    shape = dict(mesh.shape)
    shard_axis = bin_axis if kind == "bin" else row_axis
    replica_axes = tuple(a for a in mesh.axis_names if a != shard_axis)
    num_groups = 1
    for a in replica_axes:
        num_groups *= shape[a]
    return MeshLayout(
        kind=kind, shard_axis=shard_axis,
        shards_per_group=shape.get(shard_axis, 1),
        replica_axes=replica_axes, num_groups=num_groups)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The planner's resolved decisions; equal specs give equal plans."""

    spec: WorkloadSpec
    representation: str         # dense | banded | spilled | sharded | fused
    method: str
    backend: str                        # resolved: "cuda" | "torch"
    tile: int
    bin_block: int | None
    microbatch: int
    band_plan: BandPlan | None = None
    storage: str | None = None
    incremental: bool = False           # update a cached predecessor H
    microbatch_mode: str = "fixed"      # "fixed" | "adaptive"
    tuned: str | None = None            # autotune priors key, if applied
    sharding: str | None = None         # None | "bin" | "spatial"
    layout: MeshLayout | None = None    # replica x shard serving layout

    def explain(self, verdict=None) -> str:
        """Human-readable plan rationale.

        ``verdict`` (a ``repro_torch.analysis.plancheck.PlanVerdict``, e.g.
        ``engine.last_verdict``) appends the static feasibility verdict;
        the default output is unchanged."""
        s = self.spec
        per_frame = s.per_frame_h_bytes
        lines = [
            "ExecutionPlan",
            f"  workload        : {s.height}x{s.width} {s.dtype} frames, "
            f"{s.num_bins} bins, "
            + ("open stream" if s.num_frames is None
               else f"{s.num_frames} frame(s)/request"),
            f"  full H          : {per_frame} B/frame "
            f"({per_frame / 2**20:.1f} MiB fp32)",
            f"  representation  : {self.representation}",
        ]
        if self.incremental:
            df = s.dirty_fraction or 0.0
            recomputed = int(round(df * per_frame))
            lines.append(
                f"  incremental     : update — dirty fraction {df:.2f} "
                f"within threshold; recompute ~{recomputed} B/frame, "
                f"reuse ~{per_frame - recomputed} B/frame of cached H")
        if s.query_rows is not None:
            k = len(s.query_rows)
            nf = 1 if s.num_frames is None else s.num_frames
            if self.representation == "fused":
                rows_b = 4 * nf * s.num_bins * k * s.width
                lines.append(
                    f"  query fusion    : fuse — {k} corner row(s) "
                    f"({rows_b} B) << full H {per_frame} B; H never stored")
            else:
                bound = s.height // _FUSE_ROW_FRACTION
                why = (f"{k} corner row(s) exceed the fuse bound "
                       f"({bound} rows)" if k > bound else
                       f"{k} corner row(s), but the request pins another "
                       "path")
                lines.append(
                    f"  query fusion    : store — {why}; fall back to "
                    f"{self.representation}")
        bb = "auto" if self.bin_block is None else self.bin_block
        lines += [
            f"  method/backend  : {self.method} / {self.backend}",
            f"  tile/bin_block  : {self.tile} / {bb}"
            + (f" (tuned prior {self.tuned})" if self.tuned else ""),
            f"  microbatch      : {self.microbatch} frame(s)/dispatch"
            + (" (adaptive start)" if self.microbatch_mode == "adaptive"
               else ""),
        ]
        if self.band_plan is None:
            budget = s.memory_budget_bytes
            why = ("no memory budget" if budget is None
                   else f"fits the {budget} B budget in one band")
            lines.append(f"  bands           : none ({why})")
        else:
            bp = self.band_plan
            lines.append(
                f"  bands           : {bp.num_bands} x {bp.band_h} rows "
                f"({bp.band_bytes} B/band <= {s.memory_budget_bytes} B "
                "budget)")
        if self.storage is None:
            lines.append("  storage         : device fp32")
        else:
            bound = STORAGE_POLICIES[self.storage][1]
            lines.append(
                f"  storage         : host spill {self.storage} "
                f"(exact regions <= {bound} px)")
        if self.sharding is None:
            lines.append("  sharding        : none")
        else:
            axis = s.bin_axis if self.sharding == "bin" else s.row_axis
            size = dict(s.mesh.shape)[axis]
            lines.append(
                f"  sharding        : {self.sharding} over mesh axis "
                f"{axis!r} ({size} devices)")
            if self.layout is not None:
                lines.append(
                    f"  mesh layout     : {self.layout.describe()}")
        if verdict is not None:
            lines.append("  " + verdict.render().replace("\n", "\n  "))
        return "\n".join(lines)


def plan(spec: WorkloadSpec) -> ExecutionPlan:
    """Deterministically map a workload onto an execution path.

     -1. dirty_fraction known and at most 0.35 -> incremental: update the
         cached predecessor H (dirty rows recomputed, clean rows below
         carry-corrected) instead of recomputing; fusion is skipped, since
         a fused result stores nothing to update next frame.
      0. query_rows known and small (at most height/4 rows, no storage
         pinning another path, row slab within any budget) -> fused:
         compute only those corner rows straight out of the scan (K2),
         never store H.
      1. mesh given -> sharded.  "auto" picks the paper's bin mapping
         when num_bins divides the bin axis, else the spatial (row-strip)
         mapping, which takes one frame a request.  A memory budget on
         top bands the stream (whole row strips a band).  A mesh plan
         never fuses, updates incrementally or spills.
      2. budget given -> band-plan the frame; more than one band means the
         monolithic H breaks the budget: banded (stream) or, with a
         storage policy, spilled.  One band fits: dense.
      3. storage given -> spilled even without a budget (one band).
      4. otherwise -> dense (K1; K4 for cw_tis).

    Microbatch comes from the per-frame H footprint (auto_batch_size),
    capped by ``num_frames``; banded/spilled/fused plans take the whole
    request.  A priors file (core/autotune.py) supplies K1's bin block
    when the spec leaves it at ``None``, and the dirty-fraction threshold;
    the plan's ``tuned`` names the entry applied.

    >>> p = plan(WorkloadSpec(height=64, width=64, num_bins=8,
    ...                       device="cpu"))
    >>> p.representation, p.method, p.backend
    ('dense', 'wf_tis', 'torch')
    """
    from repro_torch.core import scans
    from repro_torch.kernels.ops import resolve_backend

    if spec.method not in scans.METHODS:
        raise ValueError(f"unknown method {spec.method!r}")
    backend = resolve_backend(spec.backend, spec.method,
                              resolve_device(spec.device))
    nf = spec.num_frames
    microbatch = auto_batch_size(spec.num_bins, spec.height, spec.width)
    if nf is not None:
        microbatch = max(1, min(microbatch, nf))
    bin_block, tuned = spec.bin_block, None
    prior = autotune.prior_for(spec)
    if prior:
        bb = prior.get("bin_block", bin_block)
        bin_block = None if bb is None else int(bb)
        tuned = autotune.config_key(spec.height, spec.width, spec.num_bins)
    common = dict(
        spec=spec, method=spec.method, backend=backend, tile=spec.tile,
        bin_block=bin_block, tuned=tuned,
        microbatch_mode="adaptive" if spec.adaptive_microbatch else "fixed")

    incremental = False
    if spec.dirty_fraction is not None:
        if not 0.0 <= spec.dirty_fraction <= 1.0:
            raise ValueError(
                f"dirty_fraction must be within [0, 1], got "
                f"{spec.dirty_fraction}")
        threshold = float(
            (prior or {}).get("delta_threshold", _DELTA_DIRTY_THRESHOLD))
        incremental = spec.mesh is None and spec.dirty_fraction <= threshold

    if spec.query_rows is not None and not incremental:
        rows = spec.query_rows
        k = len(rows)
        r = np.asarray(rows)
        if k and (r.ndim != 1 or r[0] < 0 or r[-1] >= spec.height
                  or not bool(np.all(r[1:] > r[:-1]))):
            raise ValueError(
                f"query_rows must be sorted unique within "
                f"[0, {spec.height}), got {rows[:8]}")
        rows_bytes = 4 * (1 if nf is None else nf) * spec.num_bins * k \
            * spec.width
        fits = (spec.memory_budget_bytes is None
                or rows_bytes <= spec.memory_budget_bytes)
        if 0 < k <= spec.height // _FUSE_ROW_FRACTION \
                and spec.storage is None and spec.mesh is None and fits:
            return ExecutionPlan(
                representation="fused",
                microbatch=(microbatch if nf is None else nf), **common)

    if spec.storage is not None:
        validate_storage_policy(spec.storage, spec.height, spec.width)
        if spec.mesh is not None:
            raise ValueError(
                "storage policies spill host-side; combine them with "
                "banding, not with a mesh")

    band_frames = 1 if nf is None else nf
    band_plan = None
    if spec.mesh is not None:
        mesh_shape = dict(spec.mesh.shape)
        sharding = spec.sharding
        if sharding == "auto":
            divisible = (spec.bin_axis in mesh_shape
                         and spec.num_bins % mesh_shape[spec.bin_axis] == 0)
            sharding = "bin" if divisible else "spatial"
        if sharding not in ("bin", "spatial"):
            raise ValueError(
                f"unknown sharding {spec.sharding!r} (auto|bin|spatial)")
        if sharding == "spatial" and nf is not None and nf != 1:
            # Row strips shard the rows of one (h, w) frame; an open
            # stream (nf None) is one frame at a time, which is fine.
            raise ValueError(
                "spatial (row-strip) sharding is single-frame; this "
                f"request has num_frames={spec.num_frames} — make "
                f"num_bins divisible by the {spec.bin_axis!r} mesh axis "
                "for bin sharding, or submit frames one at a time")
        row_multiple = (mesh_shape[spec.row_axis] if sharding == "spatial"
                        else 1)
        if spec.memory_budget_bytes is not None:
            band_plan = plan_bands(
                spec.height, spec.width, spec.num_bins,
                memory_budget_bytes=spec.memory_budget_bytes,
                num_frames=band_frames, row_multiple=row_multiple)
            if band_plan.num_bands == 1:
                band_plan = None
        return ExecutionPlan(
            representation="sharded", microbatch=microbatch,
            band_plan=band_plan, sharding=sharding,
            layout=choose_layout(spec.mesh, sharding,
                                 bin_axis=spec.bin_axis,
                                 row_axis=spec.row_axis),
            **common)

    if spec.memory_budget_bytes is not None:
        band_plan = plan_bands(
            spec.height, spec.width, spec.num_bins,
            memory_budget_bytes=spec.memory_budget_bytes,
            num_frames=band_frames)
        if band_plan.num_bands == 1 and spec.storage is None:
            band_plan = None
    elif spec.storage is not None:
        band_plan = plan_bands(spec.height, spec.width, spec.num_bins,
                               num_frames=band_frames)

    if spec.storage is not None:
        representation = "spilled"
    elif band_plan is not None:
        representation = "banded"
    else:
        representation = "dense"
    if representation in ("banded", "spilled") and nf is not None:
        microbatch = nf        # bands stream the whole request at once
    if representation == "dense" and spec.memory_budget_bytes is not None:
        # One band fits the budget, but the launch is microbatch frames
        # wide: cap it so the budget bounds the live H too.
        microbatch = max(1, min(
            microbatch, spec.memory_budget_bytes // spec.per_frame_h_bytes))

    return ExecutionPlan(
        representation=representation, microbatch=microbatch,
        band_plan=band_plan, storage=spec.storage, incremental=incremental,
        **common)


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------
def _window_rows(source, window, stride) -> np.ndarray:
    """The corner rows a sliding-window field reads (empty if no fit)."""
    n_r, n_c, bot, top = source._window_lattices(window, stride)
    if n_r <= 0 or n_c <= 0:
        return np.zeros((0,), np.int64)
    return np.unique(np.concatenate([bot, top[top >= 0]]))


class _GeomView:
    """Just enough HSource surface for ``needed_rows`` to run before any
    H exists: the planner asks the queries for their rows."""

    def __init__(self, height: int, width: int):
        self.height = height
        self.width = width

    _window_lattices = HSource._window_lattices


def _row_needs(queries, height: int, width: int) -> list | None:
    """Each query's declared corner rows as an array, or ``None`` when a
    query cannot declare its rows up front."""
    view = _GeomView(height, width)
    needs = []
    for q in queries:
        declare = getattr(q, "needed_rows", None)
        if declare is None:
            return None
        rows = declare(view)
        if rows is None:
            return None
        needs.append(np.asarray(rows))
    return needs


def _union_rows(needs, height: int) -> tuple[int, ...] | None:
    """The sorted union within [0, ``height``) of ``_row_needs``, or
    ``None`` when it is empty or a query declared nothing."""
    if not needs:
        return None
    rows = np.unique(np.concatenate(needs))
    rows = rows[(rows >= 0) & (rows < height)]
    if rows.size == 0:
        return None
    return tuple(rows.tolist())


def _declared_rows(queries, height: int, width: int) -> tuple[int, ...] | None:
    """The corner-row union the request will read, or ``None`` when a
    query cannot declare its rows up front."""
    return _union_rows(_row_needs(queries, height, width), height)


@dataclasses.dataclass(frozen=True)
class RegionQuery:
    """O(1) region histograms of ``rects`` (Eq. 2)."""

    rects: object

    def apply(self, source: HSource):
        return source.region_histogram(self.rects)

    def needed_rows(self, source) -> np.ndarray:
        from repro_torch.core.region_query import corner_rows

        return corner_rows(np.asarray(self.rects))


@dataclasses.dataclass(frozen=True)
class SlidingWindowQuery:
    """Histograms of every (wh, ww) window at ``stride``."""

    window: tuple[int, int]
    stride: int = 1

    def apply(self, source: HSource):
        return source.sliding_window_histograms(self.window, self.stride)

    def needed_rows(self, source) -> np.ndarray:
        return _window_rows(source, self.window, self.stride)


@dataclasses.dataclass(frozen=True)
class LikelihoodQuery:
    """Per-position similarity of window histograms to ``target``."""

    target: object
    window: tuple[int, int]
    metric: object = None
    stride: int = 1

    def apply(self, source: HSource):
        from repro_torch.core import distances

        metric = self.metric or distances.intersection
        return source.likelihood_map(self.target, self.window, metric,
                                     self.stride)

    def needed_rows(self, source) -> np.ndarray:
        return _window_rows(source, self.window, self.stride)


@dataclasses.dataclass(frozen=True)
class MultiScaleQuery:
    """Best-matching window across scales (rect, score, per-scale maps)."""

    target: object
    windows: tuple[tuple[int, int], ...]
    metric: object = None
    stride: int = 1

    def apply(self, source: HSource):
        from repro_torch.core import distances

        metric = self.metric or distances.intersection
        return source.multi_scale_search(self.target, self.windows, metric,
                                         self.stride)

    def needed_rows(self, source) -> np.ndarray:
        rows = [_window_rows(source, wnd, self.stride)
                for wnd in self.windows]
        return (np.unique(np.concatenate(rows))
                if rows else np.zeros((0,), np.int64))


def _to_device(x, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``, a host array as ``as_tensor`` makes it; a host
    tensor bound for the card goes through pinned memory and an
    asynchronous copy, so the host does not wait on the card's queue."""
    t = x if isinstance(x, torch.Tensor) else as_tensor(x, "cpu")
    if t.device == device:
        return t
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass(frozen=True, eq=False)
class TrackQuery:
    """One step of the fragments tracker (core/tracking.py, Adam et al.
    CVPR'06) for every target of every frame of the request, each target
    searched on its own frame: a fleet's capture tick, one frame a camera.

    ``boxes`` (n, t, 4) int [r0, c0, r1, c1], inside the frame as
    ``FragmentTracker.init`` clamps them; ``ref_hists`` (n, t, f, b), or a
    shape that broadcasts to it, the reference histogram of each of the
    f = gr * gc fragments of a box's ``fragments`` grid; ``radius`` the
    candidate offsets per axis.  ``apply`` returns (the new boxes (n, t, 4)
    int32, their scores (n, t) fp32): every candidate of every target
    scored by the median of its fragments' intersections with the
    reference, the first maximal candidate winning, equal bit for bit to
    ``FragmentTracker.step_on_h`` frame by frame.

    A dense H goes to ``kernels.track_vote`` (one CUDA launch on the card,
    the plain torch vote elsewhere), which clamps the candidates and
    reads their fragments' corners from the boxes on the device.  Any
    other representation is voted on its rows at ``needed_rows``.
    ``needed_rows`` reads the boxes on the host once (the query's one wait
    on the card when they live there) into ``tracking.vote_geometry``, the
    candidates' fragment corner lattices, targets x (2 R + 1) x (grid + 1)
    numbers: no fragment rect is built.  Host boxes and histograms reach
    the card through pinned memory, with no wait.  A query reads its host
    inputs once: its rows a frame size and its copies a device are made
    at their first use and kept, so a query run on tick after tick plans
    and launches from them.  Traced, the vote is a
    ``repro_torch.track`` span under its query's, and the root counts
    ``track_targets`` and ``track_rects`` (fragment histograms scored)."""

    boxes: object
    ref_hists: object
    fragments: tuple[int, int] = (2, 2)
    radius: int = 12

    @functools.cached_property
    def _host_boxes(self) -> np.ndarray:
        b = self.boxes
        return np.asarray(b.cpu() if hasattr(b, "cpu") else b, np.int64)

    def _geometry(self, h: int, w: int):
        """``tracking.vote_geometry`` of the boxes on the host, in (h, w)
        frames, made once: the planner's rows and the bound check read
        it."""
        from repro_torch.core import tracking

        made = self.__dict__.setdefault("_geometries", {})
        if (h, w) not in made:
            made[h, w] = tracking.vote_geometry(
                torch.from_numpy(self._host_boxes), self.fragments,
                self.radius, h, w)
        return made[h, w]

    def _on(self, name: str, device: torch.device) -> torch.Tensor:
        """The input ``name`` on ``device``: a tensor already there as it
        stands, anything else copied there once (``_to_device``)."""
        x = getattr(self, name)
        if isinstance(x, torch.Tensor) and x.device == device:
            return x
        made = self.__dict__.setdefault("_copies", {})
        if (name, device) not in made:
            made[name, device] = _to_device(x, device)
        return made[name, device]

    def apply(self, source: HSource):
        from repro_torch.core import tracking
        from repro_torch.kernels.track_vote import track_vote_cuda

        h, w = source.height, source.width
        gr, gc = self.fragments
        with trace.span("repro_torch.track"):
            boxes = self._on("boxes", source.device)
            n, t = boxes.shape[:2]
            trace.count(track_targets=n * t, track_rects=n * t * gr * gc
                        * (2 * self.radius + 1) ** 2)
            ref = self._on("ref_hists", source.device)
            if isinstance(source, DenseH):
                return track_vote_cuda(source.H, boxes, ref, self.fragments,
                                       self.radius)
            # Any other representation: its rows at the rows declared up
            # front, which the lattice's rows index through ``slot``.
            needed = self.needed_rows(source)
            g = self._geometry(h, w)
            cell = (torch.div(g.height + 1, gr, rounding_mode="floor")
                    * torch.div(g.width + 1, gc, rounding_mode="floor"))
            source._check_region_bound(int(cell.max()) if cell.numel() else 0)
            R = source.rows(needed)
            slot = torch.as_tensor(np.searchsorted(needed, np.arange(h)),
                                   device=R.device).clamp(max=len(needed) - 1)
            return tracking.vote_plain(R, boxes.to(R.device), ref,
                                       self.fragments, self.radius, height=h,
                                       slot=slot, reduce=source._reduce)

    def needed_rows(self, source) -> np.ndarray:
        from repro_torch.core import tracking

        made = self.__dict__.setdefault("_rows", {})
        hw = (source.height, source.width)
        if hw not in made:
            rows = tracking.candidate_rows(self._geometry(*hw), hw[0])
            rows.flags.writeable = False
            made[hw] = rows
        return made[hw]


@dataclasses.dataclass
class EngineResult:
    """What ``HistogramEngine.run`` hands back."""

    plan: ExecutionPlan
    source: HSource
    results: list


def prefetch_rows(source: HSource, queries) -> PrefetchedRowsH | None:
    """Union the corner rows every query needs and fetch them in ONE
    ``rows()`` pass; ``None`` when a query cannot declare its rows or
    none are needed."""
    needs = []
    for q in queries:
        declare = getattr(q, "needed_rows", None)
        if declare is None:
            return None
        rows = declare(source)
        if rows is None:
            return None
        needs.append(np.asarray(rows))
    needed = (np.unique(np.concatenate(needs))
              if needs else np.zeros((0,), np.int64))
    if needed.size == 0:
        return None
    return PrefetchedRowsH(source, needed, source.rows(needed))


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
class HistogramEngine:
    """Plan -> compute -> query facade.

        engine = HistogramEngine(num_bins=32)
        out = engine.run(frames, [RegionQuery(rects),
                                  LikelihoodQuery(target, (48, 48))])
        out.plan.explain()       # why this path
        out.results              # one entry per query

    ``device=None`` runs on the GPU; ``device="cpu"`` runs the plain
    torch versions.  ``engine.last_plan`` keeps the most recent plan,
    ``engine.last_verdict`` its static verdict (``validate``) and
    ``engine.last_runtime`` the ``FrameRuntime`` of the last
    ``map_frames``.  ``memory_budget_bytes`` bands an H that breaks it;
    ``storage`` spills it to the host under that policy;
    ``adaptive_microbatch`` lets ``map_frames`` retune its microbatch
    online.  ``mesh`` (a ``device.Mesh``, e.g.
    ``launch.mesh.make_host_mesh``) shards H over its devices
    (``sharding``, ``bin_axis``, ``row_axis``: core/distributed.py); the
    engine's ``device`` is then the mesh's first device, where rows and
    answers land.  Each shard computes once, at index 0 of the mesh axes
    its mapping does not use.
    """

    def __init__(
        self,
        num_bins: int = 32,
        *,
        method: str = "wf_tis",
        backend: str = "auto",
        tile: int = 128,
        bin_block: int | None = None,
        value_range: int | None = 256,
        memory_budget_bytes: int | None = None,
        storage: str | None = None,
        adaptive_microbatch: bool = False,
        mesh=None,
        sharding: str = "auto",
        bin_axis: str = "model",
        row_axis: str = "data",
        device=None,
    ):
        self.num_bins = num_bins
        self.method = method
        self.backend = backend
        self.tile = tile
        self.bin_block = bin_block
        self.value_range = value_range
        self.memory_budget_bytes = memory_budget_bytes
        self.storage = storage
        self.adaptive_microbatch = adaptive_microbatch
        self.mesh = mesh
        self.sharding = sharding
        self.bin_axis = bin_axis
        self.row_axis = row_axis
        if device is None and mesh is not None:
            device = mesh.devices.flat[0]
        self.device = None if device is None else str(device)
        self.last_plan: ExecutionPlan | None = None
        self.last_runtime = None        # FrameRuntime from map_frames
        self.last_verdict = None        # PlanVerdict from validate()
        self._kept = None               # the last request's, _repeat

    # -- planning -----------------------------------------------------------
    def spec_for(
        self, shape, dtype="uint8", *, num_frames: int | None = "infer"
    ) -> WorkloadSpec:
        """The WorkloadSpec for an (h, w) / (n, h, w) request."""
        shape = tuple(shape)
        if len(shape) == 2:
            nf = 1 if num_frames == "infer" else num_frames
        elif len(shape) == 3:
            nf = shape[0]
        else:
            raise ValueError(f"expected (h, w) or (n, h, w), got {shape}")
        return WorkloadSpec(
            height=shape[-2], width=shape[-1], num_frames=nf,
            dtype=dtype_name(dtype),
            **dict(zip(self._SETTINGS, self._settings())))

    #: The engine's settings that every request's spec takes.
    _SETTINGS = ("num_bins", "value_range", "method", "backend", "tile",
                 "bin_block", "memory_budget_bytes", "storage",
                 "adaptive_microbatch", "mesh", "sharding", "bin_axis",
                 "row_axis", "device")

    def _settings(self) -> tuple:
        return tuple(getattr(self, k) for k in self._SETTINGS)

    def plan_for(self, frames) -> ExecutionPlan:
        p = plan(self.spec_for(np.shape(frames),
                               getattr(frames, "dtype", "uint8")))
        self.last_plan = p
        return p

    # -- static validation --------------------------------------------------
    def validate(self, p: ExecutionPlan | None = None, queries=(),
                 *, deep: bool = False):
        """Statically verify a plan (``repro_torch.analysis.plancheck``):
        H shapes and dtypes by abstract evaluation on meta tensors, the
        cross-band carry chain, peak memory against the budget, shared
        memory of the CUDA launches, and the count-validity bounds for
        ``queries``; nothing launches.

        ``deep=True`` adds the CUDA kernels' proofs
        (``repro_torch.analysis.kernelcheck``: carry order within a CTA
        and across launches, exactly-once output coverage, in-bounds
        operands, shared-memory fit) at the launch the plan makes.

        Returns the ``PlanVerdict`` (also kept as ``last_verdict``;
        ``explain()`` shows it).  ``run()``/``map_frames()`` call this
        with ``deep=True`` before their first launch and raise
        ``PlanValidationError`` on a rejected plan."""
        from repro_torch.analysis.plancheck import check_plan

        if p is None:
            p = self.last_plan
        if p is None:
            raise ValueError("no plan to validate — pass one or run "
                             "plan_for() first")
        verdict = check_plan(p, tuple(queries), deep=deep)
        self.last_verdict = verdict
        return verdict

    def _validate_or_raise(self, p: ExecutionPlan, queries=()) -> None:
        from repro_torch.analysis import plancheck

        checked = plancheck.plans_checked() if trace.enabled() else None
        with trace.leaf("repro_torch.gate"):
            verdict = self.validate(p, queries, deep=True)
        if checked is not None:
            trace.count(gate_computed=int(plancheck.plans_checked() > checked))
        if not verdict.ok:
            raise PlanValidationError(
                "plan rejected by static validation:\n" + verdict.render())

    def explain(self) -> str:
        """``last_plan.explain()`` with the ``last_verdict`` appended."""
        if self.last_plan is None:
            raise ValueError("no plan yet — run plan_for()/run() first")
        return self.last_plan.explain(self.last_verdict)

    # -- execution ----------------------------------------------------------
    def _kernel_kwargs(self, p: ExecutionPlan) -> dict:
        return dict(
            method=p.method, backend=p.backend, tile=p.tile,
            bin_block=p.bin_block, value_range=p.spec.value_range,
            device=self.device,
        )

    def compute_dense(self, frames):
        """The raw (..., b, h, w) H tensor, no HSource wrapper."""
        from repro_torch.kernels.ops import integral_histogram

        return integral_histogram(
            frames, self.num_bins, method=self.method, backend=self.backend,
            tile=self.tile, bin_block=self.bin_block,
            value_range=self.value_range, device=self.device,
        )

    def compute(self, frames, p: ExecutionPlan | None = None) -> HSource:
        """Execute the plan: frames -> the planned H representation."""
        from repro_torch.core import bands as bands_mod
        from repro_torch.kernels.ops import (
            fused_corner_rows,
            integral_histogram,
        )

        if p is None:
            p = self.plan_for(frames)
        kw = self._kernel_kwargs(p)
        if p.representation == "fused":
            rows = np.asarray(p.spec.query_rows, np.int64)
            stats: dict = {}
            R = fused_corner_rows(frames, self.num_bins, rows, stats=stats,
                                  **kw)
            source = FusedRowsH(rows, R, height=p.spec.height,
                                width=p.spec.width)
            source.last_fused_stats = stats
            return source
        if p.representation == "sharded":
            return self._compute_sharded(frames, p)
        if p.representation == "spilled":
            return bands_mod.spill_banded_ih(
                frames, self.num_bins, storage=p.storage, plan=p.band_plan,
                **kw)
        if p.representation == "banded":
            return BandedH(lambda: bands_mod.iter_banded_ih(
                frames, self.num_bins, plan=p.band_plan, **kw))
        return DenseH(integral_histogram(frames, self.num_bins, **kw))

    def _compute_sharded(self, frames, p: ExecutionPlan) -> HSource:
        """The mesh plan: a ``ShardedH``, or a ``BandedH`` of sharded bands
        under a budget (core/distributed.py)."""
        from repro_torch.core import distributed

        s = p.spec
        kw = dict(method=p.method, backend=p.backend,
                  value_range=s.value_range)
        if p.band_plan is not None:
            return BandedH(lambda: distributed.iter_banded_sharded_ih(
                frames, self.num_bins, s.mesh, sharding=p.sharding,
                band_h=p.band_plan.band_h, bin_axis=s.bin_axis,
                row_axis=s.row_axis, **kw))
        if p.sharding == "bin":
            shards = distributed.bin_sharded_ih(
                frames, self.num_bins, s.mesh, bin_axis=s.bin_axis, **kw)
        else:
            shards = distributed.spatial_sharded_ih(
                frames, self.num_bins, s.mesh, row_axis=s.row_axis, **kw)
        return ShardedH(shards, s.mesh, kind=p.sharding)

    # -- incremental video path (core/delta.py) -----------------------------
    def _delta_spans(self, spec: WorkloadSpec, prev_source: HSource):
        """The band granularity dirty detection and update share: a
        spilled source's own spans, the spec's budget bands otherwise,
        16-row bands for a dense plan (no bands of its own)."""
        spans = getattr(prev_source, "spans", None)
        if spans is not None:
            return tuple(spans)
        nf = spec.num_frames
        if spec.memory_budget_bytes is not None:
            bp = plan_bands(
                spec.height, spec.width, spec.num_bins,
                memory_budget_bytes=spec.memory_budget_bytes,
                num_frames=1 if nf is None else nf)
        else:
            # Dense plans have no bands of their own: detect finely (the
            # dense walk merges adjacent spans back into maximal runs, so
            # fine detection costs no launches and recomputes less) while
            # keeping at least ~8 bands on small frames.
            band_h = max(1, min(16, -(-spec.height // 8)))
            bp = plan_bands(spec.height, spec.width, spec.num_bins,
                            band_h=band_h)
        return bp.spans

    def _delta_report(self, frames, prev_frame, prev_source: HSource,
                      spec: WorkloadSpec):
        """Dirty-band detection against a cached predecessor, or None
        when the predecessor cannot seed an update (geometry, bin or shape
        mismatch, or a representation without the hook)."""
        if self.mesh is not None:
            return None
        if not hasattr(prev_source, "update_bands"):
            return None
        if tuple(np.shape(prev_frame)) != tuple(np.shape(frames)):
            return None
        if (prev_source.height, prev_source.width) != (spec.height,
                                                       spec.width):
            return None
        if prev_source.num_bins != self.num_bins:
            return None
        return delta_mod.diff_bands(
            prev_frame, frames, self._delta_spans(spec, prev_source))

    def _updatable(self, prev_source: HSource, p: ExecutionPlan) -> bool:
        """Does the cached representation match the plan well enough to
        take the update?  (Policy mismatch -> full recompute.)"""
        if p.representation == "dense":
            return isinstance(prev_source, DenseH)
        if p.representation == "banded":
            return (isinstance(prev_source, BandedH)
                    and prev_source._factory is not None)
        if p.representation == "spilled":
            return (isinstance(prev_source, SpilledIH)
                    and prev_source.storage == p.storage
                    and prev_source.carries is not None)
        return False

    def _update(self, prev_source: HSource, frames, report,
                p: ExecutionPlan) -> HSource:
        """Drive the cached source's ``update_bands`` hook with the plan's
        kernel launch and the delta_apply slab repair."""
        from repro_torch.kernels import ops

        kw = self._kernel_kwargs(p)

        def recompute(band_rows, carry):
            return ops.integral_histogram(band_rows, self.num_bins,
                                          carry_in=carry, **kw)

        # "cuda" plans repair clean rows with K3; "torch" plans leave
        # apply_fn unset, so the dense walk takes its plain assembly.
        apply_fn = None
        if p.backend == "cuda":
            def apply_fn(slab, d, out=None):
                return ops.delta_apply(slab, d, backend="cuda", out=out)

        return prev_source.update_bands(frames, report, recompute=recompute,
                                        apply_fn=apply_fn)

    def run(self, frames, queries: Iterable = (), *,
            prev=None) -> EngineResult:
        """Plan, compute, and answer ``queries`` in order.

        The queries' declared corner-row union goes into the spec as
        ``query_rows``; when it is small the plan fuses the queries into
        the scan (``representation == "fused"``) and H is never stored.
        Several queries against a band stream share ONE stream: the union
        of their corner rows is fetched in a single ``rows()`` pass
        (``prefetch_rows``).

        ``prev=(prev_frame, prev_source)`` offers a predecessor frame and
        its H (an ``HSource`` or ``EngineResult``): when few enough rows
        changed (core/delta.py) the plan goes ``incremental`` and the
        cached H is *updated* — dirty bands recomputed, clean rows below
        carry-corrected — bit-exactly.  High motion, geometry or policy
        mismatches and sources that cannot take an update (fused,
        single-shot banded) fall back to a full recompute.

        >>> import numpy as np
        >>> frame = np.arange(64, dtype=np.uint8).reshape(8, 8) % 4
        >>> eng = HistogramEngine(num_bins=4, value_range=4, device="cpu")
        >>> out = eng.run(frame, [RegionQuery([[0, 0, 7, 7]])])
        >>> out.plan.representation      # 1 corner row -> query-fused
        'fused'
        >>> [float(v) for v in out.results[0].ravel()]
        [16.0, 16.0, 16.0, 16.0]

        On a card, with no ``prev``, budget, storage or mesh, the host
        frames' copy to the card is queued first, so it runs while the host
        plans; ``run`` waits for the copy, not for the computation, before
        it returns, and the caller may then reuse the host buffer.  A request
        that repeats the engine's last one (frame shape and dtype, settings,
        tuned priors, and queries that keep their rows, as ``TrackQuery``)
        takes that one's plan and gate verdict (``_repeat``).

        Under ``torch.profiler`` each step is a span of
        ``repro_torch.trace`` (``repro_torch.run`` over ``plan``, ``gate``,
        ``compute`` and one ``query`` a query; on a card that stages first,
        a ``stage`` before ``plan``), with the request's counters on the
        root.
        """
        with trace.request():
            return self._run(frames, list(queries), prev)

    def _stages_first(self, prev) -> bool:
        """Do the frames go to the card before the plan?  Only where every
        plan the engine can make stages them whole there first: on a card,
        with no predecessor, budget, storage or mesh."""
        if (prev is not None or self.mesh is not None
                or self.memory_budget_bytes is not None
                or self.storage is not None):
            return False
        if self.device is None:
            return torch.cuda.is_available()
        return torch.device(self.device).type == "cuda"

    def _run(self, frames, queries: list, prev) -> EngineResult:
        shape, dtype = np.shape(frames), getattr(frames, "dtype", "uint8")
        staged = None
        if self._stages_first(prev):
            # The copy runs on the card while the host plans; the host
            # frames are waited on before run() hands them back.
            with trace.span("repro_torch.stage"):
                frames, staged = stage_async(frames, self.device)
        try:
            return self._plan_and_compute(frames, shape, dtype, queries, prev)
        finally:
            if staged is not None:
                staged.synchronize()

    def _repeat(self, shape, dtype, queries):
        """(plan, verdict) of the engine's last request when this one
        repeats it, else ``None``.  A repeat has the last one's frame shape
        and dtype, engine settings and tuned priors, and queries that hand
        over the very read-only row arrays they handed over then: such a
        query keeps its rows and reads its inputs once (``TrackQuery``), so
        the spec, the plan and the gate's verdict would come out as they
        did."""
        kept = self._kept
        if kept is None or kept[0] != (shape, dtype_name(dtype),
                                       self._settings()):
            return None
        needs = _row_needs(queries, shape[-2], shape[-1])
        if (not needs or len(needs) != len(kept[1])
                or not all(a is b and not a.flags.writeable
                           for a, b in zip(needs, kept[1]))):
            return None
        p, verdict = kept[2], kept[3]
        if autotune.prior_for(p.spec) != kept[4]:
            return None
        return p, verdict

    def _keep(self, shape, dtype, needs, p: ExecutionPlan) -> None:
        """Keep the request just gated for ``_repeat`` when each of its
        queries declared a read-only array of rows."""
        self._kept = None
        if needs and all(not a.flags.writeable for a in needs):
            self._kept = ((shape, dtype_name(dtype), self._settings()),
                          needs, p, self.last_verdict,
                          autotune.prior_for(p.spec))

    def _plan_and_compute(self, frames, shape, dtype, queries: list,
                          prev) -> EngineResult:
        with trace.span("repro_torch.plan"):
            repeat = None if prev is not None else self._repeat(
                shape, dtype, queries)
            prev_source = report = None
            if repeat is not None:
                p, verdict = repeat
            else:
                spec = self.spec_for(shape, dtype)
                needs = _row_needs(queries, spec.height, spec.width)
                rows = _union_rows(needs, spec.height)
                if rows is not None:
                    spec = dataclasses.replace(spec, query_rows=rows)
                if prev is not None:
                    prev_frame, prev_source = prev
                    if isinstance(prev_source, EngineResult):
                        prev_source = prev_source.source
                    report = self._delta_report(frames, prev_frame,
                                                prev_source, spec)
                    if report is not None:
                        spec = dataclasses.replace(
                            spec, dirty_fraction=report.dirty_fraction)
                p = plan(spec)
                if p.incremental and not self._updatable(prev_source, p):
                    # The cached representation cannot take the update
                    # (policy mismatch, single-shot stream, ...): re-plan
                    # for a full recompute rather than fail.
                    spec = dataclasses.replace(spec, dirty_fraction=None)
                    p = plan(spec)
        rows = p.spec.query_rows
        trace.count(representation=p.representation,
                    corner_rows=0 if rows is None else len(rows))
        self.last_plan = p
        if repeat is None:
            self._validate_or_raise(p, queries)
            if prev is None:
                self._keep(shape, dtype, needs, p)
        else:
            # The gate's verdict on this very plan and these queries.
            self.last_verdict = verdict
            with trace.leaf("repro_torch.gate"):
                pass
            if trace.enabled():
                trace.count(gate_computed=0)
        with trace.span("repro_torch.compute"):
            if p.incremental:
                source = self._update(prev_source, frames, report, p)
            else:
                source = self.compute(frames, p)
            target = source
            if len(queries) > 1 and isinstance(source, BandedH):
                # The one rows() pass every query then reads.
                target = prefetch_rows(source, queries) or source
        results = []
        for q in queries:
            with trace.span("repro_torch.query", kind=type(q).__name__):
                results.append(q.apply(target))
        return EngineResult(plan=p, source=source, results=results)

    # -- streaming ----------------------------------------------------------
    def runtime_for(self, p: ExecutionPlan, step=None, *, depth: int = 2,
                    **kw):
        """A ``FrameRuntime`` (core/runtime.py) configured from a plan:
        microbatch size and fixed/adaptive mode come from the planner,
        the in-flight window from the caller.  ``step`` defaults to the
        engine's dense compute lifted to the runtime signature."""
        from repro_torch.core.runtime import FrameRuntime

        if step is None:
            step = FrameRuntime.stateless(self.compute_dense)
        return FrameRuntime(
            step, depth=depth, microbatch=p.microbatch,
            adaptive=(p.microbatch_mode == "adaptive"), device=self.device,
            **kw)

    def map_frames(self, frames: Iterable, *, depth: int = 2) -> Iterator:
        """Stream per-frame H's with planner-chosen microbatching and
        ``depth`` dispatches in flight (paper §4.4 double buffering): host
        frames are staged through pinned buffers on a copy stream while
        earlier frames compute.  An ``adaptive_microbatch`` engine hands
        the runtime the plan's size as a starting point and lets its
        online controller retune it from measured per-dispatch latency.
        A plan that is not dense, or that static validation rejects, is
        refused before the first launch."""
        frames = iter(frames)
        try:
            first = next(frames)
        except StopIteration:
            return iter(())
        p = plan(self.spec_for(np.shape(first),
                               getattr(first, "dtype", "uint8"),
                               num_frames=None))
        self.last_plan = p
        if p.representation != "dense":
            # Streaming yields one dense (b, h, w) H per frame; executing
            # a banded/spilled/sharded plan here would silently ignore the
            # budget, storage or mesh the engine was configured with.
            raise ValueError(
                f"map_frames streams dense per-frame H's, but the plan "
                f"chose {p.representation!r} for {p.spec.height}x"
                f"{p.spec.width}x{p.spec.num_bins}; run each frame "
                "through engine.run()/compute() instead")
        self._validate_or_raise(p)
        runtime = self.runtime_for(p, depth=depth)
        self.last_runtime = runtime
        return runtime.map_frames(itertools.chain([first], frames))

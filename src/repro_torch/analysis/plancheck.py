"""Static plan validation: decide feasibility before a dispatch runs.

Port of ``repro/analysis/plancheck.py``.  ``check_plan(plan, queries=())``
verifies an :class:`~repro_torch.core.engine.ExecutionPlan` without
executing it, by abstract evaluation on meta tensors (the counterpart of
``jax.eval_shape``: shapes and dtypes, no values, no device memory) and
the planner's own metadata:

  * **representation**: the decision is internally consistent (known
    representation, mesh-axis divisibility for sharded plans);
  * **h-shape**: the kernel the plan selects produces the (..., b, h, w)
    fp32 H the representation expects.  A ``torch`` plan runs its plain
    scans on meta tensors; a ``cuda`` plan runs each wrapper's own checks
    and launch shape (raising as they would on the card, e.g. for more
    row strips than the grid holds), allocates its outputs on meta and
    launches nothing;
  * **carry-chain**: every band height accepts and re-emits the
    (..., b, w) bottom-row carry (again on meta tensors);
  * **memory-budget**: the peak live H (microbatch x per-frame H for
    dense, the largest band for banded/spilled) fits
    ``memory_budget_bytes``;
  * **smem-fit**: ``cuda`` plans: the shared memory a CTA of the plan's
    launches takes fits the H100's 232,448 B, from the kernels' own specs
    (kernelcheck) at the launch the wrapper would pick;
  * **count-validity**: the §4.6 exactness regime (storage-policy plans
    fail past the fp32 exact range, plain fp32 plans warn);
  * **incremental**: video-delta plans only, the dirty-fraction input and
    the bytes recomputed and reused;
  * **mesh-layout**: sharded plans only, the replica x shard layout;
  * **query-validity**: when queries are given, each query's largest
    region fits the plan's exact-count bound;
  * with ``deep=True``, kernelcheck's four proofs for the plan's kernels
    (kernel-carry, kernel-coverage, kernel-bounds, kernel-smem).

The verdict is cached per plan (plans are frozen, hashable dataclasses),
but for the incremental and query lines, computed fresh each time: an
incremental plan is new with each video frame's dirty fraction, and its
other lines are cached without it.  A new plan, such as a fused one with
new corner rows, reuses two caches below it: the meta evaluation, keyed on
the fields that fix shapes, and kernelcheck's enumeration proofs, keyed on
the canonical launch geometry.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.bands import FP32_EXACT_COUNT, STORAGE_POLICIES
from repro_torch.kernels.fused_rows import check_rows
from repro_torch.kernels.specs import SMEM_LIMIT_BYTES

@dataclasses.dataclass(frozen=True)
class PlanCheck:
    """One verified property: ``status`` is ok | warn | fail | skip."""

    name: str
    status: str
    detail: str

    def render(self) -> str:
        return f"{self.status.upper():4s} {self.name:15s} {self.detail}"


@dataclasses.dataclass(frozen=True)
class PlanVerdict:
    """The static feasibility verdict for one plan."""

    checks: tuple[PlanCheck, ...]

    @property
    def ok(self) -> bool:
        return not self.failures

    @property
    def failures(self) -> tuple[PlanCheck, ...]:
        return tuple(c for c in self.checks if c.status == "fail")

    def render(self) -> str:
        head = "plan verdict    : " + (
            "OK (statically feasible)" if self.ok
            else f"REJECTED ({len(self.failures)} infeasible)"
        )
        lines = [head]
        lines += [f"  {c.render()}" for c in self.checks]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# abstract evaluation on meta tensors
# ---------------------------------------------------------------------------
def _lead(plan) -> tuple:
    nf = plan.spec.num_frames
    return () if nf is None or nf == 1 else (int(nf),)


class _Dispatch(NamedTuple):
    """The fields of a plan that fix its dispatch's shapes (not the dirty
    fraction, new with every video frame): the meta evaluations' key."""
    method: str
    backend: str
    tile: int
    bin_block: int | None
    lead: tuple
    dtype: str
    num_bins: int
    value_range: int | None


def _dispatch(plan) -> _Dispatch:
    s = plan.spec
    return _Dispatch(plan.method, plan.backend, plan.tile, plan.bin_block,
                     _lead(plan), s.dtype, s.num_bins, s.value_range)


@functools.lru_cache(maxsize=256)
def _abstract_eval(d: _Dispatch, h: int, w: int, carry: bool,
                   rows: tuple[int, int] | None):
    """The plan's dispatch on a meta (lead, h, w) frame: (shape, dtype) of
    what it yields, or the exception it raised.  ``rows=None`` runs the
    kernel (with a (lead, bins, w) carry-in when ``carry``); ``rows = (k,
    h_cut)`` the fused dispatch of ``k`` sorted rows whose last lies in
    the tile-high band ending at ``h_cut``: the rows reach the dispatch's
    shapes only through their count and that early cut, so the eval runs
    on the last ``k`` rows above it (``_check_h_shape`` checks the plan's
    own rows first)."""
    from repro_torch.kernels.ops import fused_corner_rows, integral_histogram

    frames = torch.empty((*d.lead, h, w), dtype=getattr(torch, d.dtype),
                         device="meta")
    kwargs = dict(method=d.method, backend=d.backend, tile=d.tile,
                  bin_block=d.bin_block, value_range=d.value_range,
                  device="meta")
    try:
        if rows is None:
            out = integral_histogram(
                frames, d.num_bins, carry_in=torch.empty(
                    (*d.lead, d.num_bins, w), device="meta") if carry
                else None, **kwargs)
        else:
            k, h_cut = rows
            out = fused_corner_rows(frames, d.num_bins,
                                    np.arange(h_cut - k, h_cut), **kwargs)
    except Exception as e:  # abstract eval surfaces kernel/shape errors
        return e
    return tuple(out.shape), out.dtype


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------
def _check_representation(plan) -> PlanCheck:
    name = "representation"
    s = plan.spec
    known = ("dense", "banded", "spilled", "sharded", "fused")
    if plan.representation not in known:
        return PlanCheck(name, "fail",
                         f"unknown representation {plan.representation!r}")
    if plan.representation == "fused":
        if not s.query_rows:
            return PlanCheck(
                name, "fail",
                "fused plan without query_rows — nothing declares which "
                "corner rows to emit")
        return PlanCheck(
            name, "ok",
            f"fused: {len(s.query_rows)} corner row(s), H never stored")
    if plan.representation == "sharded":
        if s.mesh is None:
            return PlanCheck(name, "fail", "sharded plan without a mesh")
        shape = dict(s.mesh.shape)
        axis = s.bin_axis if plan.sharding == "bin" else s.row_axis
        size = shape.get(axis)
        if size is None:
            return PlanCheck(
                name, "fail",
                f"mesh has no {axis!r} axis (axes: {sorted(shape)})")
        extent = s.num_bins if plan.sharding == "bin" else s.height
        what = "num_bins" if plan.sharding == "bin" else "height"
        if extent % size != 0:
            return PlanCheck(
                name, "fail",
                f"{what}={extent} not divisible by mesh axis "
                f"{axis!r} ({size} devices)")
        return PlanCheck(
            name, "ok",
            f"sharded[{plan.sharding}]: {what}={extent} over "
            f"{size} devices")
    if plan.storage is not None and plan.representation != "spilled":
        return PlanCheck(
            name, "fail",
            f"storage policy {plan.storage!r} on a "
            f"{plan.representation!r} plan (must spill)")
    return PlanCheck(name, "ok", plan.representation)


def _check_h_shape(plan) -> PlanCheck:
    name = "h-shape"
    s = plan.spec
    d = _dispatch(plan)
    if plan.representation == "fused":
        try:
            rows = check_rows(s.query_rows, s.height)
        except ValueError as e:
            out = e
        else:
            h_cut = min(s.height, (int(rows[-1]) // plan.tile + 1)
                        * plan.tile)
            out = _abstract_eval(d, s.height, s.width, False,
                                 (rows.size, h_cut))
        if isinstance(out, Exception):
            return PlanCheck(name, "fail", f"fused abstract eval: {out}")
        shape, dtype = out
        expect = (*_lead(plan), s.num_bins, len(s.query_rows), s.width)
        if shape != expect:
            return PlanCheck(
                name, "fail",
                f"fused dispatch yields {shape}, plan expects "
                f"the corner-row slab {expect}")
        if dtype != torch.float32:
            return PlanCheck(
                name, "fail",
                f"fused dispatch yields {dtype}, engine arithmetic "
                "is fp32")
        return PlanCheck(
            name, "ok",
            f"corner-row slab {expect} float32 via fused "
            f"{plan.method}/{plan.backend}")
    out = _abstract_eval(d, s.height, s.width, False, None)
    if isinstance(out, Exception):
        return PlanCheck(name, "fail", f"kernel abstract eval: {out}")
    shape, dtype = out
    expect = (*_lead(plan), s.num_bins, s.height, s.width)
    if shape != expect:
        return PlanCheck(
            name, "fail",
            f"kernel yields {shape}, plan expects {expect}")
    if dtype != torch.float32:
        return PlanCheck(
            name, "fail",
            f"kernel yields {dtype}, engine arithmetic is fp32")
    return PlanCheck(
        name, "ok", f"{expect} float32 via {plan.method}/{plan.backend}")


def _check_carry_chain(plan) -> PlanCheck:
    name = "carry-chain"
    s = plan.spec
    if plan.band_plan is None:
        return PlanCheck(name, "skip", "single-band plan has no carry")
    heights = sorted({r1 - r0 for r0, r1 in plan.band_plan.spans})
    carry_shape = (*_lead(plan), s.num_bins, s.width)
    for bh in heights:
        out = _abstract_eval(_dispatch(plan), bh, s.width, True, None)
        if isinstance(out, Exception):
            return PlanCheck(
                name, "fail",
                f"{bh}-row band rejects the {carry_shape} carry: {out}")
        band_expect = (*_lead(plan), s.num_bins, bh, s.width)
        if out[0] != band_expect:
            return PlanCheck(
                name, "fail",
                f"{bh}-row band yields {out[0]}, expected {band_expect}")
        # next carry = H_band[..., -1, :]; shape follows from band_expect
        emitted = band_expect[:-2] + band_expect[-1:]
        if emitted != carry_shape:
            return PlanCheck(
                name, "fail",
                f"{bh}-row band re-emits carry {emitted}, "
                f"chain needs {carry_shape}")
    return PlanCheck(
        name, "ok",
        f"{plan.band_plan.num_bands} bands (heights {heights}) thread a "
        f"{carry_shape} carry")


def _check_memory_budget(plan) -> PlanCheck:
    name = "memory-budget"
    s = plan.spec
    budget = s.memory_budget_bytes
    if budget is None:
        return PlanCheck(name, "skip", "no memory budget declared")
    if plan.representation == "fused":
        k = len(s.query_rows)
        nf = 1 if s.num_frames is None else s.num_frames
        live = 4 * nf * s.num_bins * k * s.width
        what = f"fused corner-row slab ({k} row(s))"
    elif plan.band_plan is not None:
        live = plan.band_plan.band_bytes
        what = f"largest band ({plan.band_plan.band_h} rows)"
    else:
        live = plan.microbatch * s.per_frame_h_bytes
        what = f"microbatch of {plan.microbatch} frame(s)"
    if live > budget:
        return PlanCheck(
            name, "fail",
            f"{what} holds {live} B of live H > {budget} B budget")
    return PlanCheck(name, "ok", f"{what}: {live} B <= {budget} B budget")


def _launch_specs(plan):
    """The ``KernelSpec``s of a ``cuda`` plan's launches at its real
    geometry, resolved as the wrapper resolves them at dispatch; the
    ``KeyError`` of a method without a spec, or the error the wrapper's
    launch choice raises.  Built once a plan for smem-fit and the deep
    checks."""
    from repro_torch.analysis import kernelcheck

    try:
        return kernelcheck.specs_for(kernelcheck.plan_method(plan),
                                     kernelcheck.plan_geometry(plan))
    except (KeyError, ValueError, NotImplementedError) as e:
        return e


def _check_smem_fit(plan, specs) -> PlanCheck:
    from repro_torch.analysis import kernelcheck

    name = "smem-fit"
    if plan.backend != "cuda":
        return PlanCheck(name, "skip", f"{plan.backend} backend uses HBM")
    if isinstance(specs, KeyError):
        return PlanCheck(
            name, "skip",
            f"no shared-memory model for method {plan.method!r}")
    if isinstance(specs, Exception):
        return PlanCheck(name, "fail", f"the launch is refused: {specs}")
    nbytes, detail = kernelcheck.peak_smem(specs)
    if nbytes > SMEM_LIMIT_BYTES:
        return PlanCheck(
            name, "fail",
            f"~{nbytes} B ({detail}) exceeds the {SMEM_LIMIT_BYTES} B "
            "one CTA of an H100 may use — shrink bin_block")
    return PlanCheck(
        name, "ok", f"~{nbytes} B of {SMEM_LIMIT_BYTES} B ({detail})")


def _plan_exact_bound(plan) -> int:
    """Largest region pixel count queries on this plan read back exactly."""
    if plan.storage is not None:
        return int(STORAGE_POLICIES[plan.storage][1])
    return FP32_EXACT_COUNT - 1


def _check_count_validity(plan) -> PlanCheck:
    name = "count-validity"
    s = plan.spec
    px = s.height * s.width
    if plan.storage is not None:
        bound = _plan_exact_bound(plan)
        if px >= FP32_EXACT_COUNT:
            return PlanCheck(
                name, "fail",
                f"{s.height}x{s.width} frame accumulates up to {px} "
                f"counts, beyond fp32 exact range {FP32_EXACT_COUNT} — "
                f"no storage policy recovers exactness; shard spatially")
        return PlanCheck(
            name, "ok",
            f"{plan.storage} spill: regions <= {bound} px exact "
            f"(modular arithmetic)")
    if px >= FP32_EXACT_COUNT:
        return PlanCheck(
            name, "warn",
            f"{px}-px frame exceeds the fp32 exact range "
            f"{FP32_EXACT_COUNT}; only regions <= "
            f"{FP32_EXACT_COUNT - 1} px are exact (enforced per query)")
    return PlanCheck(
        name, "ok", f"{px}-px frame within fp32 exact range")


def _check_incremental(plan) -> PlanCheck:
    """Price and validate an incremental (video-delta) plan: the
    dirty-fraction decision input must be present and sane, and the
    representation must expose the ``update_bands`` hook."""
    name = "incremental"
    s = plan.spec
    df = s.dirty_fraction
    if df is None:
        return PlanCheck(
            name, "fail",
            "incremental plan without a dirty_fraction — nothing measured "
            "the frame delta that justifies an update")
    if not 0.0 <= df <= 1.0:
        return PlanCheck(
            name, "fail", f"dirty_fraction {df} outside [0, 1]")
    if plan.representation in ("fused", "sharded"):
        return PlanCheck(
            name, "fail",
            f"{plan.representation!r} representation cannot update in "
            "place (no cached H to repair)")
    per_frame = s.per_frame_h_bytes
    recomputed = int(round(df * per_frame))
    return PlanCheck(
        name, "ok",
        f"dirty fraction {df:.2f}: recompute ~{recomputed} B/frame, "
        f"reuse ~{per_frame - recomputed} B/frame of cached H")


def _check_layout(plan) -> PlanCheck:
    """Validate the planner's replica x shard mesh layout: the shard axis
    and every replica axis must exist in the mesh, be disjoint, and their
    product must cover the whole device set."""
    name = "mesh-layout"
    s = plan.spec
    lay = plan.layout
    if plan.representation != "sharded" or s.mesh is None:
        return PlanCheck(
            name, "fail",
            f"layout on a {plan.representation!r} plan without a mesh")
    shape = dict(s.mesh.shape)
    if lay.shard_axis not in shape:
        return PlanCheck(
            name, "fail",
            f"shard axis {lay.shard_axis!r} not in mesh axes "
            f"{tuple(shape)}")
    if lay.kind != plan.sharding:
        return PlanCheck(
            name, "fail",
            f"layout kind {lay.kind!r} disagrees with plan sharding "
            f"{plan.sharding!r}")
    if lay.shard_axis in lay.replica_axes:
        return PlanCheck(
            name, "fail",
            f"shard axis {lay.shard_axis!r} doubles as a replica axis")
    missing = [a for a in lay.replica_axes if a not in shape]
    if missing:
        return PlanCheck(
            name, "fail", f"replica axes {missing} not in mesh")
    mesh_devices = 1
    for v in shape.values():
        mesh_devices *= v
    covered = lay.num_groups * lay.shards_per_group
    if covered != mesh_devices or lay.shards_per_group != shape[lay.shard_axis]:
        return PlanCheck(
            name, "fail",
            f"layout covers {covered} of {mesh_devices} mesh devices")
    return PlanCheck(name, "ok", lay.describe())


def _query_area(query) -> int | None:
    """Largest region/window pixel area a query touches, else None."""
    rects = getattr(query, "rects", None)
    if rects is not None:
        r = np.asarray(rects).reshape(-1, 4)
        if r.size == 0:
            return 0
        return int(((r[:, 2] - r[:, 0] + 1)
                    * (r[:, 3] - r[:, 1] + 1)).max())
    windows = getattr(query, "windows", None)
    if windows is not None:
        return max((int(wh) * int(ww) for wh, ww in windows), default=0)
    window = getattr(query, "window", None)
    if window is not None:
        wh, ww = window
        return int(wh) * int(ww)
    return None


def _check_queries(plan, queries) -> PlanCheck:
    name = "query-validity"
    bound = _plan_exact_bound(plan)
    worst = 0
    opaque = 0
    for q in queries:
        area = _query_area(q)
        if area is None:
            opaque += 1
            continue
        if area > bound:
            return PlanCheck(
                name, "fail",
                f"{type(q).__name__} touches a {area}-px region, beyond "
                f"the plan's exact-count bound {bound} px"
                + (f" ({plan.storage} modular arithmetic wraps)"
                   if plan.storage else " (fp32 exactness)"))
        worst = max(worst, area)
    detail = f"largest region {worst} px <= {bound} px bound"
    if opaque:
        detail += f" ({opaque} query(ies) undeclared — checked at run time)"
    return PlanCheck(name, "ok", detail)


# ---------------------------------------------------------------------------
# deep checks: kernelcheck's proofs, as PlanChecks
# ---------------------------------------------------------------------------
#: kernelcheck check name -> the PlanCheck name it merges under.
_KERNEL_CHECK_NAMES = {
    "carry-order": "kernel-carry",
    "out-coverage": "kernel-coverage",
    "in-bounds": "kernel-bounds",
    "smem-fit": "kernel-smem",
}


def _kernel_checks(plan, specs) -> tuple[PlanCheck, ...]:
    """The four kernelcheck properties for the plan's kernels, folded
    across launches (a method with two launches fails a property when
    either does).  One skip line when the plan launches no CUDA kernel."""
    from repro_torch.analysis import kernelcheck

    if plan.backend != "cuda":
        return (PlanCheck(
            "kernel-checks", "skip",
            f"{plan.backend} backend dispatches no CUDA kernel"),)
    if isinstance(specs, KeyError):
        return (PlanCheck(
            "kernel-checks", "fail",
            f"cuda plan without a KernelSpec contract: {specs}"),)
    if isinstance(specs, Exception):
        return (PlanCheck(
            "kernel-checks", "fail", f"the launch is refused: {specs}"),)
    verdict = kernelcheck.check_launches(kernelcheck.plan_method(plan),
                                         specs)
    merged = []
    for kname, pname in _KERNEL_CHECK_NAMES.items():
        per_launch = [c for c in verdict.checks if c.name == kname]
        bad = [c for c in per_launch if not c.ok]
        if bad:
            merged.append(PlanCheck(pname, "fail", "; ".join(
                f"[{c.kernel}] {c.detail}" for c in bad)))
        else:
            merged.append(PlanCheck(pname, "ok", "; ".join(
                f"[{c.kernel}] {c.detail}" for c in per_launch)))
    return tuple(merged)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=256)
def _plan_checks(plan, deep: bool) -> tuple[tuple[PlanCheck, ...],
                                             tuple[PlanCheck, ...]]:
    """The plan's checks but the incremental line: the ones before it and
    the ones after it."""
    specs = _launch_specs(plan) if plan.backend == "cuda" else None
    head = (
        _check_representation(plan),
        _check_h_shape(plan),
        _check_carry_chain(plan),
        _check_memory_budget(plan),
        _check_smem_fit(plan, specs),
        _check_count_validity(plan),
    )
    # Only sharded plans carry a mesh layout, as in the reference.
    tail = ((_check_layout(plan),)
            if getattr(plan, "layout", None) is not None else ())
    if deep:
        tail = tail + _kernel_checks(plan, specs)
    return head, tail


def plans_checked() -> int:
    """How many plans' checks were worked out, not taken from the cache,
    so far: the engine's trace tells a computed gate from a cached one."""
    return _plan_checks.cache_info().misses


def clear_caches() -> None:
    """Forget every cached verdict, meta evaluation and kernel proof (a
    first, uncached call; a test that patches ``ops.KERNEL_SPECS``)."""
    from repro_torch.analysis import kernelcheck

    _plan_checks.cache_clear()
    _abstract_eval.cache_clear()
    kernelcheck._proofs.cache_clear()


def check_plan(plan, queries=(), *, deep: bool = False) -> PlanVerdict:
    """Statically verify a plan (and optionally its queries).

    ``deep=True`` adds kernelcheck's proofs (carry order, output
    coverage, in-bounds operands, shared-memory fit) for ``cuda`` plans;
    the engine's pre-dispatch gate (``_validate_or_raise``) always runs
    deep.  The plan's checks are cached per plan; the incremental and
    query lines are cheap arithmetic computed fresh (the dirty fraction
    changes with every video frame, queries carry unhashable arrays)."""
    # The dirty fraction, new with every video frame, reaches only the
    # incremental line, which is computed fresh like the query line.
    key = plan
    if plan.spec.dirty_fraction is not None:
        key = dataclasses.replace(plan, spec=dataclasses.replace(
            plan.spec, dirty_fraction=None))
    head, tail = _plan_checks(key, deep)
    # Only incremental plans carry the extra line, as in the reference.
    incremental = ((_check_incremental(plan),)
                   if getattr(plan, "incremental", False) else ())
    checks = head + incremental + tail
    queries = tuple(queries) if not isinstance(queries, tuple) else queries
    if queries:
        checks = checks + (_check_queries(plan, queries),)
    return PlanVerdict(checks=checks)

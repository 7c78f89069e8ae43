"""Static verification of the CUDA kernels' launch contracts.

Port of ``repro/analysis/kernelcheck.py``.  The reference proves its Pallas
kernels correct under a sequential grid: a TPU core walks the grid in
order, so a value may pass from one grid step to the next in VMEM.  CUDA
CTAs run in parallel and in no order, so the port's kernels carry values
only along serial loops inside one CTA, or from one launch to a later one
on the same stream (K1's count pre-pass to its strips, K2's pass A to pass
B, K4's hscan to vscan).  This module proves that from the declarative
:class:`~repro_torch.kernels.specs.KernelSpec` each kernel module builds
beside its wrapper.

Four checks per launch:

  * **carry-order**: every value a step consumes was last written by its
    declared producer, either the same CTA at an earlier iteration of its
    loops (in their declared order) or a point of an earlier launch.  An
    edge whose producer is another CTA of the same launch fails: CTAs have
    no order.  The steps are enumerated under four CTA orders (grid order,
    reversed, and both interleaved step by step across CTAs), and every
    order must give the same verdict, so a cell two CTAs share shows as a
    race.
  * **out-coverage**: the out maps write every output block exactly once
    over CTAs x loop steps (a ragged last block counts once where the
    kernel guards it).
  * **in-bounds**: every block index stays inside the logical operand
    after the kernel's guards: a guarded dimension's block starts inside
    the extent, any other lies wholly inside.
  * **smem-fit**: static plus dynamic shared bytes fit the 232,448 B one
    CTA of an H100 may use, and a launch whose dynamic part passes 48 KiB
    opts in to it (``cudaFuncAttributeMaxDynamicSharedMemorySize``).

Enumeration runs on ``KernelGeometry.canonical()`` (frames pinned to 2,
grid dimensions and loops clamped to 3 blocks); smem-fit prices the real
geometry; the enumeration proofs are cached by the canonical geometry.
Entry points: ``check_method`` (one method, one geometry),
``check_kernels`` (the registry: ``--check-kernels``), and
``plan_method``/``plan_geometry``/``smem_required`` (the plancheck bridge).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools

from repro_torch.kernels.specs import (
    SMEM_DEFAULT_BYTES,
    SMEM_LIMIT_BYTES,
    KernelGeometry,
    KernelSpec,
)

#: how many violations a failing check reports before truncating.
_MAX_VIOLATIONS = 3

#: the CTA orders every carry proof must hold under.
SCHEDULES = ("grid order", "reversed", "interleaved", "interleaved reversed")


@dataclasses.dataclass(frozen=True)
class KernelCheck:
    """One verified kernel property: ``status`` is ok | fail."""

    kernel: str                 # KernelSpec name, e.g. "cw_tis/vscan"
    name: str                   # carry-order | out-coverage | in-bounds | smem-fit
    status: str
    detail: str

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def render(self) -> str:
        return (f"{self.status.upper():4s} {self.name:12s} "
                f"[{self.kernel}] {self.detail}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class KernelVerdict:
    """All checks for one method at one geometry."""

    method: str
    geometry: KernelGeometry
    checks: tuple[KernelCheck, ...]

    @property
    def ok(self) -> bool:
        return not self.failures

    @property
    def failures(self) -> tuple[KernelCheck, ...]:
        return tuple(c for c in self.checks if c.status == "fail")

    def render(self) -> str:
        g = self.geometry
        head = (
            f"kernelcheck {self.method} @ {g.n}x{g.h}x{g.w}/{g.num_bins} "
            f"bins ({g.describe()}): "
            + ("OK" if self.ok else f"REJECTED ({len(self.failures)})")
        )
        return "\n".join([head] + [f"  {c.render()}" for c in self.checks])

    def to_json(self) -> dict:
        return {
            "method": self.method,
            "geometry": dataclasses.asdict(self.geometry),
            "ok": self.ok,
            "checks": [c.to_json() for c in self.checks],
        }


# ---------------------------------------------------------------------------
# enumeration
# ---------------------------------------------------------------------------
def _points(dims) -> list[dict]:
    names = [name for name, _ in dims]
    return [dict(zip(names, idx))
            for idx in itertools.product(*(range(size) for _, size in dims))]


def iter_steps(spec: KernelSpec, schedule: str = SCHEDULES[0]):
    """Active steps (grid point and loop point in one dict) under a CTA
    ``schedule``: each CTA's whole walk in turn (grid order or reversed),
    or every CTA's first iteration, then every CTA's second, and so on
    (interleaved).  Inside a CTA the loops run in their declared order."""
    ctas = _points(spec.grid)
    if schedule.endswith("reversed"):
        ctas.reverse()
    loops = _points(spec.loops)
    if schedule.startswith("interleaved"):
        pairs = ((c, lp) for lp in loops for c in ctas)
    else:
        pairs = ((c, lp) for c in ctas for lp in loops)
    for c, lp in pairs:
        point = {**c, **lp}
        if spec.active is None or spec.active(point):
            yield point


def _key(spec: KernelSpec, point) -> tuple[int, ...]:
    return tuple(point[d] for d in spec.step_names)


def _fmt(point) -> str:
    return "(" + ", ".join(f"{k}={v}" for k, v in point.items()
                           if k != "pass") + ")"


# ---------------------------------------------------------------------------
# check (1): carry order
# ---------------------------------------------------------------------------
def _edge_problem(spec, point, cell, producer, last, earlier) -> str | None:
    """Why the edge (cell, producer) at ``point`` does not hold, or None."""
    src = producer.get("pass", spec.name)
    if src != spec.name:
        prev = earlier.get(src)
        if prev is None:
            return (f"step {_fmt(point)} reads {cell!r} from launch "
                    f"{src!r}, which does not run earlier on the stream")
        want = (src, _key(prev, producer))
    else:
        if any(producer[d] != point[d] for d in spec.dim_names):
            cta = _fmt({d: producer[d] for d in spec.dim_names})
            return (f"step {_fmt(point)} reads {cell!r} from CTA {cta} of "
                    "the same launch: CTAs run in parallel and in no "
                    "order, so no CTA may consume another's write")
        mine = tuple(point[d] for d in spec.loop_names)
        theirs = tuple(producer[d] for d in spec.loop_names)
        if theirs >= mine:
            return (f"step {_fmt(point)} reads {cell!r} from loop step "
                    f"{theirs}, which does not come before {mine} in the "
                    "CTA's loop order")
        want = (src, _key(spec, producer))
    got = last.get(cell)
    if got is None:
        return (f"step {_fmt(point)} reads {cell!r} before any write "
                f"(declared producer {want})")
    if got != want:
        return (f"step {_fmt(point)} reads {cell!r} expecting the value "
                f"from {want}, but the last write was at {got}: the "
                "declared loop order does not realize the carry chain")
    return None


def check_carry_order(spec: KernelSpec,
                      earlier: tuple[KernelSpec, ...] = ()) -> KernelCheck:
    """Walk ``spec``'s steps under every CTA order, after its ``earlier``
    launches; every declared read must see its declared producer's write
    as the last one."""
    name = "carry-order"
    if spec.carry_reads is None:
        return KernelCheck(spec.name, name, "ok",
                           "no carried values declared")
    before: dict = {}
    for prev in earlier:
        if prev.carry_writes is not None:
            for point in iter_steps(prev):
                for cell in prev.carry_writes(point):
                    before[cell] = (prev.name, _key(prev, point))
    by_name = {prev.name: prev for prev in earlier}
    edges = steps = 0
    for schedule in SCHEDULES:
        last = dict(before)
        violations: list[str] = []
        for point in iter_steps(spec, schedule):
            steps += 1
            for cell, producer in spec.carry_reads(point):
                edges += 1
                problem = _edge_problem(spec, point, cell, producer, last,
                                        by_name)
                if problem:
                    violations.append(problem)
            if len(violations) >= _MAX_VIOLATIONS:
                break
            if spec.carry_writes is not None:
                for cell in spec.carry_writes(point):
                    last[cell] = (spec.name, _key(spec, point))
        if violations:
            more = " ... (truncated)" if len(violations) >= \
                _MAX_VIOLATIONS else ""
            return KernelCheck(
                spec.name, name, "fail",
                f"under the {schedule} CTA order: "
                + "; ".join(violations[:_MAX_VIOLATIONS]) + more)
    loops = " > ".join(spec.loop_names) or "none"
    return KernelCheck(
        spec.name, name, "ok",
        f"{edges // len(SCHEDULES)} carry edge(s) proven over "
        f"{steps // len(SCHEDULES)} steps under {len(SCHEDULES)} CTA "
        f"orders (serial loops {loops}; edges within a CTA or from an "
        "earlier launch)")


# ---------------------------------------------------------------------------
# check (2): output coverage
# ---------------------------------------------------------------------------
def _blocks_per_dim(op) -> list[int]:
    return [-(-size // blk) for size, blk in zip(op.shape, op.block)]


def check_out_coverage(spec: KernelSpec) -> KernelCheck:
    """Every out map must write each output block exactly once."""
    name = "out-coverage"
    problems: list[str] = []
    for op in spec.out_specs:
        for d, (size, blk) in enumerate(zip(op.shape, op.block)):
            if size % blk and not op.is_guarded(d):
                problems.append(
                    f"{op.name}: dim {d} size {size} not a multiple of "
                    f"block {blk} and the kernel guards no ragged block")
        seen: dict[tuple, int] = {}
        for point in iter_steps(spec):
            idx = op.index_map(point)
            if idx is not None:
                seen[tuple(idx)] = seen.get(tuple(idx), 0) + 1
        per_dim = _blocks_per_dim(op)
        total = 1
        for b in per_dim:
            total *= b
        overlaps = {i: c for i, c in seen.items() if c > 1}
        inside = [i for i in seen
                  if all(0 <= v < b for v, b in zip(i, per_dim))]
        gaps = total - len(inside)
        if overlaps:
            worst = sorted(overlaps.items())[:_MAX_VIOLATIONS]
            problems.append(
                f"{op.name}: {len(overlaps)} output block(s) written more "
                "than once (a write race between CTAs or steps), e.g. "
                + ", ".join(f"{i} x{c}" for i, c in worst))
        if gaps > 0:
            missing = [i for i in itertools.product(
                *(range(b) for b in per_dim)) if i not in seen]
            problems.append(
                f"{op.name}: {gaps} of {total} output block(s) never "
                f"written (garbage), e.g. {missing[:_MAX_VIOLATIONS]}")
    if problems:
        return KernelCheck(spec.name, name, "fail", "; ".join(problems))
    covered = ", ".join(
        f"{op.name}: {_count(op)} blocks exactly once"
        for op in spec.out_specs)
    return KernelCheck(spec.name, name, "ok", covered)


def _count(op) -> int:
    total = 1
    for b in _blocks_per_dim(op):
        total *= b
    return total


# ---------------------------------------------------------------------------
# check (3): in-bounds
# ---------------------------------------------------------------------------
def check_in_bounds(spec: KernelSpec) -> KernelCheck:
    """Every touched block inside its operand after the kernel's guards."""
    name = "in-bounds"
    violations: list[str] = []
    operands = spec.in_specs + spec.out_specs
    points = 0
    for point in iter_steps(spec):
        points += 1
        for op in operands:
            idx = op.index_map(point)
            if idx is None:
                continue
            if len(idx) != len(op.block):
                violations.append(
                    f"{op.name}: index map yields rank {len(idx)} for a "
                    f"rank-{len(op.block)} block")
            else:
                for d, (i, blk, size) in enumerate(
                        zip(idx, op.block, op.shape)):
                    end = i * blk + (1 if op.is_guarded(d) else blk)
                    if i < 0 or end > size:
                        violations.append(
                            f"{op.name}: step {_fmt(point)} maps dim {d} "
                            f"to block {i}, elements [{i * blk}, "
                            f"{(i + 1) * blk}) outside the logical extent "
                            f"{size}")
            if len(violations) >= _MAX_VIOLATIONS:
                return KernelCheck(
                    spec.name, name, "fail",
                    "; ".join(violations) + " ... (truncated)")
    if violations:
        return KernelCheck(spec.name, name, "fail", "; ".join(violations))
    return KernelCheck(
        spec.name, name, "ok",
        f"{len(operands)} operand(s) in bounds at all {points} steps")


# ---------------------------------------------------------------------------
# check (4): shared-memory fit
# ---------------------------------------------------------------------------
def check_smem_fit(spec: KernelSpec) -> KernelCheck:
    name = "smem-fit"
    nbytes = spec.smem_bytes()
    detail = f"{nbytes} B ({spec.smem_detail()})"
    if nbytes > SMEM_LIMIT_BYTES:
        return KernelCheck(
            spec.name, name, "fail",
            f"{detail} exceeds the {SMEM_LIMIT_BYTES} B of shared memory "
            "one CTA of an H100 may use: shrink bin_block or threads")
    if spec.smem_dynamic > SMEM_DEFAULT_BYTES and not spec.smem_opt_in:
        return KernelCheck(
            spec.name, name, "fail",
            f"{detail}: a dynamic part over {SMEM_DEFAULT_BYTES} B needs "
            "cudaFuncAttributeMaxDynamicSharedMemorySize set before the "
            "launch, or the launch is refused")
    return KernelCheck(
        spec.name, name, "ok", f"{detail} of {SMEM_LIMIT_BYTES} B")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def check_spec(spec: KernelSpec,
               earlier: tuple[KernelSpec, ...] = ()) -> tuple[KernelCheck, ...]:
    """All four checks for one launch, after its ``earlier`` launches at
    the same geometry (``check_method`` enumerates at the canonical one
    and prices smem on the real one)."""
    return (
        check_carry_order(spec, earlier),
        check_out_coverage(spec),
        check_in_bounds(spec),
        check_smem_fit(spec),
    )


def specs_for(method: str, geom: KernelGeometry) -> tuple[KernelSpec, ...]:
    from repro_torch.kernels.ops import KERNEL_SPECS

    builder = KERNEL_SPECS.get(method)
    if builder is None:
        raise KeyError(
            f"method {method!r} has no registered KernelSpec "
            f"(registry: {sorted(KERNEL_SPECS)})")
    return builder(geom)


def check_method(method: str, geom: KernelGeometry) -> KernelVerdict:
    """Verify every launch of ``method`` at ``geom``: enumeration at the
    canonical form of the resolved geometry, smem on the real one."""
    return check_launches(method, specs_for(method, geom))


def check_launches(method: str, real: tuple[KernelSpec, ...]
                   ) -> KernelVerdict:
    """``check_method`` on the method's launches already built at the real
    geometry.  The enumeration proofs are cached by the canonical geometry,
    which most calls share (a new set of requested rows, a new frame
    count); smem-fit is arithmetic on the real specs."""
    geom = real[0].geometry
    proofs = _proofs(method, geom.canonical())
    checks: list[KernelCheck] = []
    for proved, spec in zip(proofs, real):
        checks.extend(proved + (check_smem_fit(spec),))
    return KernelVerdict(method=method, geometry=geom, checks=tuple(checks))


@functools.lru_cache(maxsize=256)
def _proofs(method: str, canon: KernelGeometry
            ) -> tuple[tuple[KernelCheck, ...], ...]:
    """carry-order, out-coverage and in-bounds of each launch, enumerated
    at the canonical geometry ``canon``."""
    specs = specs_for(method, canon)
    return tuple(check_spec(spec, specs[:i])[:3]
                 for i, spec in enumerate(specs))


def check_kernels(methods=None, geometries=None) -> list[KernelVerdict]:
    """The ``--check-kernels`` sweep: every registered method (or
    ``methods``) at each geometry (default: the 640x480/32-bin serving
    shape and the paper's §4.6 8192x8192/128-bin scale).  A ``fused_rows``
    geometry without rows takes every 8th row."""
    from repro_torch.kernels.ops import KERNEL_SPECS

    if methods is None:
        methods = sorted(KERNEL_SPECS)
    if geometries is None:
        geometries = DEFAULT_GEOMETRIES
    out = []
    for g in geometries:
        for m in methods:
            if m == "fused_rows" and g.rows is None:
                g_m = dataclasses.replace(g, rows=tuple(range(7, g.h, 8)))
            else:
                g_m = g
            out.append(check_method(m, g_m))
    return out


DEFAULT_GEOMETRIES = (
    KernelGeometry(n=2, h=480, w=640, num_bins=32),
    KernelGeometry(n=1, h=8192, w=8192, num_bins=128),
)


# ---------------------------------------------------------------------------
# plancheck bridge
# ---------------------------------------------------------------------------
def plan_method(plan) -> str:
    """The kernels a plan dispatches: a query-fused ``wf_tis`` plan runs K2
    (kernels/fused_rows.py), a fused ``cw_tis`` plan streams tile-high
    bands through K4, anything else its method's kernels."""
    if plan.representation == "fused" and plan.method == "wf_tis":
        return "fused_rows"
    return plan.method


def plan_geometry(plan) -> KernelGeometry:
    """The geometry of the launches a plan dispatches, unresolved:
    ``kernel_specs`` resolves ``bin_block=None`` and the strip cut through
    the wrapper's own ``launch_shape`` (or ``chunk_shape``), as the wrapper
    does at dispatch.  Frames: the request's, or the microbatch of an open
    stream; rows: a band's where the plan streams bands, a shard's where it
    shards rows (bins likewise); a fused plan's K2 runs the frame cut below
    the tile-high band holding its last row, with its requested rows."""
    s = plan.spec
    n = s.num_frames if s.num_frames is not None else max(plan.microbatch, 1)
    h, nb = s.height, s.num_bins
    if plan.representation == "fused":
        rows = tuple(s.query_rows)
        if plan.method == "wf_tis":
            h_cut = min(h, (max(rows) // plan.tile + 1) * plan.tile)
            return KernelGeometry(n=n, h=h_cut, w=s.width, num_bins=nb,
                                  bin_block=plan.bin_block, rows=rows)
        h = min(h, plan.tile)
    if plan.band_plan is not None:
        h = plan.band_plan.band_h
    if plan.sharding is not None and s.mesh is not None:
        shape = dict(s.mesh.shape)
        if plan.sharding == "bin":
            nb = max(1, nb // shape.get(s.bin_axis, 1))
        else:
            h = max(1, h // shape.get(s.row_axis, 1))
    return KernelGeometry(n=n, h=h, w=s.width, num_bins=nb,
                          bin_block=plan.bin_block)


def smem_required(method: str, geom: KernelGeometry
                  ) -> tuple[int, str] | None:
    """Peak shared bytes a CTA takes across the method's launches, with a
    detail string (``peak_smem``).  ``None`` when the method has no
    registered KernelSpec (no CUDA kernel to model)."""
    from repro_torch.kernels.ops import KERNEL_SPECS

    if method not in KERNEL_SPECS:
        return None
    return peak_smem(specs_for(method, geom))


def peak_smem(specs: tuple[KernelSpec, ...]) -> tuple[int, str]:
    """The launches run one after another, so a CTA's peak is the max over
    them: what plancheck's smem-fit prices."""
    peak = max(specs, key=lambda sp: sp.smem_bytes())
    label = f" (peak launch {peak.name})" if len(specs) > 1 else ""
    return peak.smem_bytes(), peak.smem_detail() + label

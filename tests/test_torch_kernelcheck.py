"""kernelcheck: the CUDA kernels' launch contracts, proved on the CPU.

Three layers, as the reference's tests/test_kernelcheck.py:

  * the verifier PROVES the four properties (carry order, exactly-once
    output coverage, in-bounds operands, shared-memory fit) for every
    registered method, at the default geometries and at the shapes
    chip_smoke.py launches K1-K4 at;
  * each check CATCHES its seeded violation: a carry edge between two CTAs
    of one launch, a reordered serial loop, an overlapping out map, an
    off-by-one block, 232,449 shared bytes, 64 KiB of dynamic shared
    memory without the opt-in;
  * the declared launch CANNOT DRIFT from the wrapper: each wrapper's
    ``_lib()`` is replaced by a recorder of the ctypes call, and the spec's
    resolved launch must equal what the wrapper passes (the grid the C++
    computes from those arguments is held against the spec on the card,
    chip_smoke's analysis phase).

The CUDA kernels themselves do not run here: the recorder takes tensors on
the meta device dressed as CUDA tensors, so no memory is touched.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import kernelcheck as kc
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.kernels import cw_tis, delta_apply, fused_rows, ops, wf_tis
from repro_torch.kernels.specs import (
    SMEM_LIMIT_BYTES,
    KernelGeometry,
)

ROOT = Path(__file__).resolve().parent.parent
CHECK_NAMES = ("carry-order", "out-coverage", "in-bounds", "smem-fit")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_shapes", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
#: K1 at chip_smoke's K1_SHAPES, K2 at its K2_SHAPES, K3 and K4 at the clip.
SMOKE_GEOMS = (
    [("wf_tis", f"K1 {label}", KernelGeometry(n, h, w, nb))
     for label, ((n, h, w, nb, _), _) in CS.K1_SHAPES.items()]
    + [("fused_rows", f"K2 {label}", KernelGeometry(n, h, w, nb, rows=rows))
       for label, ((n, h, w, nb, rows), _) in CS.K2_SHAPES.items()]
    + [("delta_apply", "K3 clip", KernelGeometry(16, 480, 640, 32)),
       ("cw_tis", "K4 clip", KernelGeometry(16, 480, 640, 32))]
)

GEOMS = {
    "640x480": KernelGeometry(n=2, h=480, w=640, num_bins=32),
    "uneven": KernelGeometry(n=3, h=300, w=500, num_bins=20),
    "paper-8k": KernelGeometry(n=1, h=8192, w=8192, num_bins=128),
    # past one CTA's 16,384 columns: the panorama (two column strips), and
    # a ragged width cut both ways (three column strips, row strips)
    "wide-32k": KernelGeometry(n=4, h=480, w=32768, num_bins=32),
    "wide-ragged": KernelGeometry(n=1, h=97, w=40003, num_bins=5),
}


@pytest.fixture
def fresh_caches():
    """Tests that patch KERNEL_SPECS must leave no verdict cached under
    an unpatched key."""
    from repro_torch.analysis import plancheck

    plancheck.clear_caches()
    yield
    plancheck.clear_caches()


def _with_rows(method, geom):
    if method == "fused_rows" and geom.rows is None:
        return dataclasses.replace(geom, rows=tuple(range(7, geom.h, 8)))
    return geom


# ---------------------------------------------------------------------------
# the four properties hold for every registered method
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("geom", GEOMS.values(), ids=GEOMS.keys())
@pytest.mark.parametrize("method", sorted(ops.KERNEL_SPECS))
def test_all_four_properties_prove(method, geom):
    verdict = kc.check_method(method, _with_rows(method, geom))
    assert verdict.ok, verdict.render()
    names = [c.name for c in verdict.checks]
    n_launches = len(ops.KERNEL_SPECS[method](_with_rows(method, geom)))
    assert names == list(CHECK_NAMES) * n_launches


@pytest.mark.parametrize("case", SMOKE_GEOMS, ids=[c[1] for c in SMOKE_GEOMS])
def test_properties_prove_at_chip_smoke_shapes(case):
    method, _, geom = case
    verdict = kc.check_method(method, geom)
    assert verdict.ok, verdict.render()


def test_proofs_are_cached_by_the_canonical_geometry(fresh_caches):
    """New requested rows build new real specs, but prove nothing again
    where their canonical geometry is one already proved; the verdict is
    the one an uncached call gives."""
    base = KernelGeometry(1, 480, 640, 32, rows=(99, 219, 279))
    moved = [dataclasses.replace(base, rows=(99 + d, 219 + d, 279 + d))
             for d in range(1, 6)]
    first = kc.check_method("fused_rows", base)
    assert kc._proofs.cache_info().misses == 1
    for g in moved:
        v = kc.check_method("fused_rows", g)
        assert v.ok and v.geometry.rows == g.rows
    assert kc._proofs.cache_info().misses == 1
    kc._proofs.cache_clear()
    assert kc.check_method("fused_rows", moved[-1]).render() == v.render()
    assert first.render().splitlines()[1:] == v.render().splitlines()[1:]


def test_registry_has_the_references_four_keys():
    from repro.kernels.ops import KERNEL_SPECS as REF

    assert set(ops.KERNEL_SPECS) == set(REF)
    assert "ssd_scan" not in ops.KERNEL_SPECS       # K5: none, as there
    launches = {m: [s.kernel for s in ops.KERNEL_SPECS[m](
        _with_rows(m, GEOMS["640x480"]))] for m in ops.KERNEL_SPECS}
    assert launches == {
        "wf_tis": ["count_kernel", "scan_kernel"],
        "fused_rows": ["chunk_kernel", "sum_kernel"],
        "delta_apply": ["delta_apply_kernel"],
        "cw_tis": ["hscan_kernel", "vscan_kernel"],
    }


def test_canonical_geometry_clamps_and_keeps_ragged_blocks():
    g = wf_tis.resolve_geometry(GEOMS["640x480"])
    assert (g.strip_rows, g.bin_block) == (53, 1)
    c = g.canonical()
    # 10 strips of 53 rows, the last of 3 -> 3 strips of 3 rows, last of 2
    assert (c.n, c.strip_rows, c.h, c.num_bins) == (2, 3, 8, 3)
    assert (c.threads, c.chunks) == (g.threads, g.chunks)   # block sizes stay
    big = wf_tis.resolve_geometry(GEOMS["paper-8k"]).canonical()
    assert (big.n, big.w) == (2, 1536)                 # 3 column blocks
    k4 = cw_tis.resolve_geometry(GEOMS["640x480"]).canonical()
    assert (k4.max_blocks, k4.stride_threads) == (3, 4)  # the stride turns
    k2 = fused_rows.resolve_geometry(
        dataclasses.replace(GEOMS["640x480"], rows=(7, 99, 219, 300)))
    c2 = k2.canonical()
    assert len(c2.rows) == 3 and c2.strip_rows == 3
    assert all(b - a <= 7 for a, b in zip((-1,) + c2.rows, c2.rows))


def test_canonical_geometry_keeps_two_column_strips():
    """A frame cut into column strips keeps two or three of them, two
    column blocks wide, the last ragged: the strip-to-strip edges stay in
    the proof.  K4's hscan, which walks a whole row in 128-column chunks,
    keeps three chunks, so its chunk-to-chunk carry stays in view."""
    g = wf_tis.resolve_geometry(GEOMS["wide-32k"])
    assert (g.strip_cols, g.strip_rows) == (16384, 480)
    c = g.canonical()
    assert (c.strip_cols, c.w) == (1024, 2048)
    r = wf_tis.resolve_geometry(GEOMS["wide-ragged"]).canonical()
    assert (r.strip_cols, r.w, -(-r.w // r.strip_cols)) == (1024, 3071, 3)
    assert [s.name for s in ops.KERNEL_SPECS["wf_tis"](r)] == [
        "wf_tis/rows", "wf_tis/count", "wf_tis/scan"]
    k4 = cw_tis.resolve_geometry(GEOMS["wide-32k"]).canonical()
    assert (k4.strip_cols, k4.col_block, k4.w) == (None, 128, 384)
    assert dict(ops.KERNEL_SPECS["cw_tis"](k4)[0].loops)["chunk"] == 3


#: K4's hscan at the clip, chip_smoke's WIDE_SHAPE and TALL_SHAPE, and a
#: ragged width (a masked tail chunk, ragged bin blocks).
HSCAN_GEOMS = {
    "clip": KernelGeometry(16, 480, 640, 32),
    "wide": KernelGeometry(*CS.WIDE_SHAPE),
    "tall": KernelGeometry(*CS.TALL_SHAPE),
    "ragged": KernelGeometry(2, 3, 4099, 3),
}


@pytest.mark.parametrize("geom", HSCAN_GEOMS.values(), ids=HSCAN_GEOMS)
def test_hscan_spec_proves_under_every_cta_order(geom):
    """One warp a (frame, row, bin block), 8 warps a CTA, a row walked in
    128-column chunks with its bins' totals carried from chunk to chunk:
    the four checks hold under each of the four CTA orders, with every
    chunk after the first reading its own warp's carry."""
    hscan, vscan = ops.KERNEL_SPECS["cw_tis"](geom)
    g = hscan.geometry
    bb, warps = cw_tis.hscan_shape(geom.num_bins)
    units = geom.n * geom.h * -(-geom.num_bins // bb)
    assert (g.bin_block, g.threads, g.col_block) == (bb, 32 * warps, 128)
    assert hscan.cuda_grid == (-(-units // warps), 1, 1)
    assert hscan.warps == (("warp", warps),)
    assert hscan.loops == (("chunk", -(-geom.w // 128)),)
    assert hscan.smem_bytes() == 0
    canon = ops.KERNEL_SPECS["cw_tis"](g.canonical())
    for schedule in kc.SCHEDULES:
        steps = list(kc.iter_steps(canon[0], schedule))
        assert steps and all(canon[0].active(p) for p in steps)
    verdict = kc.check_method("cw_tis", geom)
    assert verdict.ok, verdict.render()
    carry = verdict.checks[0]
    chunks = dict(canon[0].loops)["chunk"]
    cu = g.canonical()
    c_units = cu.n * cu.h * -(-cu.num_bins // bb)
    assert f"{c_units * (chunks - 1)} carry edge(s)" in carry.detail
    assert "4 CTA orders" in carry.detail and "within a warp" in carry.detail


def test_hscan_chunk_reading_another_warps_carry_fails_carry_order():
    """A warp whose chunk takes its row total from the warp beside it (two
    bin blocks of a row sharing one running total) fails: warps of a CTA,
    like CTAs, run in no order."""
    hscan, vscan = _canon("cw_tis")
    W = dict(hscan.warps)["warp"]

    def reads(p):
        if p["chunk"] > 0 and p["warp"] > 0:
            return [(("run", p["x"], p["warp"] - 1),
                     {"x": p["x"], "warp": p["warp"] - 1,
                      "chunk": p["chunk"] - 1})]
        return hscan.carry_reads(p)

    assert W > 1
    bad = dataclasses.replace(hscan, carry_reads=reads)
    check = kc.check_carry_order(bad)
    assert check.status == "fail"
    assert "warps run in parallel and in no order" in check.detail
    assert kc.check_carry_order(hscan).ok
    assert kc.check_carry_order(vscan, (hscan,)).ok


def test_every_cta_order_gives_the_same_steps():
    spec = ops.KERNEL_SPECS["cw_tis"](
        cw_tis.resolve_geometry(GEOMS["640x480"]).canonical())[1]
    keys = {s: sorted(tuple(p.values()) for p in kc.iter_steps(spec, s))
            for s in kc.SCHEDULES}
    assert len({tuple(v) for v in keys.values()}) == 1
    orders = {s: [tuple(p.values()) for p in kc.iter_steps(spec, s)]
              for s in kc.SCHEDULES}
    assert len({tuple(v) for v in orders.values()}) == len(kc.SCHEDULES)


# ---------------------------------------------------------------------------
# each check catches its seeded violation
# ---------------------------------------------------------------------------
def _canon(method, geom=GEOMS["640x480"]):
    specs = ops.KERNEL_SPECS[method](_with_rows(method, geom))
    return ops.KERNEL_SPECS[method](specs[0].geometry.canonical())


def test_edge_between_two_ctas_fails_carry_order():
    """K1's strip reading the strip above's last row of V (a walk handed
    from one CTA to the next) is a naive port of the TPU's grid carry."""
    count, scan = _canon("wf_tis")
    R = scan.geometry.strip_rows

    def reads(p):
        if p["row"] == 0 and p["z"] > 0:
            return [(("V", p["x"], p["y"], p["z"] - 1),
                     {"x": p["x"], "y": p["y"], "z": p["z"] - 1,
                      "row": R - 1})]
        return scan.carry_reads(p)

    bad = dataclasses.replace(scan, carry_reads=reads)
    check = kc.check_carry_order(bad, (count,))
    assert check.status == "fail"
    assert "CTAs run in parallel and in no order" in check.detail
    assert kc.check_carry_order(scan, (count,)).ok


def test_column_strip_reading_its_neighbour_fails_carry_order():
    """K1's column strip j taking its row carry from the walk of strip
    j - 1 in the same launch (the TPU's row carry between column tiles,
    ported as it was) fails: only the row-count pre-pass may feed it."""
    specs = _canon("wf_tis", GEOMS["wide-ragged"])
    *earlier, scan = specs
    n = scan.geometry.n

    def reads(p):
        if p["x"] >= n:                     # column strip 1 and on
            left = {"x": p["x"] - n, "y": p["y"], "z": p["z"],
                    "row": p["row"]}
            return [(("V", p["x"] - n, p["y"], p["z"]), left)]
        return scan.carry_reads(p)

    bad = dataclasses.replace(scan, carry_reads=reads)
    check = kc.check_carry_order(bad, tuple(earlier))
    assert check.status == "fail"
    assert "CTAs run in parallel and in no order" in check.detail
    assert kc.check_carry_order(scan, tuple(earlier)).ok


def test_reordered_serial_loop_fails_carry_order():
    """vscan's running sum declared with its row walk outside the
    grid-stride loop: the register's last writer is another item's row."""
    hscan, vscan = _canon("cw_tis")
    bad = dataclasses.replace(vscan, loops=tuple(reversed(vscan.loops)))
    check = kc.check_carry_order(bad, (hscan,))
    assert check.status == "fail"
    assert "last write was at" in check.detail
    assert kc.check_carry_order(vscan, (hscan,)).ok


def test_missing_earlier_launch_and_unwritten_cell_fail_carry_order():
    count, scan = _canon("wf_tis")
    check = kc.check_carry_order(scan)      # strips without their pre-pass
    assert check.status == "fail" and "does not run earlier" in check.detail
    bad = dataclasses.replace(scan, carry_writes=lambda p: [])
    check = kc.check_carry_order(bad, (count,))
    assert check.status == "fail" and "before any write" in check.detail


def test_shared_cell_races_under_interleaved_cta_orders():
    """A cell every CTA writes (one running sum for the whole launch) holds
    when CTAs run one after another, and fails once their steps
    interleave: the verdict must not depend on the CTA order."""
    hscan, vscan = _canon("cw_tis")
    bad = dataclasses.replace(
        vscan,
        carry_reads=lambda p: [(("acc",) if cell[0] == "acc" else cell, src)
                               for cell, src in vscan.carry_reads(p)],
        carry_writes=lambda p: [("acc",)])
    check = kc.check_carry_order(bad, (hscan,))
    assert check.status == "fail" and "interleaved" in check.detail


def test_overlapping_out_map_fails_coverage():
    """A K1 out map that drops the bin block writes every row once per
    bin block (a write race) and never writes the other blocks."""
    _, scan = _canon("wf_tis")
    op = scan.out_specs[0]
    bad_op = dataclasses.replace(
        op, index_map=lambda p: (p["x"], 0, p["z"] * scan.geometry.strip_rows
                                 + p["row"], 0))
    check = kc.check_out_coverage(
        dataclasses.replace(scan, out_specs=(bad_op,)))
    assert check.status == "fail"
    assert "more than once" in check.detail
    assert "never written" in check.detail


def test_off_by_one_block_fails_bounds():
    _, scan = _canon("wf_tis")
    op = scan.out_specs[0]
    bad_op = dataclasses.replace(
        op, index_map=lambda p: (p["x"], p["y"], p["z"]
                                 * scan.geometry.strip_rows + p["row"] + 1, 0))
    check = kc.check_in_bounds(dataclasses.replace(scan, out_specs=(bad_op,)))
    assert check.status == "fail"
    assert "outside the logical extent" in check.detail


def test_shared_memory_over_the_h100_limit_fails_smem_fit():
    _, scan = ops.KERNEL_SPECS["wf_tis"](GEOMS["640x480"])
    at = dataclasses.replace(scan, smem_static=0,
                             smem_dynamic=SMEM_LIMIT_BYTES, smem_opt_in=True)
    assert kc.check_smem_fit(at).ok
    over = dataclasses.replace(at, smem_dynamic=SMEM_LIMIT_BYTES + 1)
    assert SMEM_LIMIT_BYTES + 1 == 232_449
    check = kc.check_smem_fit(over)
    assert check.status == "fail" and "232448" in check.detail


def test_large_dynamic_launch_without_opt_in_fails_smem_fit():
    _, scan = ops.KERNEL_SPECS["wf_tis"](GEOMS["640x480"])
    bad = dataclasses.replace(scan, smem_dynamic=64 * 1024,
                              smem_opt_in=False)
    check = kc.check_smem_fit(bad)
    assert check.status == "fail"
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in check.detail
    assert kc.check_smem_fit(dataclasses.replace(bad, smem_opt_in=True)).ok
    # K1 at 2048 columns and bin block 8 takes 66 KiB: its spec opts in
    (wide,) = ops.KERNEL_SPECS["wf_tis"](
        KernelGeometry(1, 64, 2048, 8, bin_block=8))
    assert wide.smem_dynamic > 48 * 1024 and wide.smem_opt_in
    assert kc.check_smem_fit(wide).ok


# ---------------------------------------------------------------------------
# the spec states the launch the wrapper makes
# ---------------------------------------------------------------------------
class _OnCard(torch.Tensor):
    """A meta tensor that the wrappers take for a CUDA tensor."""

    @property
    def is_cuda(self):
        return True


def _on_card(shape, dtype=torch.float32):
    return torch.Tensor._make_subclass(
        _OnCard, torch.empty(shape, dtype=dtype, device="meta"))


@pytest.fixture
def recorder(monkeypatch):
    """Every wrapper's ``_lib()`` replaced by one that records the C
    call's arguments; the CUDA device context and stream stubbed."""
    calls: dict[str, list] = {}

    def fn(name):
        def call(*args):
            calls.setdefault(name, []).append(args)
            return 0
        return call

    monkeypatch.setattr(wf_tis, "_lib", lambda: fn("wf_tis"))
    monkeypatch.setattr(fused_rows, "_lib", lambda: fn("fused_rows"))
    monkeypatch.setattr(delta_apply, "_lib", lambda: fn("delta_apply"))
    monkeypatch.setattr(cw_tis, "_lib",
                        lambda: (fn("cw_tis/hscan"), fn("cw_tis/vscan")))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


RECORDED = SMOKE_GEOMS + [
    (m, f"{m} {k}", _with_rows(m, g)) for m in sorted(ops.KERNEL_SPECS)
    for k, g in GEOMS.items()]


@pytest.mark.parametrize("case", RECORDED, ids=[c[1] for c in RECORDED])
def test_spec_matches_the_wrappers_launch(case, recorder):
    method, _, g = case
    n, h, w, nb = g.n, g.h, g.w, g.num_bins
    specs = ops.KERNEL_SPECS[method](g)
    r = specs[0].geometry
    if method == "wf_tis":
        wf_tis.wf_tis_cuda(_on_card((n, h, w), torch.int32), nb)
        (args,) = recorder["wf_tis"]
        assert args[6:15] == (n, h, w, nb, r.bin_block, r.threads, r.chunks,
                              r.strip_rows, r.strip_cols)
        assert [s.kernel for s in specs] == (
            ["row_count_kernel"] if r.strip_cols < w else []) + (
            ["count_kernel"] if r.strip_rows < h else []) + ["scan_kernel"]
        assert specs[-1].cuda_grid == (n * -(-w // r.strip_cols),
                                       -(-nb // r.bin_block),
                                       -(-h // r.strip_rows))
    elif method == "fused_rows":
        fused_rows.fused_rows_cuda(_on_card((n, h, w), torch.int32), nb,
                                   g.rows)
        (args,) = recorder["fused_rows"]
        chunks = specs[0].cuda_grid[0] // (n * -(-nb // r.bin_block))
        assert args[6:15] == (n, h, g.rows[-1] + 1, w, nb, chunks,
                              len(g.rows), r.bin_block, r.threads)
        assert specs[0].threads == r.threads
    elif method == "delta_apply":
        delta_apply.delta_apply_cuda(_on_card((n, nb, h, w)),
                                     _on_card((n, nb, w)))
        (args,) = recorder["delta_apply"]
        assert args[5:9] == (n * nb, h, w, r.max_blocks)
        assert specs[0].threads == delta_apply._THREADS
    else:
        cw_tis.cw_tis_hscan_cuda(_on_card((n, h, w), torch.int32), nb)
        cw_tis.cw_tis_vscan_cuda(_on_card((n, nb, h, w)))
        (h_args,) = recorder["cw_tis/hscan"]
        (v_args,) = recorder["cw_tis/vscan"]
        warps = r.threads // 32
        assert h_args[2:8] == (n, h, w, nb, r.bin_block, warps)
        assert v_args[3:7] == (n * nb, h, w, r.max_blocks)
        assert specs[0].cuda_grid == (
            -(-(n * h * -(-nb // r.bin_block)) // warps), 1, 1)
        assert specs[0].warps == (("warp", warps),)


def test_bin_block_none_resolves_by_the_busy_rule(recorder):
    """A plan's ``bin_block=None`` must give the spec the bin block the
    wrapper picks at dispatch: the largest block that still gives two
    CTAs an SM (8 from 66 frames at 32 bins, 4 from 33), else the
    smallest (1: one frame)."""
    for n, want in ((1, 1), (33, 4), (66, 8)):
        geom = KernelGeometry(n, 480, 640, 32)
        assert wf_tis.resolve_geometry(geom).bin_block == want
        wf_tis.wf_tis_cuda(_on_card((n, 480, 640), torch.int32), 32)
        assert recorder["wf_tis"][-1][10] == want    # after six pointers


# ---------------------------------------------------------------------------
# the plancheck bridge
# ---------------------------------------------------------------------------
def _cuda_plan(shape=(480, 640), bins=32, queries=None, **kw):
    """A ``backend="cuda"`` plan built on the CPU: the planner resolves
    "torch" without a card, so the backend is set on its plan."""
    from repro_torch.core import engine

    e = engine.HistogramEngine(bins, device="cpu", **kw)
    spec = e.spec_for(shape)
    if queries is not None:
        spec = dataclasses.replace(spec, query_rows=queries)
    return e, dataclasses.replace(engine.plan(spec), backend="cuda")


def test_plan_geometry_is_the_dispatched_launch():
    _, p = _cuda_plan((16, 480, 640))
    g = kc.plan_geometry(p)
    assert (g.n, g.h, g.w, g.num_bins, g.bin_block) == (16, 480, 640, 32,
                                                        None)
    _, fused = _cuda_plan((480, 640), queries=(7, 99, 219))
    assert kc.plan_method(fused) == "fused_rows"
    fg = kc.plan_geometry(fused)
    assert (fg.h, fg.rows) == (256, (7, 99, 219))   # the early cut
    _, cw = _cuda_plan((480, 640), queries=(7, 99), method="cw_tis")
    assert kc.plan_method(cw) == "cw_tis"
    assert kc.plan_geometry(cw).h == 128            # one tile-high band
    _, banded = _cuda_plan((2160, 3840), bins=128,
                           memory_budget_bytes=512 << 20)
    assert kc.plan_geometry(banded).h == banded.band_plan.band_h == 273


def _smem_line(e, p):
    return next(c for c in e.validate(p).checks if c.name == "smem-fit")


def test_plancheck_smem_delegates_to_kernelcheck():
    for method in ("wf_tis", "cw_tis"):
        e, p = _cuda_plan(method=method)
        est = kc.smem_required(method, kc.plan_geometry(p))
        specs = ops.KERNEL_SPECS[method](kc.plan_geometry(p))
        assert est[0] == max(s.smem_bytes() for s in specs)
        line = _smem_line(e, p)
        assert (line.status, line.detail) == (
            "ok", f"~{est[0]} B of {SMEM_LIMIT_BYTES} B ({est[1]})")
    e, p = _cuda_plan(method="cw_b")
    assert kc.smem_required("cw_b", kc.plan_geometry(p)) is None
    assert _smem_line(e, p).status == "skip"


def test_validate_deep_merges_kernel_checks(fresh_caches):
    e, p = _cuda_plan()
    assert "kernel-carry" not in e.validate(p).render()
    deep = e.validate(p, deep=True)
    assert deep.ok
    names = [c.name for c in deep.checks]
    for name in ("kernel-carry", "kernel-coverage", "kernel-bounds",
                 "kernel-smem"):
        assert name in names
    e.last_plan = p
    assert "kernel-carry" in e.explain()
    torch_plan = dataclasses.replace(p, backend="torch")
    skip = [c for c in e.validate(torch_plan, deep=True).checks
            if c.name == "kernel-checks"]
    assert len(skip) == 1 and skip[0].status == "skip"


def _broken_wf_specs(geom):
    """K1 re-declared with its strips reading the strip above: an edge
    between two CTAs of one launch."""
    *earlier, scan = wf_tis.kernel_specs(geom)
    R = scan.geometry.strip_rows

    def reads(p):
        if p["row"] == 0 and p["z"] > 0:
            return [(("V", p["x"], p["y"], p["z"] - 1),
                     {"x": p["x"], "y": p["y"], "z": p["z"] - 1,
                      "row": R - 1})]
        return scan.carry_reads(p)

    return (*earlier, dataclasses.replace(scan, carry_reads=reads))


def test_engine_deep_gate_rejects_a_failing_spec(monkeypatch, fresh_caches):
    from repro_torch.core import engine

    monkeypatch.setitem(ops.KERNEL_SPECS, "wf_tis", _broken_wf_specs)
    e, p = _cuda_plan((480, 640))
    deep = e.validate(p, deep=True)
    assert [c.name for c in deep.failures] == ["kernel-carry"]
    assert e.validate(p).ok             # the rejection is the deep gate's
    real_plan = engine.plan
    monkeypatch.setattr(engine, "plan", lambda spec: dataclasses.replace(
        real_plan(spec), backend="cuda"))
    monkeypatch.setattr(e, "compute", lambda *a, **k: pytest.fail(
        "dispatched a rejected plan"))
    with pytest.raises(engine.PlanValidationError, match="kernel-carry"):
        e.run(np.zeros((480, 640), np.uint8))


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.analysis --check-kernels
# ---------------------------------------------------------------------------
def test_cli_check_kernels_clean(tmp_path, capsys):
    report = tmp_path / "kernelcheck.json"
    assert analysis_main(["--check-kernels", "--json", str(report)]) == 0
    assert "kernel verdict(s), 0 failed" in capsys.readouterr().out
    data = json.loads(report.read_text())
    assert data["counts"] == {"total": 8, "failed": 0}
    assert {v["method"] for v in data["verdicts"]} == set(ops.KERNEL_SPECS)
    for v in data["verdicts"]:
        assert v["ok"] and {c["name"] for c in v["checks"]} \
            == set(CHECK_NAMES)


def test_cli_check_kernels_fails_on_bad_spec(monkeypatch, fresh_caches,
                                             capsys):
    monkeypatch.setitem(ops.KERNEL_SPECS, "wf_tis", _broken_wf_specs)
    assert analysis_main(["--check-kernels"]) == 1
    assert "REJECTED" in capsys.readouterr().out

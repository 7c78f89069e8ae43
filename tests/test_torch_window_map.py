"""The dense likelihood map's kernel (kernels/window_map.py), on the CPU.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py`` holds
it bit-equal to the plain path there).  Here:

  * ``window_map_cuda`` on a CPU tensor (its plain version) equals the
    plain path of ``region_query.likelihood_map`` — the strided-slice
    window histograms scored by ``distances.intersection`` — bit for bit,
    and ``_map_restated``, the kernel's walk in torch (``launch_shape``'s
    chains, the corners carried from one step to the next, the bins summed
    in order from 0), equals both;
  * only a contiguous fp32 H on the card scored by ``intersection`` is
    routed to the kernel; other metrics, CPU tensors and the row-slab
    sources keep the plain path;
  * the wrapper refuses what the kernel does not take, and the launch it
    makes is the one ``kernel_specs`` states, proved by kernelcheck;
  * the tracer's root counts the kernel's launches (0 on the CPU).
"""

from __future__ import annotations

import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.analysis import kernelcheck as kc
from repro_torch.core import distances
from repro_torch.core.bands import iter_banded_ih
from repro_torch.core import region_query as rq
from repro_torch.core.engine import (
    HistogramEngine,
    LikelihoodQuery,
    MultiScaleQuery,
)
from repro_torch.core.hsource import BandedH, DenseH, FusedRowsH
from repro_torch.kernels import window_map as wm
from repro_torch.kernels.ref import integral_histogram_ref
from repro_torch.kernels.specs import KernelGeometry

torch.set_num_threads(1)

WINDOWS = [(24, 24), (23, 17), (1, 1)]
STRIDES = [1, 2, 16]
BINS = [16, 32, 128]
EPS = np.float32(1e-8)


def _H(shape, bins, seed=0):
    """An integral histogram of seeded 8-bit frames, (..., bins, h, w)."""
    frames = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    return integral_histogram_ref(torch.from_numpy(frames), bins)


def _target(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 200, shape).astype(
        np.float32)


def _today(H, target, window, stride):
    """The plain path as ``region_query.likelihood_map`` takes it."""
    hists = rq.sliding_window_histograms(H, window, stride)
    return distances.intersection(hists, rq._target(target, hists))


def _map_restated(H, target, window, stride):
    """The kernel's walk in torch: each chain of ``launch_shape`` walks its
    output rows; a step takes its bottom corners of every bin and its top
    ones (carried from the step before where ``reuse``), v = ((d - b) - c)
    + a, N and the map as in-order sums from 0, IEEE division, the target
    normalised once a frame.  Every output element is written once."""
    lead, (nb, h, w) = tuple(H.shape[:-3]), H.shape[-3:]
    Hf = H.reshape(-1, nb, h, w)
    F = Hf.shape[0]
    wh, ww = window
    s = stride
    n_r, n_c = wm.map_shape(h, w, window, s)
    q, steps, units, reuse = wm.launch_shape(n_r, window, s, nb, w)[1:5]
    t = torch.as_tensor(target, dtype=torch.float32)
    t = (t.broadcast_to(lead + (nb,)).reshape(F, nb) if t.ndim > 1
         else t.expand(F, nb))
    T = torch.zeros(F)
    for b in range(nb):
        T = T + t[:, b]
    t_hat = t / (T + EPS)[:, None]
    j = torch.arange(n_c)
    c1, c0 = j * s + ww - 1, j * s - 1
    left = c0 >= 0

    def corners(r):             # (F, nb, n_c) right and left, 0 where virtual
        if r < 0:
            z = torch.zeros(F, nb, n_c)
            return z, z
        rows = Hf[:, :, r]
        return rows[..., c1], torch.where(left, rows[..., c0.clamp(min=0)],
                                          torch.zeros(()))

    out = torch.full((F, n_r, n_c), float("nan"))
    written = torch.zeros(n_r, dtype=torch.int64)
    for unit in range(units):
        rho, piece = unit % q, unit // q
        top = None
        for k in range(steps):
            i = rho + (piece * steps + k) * q
            if i >= n_r:
                break
            if not reuse or k == 0:
                top = corners(i * s - 1)
            bot = corners(i * s + wh - 1)
            v = [((bot[0][:, b] - top[0][:, b]) - bot[1][:, b]) + top[1][:, b]
                 for b in range(nb)]
            N = torch.zeros(F, n_c)
            for b in range(nb):
                N = N + v[b]
            den = N + EPS
            acc = torch.zeros(F, n_c)
            for b in range(nb):
                acc = acc + torch.minimum(v[b] / den, t_hat[:, b, None])
            out[:, i] = acc
            written[i] += 1
            if reuse:
                top = bot
    assert bool((written == 1).all()), "a row written twice or never"
    return out.reshape(lead + (n_r, n_c))


# ---------------------------------------------------------------------------
# the plain version and the kernel's walk against today's map
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bins", BINS)
@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("window", WINDOWS, ids=str)
def test_plain_and_the_kernels_walk_equal_todays_map(window, stride, bins):
    H = _H((2, 53, 61), bins)
    targets = {"one": _target((bins,)), "a frame each": _target((2, bins))}
    for what, target in targets.items():
        want = _today(H, target, window, stride)
        assert want.shape == (2,) + wm.map_shape(53, 61, window, stride)
        got = wm.window_map_cuda(H, target, window, stride)
        assert torch.equal(got, want), what
        assert torch.equal(_map_restated(H, target, window, stride), want), \
            what
    lone = H[1].contiguous()                        # (b, h, w), one frame
    assert torch.equal(
        wm.window_map_cuda(lone, targets["one"], window, stride),
        _today(H, targets["one"], window, stride)[1])
    assert torch.equal(
        _map_restated(lone, targets["one"], window, stride),
        _today(lone, targets["one"], window, stride))


@pytest.mark.parametrize("max_steps", [1, 2, 3])
@pytest.mark.parametrize("window,stride", [((6, 5), 1), ((6, 4), 3),
                                           ((5, 5), 2), ((1, 1), 1)])
def test_short_chains_cut_into_pieces_cover_every_row(window, stride,
                                                      max_steps,
                                                      monkeypatch):
    """Chains longer than ``MAX_STEPS`` split into pieces, each starting
    from its own top corners: every row once, the same bits."""
    monkeypatch.setattr(wm, "MAX_STEPS", max_steps)
    H = _H((3, 31, 27), 8, seed=4)
    target = _target((8,), seed=5)
    assert torch.equal(_map_restated(H, target, window, stride),
                       _today(H, target, window, stride))


@pytest.mark.parametrize("window,stride", [((60, 8), 1), ((8, 70), 1),
                                           ((54, 62), 3)])
def test_a_window_larger_than_the_frame_gives_an_empty_map(window, stride):
    H = _H((2, 53, 61), 16)
    got = wm.window_map_cuda(H, _target((16,)), window, stride)
    want = _today(H, _target((16,)), window, stride)
    assert got.shape == want.shape and got.numel() == 0
    meta = torch.empty(H.shape, device="meta")
    assert wm.window_map_cuda(meta, _target((16,)), window,
                              stride).shape == want.shape


@pytest.mark.parametrize("args,want", [
    # the cell: stride 1, 32 bins, whole chunks -> the rows kernel
    ((457, (24, 24), 1, 32, 640), (True, 24, 20, 24, True, 160)),
    ((480, (1, 1), 1, 16, 640), (True, 1, 32, 15, True, 136)),
    ((457, (24, 24), 2, 32, 640), (False, 12, 32, 24, True, 0)),
    ((30, (23, 17), 2, 32, 640), (False, 1, 30, 1, False, 0)),
    ((457, (24, 24), 1, 128, 640), (False, 1, 32, 15, False, 0)),
    ((457, (24, 24), 1, 32, 641), (False, 24, 20, 24, True, 0)),
    ((457, (24, 24), 1, 32, 640, False), (False, 24, 20, 24, True, 0)),
])
def test_launch_shape(args, want):
    """Chains carry their corner row where the stride divides the window
    height; the rows kernel takes stride 1, bins in registers and rows of
    whole aligned 16-byte chunks."""
    *pos, w = args[:5]
    aligned = args[5] if len(args) > 5 else True
    shape = wm.launch_shape(*pos, w, aligned=aligned)
    assert tuple(shape) == want
    assert shape.steps * (shape.units // shape.q) * shape.q >= pos[0]


# ---------------------------------------------------------------------------
# routing: only a card fp32 H scored by intersection takes the kernel
# ---------------------------------------------------------------------------
class _OnCard(torch.Tensor):
    """A meta tensor that the wrappers take for a CUDA tensor."""

    @property
    def is_cuda(self):
        return True


def _on_card(shape, dtype=torch.float32):
    return torch.Tensor._make_subclass(
        _OnCard, torch.empty(shape, dtype=dtype, device="meta"))


@pytest.mark.parametrize("case,takes", [
    ("card fp32 intersection", True),
    ("cpu", False),
    ("card float64", True),
    ("card not contiguous", True),
    ("chi2", False),
    ("bhattacharyya", False),
    ("a metric of its own", False),
])
def test_route_predicate(case, takes):
    """The device and the metric alone choose: the wrapper refuses a dtype
    it does not take, and ``likelihood_map`` hands it a contiguous H."""
    H = {"cpu": torch.zeros(2, 4, 9, 9),
         "card float64": _on_card((2, 4, 9, 9), torch.float64),
         "card not contiguous": _on_card((2, 9, 4, 9)).transpose(1, 2),
         }.get(case, _on_card((2, 4, 9, 9)))
    metric = {"chi2": distances.chi2,
              "bhattacharyya": distances.bhattacharyya,
              "a metric of its own": lambda a, b: distances.intersection(
                  a, b)}.get(case, distances.intersection)
    assert rq.map_kernel_takes(H, metric) is takes


@pytest.fixture
def stubbed(monkeypatch):
    """``window_map_cuda`` replaced by a recorder giving a meta map."""
    calls = []

    def stub(H, target, window, stride=1):
        calls.append((tuple(H.shape), window, stride))
        n_r, n_c = wm.map_shape(H.shape[-2], H.shape[-1], window, stride)
        return torch.zeros(H.shape[:-3] + (max(n_r, 0), max(n_c, 0)),
                           device="meta")

    monkeypatch.setattr(wm, "window_map_cuda", stub)
    return calls


def test_dense_sources_on_the_card_take_the_kernel(stubbed):
    H = _on_card((3, 8, 40, 50))
    stats = {}
    out = rq.likelihood_map(H, _target((8,)), (6, 5), distances.intersection,
                            2, stats=stats)
    assert stubbed == [((3, 8, 40, 50), (6, 5), 2)]
    assert out.shape == (3, 18, 23)
    nbytes = 4 * H.numel()
    assert stats == {"num_bands": 1, "band_bytes": nbytes, "slab_bytes": 0,
                     "peak_bytes": nbytes, "full_h_bytes": nbytes}
    DenseH(H).likelihood_map(_target((8,)), (4, 4), distances.intersection)
    assert stubbed[-1] == ((3, 8, 40, 50), (4, 4), 1)
    windows = ((4, 4), (8, 6), (60, 8))
    rq.multi_scale_search(H, _target((8,)), windows, distances.intersection)
    DenseH(H).multi_scale_search(_target((8,)), windows,
                                 distances.intersection)
    assert [c[1] for c in stubbed[2:]] == list(windows) * 2


def test_a_strided_card_h_reaches_the_kernel_contiguous(monkeypatch):
    seen = []
    monkeypatch.setattr(wm, "window_map_cuda", lambda H, *a: seen.append(
        (tuple(H.shape), H.is_contiguous())))
    H = _on_card((3, 40, 8, 50)).transpose(1, 2)
    assert not H.is_contiguous()
    rq.likelihood_map(H, _target((8,)), (6, 5), distances.intersection, 2)
    assert seen == [((3, 8, 40, 50), True)]


def test_other_metrics_cpu_and_row_slab_sources_keep_the_plain_path(
        stubbed):
    H = _H((2, 30, 40), 8)
    target = _target((8,))
    for metric in (distances.chi2, distances.l1, distances.bhattacharyya):
        rq.likelihood_map(_on_card((2, 8, 30, 40)), target, (5, 5), metric)
    rq.likelihood_map(H, target, (5, 5), distances.intersection)
    DenseH(H).likelihood_map(target, (5, 5), distances.intersection)
    rows = np.arange(30)
    FusedRowsH(rows, H[..., rows, :], height=30, width=40).likelihood_map(
        target, (5, 5), distances.intersection)
    frames = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 30, 40), np.uint8))
    bands = BandedH(lambda: iter_banded_ih(frames, 8, band_h=10,
                                           device="cpu"))
    bands.likelihood_map(target, (5, 5), distances.intersection, 5)
    assert stubbed == []


@pytest.mark.parametrize("representation", ["dense", "fused", "banded"])
def test_engine_requests_on_the_cpu_never_call_the_kernel(representation,
                                                          stubbed):
    frames = np.random.default_rng(3).integers(0, 256, (2, 40, 48), np.uint8)
    options = {"dense": {}, "fused": {},
               "banded": {"memory_budget_bytes": 20_000}}[representation]
    queries = ([LikelihoodQuery(_target((8,)), (40, 8), stride=8)]
               if representation == "fused" else
               [LikelihoodQuery(_target((8,)), (6, 6)),
                MultiScaleQuery(_target((8,)), ((4, 4), (8, 8)))])
    eng = HistogramEngine(num_bins=8, device="cpu", **options)
    out = eng.run(frames, queries)
    assert out.plan.representation == representation
    assert stubbed == []


# ---------------------------------------------------------------------------
# the wrapper's contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", [
    "float64 H", "int32 H", "rank 2", "not contiguous", "stride 0",
    "negative stride", "window of 0", "target of other bins",
    "target of other frames",
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    H = _H((2, 20, 24), 8)
    H_card = _on_card((2, 8, 20, 24))
    target, window, stride = _target((8,)), (4, 4), 1
    if case == "float64 H":
        H = H.double()
    elif case == "int32 H":
        H = H.to(torch.int32)
    elif case == "rank 2":
        H = H[0, 0]
    elif case == "not contiguous":
        H = H.transpose(-1, -2)
    elif case == "stride 0":
        stride = 0
    elif case == "negative stride":
        stride = -2
    elif case == "window of 0":
        window = (0, 4)
    elif case == "target of other bins":
        target = _target((7,))
        H = H_card
    else:
        target = _target((3, 8))
        H = H_card
    with pytest.raises(ValueError):
        wm.window_map_cuda(H, target, window, stride)


def test_a_host_target_is_staged_without_a_blocking_copy(monkeypatch):
    """A NumPy target goes to the card through pinned memory with a
    non-blocking copy; a target already on H's device is used as it is."""
    seen = []
    real_to = torch.Tensor.to

    def pin_memory(self):
        seen.append("pin")
        return self

    def to(self, *args, **kwargs):
        if args and isinstance(args[0], torch.device):
            seen.append(("to", kwargs.get("non_blocking", False)))
            return real_to(self, "meta")
        return real_to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "pin_memory", pin_memory)
    monkeypatch.setattr(torch.Tensor, "to", to)
    H = _on_card((2, 8, 20, 24))
    t, stride = wm._target_on(_target((8,)), H)
    assert seen == ["pin", ("to", True)] and stride == 0
    assert t.shape == (8,) and t.dtype == torch.float32
    seen.clear()
    t, stride = wm._target_on(_target((1, 8)), H)
    assert seen == ["pin", ("to", True)] and stride == 8
    assert t.shape == (2, 8)
    seen.clear()
    on_card = torch.zeros(8, device="meta")
    t, _ = wm._target_on(on_card, torch.empty((2, 8, 20, 24), device="meta"))
    assert seen == [] and t.device.type == "meta"


# ---------------------------------------------------------------------------
# the launch: spec, proofs, and the wrapper's call
# ---------------------------------------------------------------------------
def _canonical(geom, window, stride):
    """``wm.kernel_specs`` at a geometry small enough to enumerate, with
    ``window``, ``stride``, the bins and the kernel kept: 2 frames, chains
    of at most 3 steps, a height of at most two pieces of every chain plus
    a ragged row, and a width of at most three column strips (the last
    ragged where it was), of 4 lanes in the walk kernel."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wm, "MAX_STEPS", 3)
        n_r, n_c = wm.map_shape(geom.h, geom.w, window, stride)
        shape = wm.launch_shape(max(n_r, 1), window, stride, geom.num_bins,
                                geom.w)
        lanes = wm.ROW_THREADS if shape.rows else 4
        mp.setattr(wm, "LANES", lanes)
        keep_r = min(n_r, 2 * shape.q * wm.MAX_STEPS + 1)
        keep_c = min(n_c, 2 * lanes + (n_c % lanes or lanes))
        h = geom.h if n_r <= 0 else (keep_r - 1) * stride + window[0]
        w = geom.w if n_c <= 0 else (keep_c - 1) * stride + window[1]
        if shape.rows:                  # keep whole 16-byte chunks
            w = min(geom.w, -(-w // 4) * 4)
        return wm.kernel_specs(dataclasses.replace(geom, n=2, h=h, w=w),
                               window, stride)


CELL = (KernelGeometry(32, 480, 640, 32), (24, 24), 1)
SPEC_CASES = {                  # case: (geometry, window, stride), kernel
    "the cell": (CELL, "window_map_rows_kernel"),
    "ragged 23x17 stride 2": ((KernelGeometry(3, 97, 131, 16), (23, 17), 2),
                              "window_map_walk_kernel"),
    "1x1": ((KernelGeometry(2, 41, 72, 32), (1, 1), 1),
            "window_map_rows_kernel"),
    "1x1 ragged width": ((KernelGeometry(2, 41, 70, 32), (1, 1), 1),
                         "window_map_walk_kernel"),
    "7x5 at 8 bins": ((KernelGeometry(3, 300, 404, 8), (7, 5), 1),
                      "window_map_rows_kernel"),
    "stride 16": ((KernelGeometry(2, 480, 640, 32), (24, 24), 16),
                  "window_map_walk_kernel"),
    "128 bins": ((KernelGeometry(1, 130, 99, 128), (24, 24), 1),
                 "window_map_walk_kernel"),
    "8 bins stride 3": ((KernelGeometry(2, 65, 200, 8), (6, 9), 3),
                        "window_map_walk_kernel"),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_the_kernels_spec_proves(case):
    (geom, window, stride), kernel = SPEC_CASES[case]
    (spec,) = _canonical(geom, window, stride)
    assert spec.kernel == kernel
    checks = kc.check_spec(spec)
    assert [c.name for c in checks] == ["carry-order", "out-coverage",
                                         "in-bounds", "smem-fit"]
    assert all(c.ok for c in checks), [c.render() for c in checks]
    (real,) = wm.kernel_specs(geom, window, stride)
    assert real.kernel == kernel and kc.check_smem_fit(real).ok
    n_r, n_c = wm.map_shape(geom.h, geom.w, window, stride)
    shape = wm.launch_shape(n_r, window, stride, geom.num_bins, geom.w)
    assert real.cuda_grid == shape.grid(geom.n, n_c)
    assert real.smem_dynamic == shape.smem_bytes(geom.num_bins)
    assert (spec.carry_reads is not None) is shape.reuse


def test_the_cells_launch_reads_each_row_once_a_strip():
    """At the cell's shape a CTA walks one chain of 128 columns: its top
    corner row, then 20 bottom rows 24 apart, each row of every bin staged
    once in 16-byte chunks (columns j0 - 1 .. j0 + 150, the first chunk
    from column j0 - 4), two stages of 32 x 160 floats."""
    (spec,) = wm.kernel_specs(*CELL)
    assert spec.cuda_grid == (5, 24, 32) and spec.threads == 128
    assert dict(spec.loops)["load"] == 21
    assert spec.smem_dynamic == 4 * (36 + 2 * 32 * 160)
    first, last = spec.in_specs
    p = {"x": 1, "y": 5, "z": 3, "load": 0}
    assert first.index_map(p) == (3, 0, 4, 124)
    assert last.index_map(p) == (3, 0, 4, 279)
    assert first.index_map({**p, "load": 2}) == (3, 0, 5 + 24 + 23, 124)
    assert first.index_map({**p, "y": 0}) is None      # row -1 reads zeros
    (out,) = spec.out_specs
    assert out.index_map({**p, "load": 2}) == (3, 29, 1)


def test_a_carry_from_another_lane_or_buffer_or_a_wrong_step_fails():
    (spec,) = _canonical(*SPEC_CASES["8 bins stride 3"][0])
    assert spec.kernel == "window_map_walk_kernel"
    assert spec.carry_reads is not None

    def from_the_next_lane(p):
        if p["step"] == 0:
            return []
        other = {d: p[d] for d in ("x", "y", "z", "warp", "lane")}
        other["lane"] = (p["lane"] + 1) % 4
        return [(("top",) + tuple(other.values()),
                 {**other, "step": p["step"] - 1})]

    bad = dataclasses.replace(spec, carry_reads=from_the_next_lane)
    assert kc.check_carry_order(bad).status == "fail"
    (rows,) = _canonical(*CELL)

    def from_the_other_stage(p):
        return [((cell[0], 1 - cell[1], *cell[2:]) if cell[0] == "stage"
                 else cell, producer)
                for cell, producer in rows.carry_reads(p)]

    bad = dataclasses.replace(rows, carry_reads=from_the_other_stage)
    assert kc.check_carry_order(bad).status == "fail"
    spec = rows
    (out,) = spec.out_specs
    wrong = dataclasses.replace(out, index_map=lambda p: None if p[
        "load"] == 0 else (p["z"], min(out.index_map(p)[1] + 1,
                                       out.shape[1] - 1), p["x"]))
    bad = dataclasses.replace(spec, out_specs=(wrong,))
    assert kc.check_out_coverage(bad).status == "fail"


@pytest.fixture
def recorder(monkeypatch):
    calls = []

    def lib():
        def call(*args):
            calls.append(args)
            return 0
        return call

    monkeypatch.setattr(wm, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_the_wrapper_launches_what_the_spec_states(case, recorder):
    (geom, window, stride), _ = SPEC_CASES[case]
    n, h, w, nb = geom.n, geom.h, geom.w, geom.num_bins
    before = wm.window_map_cuda.launches
    out = wm.window_map_cuda(_on_card((n, nb, h, w)), _on_card((n, nb)),
                             window, stride)
    (args,) = recorder
    assert wm.window_map_cuda.launches == before + 1
    n_r, n_c = wm.map_shape(h, w, window, stride)
    assert out.shape == (n, n_r, n_c)
    shape = wm.launch_shape(n_r, window, stride, nb, w)
    assert args[2] == nb                            # a target a frame
    assert args[4:] == (n, nb, h, w, *window, stride, n_r, n_c, shape.q,
                        shape.steps, shape.units, int(shape.reuse),
                        shape.span, 0)
    (spec,) = wm.kernel_specs(geom, window, stride)
    assert spec.cuda_grid == shape.grid(n, n_c)
    assert spec.loops[0][1] == shape.steps + shape.rows


# ---------------------------------------------------------------------------
# the tracer's counter
# ---------------------------------------------------------------------------
def test_the_roots_launches_count_the_map_kernel():
    assert trace.LAUNCH_COUNTERS["map"] == ("window_map", "window_map_cuda")
    frames = np.random.default_rng(2).integers(0, 256, (2, 40, 48), np.uint8)
    eng = HistogramEngine(num_bins=8, device="cpu")
    trace.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            eng.run(frames, [LikelihoodQuery(_target((8,)), (6, 6))])
        roots = [r for r in trace.records() if r.parent < 0]
    finally:
        trace.clear()
    assert len(roots) == 1
    assert roots[0].attrs["launches"]["map"] == 0
    assert roots[0].attrs["launches"] == dict.fromkeys(
        trace.LAUNCH_COUNTERS, 0)

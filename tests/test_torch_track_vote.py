"""The tracker's vote kernel (kernels/track_vote.py over csrc/track_vote.cu)
on the CPU: its walk restated in NumPy float32 against the plain torch vote
bit for bit, which calls take it, and the ctypes call the wrapper makes.
The kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import contextlib
import types

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core import tracking
from repro_torch.core.engine import HistogramEngine, TrackQuery
from repro_torch.core.hsource import DenseH
from repro_torch.data import video_frames
from repro_torch.kernels import track_vote as tv

torch.set_num_threads(1)

H_, W_, BINS = 40, 56, 8


def _vote_restated(H, boxes, ref, grid, radius):
    """``csrc/track_vote.cu`` walked in NumPy float32: a target a CTA, a
    candidate a thread; each bin's corner lattice read as the kernel
    reads it, the two in-order bin walks, the IEEE quotient, the sort of
    the similarities and the first maximum."""
    H = np.asarray(H, np.float32)
    n, nb, h, w = H.shape
    gr, gc = grid
    eps = np.float32(1e-8)
    side = 2 * radius + 1
    out_box = np.zeros(boxes.shape[:2] + (4,), np.int32)
    out_score = np.zeros(boxes.shape[:2], np.float32)
    for i in range(n):
        for j in range(boxes.shape[1]):
            r0, c0, r1, c1 = (int(v) for v in boxes[i, j])
            bh, bw = r1 - r0, c1 - c0
            rmax, cmax = max(h - 1 - bh, 0), max(w - 1 - bw, 0)
            hh, ww = (bh + 1) // gr, (bw + 1) // gc
            t = np.asarray(ref[i, j], np.float32)            # (f, nb)
            tref = np.zeros_like(t)
            for f in range(gr * gc):
                T = np.float32(0)
                for b in range(nb):
                    T = np.float32(T + t[f, b])
                for b in range(nb):
                    tref[f, b] = t[f, b] / np.float32(T + eps)
            best, best_c = np.float32(-np.finfo(np.float32).max), side ** 2
            for c in range(side * side):
                top = min(max(r0 + c // side - radius, 0), rmax)
                left = min(max(c0 + c % side - radius, 0), cmax)
                rows = [min(top + k * hh - 1, h - 1) for k in range(gr + 1)]
                cols = [min(left + k * ww - 1, w - 1) for k in range(gc + 1)]

                def lattice(b):
                    return [[H[i, b, r, q] if r >= 0 and q >= 0
                             else np.float32(0) for q in cols] for r in rows]

                def count(L, k, m):
                    return np.float32(np.float32(np.float32(
                        L[k + 1][m + 1] - L[k][m + 1]) - L[k + 1][m])
                        + L[k][m])

                N = np.zeros((gr, gc), np.float32)
                for b in range(nb):
                    L = lattice(b)
                    for k in range(gr):
                        for m in range(gc):
                            N[k, m] = np.float32(N[k, m] + count(L, k, m))
                s = np.zeros(gr * gc, np.float32)
                for b in range(nb):
                    L = lattice(b)
                    for k in range(gr):
                        for m in range(gc):
                            q = count(L, k, m) / np.float32(N[k, m] + eps)
                            s[k * gc + m] = np.float32(
                                s[k * gc + m] + min(q, tref[k * gc + m, b]))
                s = np.sort(s)
                f = gr * gc
                score = np.float32(np.float32(s[(f - 1) // 2] + s[f // 2])
                                   * np.float32(0.5))
                if score > best:
                    best, best_c = score, c
            top = min(max(r0 + best_c // side - radius, 0), rmax)
            left = min(max(c0 + best_c % side - radius, 0), cmax)
            out_box[i, j] = [top, left, top + bh, left + bw]
            out_score[i, j] = best
    return out_box, out_score


def _case(seed, grid, radius, targets=2, n=2):
    frames = video_frames(H_, W_, n, seed=seed)
    H = HistogramEngine(BINS, device="cpu").compute_dense(frames)
    rng = np.random.default_rng(seed)
    th, tw = rng.integers(4, 24, 2)
    r0 = rng.integers(0, H_ - th + 1, (n, targets))
    c0 = rng.integers(0, W_ - tw + 1, (n, targets))
    boxes = np.stack([r0, c0, r0 + th - 1, c0 + tw - 1], -1)
    boxes[0, 0] = [0, 0, H_ - 1, 9]            # a full-height box: clamps
    ref = rng.integers(0, 50, (n, targets, grid[0] * grid[1], BINS))
    return H, boxes, ref.astype(np.float32)


@pytest.mark.parametrize("grid,radius", [((2, 2), 3), ((1, 1), 0),
                                         ((3, 2), 2), ((4, 4), 1)])
def test_the_kernels_walk_equals_the_plain_vote(grid, radius):
    H, boxes, ref = _case(7, grid, radius)
    want_box, want_score = tracking.vote_plain(
        H, torch.as_tensor(boxes), torch.as_tensor(ref), grid, radius)
    got_box, got_score = _vote_restated(H.numpy(), boxes, ref, grid, radius)
    np.testing.assert_array_equal(got_box, want_box.numpy())
    np.testing.assert_array_equal(got_score, want_score.numpy())


class _OnCard(torch.Tensor):
    """A meta tensor that the wrapper takes for a CUDA tensor."""

    @property
    def is_cuda(self):
        return True


def _on_card(shape, dtype=torch.float32):
    return torch.Tensor._make_subclass(
        _OnCard, torch.empty(shape, dtype=dtype, device="meta"))


@pytest.fixture
def recorder(monkeypatch):
    calls = []

    def lib():
        def call(*args):
            calls.append(args)
            return 0
        return call

    monkeypatch.setattr(tv, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("case,want", [
    ("card", True), ("cpu", False), ("float64 H", False),
    ("float64 ref", False), ("5 x 1 grid", False), ("radius 512", False),
    ("a stack of stacks", False)])
def test_which_votes_the_kernel_takes(case, want, recorder):
    """The kernel takes a card H within its limits; an H off the card is
    voted by the plain torch ops; a card H past a limit raises, naming
    it, and never falls back to the plain vote."""
    H = {"cpu": torch.zeros(2, 8, 9, 9),
         "float64 H": _on_card((2, 8, 9, 9), torch.float64),
         "a stack of stacks": _on_card((1, 2, 8, 9, 9))}.get(
             case, _on_card((2, 8, 9, 9)))
    ref = torch.zeros(8, dtype=torch.float64 if case == "float64 ref"
                      else torch.float32)
    grid = (5, 1) if case == "5 x 1 grid" else (2, 2)
    radius = 512 if case == "radius 512" else 12
    boxes = torch.tensor([[[0, 0, 3, 3]]] * H.shape[0])
    before = tv.track_vote_cuda.launches
    if want or case == "cpu":
        got_box, got_score = tv.track_vote_cuda(H, boxes, ref, grid, radius)
        assert tv.track_vote_cuda.launches - before == int(want)
        assert len(recorder) == int(want)
        if case == "cpu":
            want_box, want_score = tracking.vote_plain(H, boxes, ref, grid,
                                                       radius)
            assert torch.equal(got_box, want_box)
            assert torch.equal(got_score, want_score)
        return
    named = {"float64 H": "float32 H", "float64 ref": "float32 reference",
             "5 x 1 grid": "5 x 1", "radius 512": "radius of 0 to 511",
             "a stack of stacks": r"\(n, b, h, w\)"}[case]
    with pytest.raises(ValueError, match=named):
        tv.track_vote_cuda(H, boxes, ref, grid, radius)
    assert tv.track_vote_cuda.launches == before and not recorder


@pytest.mark.parametrize("ref_shape,strides", [
    ((32,), (0, 0, 0, 1)),                 # one target histogram for all
    ((3, 4, 4, 32), (512, 128, 32, 1)),    # one a fragment of each target
])
def test_the_wrapper_launches_once_with_the_stated_shapes(recorder,
                                                          ref_shape, strides):
    before = tv.track_vote_cuda.launches
    box, score = tv.track_vote_cuda(
        _on_card((3, 32, 480, 640)), _on_card((3, 4, 4), torch.int64),
        _on_card(ref_shape), (2, 2), 12)
    (args,) = recorder
    assert tv.track_vote_cuda.launches == before + 1
    assert box.shape == (3, 4, 4) and box.dtype == torch.int32
    assert score.shape == (3, 4) and score.dtype == torch.float32
    assert args[3:7] == strides
    assert args[9:] == (3, 4, 32, 480, 640, 2, 2, 12, 0)


def test_a_dense_card_h_takes_the_kernel_and_other_sources_do_not(
        monkeypatch):
    seen = []

    def stub(H, boxes, ref, fragments, radius):
        seen.append((tuple(H.shape), tuple(boxes.shape), fragments, radius))
        return tracking.vote_plain(H, boxes, ref, fragments, radius)

    monkeypatch.setattr(tv, "track_vote_cuda", stub)
    H, boxes, ref = _case(3, (2, 2), 3)
    q = TrackQuery(boxes, ref, radius=3)
    want = q.apply(DenseH(H))
    assert seen == [((2, BINS, H_, W_), (2, 2, 4), (2, 2), 3)]
    # A band stream is voted on its rows, never by the wrapper.
    frames = video_frames(H_, W_, 2, seed=3)
    eng = HistogramEngine(BINS, device="cpu", memory_budget_bytes=20_000)
    out = eng.run(frames, [q])
    assert out.plan.representation == "banded" and len(seen) == 1
    for a, b in zip(out.results[0], want):
        assert torch.equal(a, b)


def test_the_roots_launches_count_the_vote_kernel():
    assert trace.LAUNCH_COUNTERS["vote"] == ("track_vote", "track_vote_cuda")


@pytest.mark.parametrize("grid,radius,targets", [((2, 2), 12, 4),
                                                 ((3, 3), 2, 1)])
def test_the_work_counts_every_candidates_lattice(grid, radius, targets):
    work = tv.track_vote_work(32, targets, 32, grid, radius)
    cands = 32 * targets * (2 * radius + 1) ** 2
    lattice = (grid[0] + 1) * (grid[1] + 1)
    assert work["bytes"] == 4 * cands * lattice * 32 + 32 * targets * 20
    assert work["ops"] == cands * grid[0] * grid[1] * 32 * 7

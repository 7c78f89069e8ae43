"""A camera fleet's tracker tick (``FragmentTracker.init_fleet`` /
``step_fleet`` through ``engine.TrackQuery``) and the paired region
queries under it, on the CPU at a small size.

A tick of n cameras is held bit for bit against a loop of the single-stream
``step_on_h`` over the cameras (itself held against the JAX reference in
test_torch_tracking.py) and against the benchmark's plain reference
(``portbench/reference/track.py``); paired region histograms against
per-frame slices of H; ``TrackQuery.needed_rows`` against the corner rows
of the fragment rects it never builds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portbench.reference import plain
from portbench.reference import track as ref_track
from repro.core import region_query as ref_rq
from repro_torch.core import region_query as rq
from repro_torch.core import tracking
from repro_torch.core.engine import HistogramEngine, TrackQuery
from repro_torch.core.hsource import DenseH, PrefetchedRowsH
from repro_torch.data import video_frames

torch.set_num_threads(1)

H, W, BINS = 48, 64, 8
# Per camera, two boxes; the third camera's second box sits at the frame's
# corner, so its candidates clamp.
BOXES = np.array([[[10, 12, 29, 35], [4, 30, 25, 55]],
                  [[20, 2, 39, 25], [0, 40, 21, 63]],
                  [[5, 5, 24, 28], [28, 44, 47, 63]]])


def _ticks(n_cams, k, seed=5):
    """``k`` ticks of ``n_cams`` cameras: (k, n_cams, H, W) uint8."""
    return video_frames(H, W, k * n_cams, seed=seed).reshape(
        k, n_cams, H, W)


def _tracker(grid=(2, 2), rad=3, **engine):
    cfg = tracking.TrackerConfig(num_bins=BINS, fragments=grid,
                                 search_radius=rad)
    eng = HistogramEngine(BINS, device="cpu", **engine) if engine else None
    return tracking.FragmentTracker(cfg, engine=eng, device="cpu")


# (fragment grid, targets a camera, radius, engine options, plan)
CASES = [((2, 2), 2, 3, {}, "dense"),
         ((3, 3), 2, 3, {}, "dense"),
         ((2, 2), 1, 5, {}, "dense"),
         ((2, 2), 1, 1, {}, "fused"),
         ((2, 2), 2, 3, {"memory_budget_bytes": 40_000}, "banded")]


@pytest.mark.parametrize("grid,targets,rad,engine,plan", CASES)
def test_a_fleet_tick_equals_step_on_h_camera_by_camera(grid, targets, rad,
                                                        engine, plan):
    tr = _tracker(grid, rad, **engine)
    boxes = BOXES[:, :targets]
    if plan == "fused":
        boxes = BOXES[:2, :1]
    ticks = _ticks(boxes.shape[0], 4)
    st = tr.init_fleet(ticks[0], boxes)
    singles = [tr.init(ticks[0][c], boxes[c]) for c in range(len(boxes))]
    for c, one in enumerate(singles):
        for key in ("bbox", "ref_hists", "frag_offsets"):
            assert torch.equal(st[key][c], one[key]), key
    plans = []
    for tick in ticks[1:]:
        st = tr.step_fleet(st, tick)
        plans.append(tr._default_engine().last_plan.representation)
        assert st["bbox"].dtype == torch.int32
        assert st["score"].shape == boxes.shape[:2]
        for c in range(len(boxes)):
            singles[c] = tr.step_on_h(singles[c], tr._compute_h(tick[c]))
            assert torch.equal(st["bbox"][c], singles[c]["bbox"])
    assert plans[0] == plan


@pytest.mark.parametrize("grid,rad", [((2, 2), 3), ((3, 3), 2), ((2, 3), 7)])
def test_a_fleet_tick_equals_the_plain_reference(grid, rad):
    tr = _tracker(grid, rad)
    ticks = _ticks(3, 2, seed=9)
    ids = plain.bin_ids(torch.as_tensor(ticks[0]), BINS, 256)
    # One reference histogram for every fragment, as the benchmark gives.
    target = torch.bincount(ids[0, 8:16, 8:16].reshape(-1),
                            minlength=BINS).to(torch.float32)
    q = TrackQuery(BOXES, target.numpy(), fragments=grid, radius=rad)
    out = HistogramEngine(BINS, device="cpu").run(ticks[1], [q])
    boxes, scores = out.results[0]
    ids = plain.bin_ids(torch.as_tensor(ticks[1]), BINS, 256)
    want_boxes, want_scores = ref_track.tick(ids, BINS, BOXES, target, grid,
                                             rad)
    assert torch.equal(boxes, want_boxes)
    assert torch.equal(scores, want_scores)
    # The control rounds H through bfloat16: counts past 256 move.
    _, rounded = ref_track.tick(ids, BINS, BOXES, target, grid, rad,
                                torch.bfloat16)
    assert not torch.equal(rounded, want_scores)


@pytest.mark.parametrize("source", ["tensor", "dense"])
def test_paired_region_histograms_equal_per_frame_slices(source):
    frames = video_frames(H, W, 6, seed=3)
    Hs = HistogramEngine(BINS, device="cpu").compute_dense(frames)
    rng = np.random.default_rng(4)
    r0 = rng.integers(-2, H, (6, 5, 3))
    c0 = rng.integers(-2, W, (6, 5, 3))
    rects = np.stack([r0, c0, r0 + rng.integers(0, 30, r0.shape),
                      c0 + rng.integers(0, 30, c0.shape)], -1)
    src = Hs if source == "tensor" else DenseH(Hs)
    got = rq.region_histogram(src, rects, paired=True)
    assert got.shape == (6, 5, 3, BINS)
    for i in range(6):        # corners past the frame clamp, as unpaired
        assert torch.equal(got[i], rq.region_histogram(Hs[i], rects[i]))
    # Two leading frame axes pair the same way.
    got2 = rq.region_histogram(Hs.reshape(2, 3, BINS, H, W),
                               rects.reshape(2, 3, 5, 3, 4), paired=True)
    assert torch.equal(got2.reshape(got.shape), got)
    # The default still reads every rect on every frame, as the reference.
    cross = rq.region_histogram(src, rects[0])
    assert cross.shape == (6, 5, 3, BINS)
    np.testing.assert_array_equal(
        cross.numpy(), np.asarray(ref_rq.region_histogram(
            jnp.asarray(Hs.numpy()), rects[0])))


@pytest.mark.parametrize("budget", [None, 40_000])
def test_sources_of_rows_refuse_paired_queries(budget):
    """A prefetched row view and a band stream hold rows of H, not H: they
    refuse the paired mode by name; their unpaired queries still work."""
    frames = video_frames(H, W, 2, seed=3)
    Hs = HistogramEngine(BINS, device="cpu").compute_dense(frames)
    if budget is None:
        src = PrefetchedRowsH(DenseH(Hs), np.arange(H), Hs)
    else:
        eng = HistogramEngine(BINS, device="cpu", memory_budget_bytes=budget)
        p = eng.plan_for(frames)
        assert p.representation == "banded"
        src = eng.compute(frames, p)
    rects = np.array([[[3, 4, 20, 30]], [[0, 0, 47, 63]]])
    with pytest.raises(ValueError, match="paired"):
        rq.region_histogram(src, rects, paired=True)
    assert torch.equal(rq.region_histogram(src, rects[0]),
                       rq.region_histogram(Hs, rects[0]))


def test_paired_rects_must_lead_with_the_frames():
    Hs = torch.zeros((3, BINS, H, W))
    with pytest.raises(ValueError, match="paired"):
        rq.region_histogram(Hs, np.zeros((2, 4), np.int64), paired=True)
    with pytest.raises(ValueError, match="paired"):
        rq.region_histogram(Hs[0], np.zeros((1, 4), np.int64), paired=True)
    tr = _tracker()
    with pytest.raises(ValueError, match="init_fleet"):
        tr.init_fleet(_ticks(3, 1)[0], BOXES[:2])
    with pytest.raises(ValueError, match="init_fleet"):
        tr.init_fleet(_ticks(3, 1)[0][0], BOXES[0])


@pytest.mark.parametrize("grid,rad", [((2, 2), 3), ((3, 3), 12),
                                      ((2, 3), 30), ((1, 1), 0)])
def test_needed_rows_are_the_corner_rows_of_the_fragment_rects(grid, rad):
    boxes = np.concatenate([BOXES, [[[0, 0, 47, 63], [40, 1, 47, 9]]]])
    q = TrackQuery(boxes, np.ones(BINS, np.float32), fragments=grid,
                   radius=rad)
    got = q.needed_rows(DenseH(torch.zeros((1, BINS, H, W))))
    np.testing.assert_array_equal(got, rq.corner_rows(_fragments(boxes, grid,
                                                                 rad)))


def _fragments(boxes, grid, rad):
    """Every candidate's fragment rects, enumerated as the single-stream
    vote once built them: offsets rows outer, clamped inside the frame."""
    d = np.arange(-rad, rad + 1)
    dr, dc = (a.ravel() for a in np.meshgrid(d, d, indexing="ij"))
    b = boxes[..., None, :]
    bh, bw = b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]
    r0 = np.minimum(np.maximum(b[..., 0] + dr, 0), np.maximum(H - 1 - bh, 0))
    c0 = np.minimum(np.maximum(b[..., 1] + dc, 0), np.maximum(W - 1 - bw, 0))
    cand = np.stack([r0, c0, r0 + bh, c0 + bw], -1)
    return tracking._fragment_rects(torch.as_tensor(cand), grid).numpy()


def test_a_query_reads_its_host_inputs_once(monkeypatch):
    """A query run tick after tick makes its corner rows once a frame size
    and its boxes' and histograms' copies once a device; a tensor already
    on the source's device is used as it stands.  The ticks' answers are
    those of a fresh query."""
    from repro_torch.core import engine as engine_mod

    copies, made = [], []
    to_device, rows_of = engine_mod._to_device, tracking.candidate_rows
    monkeypatch.setattr(engine_mod, "_to_device",
                        lambda x, d: copies.append(d) or to_device(x, d))
    monkeypatch.setattr(tracking, "candidate_rows",
                        lambda g, h: made.append(h) or rows_of(g, h))
    ref = np.ones(BINS, np.float32)
    q = TrackQuery(BOXES, ref, radius=3)
    eng = HistogramEngine(BINS, device="cpu")
    ticks = _ticks(3, 3)
    outs = [eng.run(tick, [q]).results[0] for tick in ticks]
    assert len(copies) == 2 and made == [H]
    for tick, (boxes, scores) in zip(ticks, outs):
        want = eng.run(tick, [TrackQuery(BOXES, ref, radius=3)]).results[0]
        assert torch.equal(boxes, want[0]) and torch.equal(scores, want[1])
    rows = q.needed_rows(DenseH(torch.zeros((1, BINS, H, W))))
    assert not rows.flags.writeable and made == [H, H, H, H]
    boxes = torch.as_tensor(BOXES)
    assert TrackQuery(boxes, ref)._on("boxes", torch.device("cpu")) is boxes

"""repro_torch's fragments tracker (core/tracking.py) held against the JAX
reference.

The same seeded frames (48x64, 16 bins, search radius 3) go through
``repro.core.tracking`` with ``backend="jnp"`` and through the port with
``device="cpu"``.  Boxes, reference histograms and fragment offsets are
compared bit for bit: the vote's similarities sum their bins in the
reference's order, its median is ``jnp.median``'s (the mean of the two
middle values of an even count) and its argmax takes the first maximum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tracking as ref_tracking
from repro.core.engine import HistogramEngine as RefEngine
from repro_torch.core import tracking
from repro_torch.core.engine import HistogramEngine
from repro_torch.data import video_frames

torch.set_num_threads(1)

H, W, BINS, RAD = 48, 64, 16, 3
BOXES = {1: [10, 12, 29, 35], 2: [[10, 12, 29, 35], [4, 30, 25, 55]]}
CASES = [(grid, t) for grid in ((2, 2), (3, 3)) for t in (1, 2)]


def _clip(n=8):
    return video_frames(H, W, n, seed=5)


def _low_motion(n=6, rows=4, seed=6):
    rng = np.random.default_rng(seed)
    frames = [video_frames(H, W, 1, seed=seed)[0]]
    for _ in range(n - 1):
        nxt = frames[-1].copy()
        r = int(rng.integers(0, H - rows + 1))
        nxt[r:r + rows] = rng.integers(0, 256, (rows, W), np.uint8)
        frames.append(nxt)
    return np.stack(frames)


def _pair(grid, rad=RAD):
    cfg = dict(num_bins=BINS, fragments=grid, search_radius=rad)
    port = tracking.FragmentTracker(tracking.TrackerConfig(**cfg),
                                    device="cpu")
    ref = ref_tracking.FragmentTracker(
        ref_tracking.TrackerConfig(backend="jnp", **cfg))
    return port, ref


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _assert_state(got, want):
    for key in ("bbox", "ref_hists", "frag_offsets"):
        _eq(got[key], want[key])


@pytest.mark.parametrize("grid,targets", CASES)
def test_init_matches_reference(grid, targets):
    port, ref = _pair(grid)
    frame = _clip(1)[0]
    _assert_state(port.init(frame, BOXES[targets]),
                  ref.init(jnp.asarray(frame), BOXES[targets]))


@pytest.mark.parametrize("grid,targets", CASES)
def test_step_and_step_on_h_match_reference(grid, targets):
    port, ref = _pair(grid)
    clip = _clip(4)
    st = port.init(clip[0], BOXES[targets])
    st_h = dict(st)
    ref_st = ref.init(jnp.asarray(clip[0]), BOXES[targets])
    for frame in clip[1:]:
        st = port.step(st, frame)
        st_h = port.step_on_h(st_h, port._compute_h(frame))
        ref_st = ref.step(ref_st, jnp.asarray(frame))
        _eq(st["bbox"], ref_st["bbox"])
        _eq(st_h["bbox"], ref_st["bbox"])


@pytest.mark.parametrize("grid,targets", CASES)
def test_track_matches_reference(grid, targets):
    port, ref = _pair(grid)
    clip = _clip()
    st0 = port.init(clip[0], BOXES[targets])
    _, want = ref.track(ref.init(jnp.asarray(clip[0]), BOXES[targets]),
                        clip, batch_size=3)
    for batch_size in (3, "auto"):
        st, boxes = port.track(dict(st0), clip, batch_size=batch_size)
        assert boxes.dtype == torch.int32
        _eq(boxes, want)
        _eq(st["bbox"], np.asarray(want)[-1])


@pytest.mark.parametrize("grid,targets", CASES)
def test_track_incremental_matches_reference(grid, targets):
    port, ref = _pair(grid)
    clip = _low_motion()
    st0 = port.init(clip[0], BOXES[targets])
    ref_st0 = ref.init(jnp.asarray(clip[0]), BOXES[targets])
    _, want = ref.track(ref_st0, list(clip), incremental=True)
    _, batched = port.track(dict(st0), clip)
    _, boxes = port.track(dict(st0), list(clip), incremental=True)
    _eq(boxes, want)
    _eq(batched, want)
    assert port._step_engine.last_plan.incremental


@pytest.mark.parametrize("grid,rad,plan", [((2, 2), RAD, "dense"),
                                           ((3, 3), RAD, "dense"),
                                           ((2, 2), 1, "fused")])
def test_step_fused_matches_reference(grid, rad, plan):
    """One engine request a frame: fused into K2's rows where the
    candidates' corner rows are few (radius 1), dense where not."""
    port, ref = _pair(grid, rad)
    clip = _clip(5)
    st = port.init(clip[0], BOXES[1])
    ref_st = ref.init(jnp.asarray(clip[0]), BOXES[1])
    for frame in clip[1:]:
        st = port.step_fused(st, frame)
        ref_st = ref.step_fused(ref_st, frame)
        _eq(st["bbox"], ref_st["bbox"])
    assert port._step_engine.last_plan.representation == plan
    assert ref._step_engine.last_plan.representation == plan
    # several targets delegate to step
    multi = port.init(clip[0], BOXES[2])
    ref_multi = ref.init(jnp.asarray(clip[0]), BOXES[2])
    _eq(port.step_fused(multi, clip[1])["bbox"],
        ref.step_fused(ref_multi, clip[1])["bbox"])


def test_median_of_an_even_count_is_the_mean_of_the_middle_two():
    """The default 2x2 grid votes over 4 fragments: jnp.median's
    (low + high) * 0.5, not torch.median's low value."""
    rng = np.random.default_rng(7)
    x = rng.random((50, 4)).astype(np.float32)
    x[0] = [0.1, 0.7, 0.3, 0.2]
    got = tracking._median(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.median(x, axis=-1)))
    assert float(got[0]) == np.float32((np.float32(0.2) + np.float32(0.3))
                                       * np.float32(0.5))
    assert float(torch.median(torch.as_tensor(x[0]))) == np.float32(0.2)
    odd = rng.random((20, 9)).astype(np.float32)
    np.testing.assert_array_equal(tracking._median(torch.as_tensor(odd))
                                  .numpy(), np.asarray(jnp.median(odd, -1)))


def test_clamp_bbox_matches_reference():
    boxes = np.array([[-5, -3, 10, 10], [40, 60, 100, 100], [0, 0, 47, 63],
                      [50, 70, 20, 20], [3, 4, 2, 1]], np.int32)
    _eq(tracking._clamp_bbox(torch.as_tensor(boxes), H, W),
        ref_tracking._clamp_bbox(jnp.asarray(boxes), H, W))


def test_tracker_shares_an_engine():
    clip = _clip(3)
    eng = HistogramEngine(BINS, device="cpu")
    port = tracking.FragmentTracker(
        tracking.TrackerConfig(num_bins=BINS, search_radius=RAD), engine=eng)
    ref = ref_tracking.FragmentTracker(
        ref_tracking.TrackerConfig(num_bins=BINS, search_radius=RAD,
                                   backend="jnp"),
        engine=RefEngine(BINS, backend="jnp"))
    _, boxes = port.track(port.init(clip[0], BOXES[1]), clip)
    _, want = ref.track(ref.init(jnp.asarray(clip[0]), BOXES[1]), clip)
    _eq(boxes, want)
    with pytest.raises(ValueError, match="num_bins"):
        tracking.FragmentTracker(tracking.TrackerConfig(num_bins=8),
                                 engine=eng)

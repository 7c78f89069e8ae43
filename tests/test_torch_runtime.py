"""repro_torch's frame runtime (core/runtime.py) and its adapters, held
against the JAX reference.

The same seeded numpy frames go through ``repro`` on the CPU
(``backend="jnp"``) and through ``repro_torch`` with ``device="cpu"``.
H and tracker boxes are compared bit for bit (integer counts below 2^24
in fp32; the tracker's similarities sum their bins in the reference's
order).  The adaptive controller is fed the same scripted latencies as
the reference's and must make the same moves.  Staging on the card
(pinned buffers, a copy stream) is tested in ``test_torch_cuda.py``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bands as ref_bands
from repro.core import runtime as ref_runtime
from repro.core.engine import HistogramEngine as RefEngine
from repro.core.integral_histogram import IntegralHistogram as RefIH
from repro.core.pipeline import DoubleBufferedExecutor as RefExecutor
from repro.core.tracking import FragmentTracker as RefTracker
from repro.core.tracking import TrackerConfig as RefConfig
from repro_torch.core import bands, pipeline
from repro_torch.core.engine import HistogramEngine, auto_batch_size
from repro_torch.core.integral_histogram import IntegralHistogram
from repro_torch.core.pipeline import DoubleBufferedExecutor, prefetch_to_device
from repro_torch.core.runtime import (
    AdaptiveMicrobatch,
    FrameRuntime,
    iter_chunks,
    stack_chunks,
    stage_stream,
)
from repro_torch.core.tracking import FragmentTracker, TrackerConfig

torch.set_num_threads(1)


def _frames(seed, n=7, h=24, w=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(n)]


def _ref_h(frames, bins=8):
    """The reference's H per frame, as numpy."""
    ih = RefIH(num_bins=bins, backend="jnp")
    return [np.asarray(ih(jnp.asarray(f))) for f in frames]


def _assert_frames_equal(want, got):
    got = list(got)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# the scheduler core
# ---------------------------------------------------------------------------
def test_runtime_order_and_stats():
    log = []

    def step(chunk, carry):
        log.append(tuple(chunk.shape))
        return chunk * 2, carry

    rt = FrameRuntime(step, depth=3, microbatch=3, device="cpu")
    items = [np.full((2,), i, np.float32) for i in range(8)]
    outs = list(rt.map_frames(items))
    assert len(outs) == 8                      # one result per item
    for i, o in enumerate(outs):
        assert o.tolist() == [2 * i, 2 * i]
    assert log == [(3, 2), (3, 2), (2, 2)]     # ragged tail
    assert rt.last_stats.items == 8
    assert rt.last_stats.dispatches == 3
    assert rt.last_stats.batch_sizes == [3, 3, 2]
    assert len(rt.last_stats.latencies_s) == 3
    assert rt.last_stats.items_per_s > 0
    assert rt.last_stager.copies == 0          # the CPU stages no copies


def test_runtime_carry_threading():
    """carry rides between dispatches: running sum across chunks."""
    def step(chunk, carry):
        s = carry + chunk.sum()
        return s, s

    rt = FrameRuntime(step, depth=2, microbatch=2, device="cpu",
                      carry_in=torch.tensor(0.0))
    outs, last = rt.fold([np.asarray(float(i)) for i in [1, 2, 3, 4, 5]],
                         batched=True)
    assert [float(o) for o in outs] == [3.0, 10.0, 15.0]
    assert float(last) == 15.0 == float(rt.last_carry)


def test_runtime_depth_one_is_synchronous_and_valid():
    rt = FrameRuntime(FrameRuntime.stateless(lambda x: x), depth=1,
                      device="cpu")
    assert len(list(rt.map_frames([np.zeros(3), np.ones(3)]))) == 2
    for kw in (dict(depth=0), dict(microbatch=0), dict(stage_ahead=-1),
               dict(adaptive=True, block=False)):
        with pytest.raises(ValueError):
            FrameRuntime(lambda c, s: (c, s), device="cpu", **kw)


def test_iter_chunks_array_vs_iterable():
    clip = np.random.default_rng(1).integers(0, 9, (7, 4, 4), np.uint8)
    a = list(iter_chunks(clip, 3))
    b = list(iter_chunks(iter(list(clip)), 3))
    c = list(iter_chunks(torch.as_tensor(clip), 3))      # sliced, no copy
    assert [x.shape for x in a] == [(3, 4, 4), (3, 4, 4), (1, 4, 4)]
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z.numpy())
    assert [c.shape[0] for c in stack_chunks(iter(list(clip)), 4)] == [4, 3]
    ref = list(ref_runtime.iter_chunks(clip, 3))
    for x, r in zip(a, ref):
        np.testing.assert_array_equal(x, np.asarray(r))


# ---------------------------------------------------------------------------
# adaptive microbatch controller: the reference's moves on the same
# scripted latencies
# ---------------------------------------------------------------------------
def _moves(cls, initial, max_size, latency, n=16, settle=1):
    c = cls(initial=initial, max_size=max_size, settle=settle)
    seen = []
    for _ in range(n):
        seen.append(c.size)
        c.observe(c.size, latency(c.size))
    return seen, c.size, c.locked


def _same_moves_as_reference(initial, max_size, latency):
    got = _moves(AdaptiveMicrobatch, initial, max_size, latency)
    assert got == _moves(ref_runtime.AdaptiveMicrobatch, initial, max_size,
                         latency)
    return got


def test_adaptive_grows_when_batching_amortizes():
    """Constant latency (dispatch-bound): climbs to max and locks."""
    seen, size, locked = _same_moves_as_reference(1, 8, lambda k: 0.010)
    assert locked and size == 8 and seen[0] == 1


def test_adaptive_backs_off_when_batching_hurts():
    """Latency superlinear in batch: stays small."""
    _, size, locked = _same_moves_as_reference(4, 64,
                                               lambda k: 0.001 * k ** 2)
    assert locked and size == 1


def test_adaptive_settles_at_interior_optimum():
    """Throughput peaks at 4: the probe ladder finds and locks it."""
    table = {1: 1.0, 2: 0.45, 4: 0.2, 8: 0.5, 16: 2.0}
    _, size, locked = _same_moves_as_reference(2, 16,
                                               lambda k: table[k] / 10)
    assert locked and size == 4


def test_adaptive_stale_samples_do_not_steer():
    """A lagged sample is filed under the size that built it and fires no
    decision at the new size, as in the reference."""
    for cls in (AdaptiveMicrobatch, ref_runtime.AdaptiveMicrobatch):
        c = cls(initial=1, max_size=8, settle=1)
        c.observe(1, 0.010)
        assert c.size == 2
        c.observe(1, 10.0, size=1)
        assert not c.locked and c.size == 2
        c.observe(2, 0.010)
        assert c.size == 4


def test_adaptive_runtime_scripted_clock_matches_reference():
    """The whole runtime on a scripted clock: the port's dispatches take
    the sizes the reference's do, and the outputs equal per-frame H."""
    frames = _frames(2, n=23)
    want = _ref_h(frames)

    def clock():
        t = [0.0]

        def tick():
            t[0] += 0.001 * (1 + len(t) % 3)
            t.append(None)
            return t[0]
        return tick

    rt = FrameRuntime(FrameRuntime.stateless(IntegralHistogram(
        8, device="cpu")), depth=2, microbatch=2, adaptive=True,
        max_microbatch=8, device="cpu", clock=clock())
    _assert_frames_equal(want, rt.map_frames(frames))
    ref = ref_runtime.FrameRuntime(
        ref_runtime.FrameRuntime.stateless(RefIH(8, backend="jnp")),
        depth=2, microbatch=2, adaptive=True, max_microbatch=8,
        clock=clock())
    list(ref.map_frames(frames))
    assert rt.last_stats.batch_sizes == ref.last_stats.batch_sizes
    assert (rt.controller.size, rt.controller.locked) == (
        ref.controller.size, ref.controller.locked)


# ---------------------------------------------------------------------------
# adapters: equal to the reference's
# ---------------------------------------------------------------------------
def test_executor_adapter_parity():
    frames = _frames(3)
    want = _ref_h(frames)
    ih = IntegralHistogram(num_bins=8, device="cpu")
    for depth, batch in [(1, 1), (2, 3), (3, 2)]:
        _assert_frames_equal(want, DoubleBufferedExecutor(
            ih, depth=depth, batch_size=batch, device="cpu").map(frames))
        ref = RefExecutor(RefIH(num_bins=8, backend="jnp"), depth=depth,
                          batch_size=batch)
        for w, r in zip(want, ref.map(frames)):
            np.testing.assert_array_equal(w, np.asarray(r))


def test_map_frames_adapter_parity():
    frames = _frames(4)
    want = _ref_h(frames)
    ih = IntegralHistogram(num_bins=8, device="cpu")
    for kw in [dict(batch_size=2), dict(batch_size="auto"),
               dict(batch_size="adaptive"), dict(batch_size=3, depth=1)]:
        _assert_frames_equal(want, ih.map_frames(frames, **kw))
    assert list(ih.map_frames(iter(()))) == []
    with pytest.raises(ValueError):
        list(ih.map_frames(frames, batch_size="bogus"))


def test_engine_map_frames_adapter_parity():
    frames = _frames(5)
    want = _ref_h(frames)
    eng = HistogramEngine(8, device="cpu")
    _assert_frames_equal(want, eng.map_frames(frames))
    assert eng.last_runtime.last_stats.items == len(frames)
    ref = RefEngine(8, backend="jnp")
    list(ref.map_frames(frames))
    assert eng.last_plan.microbatch == ref.last_plan.microbatch
    assert eng.last_runtime.microbatch == ref.last_runtime.microbatch
    eng2 = HistogramEngine(8, device="cpu", adaptive_microbatch=True)
    _assert_frames_equal(want, eng2.map_frames(frames))
    assert eng2.last_plan.microbatch_mode == "adaptive"
    assert eng2.last_runtime.controller is not None
    assert eng2.last_plan.explain().splitlines()[6].endswith(
        "(adaptive start)")
    rt = eng.runtime_for(eng.last_plan, depth=3)
    assert (rt.depth, rt.microbatch, rt.adaptive) == (3, 16, False)


def test_engine_map_frames_refuses_a_plan_that_is_not_dense():
    frames = _frames(6, h=32, w=24)
    eng = HistogramEngine(8, device="cpu", memory_budget_bytes=4 * 8 * 8 * 24)
    with pytest.raises(ValueError, match="banded"):
        eng.map_frames(frames)
    assert list(HistogramEngine(8, device="cpu").map_frames([])) == []


def test_banded_adapter_parity_and_carry():
    img = np.random.default_rng(7).integers(0, 256, (37, 16), np.uint8)
    want = [(b.r0, b.r1, np.asarray(b.H), np.asarray(b.carry))
            for b in ref_bands.iter_banded_ih(img, 8, band_h=10,
                                              backend="jnp", prefetch=2)]
    for prefetch in (0, 1, 2):
        got = list(bands.iter_banded_ih(img, 8, band_h=10, device="cpu",
                                        prefetch=prefetch))
        assert [(b.r0, b.r1) for b in got] == [w[:2] for w in want]
        assert got[0].num_bands == 4 and got[-1].frame_h == 37
        for b, (_, _, H, carry) in zip(got, want):
            np.testing.assert_array_equal(b.H.numpy(), H)
            np.testing.assert_array_equal(b.carry.numpy(), carry)
        np.testing.assert_array_equal(
            bands.banded_integral_histogram(
                img, 8, band_h=10, device="cpu", prefetch=prefetch).numpy(),
            np.asarray(ref_bands.banded_integral_histogram(
                img, 8, band_h=10, backend="jnp", prefetch=prefetch)))


def test_map_bands_prefetch_matches_reference():
    img = np.random.default_rng(8).integers(0, 256, (2, 30, 16), np.uint8)
    got = IntegralHistogram(num_bins=8, device="cpu").map_bands(
        img, band_h=7, prefetch=1)
    want = RefIH(num_bins=8, backend="jnp").map_bands(img, band_h=7,
                                                      prefetch=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.H.numpy(), np.asarray(w.H))


def test_tracker_adapter_parity():
    clip = np.stack(_frames(9, n=6, h=32, w=32))
    tr = FragmentTracker(TrackerConfig(num_bins=8, search_radius=3),
                         device="cpu")
    ref = RefTracker(RefConfig(num_bins=8, search_radius=3, backend="jnp"))
    st0 = tr.init(clip[0], [4, 4, 15, 15])
    ref_st0 = ref.init(jnp.asarray(clip[0]), [4, 4, 15, 15])
    _, want = ref.track(dict(ref_st0), clip, batch_size=2)
    for frames in (clip, iter(list(clip)), torch.as_tensor(clip)):
        st, boxes = tr.track(dict(st0), frames, batch_size=2)
        np.testing.assert_array_equal(boxes.numpy(), np.asarray(want))
        np.testing.assert_array_equal(st["bbox"].numpy(),
                                      np.asarray(want)[-1])
    _, boxes = tr.track(dict(st0), clip)        # "auto": the planner's size
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(want))


def test_tracker_empty_and_bad_batch():
    tr = FragmentTracker(TrackerConfig(num_bins=8), device="cpu")
    frame = _frames(10, n=1, h=16, w=16)[0]
    st = tr.init(frame, [2, 2, 9, 9])
    for empty in (np.zeros((0, 16, 16), np.uint8), iter(())):
        _, boxes = tr.track(dict(st), empty)
        assert tuple(boxes.shape) == (0, 4)
    with pytest.raises(ValueError):
        tr.track(dict(st), np.zeros((3, 16, 16), np.uint8), batch_size=0)


def test_prefetch_to_device_staging_window():
    """Exactly `size` items staged before the first yield."""
    staged = []

    def gen(n=5):
        for i in range(n):
            staged.append(i)
            yield np.full((2,), i, np.float32)

    it = prefetch_to_device(gen(), size=2, device="cpu")
    first = next(it)
    assert staged == [0, 1]                     # not size + 1
    assert first.tolist() == [0, 0]
    assert len(list(it)) == 4
    spans = [(0, 3), (3, 5)]
    img = np.arange(20, dtype=np.uint8).reshape(5, 4)
    got = list(pipeline.prefetch_row_bands(img, spans, device="cpu"))
    assert [g.tolist() for g in got] == [img[:3].tolist(), img[3:].tolist()]


def test_auto_batch_size_reexport_matches_planner():
    from repro.core.engine import auto_batch_size as ref_auto

    assert pipeline.auto_batch_size is auto_batch_size
    for shape in ((8, 24, 20), (128, 2048, 2048), (32, 480, 640)):
        assert auto_batch_size(*shape) == ref_auto(*shape)


def test_runtime_adapters_emit_no_deprecation_warnings():
    ih = IntegralHistogram(num_bins=8, device="cpu")
    img = np.random.default_rng(11).integers(0, 256, (30, 16), np.uint8)
    frames = _frames(12, n=4)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        list(ih.map_frames(frames, batch_size=2))
        list(ih.map_bands(img, band_h=10, prefetch=1))
        list(DoubleBufferedExecutor(ih, depth=2, device="cpu").map(
            frames[:2]))
        list(HistogramEngine(8, device="cpu").map_frames(frames[:2]))
        tr = FragmentTracker(TrackerConfig(num_bins=8, search_radius=2),
                             device="cpu")
        tr.track(tr.init(frames[0], [2, 2, 9, 9]), np.stack(frames))


# ---------------------------------------------------------------------------
# a jax placement (the reference's Sharding) is not a port placement: the
# port's is runtime.MeshPlacement (tests/test_torch_distributed.py)
# ---------------------------------------------------------------------------
def _named_sharding():
    from jax.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(jax.make_mesh((1,), ("data",)), P())


def test_stage_stream_refuses_a_sharding():
    with pytest.raises(TypeError, match="MeshPlacement"):
        next(stage_stream(iter([np.zeros(3)]), device=_named_sharding()))


def test_frame_runtime_refuses_a_sharding():
    with pytest.raises(TypeError, match="MeshPlacement"):
        FrameRuntime(lambda c, s: (c, s), device=_named_sharding())


def test_iter_banded_ih_refuses_a_sharding():
    img = np.zeros((24, 16), np.uint8)
    with pytest.raises(TypeError, match="MeshPlacement"):
        next(bands.iter_banded_ih(img, 8, band_h=8, prefetch=1,
                                  device=_named_sharding()))

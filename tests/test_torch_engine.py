"""repro_torch's planner and engine held against the JAX reference, plus
the port's import hygiene.

The reference runs on the CPU with ``backend="jnp"``, the port with
``device="cpu"``.  Plans must agree on representation and microbatch;
``HistogramEngine.run`` must give the same answers (histograms bit for
bit, maps and scores within rtol 1e-6 / atol 1e-7, best rects equal).
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.data.synthetic import video_frames as ref_video_frames
from repro_torch.core import engine
from repro_torch.core.hsource import DenseH, FusedRowsH
from repro_torch.core.integral_histogram import IntegralHistogram
from repro_torch.data import video_frames

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def test_video_frames_copy_matches_reference():
    np.testing.assert_array_equal(video_frames(24, 40, 3, seed=5),
                                  ref_video_frames(24, 40, 3, seed=5))


@pytest.mark.parametrize("num_frames", [1, 5, None])
@pytest.mark.parametrize("height", [32, 96, 480])
def test_plan_matches_reference(height, num_frames):
    width = 640 if height == 480 else 48
    bound = height // 4
    for bins in (1, 16, 32):
        for k in (None, 1, bound - 1, bound, bound + 1):
            rows = None if k is None else tuple(range(k))
            kw = dict(height=height, width=width, num_bins=bins,
                      num_frames=num_frames, query_rows=rows)
            want = ref_engine.plan(ref_engine.WorkloadSpec(backend="jnp",
                                                           **kw))
            got = engine.plan(engine.WorkloadSpec(device="cpu", **kw))
            assert (got.representation, got.microbatch) == (
                want.representation, want.microbatch), kw
            assert got.backend == "torch"
            # workload, full H, representation and query-fusion lines
            n = 5 if rows is not None else 4
            assert got.explain().splitlines()[:n] == \
                want.explain().splitlines()[:n]


class _MeshShape:
    """All the planner reads of a mesh: its axis names and sizes."""

    axis_names = ("data", "model")
    shape = {"data": 2, "model": 4}


@pytest.mark.parametrize("field,value,item", [
    ("memory_budget_bytes", 1 << 20, "1.2"),
    ("storage", "uint16", "1.2"),
    ("mesh", _MeshShape(), "1.7"),
    ("dirty_fraction", 0.1, "1.3"),
])
def test_unported_spec_fields_raise(field, value, item):
    """No spec field is refused any more: the fields of items 1.2, 1.3
    and 1.7 (the mesh) plan as the reference plans them."""
    spec = engine.WorkloadSpec(height=32, width=32, device="cpu",
                               **{field: value})
    want = ref_engine.plan(ref_engine.WorkloadSpec(
        height=32, width=32, backend="jnp", **{field: value}))
    got = engine.plan(spec)

    def decisions(p):
        bp = p.band_plan
        return (p.representation, p.incremental, p.storage, p.microbatch,
                None if bp is None else (bp.spans, bp.band_bytes))

    assert decisions(got) == decisions(want)

    def lines(p):
        keys = ("representation", "incremental", "bands", "storage",
                "sharding", "mesh layout")
        return [ln for ln in p.explain().splitlines()
                if ln.split(":")[0].strip() in keys]

    assert lines(got) == lines(want)


def test_unported_run_arguments_raise():
    """``prev=`` and a memory budget run now: a predecessor without an H
    falls back to a full recompute, a budget below the H bands it; both
    as in the reference."""
    frame = np.arange(256, dtype=np.uint8).reshape(16, 16)
    rects = np.array([[0, 0, 15, 15], [3, 2, 9, 11]])
    cases = [
        (dict(), dict(prev=(frame, None)), "dense"),
        (dict(memory_budget_bytes=1 << 10), dict(), "banded"),
    ]
    for eng_kw, run_kw, rep in cases:
        got = engine.HistogramEngine(num_bins=4, device="cpu", **eng_kw).run(
            frame, [engine.SlidingWindowQuery((4, 4), 2)], **run_kw)
        want = ref_engine.HistogramEngine(num_bins=4, backend="jnp",
                                          **eng_kw).run(
            frame, [ref_engine.SlidingWindowQuery((4, 4), 2)], **run_kw)
        assert got.plan.representation == want.plan.representation == rep
        assert not got.plan.incremental
        np.testing.assert_array_equal(_np(got.results[0]),
                                      np.asarray(want.results[0]))
        np.testing.assert_array_equal(
            _np(got.source.region_histogram(rects)),
            np.asarray(want.source.region_histogram(rects)))


@pytest.mark.parametrize("shape,rect", [
    ((4096, 4096), [0, 0, 4095, 4095]),     # 2^24-pixel frame, whole frame
    ((32, 48), [0, 0, 5000, 5000]),         # declared area past 2^24
])
def test_plan_validation_refuses_inexact_regions(shape, rect):
    frame = np.broadcast_to(np.uint8(7), shape)     # no 16 MiB allocation
    query = [engine.RegionQuery(np.asarray([rect]))]
    with pytest.raises(ref_engine.PlanValidationError):
        ref_engine.HistogramEngine(num_bins=4, backend="jnp").run(frame,
                                                                 query)
    with pytest.raises(engine.PlanValidationError):
        engine.HistogramEngine(num_bins=4, device="cpu").run(frame, query)


def _clip():
    frames = video_frames(96, 128, 3, seed=1)
    # Template: a 32x32 patch of frame 0 on the stride-16 lattice.
    patch = frames[0, 32:64, 48:80]
    target = np.bincount(patch.ravel().astype(np.int64) * 16 // 256,
                         minlength=16).astype(np.float32)
    return frames, target


def _both(queries_fn):
    frames, target = _clip()
    want = ref_engine.HistogramEngine(num_bins=16, backend="jnp").run(
        frames, queries_fn(ref_engine, target))
    got = engine.HistogramEngine(num_bins=16, device="cpu").run(
        frames, queries_fn(engine, target))
    return want, got


def test_engine_run_fused_request_matches_reference():
    def queries(mod, target):
        return [
            mod.RegionQuery(np.array([[3, 4, 40, 60], [50, 70, 95, 127]])),
            mod.LikelihoodQuery(target, (32, 32), stride=16),
            mod.MultiScaleQuery(target, ((16, 16), (32, 32), (48, 48)),
                                stride=16),
        ]

    want, got = _both(queries)
    assert got.plan.representation == want.plan.representation == "fused"
    assert len(got.plan.spec.query_rows) == 9 <= 96 // 4
    assert isinstance(got.source, FusedRowsH)
    np.testing.assert_array_equal(_np(got.results[0]),
                                  np.asarray(want.results[0]))
    np.testing.assert_allclose(_np(got.results[1]),
                               np.asarray(want.results[1]), rtol=RTOL,
                               atol=ATOL)
    (rect, score, maps), (w_rect, w_score, w_maps) = (got.results[2],
                                                       want.results[2])
    np.testing.assert_array_equal(_np(rect), np.asarray(w_rect))
    assert _np(rect)[0].tolist() == [32, 48, 63, 79]
    np.testing.assert_allclose(_np(score), np.asarray(w_score), rtol=RTOL,
                               atol=ATOL)
    for g, w in zip(maps, w_maps):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    stats = got.source.last_fused_stats
    assert stats["rows_bytes"] < stats["full_h_bytes"]
    assert stats["backend"] == "torch"


def test_engine_run_dense_request_matches_reference():
    want, got = _both(lambda mod, _: [mod.SlidingWindowQuery((8, 8))])
    assert got.plan.representation == want.plan.representation == "dense"
    assert isinstance(got.source, DenseH)
    np.testing.assert_array_equal(_np(got.results[0]),
                                  np.asarray(want.results[0]))
    np.testing.assert_array_equal(_np(got.source.dense()),
                                  np.asarray(want.source.dense()))


def test_integral_histogram_operator_and_engine():
    frames, _ = _clip()
    ih = IntegralHistogram(num_bins=16, device="cpu")
    H = ih(frames)
    assert tuple(H.shape) == (3, 16, 96, 128)
    eng = ih.engine()
    np.testing.assert_array_equal(_np(eng.compute_dense(frames)), _np(H))
    hist = ih.query(H, np.array([0, 0, 95, 127]))
    np.testing.assert_array_equal(_np(hist), _np(H[:, :, -1, -1]))
    p = eng.plan_for(frames)
    assert p.representation == "dense" and eng.explain() == p.explain()


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)

"""The example twins (``examples/quickstart_torch.py``,
``examples/video_analytics_torch.py``) against the reference's examples.

The reference's examples run on the CPU with ``backend="auto"``, as its
own tests run them; their results are read where they print them, by
wrapping the functions they call in the example's namespace (nothing in
the reference changes).  The twins run with ``--device cpu``.  Both at
``--frames 8 --hw 96 128``, stdout captured.  Integers (region sums,
rects, boxes, shapes, the plan) must be equal, scores and likelihood maps
within MAP_RTOL.  The service's counts depend on thread timing and are
not compared.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import pathlib

import numpy as np
import pytest

MAP_RTOL = 1e-6
SMALL = ["--frames", "8", "--hw", "96", "128"]
EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args)
    return res, out.getvalue()


@pytest.fixture(scope="module")
def quickstart():
    ref = _load("quickstart")
    seen = {}
    cls = ref.IntegralHistogram
    plain_query = cls.__dict__["query"].__func__
    plain_search = cls.__dict__["multi_scale_search"].__func__

    def query(H, rect):
        out = plain_query(H, rect)
        seen.setdefault("queries", []).append(np.asarray(out))
        return out

    def search(*args, **kwargs):
        out = plain_search(*args, **kwargs)
        seen["search"] = [np.asarray(o) for o in out[:2]]
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(cls, "query", staticmethod(query))
    mp.setattr(cls, "multi_scale_search", staticmethod(search))
    try:
        _, ref_out = _quiet(ref.main)
    finally:
        mp.undo()
    twin, twin_out = _quiet(_load("quickstart_torch").main,
                            ["--device", "cpu"])
    return seen, ref_out, twin, twin_out


def test_quickstart_twin_equals_the_reference(quickstart):
    seen, ref_out, twin, twin_out = quickstart
    region, _ = seen["queries"]
    rect, score = seen["search"]
    assert twin["H_shape"] == (32, 480, 640)
    assert twin["region_sum"] == float(region.sum()) == 13000.0
    assert twin["best_rect"] == [int(v) for v in rect]
    np.testing.assert_allclose(twin["score"], float(score), rtol=MAP_RTOL)
    # the same lines, but for numpy's and Python's list formatting
    assert ref_out.replace("[200 304 263 367]", "[200, 304, 263, 367]") \
        == twin_out


@pytest.fixture(scope="module")
def video():
    ref = _load("video_analytics")
    seen = {"boxes": [], "maps": [], "runs": []}
    step_on_h = ref.FragmentTracker.step_on_h
    likelihood_map = ref.likelihood_map

    def recording_step(self, state, H):
        out = step_on_h(self, state, H)
        seen["boxes"].append(np.asarray(out["bbox"]))
        return out

    def recording_map(*args, **kwargs):
        out = likelihood_map(*args, **kwargs)
        seen["maps"].append(np.asarray(out))
        return out

    class RecordingEngine(ref.HistogramEngine):
        def run(self, *args, **kwargs):
            out = super().run(*args, **kwargs)
            seen["runs"].append((out.plan.representation,
                                 np.asarray(out.results[0])))
            return out

    mp = pytest.MonkeyPatch()
    mp.setattr(ref.FragmentTracker, "step_on_h", recording_step)
    mp.setattr(ref, "likelihood_map", recording_map)
    mp.setattr(ref, "HistogramEngine", RecordingEngine)
    try:
        _, ref_out = _quiet(ref.main, SMALL + ["--serve-requests", "0"])
    finally:
        mp.undo()
    twin, twin_out = _quiet(_load("video_analytics_torch").main,
                            SMALL + ["--device", "cpu"])
    return seen, ref_out, twin, twin_out


def test_video_twin_tracks_equal_the_reference(video):
    seen, _, twin, _ = video
    assert twin["boxes"].dtype.kind == "i"
    np.testing.assert_array_equal(twin["boxes"], np.stack(seen["boxes"]))


def test_video_twin_maps_equal_the_reference(video):
    seen, _, twin, _ = video
    (lmap,) = seen["maps"]
    assert twin["lmap"].shape == lmap.shape == (4, 4, 6)
    np.testing.assert_allclose(twin["lmap"], lmap, rtol=MAP_RTOL, atol=0)
    (plan, large), = seen["runs"]
    assert twin["large_plan"] == plan
    assert twin["large_lmap"].shape == large.shape
    np.testing.assert_allclose(twin["large_lmap"], large, rtol=MAP_RTOL,
                               atol=0)


def test_video_twin_prints_the_references_lines(video):
    """The deterministic lines agree; the timing lines, the device, the
    plan's backend and the service's counts are not compared."""
    _, ref_out, twin, twin_out = video

    def kept(text):
        return [ln for ln in text.splitlines()
                if ln.startswith(("track[", "likelihood maps", "planned",
                                  "large-frame plan", "  representation"))]

    assert kept(ref_out) == kept(twin_out)
    assert twin["service"]["requests"] == 60
    assert twin["service"]["completed"] == 60

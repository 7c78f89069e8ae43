"""The cell vga32-track at a size a CPU test holds: a sound run is correct,
each fault of its answers turns ``correct`` false, the bfloat16 control
fails a limit, its reference loads nothing of the port, and
``track_host_ms`` reads the program's ``repro_torch.track`` spans."""

import types

import numpy as np
import pytest
import torch

from portbench import check, control, generate, harness, timeline
from portbench.kinds import track as kind
from portbench.test_portbench_imports import _top_level
from repro_torch import trace

CELL = "vga32-track"
# The cell cut as smallcells cuts the others: four cameras of 48 x 64 at 8
# bins, two 16 x 16 targets a camera at radius 3, 8 x 8 fragments and
# target; the candidates' corner rows still cover most rows (dense H), and
# the bottom rows count past 256 (bfloat16 cannot hold them).
SMALL = ({"height": 48, "width": 64, "num_bins": 8},
         {"frames_per_request": 4, "target": {"window": [8, 8]},
          "queries": [{"kind": "track", "cameras": 4, "targets": 2,
                       "template": [16, 16], "fragments": [2, 2],
                       "radius": 3}]})
MS = 1_000_000      # ns


def small_cell() -> harness.Cell:
    config, traffic = SMALL
    cell = harness.load_cell(harness.load_manifest(), CELL)
    config = dict(config)
    engine = dict(cell.config["engine"], num_bins=config.pop("num_bins"))
    cell.config.update(config, engine=engine)
    cell.traffic.update(traffic)
    return cell


def _run(wrap=None, seed=2 ** 31 + 11):
    return harness.run_cell(small_cell(), seed, 0.3, False, device="cpu",
                            wrap=wrap)


def test_a_sound_run_is_correct():
    rec = _run()
    assert rec["correct"], rec["checks"]
    assert set(rec["checks"]) == {"count_gap", "box_gap", "score_gap"}
    assert all(c["value"] == 0 for c in rec["checks"].values())
    assert rec["window"]["plan"] == "dense"
    metrics = harness.metrics_of(small_cell(), rec["run"], False)
    assert set(metrics) == {"frames_per_s", "request_p95_ms", "setup_s"}


class _Broken:
    """Stands in the request's place and breaks the tick's answer."""

    def __init__(self, request, fault):
        self.request, self.fault = request, fault

    def __call__(self, frames):
        res = self.request(frames)
        boxes, scores = res.results[0]
        if self.fault == "box_moved":
            boxes = boxes.clone()
            boxes[1, 0] += torch.tensor([0, 1, 0, 1], dtype=boxes.dtype)
        elif self.fault == "score_altered":
            scores = scores.clone()
            scores[2, 1] += 1e-4
        else:                                   # the last camera left out
            boxes, scores = boxes[:-1], scores[:-1]
        res.results = [(boxes, scores)]
        return res


@pytest.mark.parametrize("fault", ["box_moved", "score_altered",
                                   "camera_left_out"])
def test_a_broken_tick_is_not_correct(fault):
    rec = _run(wrap=lambda e: _Broken(e, fault))
    assert not rec["correct"], rec["checks"]
    name = "score_gap" if fault == "score_altered" else "box_gap"
    assert rec["checks"][name]["value"] > rec["checks"][name]["limit"]


def test_the_control_fails_and_the_port_passes():
    c = small_cell()
    out = control.readings(c, [2 ** 31 + 1, 2 ** 33 + 7], [17, 2 ** 31 + 3],
                           0.2, "cpu")
    limits = c.traffic["limits"]
    assert all(p["correct"] for p in out["program"])
    names = check.numbers_for(generate.make_queries(c.config, c.traffic, 0))
    for reading in out["control"]:
        assert any(reading[n] > limits[n] for n in names), reading


def test_the_rows_are_the_ports_declared_rows():
    c = small_cell()
    spec = generate.make_queries(c.config, c.traffic, 2 ** 32 + 3)[0]
    assert spec["boxes"].shape == (4, 2, 4)
    q = kind.program(spec, np.ones(8, np.float32))
    view = types.SimpleNamespace(height=48, width=64)
    np.testing.assert_array_equal(kind.rows(spec, 48), q.needed_rows(view))
    assert len(kind.rows(spec, 48)) > 48 // 4        # dense, not fused


def test_the_reference_loads_nothing_of_the_port():
    loaded = _top_level(["portbench.reference.track"])
    assert not loaded & {"repro_torch", "repro", "jax"}


def _nest():
    """Two requests: (name, parent index, start ms, end ms)."""
    spans = [
        ("repro_torch.run", -1, 10, 100),
        ("repro_torch.plan", 0, 11, 15),
        ("repro_torch.query", 0, 40, 70),       # 30, less track 20
        ("repro_torch.track", 2, 45, 65),       # 20, less stage 2: 18
        ("repro_torch.stage", 3, 50, 52),
        ("repro_torch.run", -1, 200, 300),
        ("repro_torch.query", 5, 210, 230),
        ("repro_torch.track", 6, 212, 228),     # 16
    ]
    return [trace.Record(n, 0, p, a * MS, b * MS) for n, p, a, b in spans]


def _timeline(busy):
    ops = [timeline.Op("k", "kernel", a * MS, b * MS) for a, b in busy]
    return types.SimpleNamespace(timeline=types.SimpleNamespace(ops=ops))


def test_track_host_ms_reads_synthetic_records(monkeypatch):
    read = harness.load_reader("track_host_ms")
    monkeypatch.setattr(trace, "_records", _nest())
    # A card that never ran: the whole self time, (18 + 16) / 2 requests.
    assert read(_timeline([(0, 1)])) == pytest.approx(17.0)
    # Busy 46-49 and 220-300: track 1 loses 3 of its 18, track 2 loses 8
    # of its 16.
    assert read(_timeline([(46, 49), (220, 300)])) == pytest.approx(
        (15 + 8) / 2)
    assert read(_timeline([])) is None                  # no timeline
    assert read(types.SimpleNamespace(timeline=None)) is None
    monkeypatch.setattr(trace, "_records", _nest()[:3])
    assert read(_timeline([(0, 1)])) is None            # no track span


def test_track_host_ms_on_a_profiled_run():
    c = small_cell()
    inputs = generate.make_inputs(c.config, c.traffic, 5, "cpu")
    q = kind.program(inputs.queries[0], inputs.target)
    from repro_torch.core.engine import HistogramEngine

    eng = HistogramEngine(num_bins=8, device="cpu")
    frames = inputs.frames(0, 4)
    trace.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(2):
                eng.run(frames, [q])
        recs = trace.records()
        track = [(i, r) for i, r in enumerate(recs)
                 if r.name == "repro_torch.track"]
        assert len(track) == 2
        own = sum(r.end_ns - r.start_ns - sum(
            k.end_ns - k.start_ns for k in recs if k.parent == i)
            for i, r in track)
        read = harness.load_reader("track_host_ms")
        assert read(_timeline([(0, 1)])) == pytest.approx(own / 2 / 1e6)
    finally:
        trace.clear()

"""BENCHMARK.json against the benchmark's contract, and the harness
finding every file a cell names."""

import json
import math
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_command_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"][:2] == ["python3", "portbench/run.py"]
    assert len(MANIFEST["command"]) <= 32
    assert all(_line(word) for word in MANIFEST["command"])
    for path in MANIFEST["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path)
        assert not path.startswith("/") and ".." not in path.split("/")
        assert not path.endswith("_torch") and path != "benchmarks"
        assert (ROOT / path).is_dir()
    for word in MANIFEST["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MANIFEST["paths"])


def test_names_units_and_entry_keys():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        names.append(("config", c["name"]))
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(("workload", w["name"]))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    for kind, name in names:
        assert NAME.match(name), (kind, name)
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_bounds_and_run_length():
    bounds = {m["name"]: m["bound"] for m in MANIFEST["end_to_end"]}
    assert bounds["setup_s"] <= 0.25
    assert all(0.01 <= b <= 0.25 for b in bounds.values())
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells fits its 43,200 seconds.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_metric_moves_one_that_its_cells_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        target = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert "workloads" not in target or cell in target["workloads"]
    for cell in CELLS:
        reported = [m for m in MANIFEST["end_to_end"]
                    if cell in m.get("workloads", CELLS)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", CELLS)
                   for m in MANIFEST["per_layer"])


def test_layers_are_named_alike():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert layers == {"device", "scan kernels", "staging",
                      "binning and analytics"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_harness_finds_every_file_of_a_cell(cell):
    c = harness.load_cell(MANIFEST, cell)
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["name"] == c.entry["traffic"]
    assert {m["name"] for m in c.end_to_end} >= {"frames_per_s",
                                                 "request_p95_ms", "setup_s"}
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.load_reader(m["name"]))
    assert callable(harness.load_part("clients", c.traffic["client"]).make)
    assert callable(harness.load_part("loops", c.traffic["loop"]).serve)
    files = [ROOT / "portbench" / "traffic" / f"{c.entry['traffic']}.json"]
    files += [ROOT / f["file"] for f in MANIFEST["configs"]
              if f["name"] == c.entry["config"]]
    for f in files:
        rel = f.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel)


@pytest.mark.parametrize("cell", CELLS)
def test_every_compared_number_has_a_limit(cell):
    from portbench import check, generate

    c = harness.load_cell(MANIFEST, cell)
    specs = generate.make_queries(c.config, c.traffic, 0)
    for name in check.numbers_for(specs):
        limit = c.traffic["limits"][name]
        assert limit is not None and math.isfinite(limit) and limit >= 0


def test_configs_state_their_source_and_cuts():
    for entry in MANIFEST["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert cfg["name"] == entry["name"]
        assert entry["source"].startswith(cfg["source"])
        assert cfg["reduced"] == entry["reduced"] == []
        assert cfg["h_dtype"] == "float32"
        assert cfg["guarantees"]["exact_below"] == 2 ** 24
        assert {"num_bins", "value_range"} <= set(cfg["engine"])


@pytest.mark.parametrize("part", ["config", "traffic"])
def test_a_key_the_harness_does_not_read_is_refused(tmp_path, part):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench" / "configs",
                    tmp_path / "portbench" / "configs")
    shutil.copytree(ROOT / "portbench" / "traffic",
                    tmp_path / "portbench" / "traffic")
    cell = CELLS[0]
    harness.load_cell(MANIFEST, cell, root=tmp_path)
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    path = tmp_path / (
        next(c["file"] for c in MANIFEST["configs"]
             if c["name"] == entry["config"]) if part == "config"
        else f"portbench/traffic/{entry['traffic']}.json")
    data = json.loads(path.read_text())
    path.write_text(json.dumps(dict(data, method="cw_tis")))
    with pytest.raises(ValueError, match="method"):
        harness.load_cell(MANIFEST, cell, root=tmp_path)


def test_the_engine_options_reach_the_port_unchanged():
    from repro_torch.core import engine

    made = []

    class Spy(engine.HistogramEngine):
        def __init__(self, **kw):
            made.append(kw)
            super().__init__(**kw)

    client = harness.load_part("clients", "engine_run")
    real = engine.HistogramEngine
    engine.HistogramEngine = Spy
    try:
        options = {"num_bins": 8, "value_range": 256, "method": "cw_tis"}
        client.make(options, [], "cpu")
        assert made == [dict(options, device="cpu")]
        with pytest.raises(TypeError):
            client.make(dict(options, bogus=1), [], "cpu")
    finally:
        engine.HistogramEngine = real

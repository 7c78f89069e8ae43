"""repro_torch's tuned-config priors (core/autotune.py).

The port reads its own priors file (``$REPRO_TORCH_TUNED_CONFIGS``), never
the reference's (``$REPRO_TUNED_CONFIGS``): winners measured on a TPU do
not apply to the card.  With no file, plans and ``explain()`` are what
they were.
"""

import json

import pytest

from repro.core import autotune as ref_autotune
from repro_torch.core import autotune, engine


def _spec(**kw):
    base = dict(height=48, width=64, num_bins=8, device="cpu")
    base.update(kw)
    return engine.WorkloadSpec(**base)


def _write(path, entry, key="48x64x8"):
    autotune.save_priors(str(path), {key: entry})
    return str(path)


@pytest.fixture(autouse=True)
def no_priors(monkeypatch):
    monkeypatch.delenv(autotune.ENV_VAR, raising=False)
    monkeypatch.delenv(ref_autotune.ENV_VAR, raising=False)


def test_priors_round_trip(tmp_path):
    entry = {"bin_block": 4, "band_h": 12, "seconds": 0.001, "gbps": 1.5}
    path = _write(tmp_path / "tuned.json", entry)
    assert autotune.load_priors(path) == {"48x64x8": entry}
    with open(path) as f:
        assert json.load(f)["version"] == 1
    assert autotune.load_priors(str(tmp_path / "missing.json")) == {}
    assert autotune.load_priors() == {}
    (tmp_path / "bad.json").write_text("{not json")
    assert autotune.load_priors(str(tmp_path / "bad.json")) == {}
    assert autotune.config_key(480, 640, 32) == ref_autotune.config_key(
        480, 640, 32)


def test_prior_applies_only_when_bin_block_is_auto(tmp_path, monkeypatch):
    path = _write(tmp_path / "tuned.json", {"bin_block": 4})
    monkeypatch.setenv(autotune.ENV_VAR, path)
    assert autotune.prior_for(_spec()) == {"bin_block": 4}
    assert autotune.prior_for(_spec(bin_block=8)) is None
    assert autotune.prior_for(_spec(height=32)) is None
    p = engine.plan(_spec())
    assert (p.bin_block, p.tuned) == (4, "48x64x8")
    assert "128 / 4 (tuned prior 48x64x8)" in p.explain()
    pinned = engine.plan(_spec(bin_block=8))
    assert (pinned.bin_block, pinned.tuned) == (8, None)


def test_delta_threshold_comes_from_the_prior(tmp_path, monkeypatch):
    assert engine.plan(_spec(dirty_fraction=0.3)).incremental
    path = _write(tmp_path / "tuned.json", {"bin_block": None,
                                            "delta_threshold": 0.2})
    monkeypatch.setenv(autotune.ENV_VAR, path)
    p = engine.plan(_spec(dirty_fraction=0.3))
    assert not p.incremental and p.bin_block is None
    assert engine.plan(_spec(dirty_fraction=0.1)).incremental


def test_the_reference_variable_is_ignored(tmp_path, monkeypatch):
    path = _write(tmp_path / "tpu.json", {"tile": 64, "bin_block": 4,
                                          "delta_threshold": 0.01})
    monkeypatch.setenv(ref_autotune.ENV_VAR, path)
    assert autotune.prior_for(_spec()) is None
    p = engine.plan(_spec(dirty_fraction=0.3))
    assert p.tuned is None and p.incremental and p.bin_block is None


def test_no_file_leaves_plans_and_explain_unchanged():
    specs = [_spec(), _spec(num_frames=None, adaptive_microbatch=True),
             _spec(memory_budget_bytes=4 * 8 * 64 * 8),
             _spec(query_rows=(3, 9)), _spec(dirty_fraction=0.1)]
    for spec in specs:
        p = engine.plan(spec)
        assert p.tuned is None and "tuned prior" not in p.explain()
    lines = engine.plan(specs[0]).explain().splitlines()
    assert lines[5:7] == ["  tile/bin_block  : 128 / auto",
                          "  microbatch      : 1 frame(s)/dispatch"]


def test_autotune_on_the_cpu_returns_a_full_entry(tmp_path):
    entry = autotune.autotune(16, 24, 4, memory_budget_bytes=4 * 4 * 24 * 8,
                              repeats=1, device="cpu")
    assert set(entry) == {"bin_block", "seconds", "band_h", "gbps"}
    assert entry["bin_block"] in autotune.BIN_BLOCK_CANDIDATES
    assert 1 <= entry["band_h"] <= 8 and entry["seconds"] > 0
    out = tmp_path / "tuned.json"
    assert autotune.main(["--height", "16", "--width", "24", "--bins", "4",
                          "--repeats", "1", "--device", "cpu",
                          "--out", str(out)]) == 0
    assert set(autotune.load_priors(str(out))["16x24x4"]) == {
        "bin_block", "seconds", "gbps"}

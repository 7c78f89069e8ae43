"""A whole run of each cell at a small size on the CPU (the look for a card
skipped), and the same with the timed path broken underneath: each fault
a cell can have has to turn ``correct`` false."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness, smallcells

ROOT = Path(__file__).resolve().parents[1]
CELLS = list(smallcells.SMALL)
STACKS = smallcells.STACKS
PLANS = {"aerial8k128-dense": "dense", "vga32-likemap": "dense"}


def _run(cell, wrap=None, seed=2 ** 31 + 5):
    return harness.run_cell(smallcells.small_cell(cell), seed, 0.3, False,
                            device="cpu", wrap=wrap)


class _Broken:
    """Stands in the request's place and breaks what it returns."""

    def __init__(self, request, fault):
        self.request, self.fault, self.first = request, fault, None

    def __call__(self, frames):
        if self.fault == "half_batch":
            half = frames.shape[0] // 2
            res = self.request(frames[:half])
            res.results = [_tile(r, frames.shape[0]) for r in res.results]
            return res
        res = self.request(frames)
        if self.fault == "stale":
            self.first = self.first or res
            return self.first
        if not res.results:                 # H itself altered where made
            res.source.H[..., -1, -1] += 1
            return res
        r = res.results[0]                  # an answer altered where made
        flat = r.reshape(-1).clone()
        flat[flat.numel() // 2] += 1
        res.results = [flat.view(r.shape)] + res.results[1:]
        return res


def _tile(r, n):
    """The first half's answers standing for the whole batch."""
    return torch.cat([r, r[: n - r.shape[0]]])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    rec = _run(cell)
    assert rec["correct"], rec["checks"]
    assert rec["failed"] == 0 and rec["attempted"] >= 1
    assert rec["window"]["plan"] == PLANS[cell]
    assert all(c["value"] == 0 for c in rec["checks"].values())
    metrics = harness.metrics_of(smallcells.small_cell(cell), rec["run"],
                                 False)
    assert set(metrics) == {"frames_per_s", "request_p95_ms", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["altered", "stale"])
def test_a_broken_answer_is_not_correct(cell, fault):
    rec = _run(cell, wrap=lambda e: _Broken(e, fault))
    assert not rec["correct"], rec["checks"]


@pytest.mark.parametrize("cell", STACKS)
def test_half_the_batch_left_out_is_not_correct(cell):
    rec = _run(cell, wrap=lambda e: _Broken(e, "half_batch"))
    assert not rec["correct"], rec["checks"]


def test_a_failing_request_is_counted_and_not_correct():
    class Failing:
        def __init__(self, request):
            self.request, self.calls = request, 0

        def __call__(self, frames):
            self.calls += 1
            if self.calls == 7:            # the window's first request
                raise RuntimeError("planted")
            return self.request(frames)

    rec = _run("aerial8k128-dense", wrap=Failing)
    assert rec["failed"] == 1 and not rec["correct"]


def test_the_same_seed_gives_the_same_inputs():
    from portbench import generate

    cell = smallcells.small_cell("vga32-likemap")
    a = generate.make_inputs(cell.config, cell.traffic, 2 ** 33 + 1, "cpu")
    b = generate.make_inputs(cell.config, cell.traffic, 2 ** 33 + 1, "cpu")
    c = generate.make_inputs(cell.config, cell.traffic, 2 ** 33 + 2, "cpu")
    assert torch.equal(a.pool, b.pool) and not torch.equal(a.pool, c.pool)
    assert (a.target == b.target).all()
    d = generate.make_inputs(cell.config, cell.traffic, -(2 ** 31), "cpu")
    assert d.pool.shape == a.pool.shape


def test_without_the_card_the_command_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "vga32-likemap", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs on the card")


def test_a_short_run_on_the_card(cuda):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "vga32-likemap", "--seed", "11", "--seconds", "2", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


def test_alone_the_benchmark_prints_no_result(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "vga32-likemap", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""

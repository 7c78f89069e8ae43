"""Training of the dense, moe and vlm families held against the JAX
reference: the loss and its gradient, one train step with AdamW and with
Adafactor (the hybrid and audio families' in tests/test_torch_griffin.py
and tests/test_torch_encdec.py, the ssm family's in
tests/test_torch_train.py); checkpoints of a dense arch restoring across
packages, the vlm and audio data streams, ``launch/train.py`` on every
family and ``examples/train_lm_torch.py``.

Weights and optimizer states come from the reference (PRNGKey 0) and are
carried over with ``params_from_numpy`` / ``train_state_from_numpy``;
batches are numpy arrays handed to both, with a vlm's prefix embeddings
or audio's source frames.  Both run the smoke configs on the CPU in
fp32.  The checks and their tolerances: tests/_lm_parity.py.
"""

import dataclasses
import importlib.util
import io
import pathlib
import tempfile
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (
    cfgs, check_loss_and_gradient, check_train_step, flat, state_leaves,
    train_batch,
)
from repro.data import make_stream as ref_make_stream
from repro.train import CheckpointManager as RefCheckpointManager
from repro.train import init_state as ref_init_state
from repro.train import make_optimizer as ref_make_optimizer
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.data import MultimodalStream, TokenStream, make_stream
from repro_torch.launch import train as train_launch
from repro_torch.train import CheckpointManager, make_optimizer, make_train_step
from repro_torch.train.tree import tree_leaves

torch.set_num_threads(1)

# One arch of each family; kimi-k2's smoke config has a dense segment and
# a MoE one with a shared expert.
ARCHS = {"dense": "qwen2-1.5b", "moe": "kimi-k2-1t-a32b",
         "vlm": "llava-next-mistral-7b", "hybrid": "recurrentgemma-9b",
         "audio": "seamless-m4t-large-v2"}


@pytest.mark.parametrize("family", ["dense", "moe", "vlm"])
def test_loss_and_gradient_match_reference(family):
    check_loss_and_gradient(ARCHS[family])


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("family", ["dense", "moe", "vlm"])
def test_train_step_matches_reference(family, optimizer):
    check_train_step(ARCHS[family], optimizer)


def test_checkpoints_restore_across_packages_for_a_dense_arch():
    """qwen2-1.5b's smoke train state: the reference's checkpoint after a
    step restores in the port leaf for leaf, and the port's after another
    step in the reference."""
    rcfg, cfg = cfgs(ARCHS["dense"])
    ref_opt = ref_make_optimizer(rcfg, peak_lr=1e-3, warmup=2,
                                 total_steps=40)
    ref_state = ref_init_state(jax.random.PRNGKey(0), rcfg, ref_opt)
    ref_state, _ = jax.jit(ref_make_train_step(rcfg, ref_opt))(
        ref_state, train_batch(cfg, 4)[0])
    want = state_leaves(jax.tree.map(np.asarray, ref_state))
    with tempfile.TemporaryDirectory() as d:
        RefCheckpointManager(d).save(ref_state, 1)
        mine = CheckpointManager(d).restore(device="cpu")
        got = state_leaves(mine)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        opt = make_optimizer(cfg, peak_lr=1e-3, warmup=2, total_steps=40)
        mine, _ = make_train_step(cfg, opt)(mine, train_batch(cfg, 5)[1])
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(mine, 2)
        back = RefCheckpointManager(d).restore()
        assert int(back["step"]) == 2
        got = state_leaves(jax.tree.map(np.asarray, back))
        want = state_leaves(mine)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_make_stream_for_vlm_and_audio(family):
    """The family's stream: keys, shapes and dtypes as the reference's
    (a vlm's tokens leave room for its prefix, audio's source has a frame
    per token), seekable and deterministic; the embeddings 0.02 * normal
    in bf16, drawn from numpy (not the reference's jax.random bits)."""
    arch = ARCHS[family]
    cfg = smoke_config(arch)
    stream = make_stream(cfg, batch=3, seq_len=20, seed=2)
    assert isinstance(stream, MultimodalStream)
    a, again = stream.batch_at(4), stream.batch_at(4)
    ref = jax.tree.map(np.asarray, ref_make_stream(
        dataclasses.replace(cfg, name=cfg.name), 3, 20, 2).batch_at(4))
    assert sorted(a) == sorted(ref)
    for k in a:
        assert tuple(a[k].shape) == ref[k].shape, k
        assert str(a[k].dtype).split(".")[-1] == str(ref[k].dtype), k
        assert torch.equal(a[k], again[k]), k
    key = "prefix_embeds" if family == "vlm" else "src_embeds"
    n = cfg.num_prefix_embeds if family == "vlm" else 20
    assert tuple(a[key].shape) == (3, n, cfg.d_model)
    assert a["tokens"].shape[1] == 20 - (n if family == "vlm" else 0)
    assert 0.015 < float(a[key].float().std()) < 0.025
    assert not torch.equal(a[key], stream.batch_at(5)[key])
    other = make_stream(cfg, batch=3, seq_len=20, seed=3).batch_at(4)
    assert not torch.equal(a[key], other[key])
    assert isinstance(make_stream(smoke_config("qwen2-1.5b"), 3, 20),
                      TokenStream)


@pytest.mark.parametrize("arch", [*ARCHS.values(), "mamba2-130m"])
def test_launch_train_trains_every_family(arch):
    """launch/train.py --smoke --device cpu on each family: 4 steps, a
    fault at step 3 restored from the step-2 checkpoint, finite loss and
    parameters."""
    with tempfile.TemporaryDirectory() as d:
        out = io.StringIO()
        with redirect_stdout(out):
            state, history = train_launch.main([
                "--arch", arch, "--smoke", "--device", "cpu", "--steps", "4",
                "--batch", "2", "--seq", "24", "--ckpt-dir", d,
                "--ckpt-every", "2", "--fail-at", "3"])
    assert int(state["step"]) == 4
    line = out.getvalue().strip().splitlines()[-1]
    assert line == f"done: step=4 final loss={history[-1]['loss']:.4f}"
    assert all(np.isfinite(h["loss"]) for h in history)
    for leaf in tree_leaves(state["params"]):
        assert bool(torch.isfinite(leaf).all())


def test_train_lm_torch_example_runs_on_the_cpu(capsys):
    """examples/train_lm_torch.py, the twin of examples/train_lm.py, at a
    tiny width: the loss trends down, and a run with an injected fault
    ends where an uninterrupted one does."""
    path = pathlib.Path(__file__).parents[1] / "examples" / \
        "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    argv = ["--device", "cpu", "--steps", "12", "--batch", "2", "--seq",
            "32", "--d-model", "64", "--layers", "2", "--lr", "3e-3"]
    clean = example.main(argv)
    faulty = example.main(argv + ["--fail-at", "11"])
    out = capsys.readouterr().out
    assert "training loss decreased" in out and "injected failures" in out
    for key, leaf in flat(clean["params"]).items():
        np.testing.assert_array_equal(flat(faulty["params"])[key], leaf,
                                      err_msg=key)

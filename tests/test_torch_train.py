"""repro_torch's training slice held against the JAX reference: the loss,
the optimizers, the train step, checkpoints of both packages, fault
injection and restart, the token stream and the launcher.

Weights and optimizer states come from the reference (``init_state``,
PRNGKey 0) and are carried over with ``train_state_from_numpy``; batches
are numpy arrays handed to both.  Both run on the CPU in fp32 (the smoke
config with ``dtype="float32"``), where the port's SSD scan runs its plain
version under autograd.  Each tolerance is stated with the largest error
measured here.
"""

import dataclasses
import io
import os
import tempfile
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.train import CheckpointManager as RefCheckpointManager
from repro.train import init_state as ref_init_state
from repro.train import make_optimizer as ref_make_optimizer
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.data import TokenStream, make_stream
from repro_torch.launch import train as train_launch
from repro_torch.models import api
from repro_torch.models.convert import params_from_numpy, train_state_from_numpy
from repro_torch.train import (
    CheckpointManager, FaultInjector, InjectedFault, Watchdog, adafactor,
    adamw, init_state, make_optimizer, make_train_step, run_training,
    warmup_cosine,
)
from repro_torch.train import grad as G
from repro_torch.train.tree import tree_leaves

torch.set_num_threads(1)

ARCH = "mamba2-130m"
# The loss and its gradient against jax.value_and_grad: fp32, every
# gradient relative to its largest magnitude.  Largest measured: loss
# 6.3e-8 relative, gradients 2.8e-6.
LOSS_RTOL = 1e-6
GRAD_RTOL = 3e-5
# One train step against the reference's: loss and grad norm relative
# (largest measured 1.3e-6).  Parameters after the step absolute: each
# moves by at most lr = 5e-4, and AdamW's g / (sqrt(nu) + eps) turns a
# 1e-6 relative difference of a gradient near eps = 1e-8 into a larger
# one of its step (largest measured 1.2e-5, out_proj; Adafactor 6.0e-8).
# Optimizer moments relative to each leaf's largest (largest measured
# 4.5e-6).  With int8 compression: where g / scale lies within rounding
# of a half, the two packages may round to neighbouring levels, so an
# element of the error buffer may differ by one level (the leaf's scale,
# at most twice its largest residual) and the moments by what that level
# moves them: at most LEVEL_FLIPS elements a leaf (measured 2, in
# out_proj's 65536).  Every other element of a moment within MOMENT_RTOL;
# of the error buffer, a residual g - deq about 1/254 of the gradient's
# range, within ERR_RTOL of the leaf's largest (measured 7.3e-4).
STEP_RTOL = 1e-5
PARAM_ATOL = 5e-5
MOMENT_RTOL = 5e-5
ERR_RTOL = 5e-3
LEVEL_FLIPS = 4


def _cfgs(**kw):
    return (dataclasses.replace(ref_smoke_config(ARCH), dtype="float32", **kw),
            dataclasses.replace(smoke_config(ARCH), dtype="float32", **kw))


def _batch(seed, b=2, s=32, vocab=512):
    r = np.random.default_rng(seed)
    toks = r.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach().cpu() if isinstance(
        tree, torch.Tensor) else tree)}


# --------------------------------------------------------------------------
# loss_fn
# --------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_gradient_match_reference(masked):
    ref_cfg, cfg = _cfgs()
    ref_params = ref_api.init_params(jax.random.PRNGKey(0), ref_cfg)
    batch = _batch(1)
    if masked:
        batch["loss_mask"] = (np.random.default_rng(2).random((2, 32)) < 0.6
                              ).astype(np.float32)
    (want, ref_m), ref_g = jax.value_and_grad(
        lambda p: ref_api.loss_fn(p, batch, ref_cfg), has_aux=True)(
            ref_params)
    model = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                              "cpu")
    got, metrics = api.loss_fn(
        model, {k: torch.as_tensor(v) for k, v in batch.items()}, cfg)
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    assert float(metrics["tokens"]) == float(ref_m["tokens"])
    assert float(metrics["aux_loss"]) == 0.0
    grads = _flat(model.grad_tree())
    for key, w in _flat(jax.tree.map(np.asarray, ref_g)).items():
        assert np.all(np.isfinite(grads[key])), key
        assert _rel(grads[key], w) <= GRAD_RTOL, key


# --------------------------------------------------------------------------
# one train step against the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("optimizer,microbatches,compress", [
    ("adamw", 1, False), ("adafactor", 1, False), ("adamw", 2, False),
    ("adamw", 1, True),
])
def test_train_step_matches_reference(optimizer, microbatches, compress):
    ref_cfg, cfg = _cfgs(optimizer=optimizer)
    ref_opt = ref_make_optimizer(ref_cfg, peak_lr=1e-3, warmup=2,
                                 total_steps=40)
    opt = make_optimizer(cfg, peak_lr=1e-3, warmup=2, total_steps=40)
    ref_state = ref_init_state(jax.random.PRNGKey(0), ref_cfg, ref_opt,
                               compress=compress)
    state = train_state_from_numpy(jax.tree.map(np.asarray, ref_state), cfg,
                                   "cpu")
    batch = _batch(3, b=4)
    ref_new, ref_m = jax.jit(ref_make_train_step(
        ref_cfg, ref_opt, num_microbatches=microbatches,
        compress=compress))(ref_state, batch)
    new, metrics = make_train_step(cfg, opt, num_microbatches=microbatches,
                                   compress=compress)(state, batch)
    for k in ("loss", "grad_norm", "loss_total"):
        assert abs(float(metrics[k]) - float(ref_m[k])) <= STEP_RTOL * abs(
            float(ref_m[k])), k
    assert int(new["step"]) == int(ref_new["step"]) == 1
    got, want = _flat(new), _flat(jax.tree.map(np.asarray, ref_new))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if key.startswith("/params"):
            np.testing.assert_allclose(got[key], w, rtol=0, atol=PARAM_ATOL,
                                       err_msg=key)
        elif compress and key != "/step":
            diff = np.abs(got[key] - w)
            top = np.max(np.abs(w))
            assert np.max(diff) <= 2.01 * top, key
            rtol = ERR_RTOL if key.startswith("/err") else MOMENT_RTOL
            assert np.sum(diff > rtol * top) <= LEVEL_FLIPS, key
        elif key != "/step":
            assert _rel(got[key], w) <= MOMENT_RTOL, key


def test_train_step_updates_in_place_and_every_leaf_moves():
    _, cfg = _cfgs()
    opt = make_optimizer(cfg, peak_lr=1e-3, warmup=2, total_steps=40)
    state = init_state(torch.Generator().manual_seed(0), cfg, opt)
    before = {k: v.copy() for k, v in _flat(state["params"]).items()}
    new, _ = make_train_step(cfg, opt)(state, _batch(4))
    assert new["params"] is state["params"] and new["opt"] is state["opt"]
    for key, leaf in _flat(new["params"]).items():
        assert not np.array_equal(leaf, before[key]), key


# --------------------------------------------------------------------------
# optimizers and gradient machinery
# --------------------------------------------------------------------------
@pytest.mark.parametrize("make_opt", [adamw, adafactor])
def test_optimizer_minimizes_quadratic(make_opt):
    opt = make_opt(0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(5.0)}
    state = opt.init(params)
    for step in range(200):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        (torch.sum(p["w"] ** 2) + p["b"] ** 2).backward()
        params, state = opt.update({k: v.grad for k, v in p.items()}, state,
                                   params, step)
    assert float(torch.sum(params["w"] ** 2) + params["b"] ** 2) < 1e-2


def test_adafactor_state_is_factored():
    st = adafactor(0.1).init({"w": torch.zeros((64, 32)),
                              "b": torch.zeros((64,))})
    assert st["w"]["vr"].shape == (64,)
    assert st["w"]["vc"].shape == (32,)
    assert st["b"]["v"].shape == (64,)


def test_warmup_cosine_matches_reference():
    from repro.train.optimizer import warmup_cosine as ref_warmup_cosine

    mine, ref = warmup_cosine(3e-4, 5, 40), ref_warmup_cosine(3e-4, 5, 40)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 60):
        assert mine(step) == pytest.approx(float(ref(jnp.asarray(step))),
                                           rel=1e-6)


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    clipped, norm = G.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(90 + 160), rel=1e-5)
    _, norm2 = G.clip_by_global_norm(clipped, 1.0)
    assert float(norm2) == pytest.approx(1.0, rel=1e-5)


def test_int8_error_feedback_compression():
    """Quantization error is carried, not lost: over many steps the summed
    dequantized grads converge to the summed true grads."""
    g = {"w": torch.tensor(np.random.default_rng(0).normal(size=(64,)) * 1e-3,
                           dtype=torch.float32)}
    err = G.init_error_buffer(g)
    total = torch.zeros((64,))
    for _ in range(50):
        deq, err = G.compress_grads(g, err)
        total = total + deq["w"]
    np.testing.assert_allclose(total.numpy(), (g["w"] * 50).numpy(),
                               rtol=0.02, atol=1e-5)


def test_quantize_matches_reference():
    from repro.train.grad import _quantize as ref_quantize

    x = np.random.default_rng(5).normal(size=(300,)).astype(np.float32)
    q, scale = G._quantize(torch.as_tensor(x))
    rq, rscale = ref_quantize(jnp.asarray(x))
    assert float(scale) == float(rscale)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))


def test_grad_accumulation_equals_full_batch():
    _, cfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    params = api.stacked_params(api.init_params(gen, cfg))
    batch = {k: torch.as_tensor(v) for k, v in _batch(6, b=4).items()}

    def loss_fn(model, b):
        return api.loss_fn(model, b, cfg)

    l1, _, g1 = G.accumulate_grads(loss_fn, api.model_over(params, cfg),
                                   batch, 1)
    l4, m4, g4 = G.accumulate_grads(loss_fn, api.model_over(params, cfg),
                                    batch, 4)
    assert float(l4) == pytest.approx(float(l1), rel=1e-5)
    assert float(m4["tokens"]) == 32.0     # a microbatch's, averaged
    for a, b in zip(tree_leaves(g1), tree_leaves(g4)):
        assert float((a - b).abs().max()) < 5e-3 * max(
            float(a.abs().max()), 1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        G.accumulate_grads(loss_fn, api.model_over(params, cfg), batch, 3)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------
def _tiny_state(optimizer="adamw", compress=False):
    _, cfg = _cfgs(optimizer=optimizer)
    opt = make_optimizer(cfg, peak_lr=1e-3, warmup=2, total_steps=40)
    return cfg, opt, init_state(torch.Generator().manual_seed(0), cfg, opt,
                                compress=compress)


def test_checkpoint_roundtrip():
    _, _, state = _tiny_state(compress=True)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(state, 7)
        assert mgr.latest_step() == 7
        restored = mgr.restore(device="cpu")
        a, b = _flat(state), _flat(restored)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k


def test_checkpoint_keeps_last_k_and_async_copies_first():
    _, _, state = _tiny_state()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep_last=2)
        for s in (1, 2, 3):
            mgr.save(state, s)
        before = state["params"]["embed"].clone()
        mgr.save_async(state, 4)
        state["params"]["embed"].add_(1.0)    # in place, as a step updates
        mgr.wait()
        steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
        assert steps == ["step_00000003", "step_00000004"]
        restored = mgr.restore(device="cpu")
        assert torch.equal(restored["params"]["embed"], before)
        assert int(restored["step"]) == 0


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_checkpoints_restore_across_packages(optimizer):
    """The reference's checkpoint restores in the port's tree and the
    port's in the reference's, leaf for leaf."""
    ref_cfg, cfg = _cfgs(optimizer=optimizer)
    ref_opt = ref_make_optimizer(ref_cfg, peak_lr=1e-3, warmup=2,
                                 total_steps=40)
    ref_state = ref_init_state(jax.random.PRNGKey(0), ref_cfg, ref_opt,
                               compress=True)
    ref_state, _ = jax.jit(ref_make_train_step(ref_cfg, ref_opt,
                                               compress=True))(
        ref_state, _batch(7))
    want = _flat(jax.tree.map(np.asarray, ref_state))
    with tempfile.TemporaryDirectory() as d:
        RefCheckpointManager(d).save(ref_state, 1)
        mine = CheckpointManager(d).restore(device="cpu")
        got = _flat(mine)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        opt = make_optimizer(cfg, peak_lr=1e-3, warmup=2, total_steps=40)
        mine, _ = make_train_step(cfg, opt, compress=True)(mine, _batch(8))
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(mine, 2)
        back = RefCheckpointManager(d).restore()
        assert int(back["step"]) == 2
        got, want = _flat(jax.tree.map(np.asarray, back)), _flat(mine)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --------------------------------------------------------------------------
# fault injection, restart, watchdog, data
# --------------------------------------------------------------------------
def _run(d, fail_at=(), num_steps=6, optimizer="adamw"):
    cfg, opt, _ = _tiny_state(optimizer)
    step = make_train_step(cfg, opt)
    stream = make_stream(cfg, batch=2, seq_len=16, seed=3)
    return run_training(
        init_state_fn=lambda: init_state(torch.Generator().manual_seed(0),
                                         cfg, opt),
        train_step=step, stream=stream, ckpt=CheckpointManager(d),
        num_steps=num_steps, ckpt_every=2, device="cpu",
        injector=FaultInjector(fail_at) if fail_at else None,
        watchdog=Watchdog(), log_every=1)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_restart_after_injected_fault_equals_uninterrupted_run(optimizer):
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        clean, h1 = _run(d1, optimizer=optimizer)
        faulty, h2 = _run(d2, fail_at=(3,), optimizer=optimizer)
    assert int(clean["step"]) == int(faulty["step"]) == 6
    a, b = _flat(clean), _flat(faulty)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # The faulty run replays steps 3 and 4 from the step-2 checkpoint.
    assert [h["step"] for h in h2] == [1, 2, 3, 3, 4, 5, 6]
    assert h1[-1]["loss"] == h2[-1]["loss"]


def test_fault_injector_fires_once_and_restarts_are_bounded():
    inj = FaultInjector((2,))
    inj.check(1)
    with pytest.raises(InjectedFault):
        inj.check(2)
    inj.check(2)
    with tempfile.TemporaryDirectory() as d:
        cfg, opt, _ = _tiny_state()

        def always_fails(state, batch):
            raise InjectedFault("lost")

        with pytest.raises(InjectedFault):
            run_training(init_state_fn=lambda: {"step": torch.tensor(0)},
                         train_step=always_fails,
                         stream=make_stream(cfg, 2, 8), ckpt=CheckpointManager(d),
                         num_steps=2, device="cpu", max_restarts=2)


def test_watchdog_flags_stragglers():
    wd = Watchdog(ratio=3.0)
    assert wd.observe(1.0, 0) is False and wd.ema == 1.0
    assert wd.observe(1.2, 1) is False
    assert wd.ema == pytest.approx(1.02)
    assert wd.observe(10.0, 2) is True
    assert wd.slow_steps == 1
    assert wd.ema == pytest.approx(0.9 * 1.02 + 1.0)


def test_token_stream_is_seekable_and_deterministic():
    s = TokenStream(vocab_size=100, batch=4, seq_len=16, seed=3)
    a, b = s.batch_at(5), s.batch_at(5)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (4, 16)
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert not torch.equal(a["tokens"], s.batch_at(6)["tokens"])
    other = TokenStream(vocab_size=100, batch=4, seq_len=16, seed=4)
    assert not torch.equal(a["tokens"], other.batch_at(5)["tokens"])
    toks = TokenStream(100, 8, 32, seed=1, pattern_frac=1.0).batch_at(0)
    full = torch.cat([toks["tokens"], toks["labels"][:, -1:]], 1).long()
    stride = (full[:, 1] - full[:, 0]) % 100
    assert bool(((full[:, 1:] - full[:, :-1]) % 100 == stride[:, None]).all())
    assert 0 <= int(full.min()) and int(full.max()) < 100


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def test_launch_train_smoke_on_cpu():
    with tempfile.TemporaryDirectory() as d:
        out = io.StringIO()
        with redirect_stdout(out):
            state, history = train_launch.main([
                "--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
                "--seq", "32", "--ckpt-dir", d, "--ckpt-every", "2",
                "--fail-at", "3", "--microbatches", "2"])
        assert sorted(os.listdir(d))[-1] == "step_00000004"
    assert int(state["step"]) == 4
    line = out.getvalue().strip().splitlines()[-1]
    assert line == f"done: step=4 final loss={history[-1]['loss']:.4f}"
    assert np.isfinite(history[-1]["loss"])
    for leaf in tree_leaves(state["params"]):
        assert bool(torch.isfinite(leaf).all())


def test_launch_train_refuses_a_mesh():
    """The production meshes (``--mesh pod|multipod``,
    ``launch/mesh.make_production_mesh``) raise ValueError naming the 256
    (512) cards they need on a host with fewer; ``--mesh host`` trains
    (tests/test_torch_launch_mesh.py holds it against ``--mesh none``)."""
    for mesh, cards in (("pod", 256), ("multipod", 512)):
        with pytest.raises(ValueError, match=f"needs {cards} cards"):
            train_launch.main(["--smoke", "--device", "cpu", "--mesh", mesh])

"""``cfg.remat`` in the port (``models.layers.remat``) against the
reference's ``jax.checkpoint`` of each family's layer body.

* Losses and gradients: one fp32 step of every family's smoke config
  (weights the reference's seed-0 ones, carried over by
  ``models/convert.py``; the batch numpy from a seed) is bit-equal under
  "none", "dots" and "full", and each setting's train step matches the
  reference's train step under the same setting
  (``_lm_parity.check_train_step``, its training tolerances).
* Counting on meta (``launch/analysis.StepCounter``): the peak of live
  storage falls with checkpointing in every family's train cell, and
  Mamba-2 launches K5 once a layer under "none" and "dots" and twice
  under "full", K5-bwd once.
* Serving runs under ``no_grad``, where nothing is checkpointed: the ops
  a forward dispatches and its outputs are the same under every setting.
* A sharded path's recompute runs in the sharding context of its
  forward, whatever context the backward runs in.
* ``configs.all_configs`` equals the reference's, ``remat`` included.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _lm_parity import cfgs, check_train_step, port_params, train_batch
from repro.configs import all_configs as ref_all_configs
from repro_torch.config import ShapeConfig
from repro_torch.configs import all_configs, smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api, layers
from repro_torch.sharding import ShardingRules, sharding_context

torch.set_num_threads(1)

SETTINGS = ("none", "dots", "full")
# One arch of each family.
ARCHS = {"dense": "qwen2-1.5b", "moe": "kimi-k2-1t-a32b",
         "vlm": "llava-next-mistral-7b", "ssm": "mamba2-130m",
         "hybrid": "recurrentgemma-9b", "audio": "seamless-m4t-large-v2"}


def _loss_and_grads(arch, remat, seed=5):
    """The port's fp32 loss and its gradient (the reference's layout) of
    one smoke batch under ``remat``."""
    _, cfg = cfgs(arch, remat=remat)
    model = port_params(arch, cfg)
    _, batch = train_batch(cfg, seed)
    loss, metrics = api.loss_fn(model, batch, cfg)
    loss.backward()
    return loss.detach(), metrics["aux_loss"].detach(), model.grad_tree()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("family", list(ARCHS))
def test_losses_and_gradients_are_bit_equal_across_settings(family):
    """Checkpointing changes what is kept, not what is computed: the
    loss, the MoE aux loss and every gradient are torch.equal."""
    runs = {r: _loss_and_grads(ARCHS[family], r) for r in SETTINGS}
    loss, aux, grads = runs["none"]
    want = _leaves(grads)
    assert any(bool(g.any()) for g in want.values())
    for r in ("dots", "full"):
        got_loss, got_aux, got_grads = runs[r]
        assert torch.equal(got_loss, loss) and torch.equal(got_aux, aux), r
        got = _leaves(got_grads)
        assert sorted(got) == sorted(want)
        for k, g in want.items():
            assert torch.equal(got[k], g), (r, k)


@pytest.mark.parametrize("remat", SETTINGS)
@pytest.mark.parametrize("family", list(ARCHS))
def test_train_step_matches_reference_under_each_setting(family, remat):
    """One AdamW step from the reference's seed-0 state, both packages
    under the same ``remat``: metrics, parameters and moments within the
    training tolerances of tests/_lm_parity.py."""
    check_train_step(ARCHS[family], "adamw", remat=remat)


# --------------------------------------------------------------------------
# Counting on meta tensors
# --------------------------------------------------------------------------
MESH = make_host_mesh((1, 1), devices=["meta"])


def _counted(arch, remat, kind="train", b=2, s=64):
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                              remat=remat)
    return dryrun._measure(cfg, ShapeConfig("smoke", s, b, kind), MESH,
                           ShardingRules(), kind)


@pytest.mark.parametrize("family", list(ARCHS))
def test_counted_peak_falls_with_checkpointing(family):
    """In every family's train cell the counted peak of live storage is
    lower under "full" than under "none", with "dots" between; the
    recompute adds FLOPs under "full".  At 4 x 256 tokens, where the
    activations outweigh the optimizer update's temporaries (at 2 x 64
    the vlm cell's peak is that update, the same under every setting)."""
    counts = {r: _counted(ARCHS[family], r, b=4, s=256) for r in SETTINGS}
    peak = {r: c["memory"]["temp_size_in_bytes"] for r, c in counts.items()}
    assert peak["full"] < peak["none"], peak
    assert peak["full"] <= peak["dots"] <= peak["none"], peak
    assert counts["full"]["flops"] > counts["none"]["flops"]
    assert counts["dots"]["matmul_flops_global"] == \
        counts["none"]["matmul_flops_global"]


def test_mamba_k5_calls_follow_the_setting():
    """K5 (counted as the kernel on meta) runs once a layer under "none"
    and "dots", where its outputs are kept like a matmul's, and twice
    under "full", where the backward runs each layer again; K5-bwd once
    a layer under all three."""
    layers_ = smoke_config("mamba2-130m").num_layers
    for remat, fwd in (("none", 1), ("dots", 1), ("full", 2)):
        calls = {k: v["calls"] for k, v in
                 _counted("mamba2-130m", remat)["kernels"].items()}
        assert calls == {"ssd_scan": fwd * layers_,
                         "ssd_scan_bwd": layers_}, remat


# --------------------------------------------------------------------------
# Serving: nothing checkpointed under no_grad
# --------------------------------------------------------------------------
class _Ops(TorchDispatchMode):
    """Records every op dispatched."""

    def __enter__(self):
        self.ops = []
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("family", list(ARCHS))
def test_no_grad_forward_is_unchanged_by_the_setting(family):
    """A forward without a cache under no_grad (serving's, and the
    encoder of an encoder-decoder's prefill) dispatches the same ops and
    returns the same logits under every setting."""
    arch = ARCHS[family]
    seen = {}
    for r in SETTINGS:
        _, cfg = cfgs(arch, remat=r)
        model = port_params(arch, cfg)
        _, batch = train_batch(cfg, 7)
        with torch.no_grad(), _Ops() as mode:
            logits, _, _ = api.forward(model, batch, cfg)
        seen[r] = (mode.ops, logits)
    for r in ("dots", "full"):
        assert seen[r][0] == seen["none"][0], r
        assert torch.equal(seen[r][1], seen["none"][1]), r


def test_mamba_prefill_launches_k5_once_a_layer_under_every_setting():
    layers_ = smoke_config("mamba2-130m").num_layers
    for r in SETTINGS:
        calls = {k: v["calls"] for k, v in _counted(
            "mamba2-130m", r, kind="prefill")["kernels"].items()}
        assert calls == {"ssd_scan": layers_}, r


# --------------------------------------------------------------------------
# The helper itself
# --------------------------------------------------------------------------
def test_remat_helper_settings():
    def fn(x):
        return torch.tanh(x)

    cfg = smoke_config("qwen2-1.5b")
    assert layers.remat(fn, dataclasses.replace(cfg, remat="none")) is fn
    with pytest.raises(ValueError, match="remat='some'"):
        layers.remat(fn, dataclasses.replace(cfg, remat="some"))
    x = torch.tensor([-1.5, 0.25, 2.0], requires_grad=True)
    (want,) = torch.autograd.grad(fn(x).sum(), x)
    for r in ("dots", "full"):
        wrapped = layers.remat(fn, dataclasses.replace(cfg, remat=r))
        (got,) = torch.autograd.grad(wrapped(x).sum(), x)
        assert torch.equal(got, want), r
        with torch.no_grad():
            assert torch.equal(wrapped(x), fn(x))


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_sharded_recompute_runs_in_its_forwards_context(arch):
    """A sequence-parallel forward under "full", differentiated outside
    its sharding context: the recompute runs the sharded scan again (it
    sees the forward's context), so the gradients equal the ones taken
    inside the context."""
    flag = {"mamba2-130m": "ssm_seq_parallel",
            "recurrentgemma-9b": "rnn_seq_parallel"}[arch]
    _, cfg = cfgs(arch, remat="full", **{flag: True})
    mesh = make_host_mesh((1, 2), devices=["cpu"] * 2)
    _, batch = train_batch(cfg, 13, b=2, s=32)
    grads = []
    for outside in (False, True):
        model = port_params(arch, cfg)
        with sharding_context(mesh, ShardingRules()):
            loss, _ = api.loss_fn(model, batch, cfg)
            if not outside:
                loss.backward()
        if outside:
            loss.backward()
        grads.append(_leaves(model.grad_tree()))
    for k, g in grads[0].items():
        assert torch.equal(grads[1][k], g), k


def test_all_configs_equal_the_reference():
    """``configs.all_configs`` has the reference's keys, and every
    config's every field equals the reference's (``remat`` included)."""
    mine, ref = all_configs(), ref_all_configs()
    assert list(mine) == list(ref)
    for arch, cfg in mine.items():
        got, want = dataclasses.asdict(cfg), dataclasses.asdict(ref[arch])
        assert sorted(got) == sorted(want), arch
        for field, value in want.items():
            assert got[field] == value or (
                isinstance(value, (list, tuple))
                and list(got[field]) == list(value)), (arch, field)
        assert cfg.remat == ref[arch].remat == "full"

"""The sequence-parallel scans of the port (``models/ssm.ssd_seq_parallel``,
``models/griffin._rglru_seq_parallel``) against the reference's
*single-device* model, on meshes of CPU entries with a model axis of 1, 2
and 4 (and a data axis of 1 or 2).

The reference's own sequence-parallel tests run on 8 forced host devices
and fail on this host (ROADMAP Queue 3), so its unsharded
``api.forward`` / ``prefill`` / ``jax.value_and_grad`` is the oracle.
Seed-0 weights of the smoke configs in fp32 (``tests/_lm_parity.py``);
the tolerances are that file's: logits and caches within ATOL32 (1e-4,
|logit| up to ~5), loss within LOSS_RTOL, each gradient within GRAD_RTOL
of its leaf's largest magnitude.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (
    ATOL32, GRAD_RTOL, LOSS_RTOL, cfgs, compiled, flat, np_, port_params,
    ref_params, rel, state_leaves, tokens, train_batch,
)
from repro.models import api as ref_api
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api, griffin, ssm
from repro_torch.sharding import ShardingRules, sharding_context

ARCHS = {"mamba2-130m": "ssm_seq_parallel",
         "recurrentgemma-9b": "rnn_seq_parallel"}
# (data, model): a model axis of 1, 2 and 4, two with a data axis of 2
MESH_SHAPES = [(2, 1), (1, 2), (2, 2), (1, 4)]


def mesh_of(shape):
    return make_host_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))


def sp_cfgs(arch):
    return cfgs(arch, **{ARCHS[arch]: True})


def counted_scans(monkeypatch, arch):
    """Count the per-shard scans: ``ssd_chunked`` calls (one a shard a
    layer) or RG-LRU gate computations (one a shard a recurrent layer);
    each record is the scanned sequence length."""
    calls = []
    mod, name = ((ssm, "ssd_chunked") if arch == "mamba2-130m"
                 else (griffin, "_rglru_gates"))
    inner = getattr(mod, name)

    def wrapper(*args, **kwargs):
        calls.append(args[0].shape[1])
        return inner(*args, **kwargs)

    monkeypatch.setattr(mod, name, wrapper)
    return calls


def scan_layers(cfg):
    if cfg.family == "ssm":
        return cfg.num_layers
    pat = cfg.block_pattern
    full = cfg.num_layers // len(pat) * list(pat)
    return (full + list(pat[:cfg.num_layers - len(full)])).count("rec")


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_single_device_reference(arch, shape, monkeypatch):
    """A 4 x 64 forward under the context: logits of the reference's
    unsharded forward within ATOL32, every layer's scan split into one
    scan a shard."""
    rcfg, cfg = sp_cfgs(arch)
    toks = tokens(5, b=4, s=64)
    rcfg = dataclasses.replace(rcfg, **{ARCHS[arch]: False})
    want, _, _ = jax.jit(lambda p, b: ref_api.forward(p, b, rcfg))(
        ref_params(arch), {"tokens": jnp.asarray(toks)})
    model = port_params(arch, cfg)
    calls = counted_scans(monkeypatch, arch)
    with torch.no_grad(), sharding_context(mesh_of(shape), ShardingRules()):
        got, _, _ = api.forward(model, {"tokens": torch.as_tensor(toks)}, cfg)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL32,
                               rtol=0)
    assert calls == [64 // shape[1]] * (scan_layers(cfg) * shape[0]
                                        * shape[1])


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_into_state_matches_single_device_reference(arch, shape):
    """Two prefills of 16 tokens, the second into the non-zero state the
    first left (h0 seeds rank 0 only), then two decode steps, under the
    context: last logits and every cache leaf (the SSD / RG-LRU final
    state h_last among them) against the reference's unsharded ones."""
    rcfg, cfg = sp_cfgs(arch)
    rp, model = ref_params(arch), port_params(arch, cfg)
    toks = tokens(6, b=2, s=34)
    ref_cache = ref_api.init_cache(rcfg, 2, 40, dtype=jnp.float32)
    cache = api.init_cache(cfg, 2, 40, dtype=torch.float32, device="cpu")
    ref_step = compiled(lambda p, t, k: ref_api.prefill(p, {"tokens": t},
                                                        rcfg, k),
                        rp, jnp.asarray(toks[:, :16]), ref_cache)
    ref_dec = compiled(lambda p, t, k: ref_api.decode_step(p, t, rcfg, k),
                       rp, jnp.asarray(toks[:, :1]), ref_cache)
    with sharding_context(mesh_of(shape), ShardingRules()):
        for part in (slice(0, 16), slice(16, 32), slice(32, 33),
                     slice(33, 34)):
            t = toks[:, part]
            run = ref_step if t.shape[1] > 1 else ref_dec
            want, ref_cache = run(rp, jnp.asarray(t), ref_cache)
            fn = api.prefill if t.shape[1] > 1 else api.decode_step
            got, cache = fn(model, *(({"tokens": torch.as_tensor(t)},)
                                     if t.shape[1] > 1
                                     else (torch.as_tensor(t),)),
                            cfg, cache)
            np.testing.assert_allclose(np_(got), np.asarray(want),
                                       atol=ATOL32, rtol=0)
            got_leaves, want_leaves = flat(cache), flat(ref_cache)
            assert sorted(got_leaves) == sorted(want_leaves)
            for key, w in want_leaves.items():
                np.testing.assert_allclose(got_leaves[key], w, atol=ATOL32,
                                           rtol=0, err_msg=key)
    assert any(np.abs(v).max() > 0.1 for k, v in flat(cache).items()
               if k.endswith("/h"))


@pytest.mark.parametrize("arch", ARCHS)
def test_indivisible_sequence_takes_single_device_path(arch, monkeypatch):
    """S = 66 on a model axis of 4: the reference's condition fails, and
    the single-device scan runs, bit-equal to a run with no context."""
    _, cfg = sp_cfgs(arch)
    model = port_params(arch, cfg)
    b = {"tokens": torch.as_tensor(tokens(7, b=2, s=66))}
    with torch.no_grad():
        alone, _, _ = api.forward(model, b, cfg)
        calls = counted_scans(monkeypatch, arch)
        with sharding_context(mesh_of((1, 4)), ShardingRules()):
            got, _, _ = api.forward(model, b, cfg)
    assert torch.equal(got, alone)
    assert calls == [66] * scan_layers(cfg)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)], ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_gradient_matches_single_device_reference(arch, shape):
    """loss_fn and its gradient of a 2 x 32 batch in fp32 under the
    context, against jax.value_and_grad of the reference's unsharded
    loss: the ladder's and the fold's gradients reach every shard."""
    rcfg, cfg = sp_cfgs(arch)
    rcfg = dataclasses.replace(rcfg, **{ARCHS[arch]: False})
    rb, b = train_batch(cfg, 11, b=2, s=32)
    (want, _), ref_g = jax.jit(jax.value_and_grad(
        lambda p, x: ref_api.loss_fn(p, x, rcfg), has_aux=True))(
            ref_params(arch), rb)
    model = port_params(arch, cfg)
    with sharding_context(mesh_of(shape), ShardingRules()):
        got, _ = api.loss_fn(model, b, cfg)
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    grads = state_leaves(model.grad_tree())
    want_g = state_leaves(jax.tree.map(np.asarray, ref_g))
    assert sorted(grads) == sorted(want_g)
    for key, w in want_g.items():
        assert np.all(np.isfinite(grads[key])), key
        if np.any(w):
            assert rel(grads[key], w) <= GRAD_RTOL, key

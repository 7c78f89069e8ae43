"""repro_torch's MoE block and the moe family held against the JAX
reference.

The block's parts (``_capacity``, ``_route`` with its ties,
``_dispatch_compute_combine`` at capacities small enough to drop tokens,
k = 1 and k = 2, fp32 and bf16, and ``moe_block`` with and without a
shared expert), kimi-k2's segment layout, then the two moe smoke configs
(llama4-scout: 4 experts, top-1, a shared expert; kimi-k2: 4 experts,
top-2, a shared expert, a first dense layer) whole: forward and loss in
fp32 and bf16, prefill and decode against the reference, decode against
the full forward.  Inputs, weights and tolerances: tests/_lm_parity.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (
    ATOL16, ATOL32, cfgs, check_decode_matches_full_forward,
    check_forward_and_loss, check_prefill_and_decode, normal, np_,
    port_params, ref_params, rounded,
)
from repro.models import moe as ref_moe
from repro_torch.models import api, moe, transformer
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

ARCHS = ("llama4-scout-17b-a16e", "kimi-k2-1t-a32b")
# fp32 MoE outputs (values up to ~2): largest measured 7.7e-7.
ATOL_MOE = 1e-5


def _moe_cfgs(k, capacity_factor, shared=1, dtype="float32"):
    return cfgs("kimi-k2-1t-a32b", dtype, num_experts_per_token=k,
                capacity_factor=capacity_factor, num_shared_experts=shared)


def _moe_params(rcfg):
    rp = ref_moe.moe_params(jax.random.PRNGKey(3), rcfg)
    return rp, {k: torch.as_tensor(np.array(v)) for k, v in rp.items()}


def test_capacity_matches_reference():
    for t in (1, 7, 64, 4096):
        for k, cf in ((1, 1.25), (2, 0.5), (8, 1.0)):
            rcfg, cfg = _moe_cfgs(k, cf)
            assert moe._capacity(t, cfg) == ref_moe._capacity(t, rcfg)


@pytest.mark.parametrize("k", [1, 2])
def test_route_matches_reference(k):
    """Weights, experts and the aux loss; rows 0-3 have equal router
    logits, where the lower expert wins, as lax.top_k has it."""
    rcfg, cfg = _moe_cfgs(k, 1.25)
    x = normal(1, (64, 128))
    x[:4] = 0.0                                   # all-equal probabilities
    router = normal(2, (128, 4), 0.1)
    w_want, e_want, aux_want = ref_moe._route(jnp.asarray(x),
                                              jnp.asarray(router), rcfg)
    w, e, aux = moe._route(torch.as_tensor(x), torch.as_tensor(router), cfg)
    np.testing.assert_array_equal(np_(e), np.asarray(e_want))
    assert np_(e)[:4].tolist() == [list(range(k))] * 4
    np.testing.assert_allclose(np_(w), np.asarray(w_want), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(aux_want), rtol=1e-6)


# (k, capacity factor): capacities of 8, 16 and 96 for 64 tokens over 4
# experts; the first two drop assignments (checked below).
DISPATCH = [(1, 0.25), (2, 0.5), (2, 3.0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,capacity_factor", DISPATCH)
def test_dispatch_compute_combine_matches_reference(k, capacity_factor,
                                                    dtype):
    rcfg, cfg = _moe_cfgs(k, capacity_factor, dtype=dtype)
    rp, p = _moe_params(rcfg)
    x = normal(4, (64, 128))
    w, e, _ = moe._route(torch.as_tensor(x), p["router"], cfg)
    cap = moe._capacity(64, cfg)
    counts = np.bincount(np_(e).astype(int).ravel(), minlength=4)
    assert (np.maximum(counts - cap, 0).sum() > 0) == (capacity_factor < 1)
    rdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rw = [jnp.asarray(rp[n]).astype(rdt) for n in ("we_gate", "we_up",
                                                   "we_down")]
    want = rounded(
        lambda xx, ww, ee, a, b, c: ref_moe._dispatch_compute_combine(
            xx, ww, ee, a, b, c, rcfg, lo=0, e_local=4),
        jnp.asarray(x).astype(rdt), jnp.asarray(np_(w)),
        jnp.asarray(np_(e).astype(np.int32)), *rw)
    got = moe._dispatch_compute_combine(
        torch.as_tensor(x).to(dt), w, e,
        *(p[n].to(dt) for n in ("we_gate", "we_up", "we_down")), cfg,
        lo=0, e_local=4)
    assert got.dtype == dt
    # bf16: the reference rounded per op, two bf16 steps of outputs up to
    # ~2 (0.0078 each at 1-2); measured 4.9e-4.
    atol = ATOL_MOE if dtype == "float32" else 0.0157
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32),
                               atol=atol, rtol=0)
    if dtype == "bfloat16":          # no atomics: the same bits again
        again = moe._dispatch_compute_combine(
            torch.as_tensor(x).to(dt), w, e,
            *(p[n].to(dt) for n in ("we_gate", "we_up", "we_down")), cfg,
            lo=0, e_local=4)
        assert torch.equal(got, again)


@pytest.mark.parametrize("k,capacity_factor", DISPATCH)
def test_moe_block_equals_its_plain_version(k, capacity_factor):
    """moe_block against moe_block_plain (the per-expert loop the card
    checks use), which drops the same assignments; fp32, measured equal."""
    rcfg, cfg = _moe_cfgs(k, capacity_factor)
    _, p = _moe_params(rcfg)
    x = torch.as_tensor(normal(6, (2, 32, 128)))
    got, _ = moe.moe_block(x, p, cfg)
    want, dropped = moe.moe_block_plain(x, p, cfg)
    torch.testing.assert_close(got, want, atol=ATOL_MOE, rtol=0)
    _, e, _ = moe._route(x.reshape(64, 128), p["router"], cfg)
    counts = np.bincount(np_(e).astype(int).ravel(), minlength=4)
    assert dropped == np.maximum(counts - moe._capacity(64, cfg), 0).sum()
    assert (dropped > 0) == (capacity_factor < 1)


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_block_matches_reference(shared):
    rcfg, cfg = _moe_cfgs(2, 0.5, shared=shared)
    rp, p = _moe_params(rcfg)
    assert ("ws_gate" in p) == bool(shared)
    x = normal(5, (2, 32, 128))
    want, aux_want = ref_moe.moe_block(jnp.asarray(x), rp, rcfg)
    got, aux = moe.moe_block(torch.as_tensor(x), p, cfg)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL_MOE)
    np.testing.assert_allclose(float(aux), float(aux_want), rtol=1e-6)


def test_params_from_numpy_carries_every_leaf_by_segment():
    """kimi-k2's smoke config: segments of 1 dense and 2 MoE layers."""
    arch = "kimi-k2-1t-a32b"
    _, cfg = cfgs(arch)
    assert transformer.segments_spec(cfg) == (("dense", 1), ("moe", 2))
    ref = jax.tree.map(np.asarray, ref_params(arch))
    model = port_params(arch, cfg)
    back = api.stacked_params(model)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat_ref) == len(jax.tree.leaves(
        jax.tree.map(np_, back)))
    for path, leaf in flat_ref:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(np_(node), leaf)
    # the model's parameters are views of the stacked tensors
    stacked = {k: v for k, v in back.items()}
    over = api.model_over(stacked, cfg)
    stacked["segments"]["seg1"]["layers"]["moe"]["router"][1].fill_(3.0)
    assert float(over.segments.seg1.layers[1].moe.router.detach().max()) == 3.0
    bad = dict(ref)
    bad["segments"] = {"seg0": ref["segments"]["seg0"],
                       "seg1": jax.tree.map(lambda a: a[:1],
                                            ref["segments"]["seg1"])}
    with pytest.raises(ValueError, match="depth"):
        params_from_numpy(bad, cfg, "cpu")



# --------------------------------------------------------------------------
# the moe family whole
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, dtype):
    check_forward_and_loss(arch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    check_prefill_and_decode(arch, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    check_decode_matches_full_forward(arch)

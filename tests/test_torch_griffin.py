"""repro_torch's Griffin (the hybrid family, recurrentgemma-9b) held
against the JAX reference: the RG-LRU's gates and chunked scan, the
recurrent mixer's three paths, the parameter and cache layouts, and the
smoke config whole (forward and loss in fp32 and bf16, prefill and
decode against the reference, decode against the full forward, a prefill
past the ring's wrap).  Inputs, weights and whole-model tolerances:
tests/_lm_parity.py.  Each other tolerance is stated with the largest
error measured here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (
    ATOL32, batch, cfgs, check_decode_matches_full_forward,
    check_forward_and_loss, check_loss_and_gradient,
    check_prefill_and_decode, check_train_step, flat, normal, np_,
    port_params, ref_params, tokens,
)
from repro.models import api as ref_api
from repro.models import griffin as ref_griffin
from repro_torch.models import api, griffin
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

ARCH = "recurrentgemma-9b"
# The RG-LRU in fp32 (h up to ~1.3): the port's log-depth scan sums in
# another tree order than jax's associative_scan; largest measured
# 4.8e-7.
ATOL_SCAN = 1e-5
# The recurrent mixer's output in fp32 (values up to ~0.6): largest
# measured 2.4e-7; its state 4.8e-7.
ATOL_MIXER = 1e-5
# bf16 logits (|logit| up to ~4.9): the scan's tree order moves the fp32
# h by rounding, which flips a bf16 rounding of the mixer's output now
# and then (the logits of the first 14 positions are equal); measured
# 0.0624, two bf16 steps of a logit at 4-8 through the softcap.
ATOL16_LOGITS = 0.09375
# bf16 caches: the ring's keys (bf16, |k| up to ~4) and the RG-LRU's fp32
# h and conv tail of a bf16 model: largest measured 0.0312 (two bf16
# steps at 2-4 of a conv input).
ATOL16_CACHE = 0.0625


def _rec_params(seed=0, w=128, d=128, k=4):
    """One recurrent mixer's parameters, numpy, gates made non-trivial."""
    cfg = dataclasses.replace(cfgs(ARCH)[0], rnn_width=w, d_model=d,
                              conv_kernel=k)
    p = jax.tree.map(np.asarray, ref_griffin._rec_mixer_params(
        jax.random.PRNGKey(seed), cfg, jnp.float32))
    for i, name in enumerate(("g_a", "b_a", "g_x", "b_x")):
        p[name] = normal(seed + 10 + i, (w,), 0.5)
    return p


def _torch(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


# --------------------------------------------------------------------------
# the RG-LRU
# --------------------------------------------------------------------------
def test_rglru_gates_match_reference():
    p = _rec_params()
    u = normal(1, (2, 40, 128))
    want = ref_griffin._rglru_gates(jnp.asarray(u), jax.tree.map(
        jnp.asarray, p))
    got = griffin._rglru_gates(torch.as_tensor(u), _torch(p))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np.asarray(w), atol=ATOL_SCAN,
                                   rtol=0)
    assert float(got[0].max()) <= 0.0              # log_a <= 0


@pytest.mark.parametrize("s,chunk,seeded", [
    (48, 16, False),        # S % chunk == 0, h0 = 0
    (40, 16, True),         # S % chunk != 0 (padded steps), a seeded h0
    (5, 16, True),          # one short chunk
    (33, 7, False),         # an odd chunk
])
def test_rglru_chunked_matches_reference(s, chunk, seeded):
    p = _rec_params()
    u = normal(2, (2, s, 128))
    h0 = normal(3, (2, 128)) if seeded else np.zeros((2, 128), np.float32)
    want_h, want_last = ref_griffin._rglru_chunked(
        jnp.asarray(u), jax.tree.map(jnp.asarray, p), chunk, jnp.asarray(h0))
    got_h, got_last = griffin._rglru_chunked(
        torch.as_tensor(u), _torch(p), chunk, torch.as_tensor(h0))
    assert tuple(got_h.shape) == (2, s, 128)
    np.testing.assert_allclose(np_(got_h), np.asarray(want_h),
                               atol=ATOL_SCAN, rtol=0)
    np.testing.assert_allclose(np_(got_last), np.asarray(want_last),
                               atol=ATOL_SCAN, rtol=0)
    # the recurrence step by step
    log_a, b = (np_(t) for t in griffin._rglru_gates(torch.as_tensor(u),
                                                     _torch(p)))
    h, seq = h0, []
    for t in range(s):
        h = np.exp(log_a[:, t]) * h + b[:, t]
        seq.append(h)
    np.testing.assert_allclose(np_(got_h), np.stack(seq, 1), atol=ATOL_SCAN,
                               rtol=0)


@pytest.mark.parametrize("path", ["no state", "prefill into a state",
                                  "decode"])
def test_rec_mixer_paths_match_reference(path):
    """_rec_mixer with no state (a forward), a 20-step prefill into a
    seeded state (h and conv tail) and a one-step decode from it."""
    rcfg, cfg = cfgs(ARCH)
    p = _rec_params(seed=4)
    s = 1 if path == "decode" else 20
    x = normal(5, (2, s, 128))
    state = None
    if path != "no state":
        state = {"h": normal(6, (2, 128)),
                 "conv": normal(7, (2, cfg.conv_kernel - 1, 128), 0.5)}
    want, want_state = ref_griffin._rec_mixer(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p), rcfg,
        None if state is None else jax.tree.map(jnp.asarray, state))
    got, got_state = griffin._rec_mixer(
        torch.as_tensor(x), _torch(p), cfg,
        None if state is None else _torch(state))
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL_MIXER,
                               rtol=0)
    if state is None:
        assert got_state is None and want_state is None
    else:
        for key in ("h", "conv"):
            assert got_state[key].dtype == torch.float32
            np.testing.assert_allclose(np_(got_state[key]),
                                       np.asarray(want_state[key]),
                                       atol=ATOL_MIXER, rtol=0)


def test_rnn_seq_parallel_raises():
    """``rnn_seq_parallel`` no longer raises: with no sharding context the
    single-device scan runs, as in the reference, bit-equal to the flag
    off (the sharded path: tests/test_torch_seq_parallel.py)."""
    _, cfg = cfgs(ARCH)
    model = port_params(ARCH, cfg)
    toks = {"tokens": torch.as_tensor(tokens(6, s=8))}
    with torch.no_grad():
        want, _, _ = api.forward(model, toks, cfg)
        got, _, _ = api.forward(model, toks, dataclasses.replace(
            cfg, rnn_seq_parallel=True))
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# parameters and caches
# --------------------------------------------------------------------------
def test_init_params_and_cache_layouts_match_reference():
    """5 smoke layers = 1 group of (rec, rec, attn) + a (rec, rec) tail;
    the full config's 38 = 12 groups + 2."""
    rcfg, cfg = cfgs(ARCH)
    assert griffin._pattern(cfg) == (("rec", "rec", "attn"), 1,
                                     ("rec", "rec"))
    from repro_torch.configs import get_config
    assert griffin._pattern(get_config(ARCH))[1:] == (12, ("rec", "rec"))
    mine = api.stacked_params(api.init_params(
        torch.Generator().manual_seed(0), cfg))
    ref = jax.eval_shape(lambda: ref_api.init_params(jax.random.PRNGKey(0),
                                                     rcfg))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, mine)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, ref))
    assert [tuple(t.shape) for t in jax.tree.leaves(mine)] == \
        [t.shape for t in jax.tree.leaves(ref)]
    rc = ref_api.init_cache(rcfg, 3, 20)
    c = api.init_cache(cfg, 3, 20, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, c)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, rc))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(c),
                            jax.tree.leaves(rc)):
        assert tuple(a.shape) == b.shape, path
        assert str(a.dtype).split(".")[-1] == str(b.dtype), path
        np.testing.assert_array_equal(np_(a), np.asarray(b, np.float32))
    # the ring is min(sliding_window, max_len) slots
    assert c["groups"]["b2"]["k"].shape[2] == 20
    assert api.init_cache(cfg, 1, 100, device="cpu")["groups"]["b2"][
        "k"].shape[2] == cfg.sliding_window == 32


def test_params_from_numpy_checks_depth():
    _, cfg = cfgs(ARCH)
    tree = jax.tree.map(np.asarray, ref_params(ARCH))
    model = params_from_numpy(tree, cfg, "cpu")
    assert isinstance(model, griffin.GriffinLM)
    got = flat(api.stacked_params(model))
    for key, want in flat(tree).items():
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    with pytest.raises(ValueError, match="tail"):
        params_from_numpy({k: v for k, v in tree.items() if k != "tail"},
                          cfg, "cpu")
    with pytest.raises(ValueError, match="groups"):
        params_from_numpy(tree, dataclasses.replace(cfg, num_layers=8),
                          "cpu")


# --------------------------------------------------------------------------
# the model whole
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_reference(dtype):
    check_forward_and_loss(ARCH, dtype, atol=(
        ATOL32 if dtype == "float32" else ATOL16_LOGITS))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    check_prefill_and_decode(ARCH, dtype, cache_atol=(
        ATOL32 if dtype == "float32" else ATOL16_CACHE))


def test_decode_matches_full_forward():
    check_decode_matches_full_forward(ARCH)


def test_prefill_past_the_ring_wrap():
    """A 48-token prefill into a 32-slot ring (the smoke window) keeps the
    last 32 keys; 4 decode steps wrap around it.  fp32, against the
    reference (logits and every cache leaf) and against the full forward,
    where the sliding window masks what the ring dropped."""
    rcfg, cfg = cfgs(ARCH)
    rp, model = ref_params(ARCH), port_params(ARCH, cfg)
    toks = tokens(8, s=52)
    rb, b = batch(cfg, toks[:, :48])
    rc = ref_api.init_cache(rcfg, 2, 64, dtype=jnp.float32)
    c = api.init_cache(cfg, 2, 64, dtype=torch.float32, device="cpu")
    assert c["groups"]["b2"]["k"].shape[2] == 32
    want, rc = jax.jit(lambda p, x, k: ref_api.prefill(p, x, rcfg, k))(
        rp, rb, rc)
    got, c = api.prefill(model, b, cfg, c)
    steps = [got]
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL32,
                               rtol=0)
    assert sorted(np_(c["groups"]["b2"]["pos"])[0, 0].astype(int)) == \
        list(range(16, 48))
    step = jax.jit(lambda p, t, k: ref_api.decode_step(p, t, rcfg, k))
    for t in range(48, 52):
        nxt = toks[:, t:t + 1]
        want, rc = step(rp, jnp.asarray(nxt), rc)
        got, c = api.decode_step(model, torch.as_tensor(nxt), cfg, c)
        steps.append(got)
        np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL32,
                                   rtol=0)
    got_leaves, want_leaves = flat(c), flat(rc)
    for key, w in want_leaves.items():
        np.testing.assert_allclose(got_leaves[key], w, atol=ATOL32, rtol=0,
                                   err_msg=key)
    with torch.no_grad():
        full, _, _ = api.forward(model, {"tokens": torch.as_tensor(toks)},
                                 cfg)
    torch.testing.assert_close(torch.stack(steps[:-1], 1), full[:, 47:51],
                               atol=ATOL32, rtol=0)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
def test_loss_and_gradient_match_reference():
    check_loss_and_gradient(ARCH)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_step_matches_reference(optimizer):
    check_train_step(ARCH, optimizer)

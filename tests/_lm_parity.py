"""Shared parts of the language-model parity tests
(tests/test_torch_transformer.py for the dense and vlm families,
tests/test_torch_moe.py for the moe family, tests/test_torch_griffin.py
for the hybrid family, tests/test_torch_encdec.py for the audio family):
inputs, the reference's seed-0 weights carried over to the port, and the
whole-model checks each file runs over its archs.

Inputs are numpy from a seed; weights are the reference's
``init_params(PRNGKey(0))`` carried over with ``params_from_numpy``.
bf16 runs are held against the reference compiled with XLA's excess
precision off, which rounds every op as torch does
(tests/test_torch_models.py).  Each tolerance is stated with the largest
error measured.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.train import init_state as ref_init_state
from repro.train import make_optimizer as ref_make_optimizer
from repro.train import make_train_step as ref_make_train_step
from repro.train.serve_step import decode_loop as ref_decode_loop
from repro_torch.configs import smoke_config
from repro_torch.models import api, layers
from repro_torch.models.convert import params_from_numpy, train_state_from_numpy
from repro_torch.train import make_optimizer, make_train_step
from repro_torch.train.serve_step import decode_loop

# fp32 logits of the smoke models (|logit| up to ~5.2): largest measured
# 5.1e-6; fp32 caches 3.8e-6; decode against the full forward 2.1e-6.
ATOL32 = 1e-4
# bf16 logits and caches against the reference rounded per op: two bf16
# steps of the largest logit (0.03125 each at 4-8); measured 0.0449
# (forward), 0.0342 (decode), 0.0391 (caches).
ATOL16 = 0.0625
# fp32 loss: measured 9.5e-7 (loss ~6.3); bf16 loss: measured 8.5e-4.
LOSS_ATOL32, LOSS_ATOL16 = 1e-5, 1e-2
# The MoE aux loss, relative: a mean of fp32 router probabilities, whose
# input rounds to bf16 in a bf16 model; measured 1.2e-7 in fp32, 2.4e-4
# in bf16.
AUX_RTOL32, AUX_RTOL16 = 1e-5, 1e-3


def np_(x):
    return x.detach().float().cpu().numpy()


def normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def tokens(seed, b=2, s=40, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def cfgs(arch, dtype="float32", **kw):
    """The reference's smoke config of ``arch`` and the port's, both with
    ``dtype`` and ``kw``."""
    return (dataclasses.replace(ref_smoke_config(arch), dtype=dtype, **kw),
            dataclasses.replace(smoke_config(arch), dtype=dtype, **kw))


_REF_PARAMS: dict = {}


def ref_params(arch):
    """The reference's seed-0 weights of ``arch``'s smoke config (fp32
    masters, whatever the compute dtype)."""
    if arch not in _REF_PARAMS:
        _REF_PARAMS[arch] = ref_api.init_params(jax.random.PRNGKey(0),
                                                ref_smoke_config(arch))
    return _REF_PARAMS[arch]


def port_params(arch, cfg):
    return params_from_numpy(jax.tree.map(np.asarray, ref_params(arch)),
                             cfg, "cpu")


def compiled(fn, *args):
    """``fn`` jitted for ``args``' shapes with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def rounded(fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off."""
    return compiled(fn, *args)(*args)


def batch(cfg, toks, seed=9):
    """The reference's batch and the port's: tokens and, for a vlm, a
    prefix of cfg.num_prefix_embeds embeddings, for audio as many source
    frames as tokens rounded up to whole blocks of keys
    (cfg.attn_block_kv), in the compute dtype.  (The reference's chunked
    bidirectional attention counts the zero padding of a ragged last
    block as keys, which the port masks: ROADMAP Queue 3.)"""
    ref = {"tokens": jnp.asarray(toks)}
    mine = {"tokens": torch.as_tensor(toks)}
    frames = -(-toks.shape[1] // cfg.attn_block_kv) * cfg.attn_block_kv
    extra = {"vlm": ("prefix_embeds", cfg.num_prefix_embeds),
             "audio": ("src_embeds", frames)}.get(cfg.family)
    if extra is not None:
        key, n = extra
        pe = normal(seed, (toks.shape[0], n, cfg.d_model), 0.02)
        dt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[cfg.dtype]
        ref[key] = jnp.asarray(pe).astype(dt)
        mine[key] = torch.as_tensor(pe).to(layers.as_dtype(cfg.dtype))
    return ref, mine


def src_len(b) -> int | None:
    """The source frames of an audio batch (the cache's cross K/V)."""
    return b["src_embeds"].shape[1] if "src_embeds" in b else None


def lens(tree, prefix=""):
    """Every ``len`` of a (port or reference) cache by path: ints."""
    out = {}
    for k in sorted(tree):
        if k == "len":
            out[prefix or "/"] = int(tree[k])
        elif isinstance(tree[k], dict):
            out.update(lens(tree[k], f"{prefix}/{k}"))
    return out


def check_lens(c, want):
    """Every ``len`` of the port's cache ``c`` equals ``want``, and so does
    ``written``, the host's count, where the cache keeps one."""
    got = lens(c)
    assert got and set(got.values()) == {want}, got
    if hasattr(c, "written"):
        assert c.written == want


def flat(tree, prefix=""):
    """The leaves of a (port or reference) cache by path, ``len`` left out:
    numpy arrays."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            if k != "len":
                out.update(flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: np_(tree)}
    return {prefix: np.asarray(tree, np.float32)}


def _tols(dtype):
    """(logits, loss, aux) tolerances of a run in ``dtype``."""
    return ((ATOL32, LOSS_ATOL32, AUX_RTOL32) if dtype == "float32"
            else (ATOL16, LOSS_ATOL16, AUX_RTOL16))


def check_forward_and_loss(arch, dtype, atol=None):
    """Logits, aux loss and loss_fn of one forward of 2 x 70 tokens (78
    with llava's prefix): S >= flash_min_seq = 64 takes the chunked
    attention path, with a ragged last block of keys.  The logits within
    ``atol``, the dtype's tolerance unless given."""
    rcfg, cfg = cfgs(arch, dtype)
    rp = ref_params(arch)
    toks = tokens(2, s=71)
    rb, b = batch(cfg, toks[:, :-1])
    rb["labels"] = jnp.asarray(toks[:, 1:])
    b["labels"] = torch.as_tensor(toks[:, 1:])
    want, waux = rounded(lambda p, x: ref_api.forward(p, x, rcfg)[:2],
                         rp, rb)
    wloss = rounded(lambda p, x: ref_api.loss_fn(p, x, rcfg)[0], rp, rb)
    model = port_params(arch, cfg)
    with torch.no_grad():
        got, aux, new_cache = api.forward(model, b, cfg)
        loss, metrics = api.loss_fn(model, b, cfg)
    assert new_cache is None and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    tol, loss_atol, aux_rtol = _tols(dtype)
    atol = tol if atol is None else atol
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=atol, rtol=0)
    np.testing.assert_allclose(float(aux), float(waux), rtol=aux_rtol)
    np.testing.assert_allclose(float(loss), float(wloss), atol=loss_atol)
    assert float(metrics["tokens"]) == 2 * 70


def check_prefill_and_decode(arch, dtype, cache_atol=None):
    """Prefill 24 tokens into a 40-position cache of the compute dtype
    (48 with llava's prefix; an encoder-decoder's cross K/V of its 24
    source frames); 3 decode steps fed the reference's greedy tokens,
    logits and caches against the reference's (every leaf within
    ``cache_atol``, the logits' tolerance unless given); then
    decode_loop's 8 greedy tokens from the prefilled cache."""
    rcfg, cfg = cfgs(arch, dtype)
    rp = ref_params(arch)
    model = port_params(arch, cfg)
    rb, b = batch(cfg, tokens(3, s=24))
    max_len = 40 + (cfg.num_prefix_embeds if cfg.family == "vlm" else 0)
    rdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    dt = layers.as_dtype(dtype)

    def ref_fresh():
        return ref_api.init_cache(rcfg, 2, max_len, dtype=rdt,
                                  src_len=src_len(b))

    def fresh():
        return api.init_cache(cfg, 2, max_len, dtype=dt, device="cpu",
                              src_len=src_len(b))

    ref_prefill = compiled(lambda p, x, k: ref_api.prefill(p, x, rcfg, k),
                           rp, rb, ref_fresh())
    want, rc = ref_prefill(rp, rb, ref_fresh())
    got, c = api.prefill(model, b, cfg, fresh())
    atol = _tols(dtype)[0]
    cache_atol = atol if cache_atol is None else cache_atol
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=atol, rtol=0)
    step = compiled(lambda p, t, k: ref_api.decode_step(p, t, rcfg, k),
                    rp, jnp.zeros((2, 1), jnp.int32), rc)
    for _ in range(3):
        assert lens(c) == lens(rc)             # every segment's len
        check_lens(c, next(iter(lens(rc).values())))
        got_leaves, want_leaves = flat(c), flat(rc)
        assert sorted(got_leaves) == sorted(want_leaves)
        for key, w in want_leaves.items():
            np.testing.assert_allclose(got_leaves[key], w, atol=cache_atol,
                                       rtol=0, err_msg=key)
        for key in ("k", "v"):                 # KV caches in the cache dtype
            for seg in (c, *(v for v in c.values() if isinstance(v, dict))):
                if key in seg and "h" not in seg:
                    assert seg[key].dtype == dt
        nxt = np.argmax(np.asarray(want), -1).astype(np.int32)[:, None]
        want, rc = step(rp, jnp.asarray(nxt), rc)
        got, c = api.decode_step(model, torch.as_tensor(nxt), cfg, c)
        np.testing.assert_allclose(np_(got), np.asarray(want), atol=atol,
                                   rtol=0)
    # decode_loop's greedy tokens from a prefilled cache, both sides
    logits, start = api.prefill(model, b, cfg, fresh())
    first = torch.argmax(logits, -1).to(torch.int32)
    _, rc0 = ref_prefill(rp, rb, ref_fresh())
    want_toks, _ = rounded(lambda p, f, k: ref_decode_loop(p, f, k, rcfg, 8),
                           rp, jnp.asarray(np_(first).astype(np.int32)), rc0)
    got_toks, end = decode_loop(model, first, start, cfg, 8)
    assert got_toks.dtype == torch.int32
    n = next(iter(lens(start).values()))
    check_lens(start, n)
    check_lens(end, n + 8)
    if hasattr(end, "written"):
        assert end.written == start.written + 8
    np.testing.assert_array_equal(np_(got_toks), np.asarray(want_toks))


def check_decode_matches_full_forward(arch, prompt=16):
    """Prefill ``prompt`` tokens + 3 decode steps through an fp32 cache ==
    the full forward's logits at those 4 positions (fp32; a capacity
    factor of 8 keeps the MoE from dropping, as the reference's own test
    does; an encoder-decoder's source has ``prompt`` frames in both)."""
    _, cfg = cfgs(arch, capacity_factor=8.0)
    model = port_params(arch, cfg)
    toks = tokens(4, s=prompt + 3)
    _, b = batch(cfg, toks[:, :prompt])
    c = api.init_cache(cfg, 2, 64, dtype=torch.float32, device="cpu",
                       src_len=src_len(b))
    lg, c = api.prefill(model, b, cfg, c)
    steps = [lg]
    for t in range(prompt, prompt + 3):
        lg, c = api.decode_step(model, torch.as_tensor(toks[:, t:t + 1]),
                                cfg, c)
        steps.append(lg)
    with torch.no_grad():
        full, _, _ = api.forward(model, {**b, "tokens": torch.as_tensor(
            toks)}, cfg)
    # The reference's own test allows 0.02; measured here: 2.1e-6.
    torch.testing.assert_close(torch.stack(steps, 1), full[:, -4:],
                               atol=ATOL32, rtol=0)


# --------------------------------------------------------------------------
# training (tests/test_torch_train_families.py, and the hybrid and audio
# families' files)
# --------------------------------------------------------------------------
# The loss (relative; largest measured 1.3e-7, loss ~7.6-8.5) and each
# gradient against jax.value_and_grad, relative to the leaf's largest
# magnitude (largest measured 3.3e-6, Griffin's: its scan sums in another
# tree order).
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-4
# One train step: loss and grad norm relative (largest measured 3.0e-7);
# parameters absolute, each moving by at most LR (largest measured
# 1.3e-5); moments relative to each leaf's largest (largest measured
# 9.5e-6).  AdamW's first step moves a parameter by LR * g / (|g| + eps):
# where |g| is within a few eps = 1e-8 of 0 (here |mu| = 0.1 |g| <
# NEAR_ZERO_MU) a rounding-level difference of g moves it anywhere in its
# range, 2 LR (largest measured 6.9e-5, in Griffin's GeGLU weights, where
# gradients cancel to 1e-10-1e-9 and differ in sign between packages).
STEP_RTOL = 1e-5
PARAM_ATOL = 5e-5
MOMENT_RTOL = 5e-5
LR = 1e-3
NEAR_ZERO_MU = 1e-7


def rel(got, want):
    """The largest difference over ``want``'s largest magnitude."""
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def train_batch(cfg, seed, b=2, s=24):
    """The reference's batch and the port's: a family batch of ``s``
    tokens with shifted labels."""
    toks = tokens(seed, b=b, s=s + 1)
    rb, mine = batch(cfg, toks[:, :-1], seed=seed + 100)
    rb["labels"] = jnp.asarray(toks[:, 1:])
    mine["labels"] = torch.as_tensor(toks[:, 1:])
    return rb, mine


def state_leaves(tree):
    """Every leaf of a (port or reference) train state by path, numpy."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update({f"/{k}{p}": v for p, v in
                        state_leaves(tree[k]).items()})
        return out
    if isinstance(tree, torch.Tensor):
        return {"": tree.detach().float().cpu().numpy()}
    return {"": np.asarray(tree, np.float32)}


def check_loss_and_gradient(arch, **kw):
    """loss_fn and its gradient of 2 x 24 tokens (and the family's
    extras) in fp32, against jax.value_and_grad of the reference's; both
    configs with ``kw`` (e.g. a ``remat`` setting)."""
    rcfg, cfg = cfgs(arch, **kw)
    rp = ref_params(arch)
    rb, b = train_batch(cfg, 1)
    (want, ref_m), ref_g = jax.jit(jax.value_and_grad(
        lambda p, x: ref_api.loss_fn(p, x, rcfg), has_aux=True))(rp, rb)
    model = port_params(arch, cfg)
    got, metrics = api.loss_fn(model, b, cfg)
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    assert float(metrics["tokens"]) == float(ref_m["tokens"]) == 2 * 24
    np.testing.assert_allclose(float(metrics["aux_loss"].detach()),
                               float(ref_m["aux_loss"]), rtol=1e-5)
    grads = state_leaves(model.grad_tree())
    want_g = state_leaves(jax.tree.map(np.asarray, ref_g))
    assert sorted(grads) == sorted(want_g)
    for key, w in want_g.items():
        assert np.all(np.isfinite(grads[key])), key
        if np.any(w):
            assert rel(grads[key], w) <= GRAD_RTOL, key
        else:
            assert not np.any(grads[key]), key


def check_train_step(arch, optimizer, **kw):
    """One train step (``optimizer``, lr LR after a 2-step warmup) from
    the reference's seed-0 train state, in fp32: metrics, parameters and
    moments against the reference's step; every parameter moved.  Both
    configs with ``kw`` (e.g. a ``remat`` setting)."""
    rcfg, cfg = cfgs(arch, optimizer=optimizer, **kw)
    ref_opt = ref_make_optimizer(rcfg, peak_lr=LR, warmup=2, total_steps=40)
    opt = make_optimizer(cfg, peak_lr=LR, warmup=2, total_steps=40)
    ref_state = ref_init_state(jax.random.PRNGKey(0), rcfg, ref_opt)
    state = train_state_from_numpy(jax.tree.map(np.asarray, ref_state), cfg,
                                   "cpu")
    rb, b = train_batch(cfg, 3)
    ref_new, ref_m = jax.jit(ref_make_train_step(rcfg, ref_opt))(ref_state,
                                                                 rb)
    new, metrics = make_train_step(cfg, opt)(state, b)
    for k in ("loss", "grad_norm", "loss_total"):
        assert abs(float(metrics[k]) - float(ref_m[k])) <= STEP_RTOL * abs(
            float(ref_m[k])), k
    assert int(new["step"]) == int(ref_new["step"]) == 1
    got = state_leaves(new)
    want = state_leaves(jax.tree.map(np.asarray, ref_new))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if key.startswith("/params"):
            tol = np.full(w.shape, PARAM_ATOL)
            mu = want.get(key.replace("/params", "/opt/mu", 1))
            if mu is not None:
                tol[np.abs(mu) < NEAR_ZERO_MU] = 2 * LR
            assert np.all(np.abs(got[key] - w) <= tol), key
        elif key != "/step":
            assert rel(got[key], w) <= MOMENT_RTOL, key
    # every parameter moved
    before = state_leaves(jax.tree.map(np.asarray, ref_state["params"]))
    for key, leaf in state_leaves(new["params"]).items():
        assert not np.array_equal(leaf, before[key]), key

"""Shared parts of the decoder-transformer parity tests
(tests/test_torch_transformer.py for the dense and vlm families,
tests/test_torch_moe.py for the moe family): inputs, the reference's
seed-0 weights carried over to the port, and the whole-model checks each
file runs over its archs.

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
from repro.train.serve_step import decode_loop as ref_decode_loop
from repro_torch.configs import smoke_config
from repro_torch.models import api, layers
from repro_torch.models.convert import params_from_numpy
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
    prefix of cfg.num_prefix_embeds embeddings in the compute dtype."""
    ref = {"tokens": jnp.asarray(toks)}
    mine = {"tokens": torch.as_tensor(toks)}
    if cfg.family == "vlm":
        pe = normal(seed, (toks.shape[0], cfg.num_prefix_embeds,
                           cfg.d_model), 0.02)
        dt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[cfg.dtype]
        ref["prefix_embeds"] = jnp.asarray(pe).astype(dt)
        mine["prefix_embeds"] = torch.as_tensor(pe).to(
            layers.as_dtype(cfg.dtype))
    return ref, mine


def _tols(dtype):
    """(logits, loss, aux) tolerances of a run in ``dtype``."""
    return ((ATOL32, LOSS_ATOL32, AUX_RTOL32) if dtype == "float32"
            else (ATOL16, LOSS_ATOL16, AUX_RTOL16))


def check_forward_and_loss(arch, dtype):
    """Logits, aux loss and loss_fn of one forward of 2 x 70 tokens (78
    with llava's prefix): S >= flash_min_seq = 64 takes the chunked
    attention path, with a ragged last block of keys."""
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
    atol, loss_atol, aux_rtol = _tols(dtype)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=atol, rtol=0)
    np.testing.assert_allclose(float(aux), float(waux), rtol=aux_rtol)
    np.testing.assert_allclose(float(loss), float(wloss), atol=loss_atol)
    assert float(metrics["tokens"]) == 2 * 70


def check_prefill_and_decode(arch, dtype):
    """Prefill 24 tokens into a 40-position cache of the compute dtype
    (48 with llava's prefix); 3 decode steps fed the reference's greedy
    tokens, logits and caches against the reference's; then decode_loop's
    8 greedy tokens from the prefilled cache."""
    rcfg, cfg = cfgs(arch, dtype)
    rp = ref_params(arch)
    model = port_params(arch, cfg)
    rb, b = batch(cfg, tokens(3, s=24))
    max_len = 40 + (cfg.num_prefix_embeds if cfg.family == "vlm" else 0)
    rdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    dt = layers.as_dtype(dtype)

    def ref_fresh():
        return ref_api.init_cache(rcfg, 2, max_len, dtype=rdt)

    def fresh():
        return api.init_cache(cfg, 2, max_len, dtype=dt, device="cpu")

    ref_prefill = compiled(lambda p, x, k: ref_api.prefill(p, x, rcfg, k),
                           rp, rb, ref_fresh())
    want, rc = ref_prefill(rp, rb, ref_fresh())
    got, c = api.prefill(model, b, cfg, fresh())
    atol = _tols(dtype)[0]
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=atol, rtol=0)
    step = compiled(lambda p, t, k: ref_api.decode_step(p, t, rcfg, k),
                    rp, jnp.zeros((2, 1), jnp.int32), rc)
    for _ in range(3):
        for seg in rc:
            assert int(c[seg]["len"]) == int(rc[seg]["len"]) == c.written
            for key in ("k", "v"):
                assert c[seg][key].dtype == dt
                np.testing.assert_allclose(
                    np_(c[seg][key]), np.asarray(rc[seg][key], np.float32),
                    atol=atol, rtol=0)
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
    assert got_toks.dtype == torch.int32 and end.written == start.written + 8
    np.testing.assert_array_equal(np_(got_toks), np.asarray(want_toks))


def check_decode_matches_full_forward(arch):
    """Prefill 16 tokens + 3 decode steps through an fp32 cache == the
    full forward's logits at those 4 positions (fp32; a capacity factor of
    8 keeps the MoE from dropping, as the reference's own test does)."""
    _, cfg = cfgs(arch, capacity_factor=8.0)
    model = port_params(arch, cfg)
    toks = tokens(4, s=19)
    _, b = batch(cfg, toks[:, :16])
    c = api.init_cache(cfg, 2, 64, dtype=torch.float32, device="cpu")
    lg, c = api.prefill(model, b, cfg, c)
    steps = [lg]
    for t in range(16, 19):
        lg, c = api.decode_step(model, torch.as_tensor(toks[:, t:t + 1]),
                                cfg, c)
        steps.append(lg)
    with torch.no_grad():
        full, _, _ = api.forward(model, {**b, "tokens": torch.as_tensor(
            toks)}, cfg)
    # The reference's own test allows 0.02; measured here: 2.1e-6.
    torch.testing.assert_close(torch.stack(steps, 1), full[:, -4:],
                               atol=ATOL32, rtol=0)

"""repro_torch's decoder transformer held against the JAX reference: the
layers, the caches, and the dense and vlm families whole.

The layers one by one: RoPE, dense and chunked attention (a fully masked
row, a ragged last block of keys), the attention block with no cache, a
KV cache and a ring cache, cross-attention, the MLPs, LayerNorm and the
softcap; ``ring_update`` across the wrap; the parameter and cache
layouts.  Then the five dense and vlm smoke configs whole (the moe ones
are in tests/test_torch_moe.py): forward and loss in fp32 and bf16,
prefill and decode against the reference, decode against the full
forward, the vlm prefix, and a cache overrun.  Inputs, weights and
tolerances: tests/_lm_parity.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (
    ATOL32, batch, cfgs, check_decode_matches_full_forward,
    check_forward_and_loss, check_prefill_and_decode, normal, np_,
    port_params, ref_params, tokens,
)
from repro.models import api as ref_api
from repro.models import cache as ref_cache
from repro.models import layers as ref_layers
from repro.train.serve_step import decode_loop as ref_decode_loop
from repro_torch.models import api, cache, layers
from repro_torch.models.convert import kv_cache_from_numpy
from repro_torch.train.serve_step import decode_loop

torch.set_num_threads(1)

ARCHS = ("qwen2-1.5b", "qwen2.5-3b", "qwen3-4b", "llama3-8b",
         "llava-next-mistral-7b")
# Layer outputs in fp32: largest measured 3.8e-6 (the softcap of logits
# up to ~150), 2.6e-6 elsewhere (values up to ~5).
ATOL_LAYER = 2e-5


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("pos_shape", ["(S,)", "(B, S)"])
def test_apply_rope_matches_reference(pos_shape):
    x = normal(1, (2, 24, 4, 32))
    pos = np.random.default_rng(2).integers(0, 40000, (2, 24)).astype(
        np.int32)
    if pos_shape == "(S,)":
        pos = pos[0]
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6)
    # angles up to 4e4 rad: measured 2.4e-7 (|x| up to 4.4)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL_LAYER)
    small = np.arange(24, dtype=np.int32)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(small), 1e4)
    got = layers.apply_rope(torch.as_tensor(x), torch.as_tensor(small), 1e4)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL_LAYER)


def _qkv(seed, b=2, sq=37, skv=37, hq=8, hkv=2, d=16):
    return (normal(seed, (b, sq, hq, d)), normal(seed + 1, (b, skv, hkv, d)),
            normal(seed + 2, (b, skv, hkv, d)))


def _positions(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32)[None],
                           (b, s)).copy()


# (causal, sliding_window, kv_valid_len): kv_valid_len [0, 29] leaves every
# row of batch 0 fully masked.
MASKS = {
    "causal": (True, None, None),
    "sliding": (True, 9, None),
    "valid_len": (True, None, [0, 29]),
    "bidirectional": (False, None, None),
}


def _both(fn_ref, fn, arrays, **kw):
    ref_kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in kw.items()}
    mine_kw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
    want = fn_ref(*map(jnp.asarray, arrays), **ref_kw)
    got = fn(*map(torch.as_tensor, arrays), **mine_kw)
    return np.asarray(want), np_(got)


@pytest.mark.parametrize("mask", list(MASKS))
def test_attention_matches_reference(mask):
    causal, window, valid = MASKS[mask]
    q, k, v = _qkv(3)
    kw = dict(positions_q=_positions(2, 37), positions_kv=_positions(2, 37),
              causal=causal, sliding_window=window)
    if valid is not None:
        kw["kv_valid_len"] = np.asarray(valid, np.int32)
    want, got = _both(ref_layers.attention, layers.attention, (q, k, v), **kw)
    np.testing.assert_allclose(got, want, atol=ATOL_LAYER)


@pytest.mark.parametrize("skv,block_kv,mask", [
    (37, 16, "causal"),          # ragged: 37 % 16 = 5 padded keys
    (64, 32, "sliding"),
    (45, 8, "valid_len"),        # a fully masked row: zeros
])
def test_attention_chunked_matches_reference(skv, block_kv, mask):
    causal, window, valid = MASKS[mask]
    q, k, v = _qkv(4, sq=skv, skv=skv)
    kw = dict(positions_q=_positions(2, skv), positions_kv=_positions(2, skv),
              causal=causal, sliding_window=window, block_kv=block_kv)
    if valid is not None:
        kw["kv_valid_len"] = np.asarray(valid, np.int32)
    want, got = _both(ref_layers.attention_chunked, layers.attention_chunked,
                      (q, k, v), **kw)
    np.testing.assert_allclose(got, want, atol=ATOL_LAYER)
    if valid is not None:
        assert not got[0].any()               # every row of batch 0 masked
    kw.pop("block_kv")
    dense = np_(layers.attention(*map(torch.as_tensor, (q, k, v)), **{
        k_: torch.as_tensor(v_) if isinstance(v_, np.ndarray) else v_
        for k_, v_ in kw.items()}))
    rows = slice(1, None) if valid is not None else slice(None)
    np.testing.assert_allclose(got[rows], dense[rows], atol=ATOL_LAYER)


def _attn_cfgs(**kw):
    base = dict(qkv_bias=True, qk_norm=True, flash_min_seq=24,
                attn_block_kv=8, **kw)
    return cfgs("qwen2-1.5b", **base)


def _attn_params(rcfg):
    p = ref_layers.attention_params(jax.random.PRNGKey(5), rcfg)
    # the biases and q/k norms are zeros at init: make them count
    r = np.random.default_rng(6)
    p = {k: (jnp.asarray(r.standard_normal(v.shape).astype(np.float32) * 0.1)
             if k in ("bq", "bk", "bv", "q_norm", "k_norm") else v)
         for k, v in p.items()}
    return p, {k: torch.as_tensor(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("s", [12, 30])      # dense / chunked attention
def test_attention_block_without_cache_matches_reference(s):
    rcfg, cfg = _attn_cfgs()
    rp, p = _attn_params(rcfg)
    x = normal(7, (2, s, 128))
    pos = _positions(2, s)
    want, _ = jax.jit(lambda x_, p_, pos_: ref_layers.attention_block(
        x_, p_, rcfg, positions=pos_))(jnp.asarray(x), rp, jnp.asarray(pos))
    got, c = layers.attention_block(torch.as_tensor(x), p, cfg,
                                    positions=torch.as_tensor(pos))
    assert c is None
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL_LAYER)


def test_attention_block_with_kv_cache_matches_reference():
    """Prefill 26 steps into a 40-slot cache (the chunked path: 40 >= 24),
    then decode 3 steps; the cache's k, v and len follow the reference."""
    rcfg, cfg = _attn_cfgs()
    rp, p = _attn_params(rcfg)
    rc = ref_cache.kv_cache(1, 2, 40, 2, 32, jnp.float32)
    rc = {"k": rc["k"][0], "v": rc["v"][0], "len": rc["len"]}
    c = {"k": torch.zeros((2, 40, 2, 32)), "v": torch.zeros((2, 40, 2, 32)),
         "len": torch.zeros((), dtype=torch.int32)}
    ref_block = jax.jit(lambda x_, p_, pos_, c_: ref_layers.attention_block(
        x_, p_, rcfg, positions=pos_, cache=c_))
    for step, s in enumerate((26, 1, 1, 1)):
        x = normal(10 + step, (2, s, 128))
        pos = _positions(2, s, int(rc["len"]))
        want, rc = ref_block(jnp.asarray(x), rp, jnp.asarray(pos), rc)
        got, c = layers.attention_block(
            torch.as_tensor(x), p, cfg, positions=torch.as_tensor(pos),
            cache=c)
        np.testing.assert_allclose(np_(got), np.asarray(want),
                                   atol=ATOL_LAYER)
        for key in ("k", "v"):
            np.testing.assert_allclose(np_(c[key]), np.asarray(rc[key]),
                                       atol=ATOL_LAYER)
        assert int(c["len"]) == int(rc["len"])


def test_attention_block_with_ring_cache_matches_reference():
    """A 16-slot ring (sliding window 16): a 20-step prefill keeps the
    last 16 keys, then decode steps wrap around the ring."""
    rcfg, cfg = _attn_cfgs(sliding_window=16)
    rp, p = _attn_params(rcfg)
    rc = ref_cache.ring_kv_cache(1, 2, 16, 2, 32, jnp.float32)
    rc = {k: (v[0] if k != "len" else v) for k, v in rc.items()}
    c = {k: torch.as_tensor(np.array(v)) for k, v in rc.items()}
    ref_block = jax.jit(lambda x_, p_, pos_, c_: ref_layers.attention_block(
        x_, p_, rcfg, positions=pos_, sliding_window=16, cache=c_))
    for step, s in enumerate((20, 1, 1, 1, 1)):
        x = normal(20 + step, (2, s, 128))
        pos = _positions(2, s, int(rc["len"]))
        want, rc = ref_block(jnp.asarray(x), rp, jnp.asarray(pos), rc)
        got, c = layers.attention_block(
            torch.as_tensor(x), p, cfg, positions=torch.as_tensor(pos),
            sliding_window=16, cache=c)
        np.testing.assert_allclose(np_(got), np.asarray(want),
                                   atol=ATOL_LAYER)
        np.testing.assert_array_equal(np_(c["pos"]), np.asarray(rc["pos"]))
        np.testing.assert_allclose(np_(c["k"]), np.asarray(rc["k"]),
                                   atol=ATOL_LAYER)
        assert int(c["len"]) == int(rc["len"])


def test_ring_update_across_the_wrap():
    rc = ref_cache.ring_kv_cache(1, 2, 8, 1, 4, jnp.float32)
    rc = {k: v[0] for k, v in rc.items() if k != "len"}
    c = {k: torch.as_tensor(np.array(v)) for k, v in rc.items()}
    assert int(c["pos"].min()) == cache.EMPTY_SLOT == ref_cache.EMPTY_SLOT
    for start, s in ((0, 5), (5, 6), (11, 8)):      # 5..10 and 11..18 wrap
        k, v = normal(start, (2, s, 1, 4)), normal(start + 50, (2, s, 1, 4))
        rc = ref_cache.ring_update(rc, jnp.asarray(k), jnp.asarray(v),
                                   jnp.int32(start))
        c = cache.ring_update(c, torch.as_tensor(k), torch.as_tensor(v),
                              torch.tensor(start, dtype=torch.int32))
        for key in ("k", "v", "pos"):
            np.testing.assert_array_equal(np_(c[key]), np.asarray(rc[key]))
    assert sorted(np_(c["pos"])[0].astype(int)) == list(range(11, 19))


def test_cross_attention_block_and_mlps_match_reference():
    """Cross-attention (no rope, no causal mask) over a memory of another
    length, LayerNorm, SwiGLU, GeGLU and the logit softcap."""
    rcfg, cfg = _attn_cfgs()
    rp, p = _attn_params(rcfg)
    x, mem = normal(30, (2, 9, 128)), normal(31, (2, 14, 128))
    want, _ = ref_layers.attention_block(
        jnp.asarray(x), rp, rcfg, positions=jnp.asarray(_positions(2, 9)),
        kv_source=jnp.asarray(mem))
    got, _ = layers.attention_block(
        torch.as_tensor(x), p, cfg, positions=torch.as_tensor(
            _positions(2, 9)), kv_source=torch.as_tensor(mem))
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL_LAYER)
    rmlp = ref_layers.mlp_params(jax.random.PRNGKey(8), 128, 256)
    mlp = {k: torch.as_tensor(np.array(v)) for k, v in rmlp.items()}
    for ref_fn, fn in ((ref_layers.swiglu, layers.swiglu),
                       (ref_layers.geglu, layers.geglu)):
        np.testing.assert_allclose(
            np_(fn(torch.as_tensor(x), mlp)),
            np.asarray(ref_fn(jnp.asarray(x), rmlp)), atol=ATOL_LAYER)
    scale, bias = normal(32, (128,), 0.1), normal(33, (128,), 0.1)
    np.testing.assert_allclose(
        np_(layers.layer_norm(torch.as_tensor(x), torch.as_tensor(scale),
                              torch.as_tensor(bias))),
        np.asarray(ref_layers.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                         jnp.asarray(bias))),
        atol=ATOL_LAYER)
    logits = normal(34, (2, 5, 7), 40.0)
    for cap in (0.0, 30.0):
        np.testing.assert_allclose(
            np_(layers.softcap(torch.as_tensor(logits), cap)),
            np.asarray(ref_layers.softcap(jnp.asarray(logits), cap)),
            atol=ATOL_LAYER)


# --------------------------------------------------------------------------
# parameters and caches
# --------------------------------------------------------------------------
def test_init_params_and_cache_layouts_match_reference():
    for arch in ("llama4-scout-17b-a16e", "qwen2-1.5b"):
        rcfg, cfg = cfgs(arch)
        mine = api.stacked_params(api.init_params(
            torch.Generator().manual_seed(0), cfg))
        ref = jax.eval_shape(lambda: ref_api.init_params(
            jax.random.PRNGKey(0), rcfg))
        assert jax.tree.structure(jax.tree.map(lambda t: 0, mine)) == \
            jax.tree.structure(jax.tree.map(lambda t: 0, ref))
        assert [tuple(t.shape) for t in jax.tree.leaves(mine)] == \
            [t.shape for t in jax.tree.leaves(ref)]
        rc = ref_api.init_cache(rcfg, 3, 20)
        c = api.init_cache(cfg, 3, 20, device="cpu")
        assert isinstance(c, cache.KVCache) and c.written == 0
        assert jax.tree.structure(jax.tree.map(lambda t: 0, dict(c))) == \
            jax.tree.structure(jax.tree.map(lambda t: 0, rc))
        for seg in rc:
            for key in ("k", "v"):
                assert tuple(c[seg][key].shape) == rc[seg][key].shape
                assert c[seg][key].dtype == torch.bfloat16
            assert c[seg]["len"].dtype == torch.int32
        assert cache.cache_bytes(c) == ref_cache.cache_bytes(rc)
    rc = jax.tree.map(np.array, rc)
    rc["seg0"]["k"][..., 0] = 0.5
    rc["seg0"]["len"] = np.int32(7)
    c = kv_cache_from_numpy(rc, "cpu")
    assert c.written == 7 and int(c["seg0"]["len"]) == 7
    assert c["seg0"]["k"].dtype == torch.bfloat16
    assert float(c["seg0"]["k"][..., 0].min()) == 0.5


# --------------------------------------------------------------------------
# the models whole
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


def test_vlm_prefix_prefill_and_decode_match_reference():
    """llava's smoke config in fp32, the cache sized for its 8-embedding
    prefix, the prompt and 16 greedy tokens: the reference and the port
    agree on every token when neither cache overruns."""
    arch = "llava-next-mistral-7b"
    rcfg, cfg = cfgs(arch)
    rp, model = ref_params(arch), port_params(arch, cfg)
    rb, b = batch(cfg, tokens(5, s=32))
    rc = ref_api.init_cache(rcfg, 2, 8 + 32 + 16)
    c = api.init_cache(cfg, 2, 8 + 32 + 16, device="cpu")
    want, rc = jax.jit(lambda p, x, k: ref_api.prefill(p, x, rcfg, k))(
        rp, rb, rc)
    got, c = api.prefill(model, b, cfg, c)
    assert c.written == 40 and int(c["seg0"]["len"]) == int(rc["seg0"]["len"])
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL32)
    first = jnp.argmax(want, -1).astype(jnp.int32)
    want_toks, _ = jax.jit(lambda p, f, k: ref_decode_loop(p, f, k, rcfg,
                                                           16))(rp, first, rc)
    got_toks, c = decode_loop(model, torch.as_tensor(np.asarray(first)), c,
                              cfg, 16)
    np.testing.assert_array_equal(np_(got_toks), np.asarray(want_toks))
    assert c.written == c.max_len == 56


def test_cache_overrun_raises_before_any_launch():
    """A vlm prefill whose prefix and prompt pass the cache's end raises
    ValueError and writes nothing; so does a decode step past it.  The
    reference clamps such writes instead: llava's smoke config in fp32,
    B = 2, prompt 32, gen 16, prefix 8, its cache sized prompt + gen (its
    launcher's sizing) gives greedy tokens that part from those of a
    prefix + prompt + gen cache at the step where ``len`` passes 48."""
    arch = "llava-next-mistral-7b"
    rcfg, cfg = cfgs(arch)
    model = port_params(arch, cfg)
    rb, b = batch(cfg, tokens(6, s=32))
    rp = ref_params(arch)

    def ref_tokens(max_len):
        logits, rc = ref_api.prefill(rp, rb, rcfg, ref_api.init_cache(
            rcfg, 2, max_len))
        first = jnp.argmax(logits, -1).astype(jnp.int32)
        return ref_decode_loop(rp, first, rc, rcfg, 16)[0]

    clamped, sized = map(np.asarray, jax.jit(lambda: (
        ref_tokens(32 + 16), ref_tokens(8 + 32 + 16)))())
    # token j is written at position 40 + j: from j = 8 on, the clamped
    # cache's writes land on slot 47 (here the tokens part at j = 10)
    parted = np.flatnonzero((clamped != sized).any(0))
    assert parted.size and parted[0] >= 48 - 40
    logits, c = api.prefill(model, b, cfg, api.init_cache(cfg, 2, 32 + 16,
                                                          device="cpu"))
    with pytest.raises(ValueError, match="overrun"):      # at token 8
        decode_loop(model, logits.argmax(-1).to(torch.int32), c, cfg, 16)
    c = api.init_cache(cfg, 2, 32 + 4, device="cpu")    # no room for 8
    before = c["seg0"]["k"].clone()
    with pytest.raises(ValueError, match="overrun"):
        api.prefill(model, b, cfg, c)
    assert torch.equal(c["seg0"]["k"], before) and c.written == 0
    assert int(c["seg0"]["len"]) == 0
    c = api.init_cache(cfg, 2, 8 + 32 + 2, device="cpu")
    logits, c = api.prefill(model, b, cfg, c)
    toks, c = decode_loop(model, logits.argmax(-1).to(torch.int32), c, cfg,
                          2)
    assert c.written == c.max_len
    with pytest.raises(ValueError, match="overrun"):
        api.decode_step(model, toks[:, -1:], cfg, c)
    with pytest.raises(TypeError, match="KVCache"):
        api.decode_step(model, toks[:, -1:], cfg, dict(c))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama4-scout-17b-a16e"])
def test_serve_lm_torch_example_runs_on_the_cpu(arch, capsys):
    """examples/serve_lm_torch.py, the twin of examples/serve_lm.py, on the
    smoke config: greedy tokens of the padded vocabulary, seeded."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).parents[1] / "examples" / \
        "serve_lm_torch.py"
    spec = importlib.util.spec_from_file_location("serve_lm_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    argv = ["--arch", arch, "--device", "cpu", "--batch", "2",
            "--prompt-len", "12", "--gen", "3"]
    toks = example.main(argv)
    assert tuple(toks.shape) == (2, 3) and toks.dtype == torch.int32
    cfg = cfgs(arch)[1]
    assert 0 <= int(toks.min()) and int(toks.max()) < cfg.padded_vocab
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out and "decode:" in out
    assert torch.equal(example.main(argv), toks)

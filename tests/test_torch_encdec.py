"""repro_torch's encoder-decoder (the audio family, seamless-m4t-large-v2)
held against the JAX reference: the encoder, the cross-attention (dense
and chunked), the parameter and cache layouts, and the smoke config whole
(forward and loss in fp32 and bf16, prefill and decode against the
reference, decode against the full forward), the self-attention cache's
overrun and the serving request.  Inputs, weights and whole-model
tolerances: tests/_lm_parity.py.  Each other tolerance is stated with the
largest error measured here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (
    batch, cfgs, check_decode_matches_full_forward, check_forward_and_loss,
    check_loss_and_gradient, check_prefill_and_decode, check_train_step,
    normal, np_, port_params, ref_params, tokens,
)
from repro.models import api as ref_api
from repro.models import encdec as ref_encdec
from repro.models import layers as ref_layers
from repro_torch.launch import serve
from repro_torch.models import api, cache, encdec, layers
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"
# The encoder's memory and a cross-attention's output in fp32 (values up
# to ~4.3): largest measured 3.0e-6 (the encoder), 1.1e-6 (cross K and
# the cross-attention, dense and chunked), 2.1e-6 (chunked against dense
# bidirectional attention).
ATOL_LAYER = 2e-5


def _cast(cfg):
    """The reference's seed-0 weights, cast to the compute dtype, in both
    packages' trees."""
    rp = ref_layers.cast_params(ref_params(ARCH), jnp.float32)
    p = layers.cast_params(port_params(ARCH, cfg).param_tree(),
                           torch.float32)
    return rp, p


def test_encode_matches_reference():
    """The bidirectional encoder over 96 frames (S >= flash_min_seq = 64:
    the chunked attention path, three whole blocks of 32 keys)."""
    rcfg, cfg = cfgs(ARCH)
    rp, p = _cast(cfg)
    src = normal(1, (2, 96, 128), 0.02)
    want = ref_encdec.encode(rp, jnp.asarray(src), rcfg)
    got = encdec.encode(p, torch.as_tensor(src), cfg)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL_LAYER,
                               rtol=0)


def test_bidirectional_chunked_attention_masks_padded_keys():
    """70 keys in blocks of 32 leave 26 padded keys in the last block.
    The port's chunked bidirectional attention masks them, so it equals
    dense attention, and so does the encoder over 70 frames with its
    chunked path against the same encoder kept dense.  The reference's
    attends to the zero padding (scores 0), which moves its output."""
    q, k, v = (normal(40 + i, (2, 70, 4, 16)) for i in range(3))
    pos = np.broadcast_to(np.arange(70, dtype=np.int32), (2, 70)).copy()
    kw = dict(causal=False)

    def run(mod, conv, chunked):
        fn = mod.attention_chunked if chunked else mod.attention
        extra = {"block_kv": 32} if chunked else {}
        return np.asarray(np_(fn(*map(conv, (q, k, v)), positions_q=conv(
            pos), positions_kv=conv(pos), **kw, **extra)) if mod is layers
            else fn(*map(conv, (q, k, v)), positions_q=conv(pos),
                    positions_kv=conv(pos), **kw, **extra))

    dense = run(layers, torch.as_tensor, False)
    np.testing.assert_allclose(run(layers, torch.as_tensor, True), dense,
                               atol=ATOL_LAYER, rtol=0)
    np.testing.assert_allclose(run(ref_layers, jnp.asarray, False), dense,
                               atol=ATOL_LAYER, rtol=0)
    assert np.abs(run(ref_layers, jnp.asarray, True) - dense).max() > 0.01
    _, cfg = cfgs(ARCH)
    _, p = _cast(cfg)
    src = torch.as_tensor(normal(1, (2, 70, 128), 0.02))
    np.testing.assert_allclose(
        np_(encdec.encode(p, src, cfg)),
        np_(encdec.encode(p, src, dataclasses.replace(cfg,
                                                      flash_min_seq=128))),
        atol=ATOL_LAYER, rtol=0)


@pytest.mark.parametrize("s,s_src", [(9, 14), (70, 96)])  # dense / chunked
def test_cross_attend_matches_reference(s, s_src):
    rcfg, cfg = cfgs(ARCH)
    rp, p = _cast(cfg)
    rlayer = jax.tree.map(lambda t: t[0], rp["decoder"]["layers"])
    layer = p["decoder"]["layers"][0]
    x, mem = normal(2, (2, s, 128)), normal(3, (2, s_src, 128))
    rk, rv = ref_encdec._cross_kv(jnp.asarray(mem), rlayer["cross_attn"])
    k, v = encdec._cross_kv(torch.as_tensor(mem), layer["cross_attn"])
    np.testing.assert_allclose(np_(k), np.asarray(rk), atol=ATOL_LAYER)
    want = ref_encdec._cross_attend(jnp.asarray(x), rlayer["cross_attn"],
                                    rk, rv, rcfg)
    got = encdec._cross_attend(torch.as_tensor(x), layer["cross_attn"], k, v,
                               cfg)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL_LAYER,
                               rtol=0)


def test_init_params_and_cache_layouts_match_reference():
    rcfg, cfg = cfgs(ARCH)
    mine = api.stacked_params(api.init_params(
        torch.Generator().manual_seed(0), cfg))
    ref = jax.eval_shape(lambda: ref_api.init_params(jax.random.PRNGKey(0),
                                                     rcfg))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, mine)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, ref))
    assert [tuple(t.shape) for t in jax.tree.leaves(mine)] == \
        [t.shape for t in jax.tree.leaves(ref)]
    rc = ref_api.init_cache(rcfg, 3, 20, src_len=12)
    c = api.init_cache(cfg, 3, 20, device="cpu", src_len=12)
    assert isinstance(c, cache.EncDecCache) and c.written == 0
    assert c.max_len == 20
    assert jax.tree.structure(jax.tree.map(lambda t: 0, dict(c))) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, rc))
    for key in ("k", "v", "cross_k", "cross_v"):
        assert tuple(c[key].shape) == rc[key].shape
        assert c[key].dtype == torch.bfloat16
    assert cache.cache_bytes(c) == sum(
        x.size * x.dtype.itemsize for x in jax.tree.leaves(rc))
    # src_len defaults to max_len, as the reference's
    assert api.init_cache(cfg, 1, 20, device="cpu")["cross_k"].shape[2] == 20
    tree = jax.tree.map(np.asarray, ref_params(ARCH))
    model = params_from_numpy(tree, cfg, "cpu")
    assert isinstance(model, encdec.EncDecLM)
    with pytest.raises(ValueError, match="decoder"):
        params_from_numpy(tree, dataclasses.replace(cfg,
                                                    num_decoder_layers=3),
                          "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_reference(dtype):
    check_forward_and_loss(ARCH, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    check_prefill_and_decode(ARCH, dtype)


def test_decode_matches_full_forward():
    check_decode_matches_full_forward(ARCH)


def test_precomputed_memory_equals_src_embeds():
    """A batch's "memory" (the encoder's output) gives the logits its
    "src_embeds" do, as in the reference's api.forward."""
    _, cfg = cfgs(ARCH)
    model = port_params(ARCH, cfg)
    _, b = batch(cfg, tokens(9, s=12))
    with torch.no_grad():
        want, _, _ = api.forward(model, b, cfg)
        p = layers.cast_params(model.param_tree(), torch.float32)
        memory = encdec.encode(p, b["src_embeds"], cfg)
        got, _, _ = api.forward(model, {"tokens": b["tokens"],
                                        "memory": memory}, cfg)
    assert torch.equal(got, want)


def test_self_cache_overrun_raises_before_any_launch():
    """The decoder's self-attention cache counts its positions: a prefill
    past its end, or a decode step past it, raises ValueError and writes
    nothing (the reference clamps such writes).  The cross K/V, written
    once at prefill, are no positions; a source of another length than
    they hold is refused too.  A plain dict is refused with TypeError."""
    _, cfg = cfgs(ARCH)
    model = port_params(ARCH, cfg)
    _, b = batch(cfg, tokens(10, s=12))
    frames = b["src_embeds"].shape[1]
    c = api.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu",
                       src_len=frames)
    with pytest.raises(ValueError, match="overrun"):
        api.prefill(model, b, cfg, c)
    assert c.written == 0 and int(c["len"]) == 0
    assert not bool(c["k"].any()) and not bool(c["cross_k"].any())
    c = api.init_cache(cfg, 2, 14, dtype=torch.float32, device="cpu",
                       src_len=frames)
    logits, c = api.prefill(model, b, cfg, c)
    assert c.written == 12 and int(c["len"]) == 12
    assert bool(c["cross_k"].any())
    for _ in range(2):
        logits, c = api.decode_step(
            model, logits.argmax(-1).to(torch.int32)[:, None], cfg, c)
    assert c.written == c.max_len == 14
    before = {k: v.clone() for k, v in c.items()}
    with pytest.raises(ValueError, match="overrun"):
        api.decode_step(model, logits.argmax(-1).to(torch.int32)[:, None],
                        cfg, c)
    assert all(torch.equal(c[k], v) for k, v in before.items())
    short = api.init_cache(cfg, 2, 20, dtype=torch.float32, device="cpu",
                           src_len=frames - 2)
    with pytest.raises(ValueError, match="src_len"):
        api.prefill(model, b, cfg, short)
    assert not bool(short["k"].any())
    with pytest.raises(TypeError, match="EncDecCache"):
        api.decode_step(model, b["tokens"][:, :1], cfg, dict(c))


def test_serve_request_and_main_for_audio(capsys):
    """An audio request carries src_embeds of prompt_len frames (bf16,
    drawn after the prompt from the one generator), and its cache cross
    K/V of as many, beside prompt + gen self-attention positions."""
    cfg = cfgs(ARCH)[1]
    _, r1 = serve.make_request(cfg, 2, 12, seed=3, device="cpu")
    _, r2 = serve.make_request(cfg, 2, 12, seed=3, device="cpu")
    assert sorted(r1) == ["src_embeds", "tokens"]
    src = r1["src_embeds"]
    assert src.dtype == torch.bfloat16 and tuple(src.shape) == (2, 12, 128)
    assert torch.equal(src, r2["src_embeds"])
    assert 0.01 < float(src.float().std()) < 0.03
    assert serve.cache_len(cfg, 12, 4) == 16
    c = serve.init_request_cache(cfg, 2, 12, 4, device="cpu")
    assert c.max_len == 16 and c["cross_k"].shape[2] == 12
    toks = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12", "--gen", "4"])
    assert tuple(toks.shape) == (2, 4) and toks.dtype == torch.int32
    assert int(toks.max()) < cfg.padded_vocab
    assert f"arch={ARCH}-smoke" in capsys.readouterr().out


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
def test_loss_and_gradient_match_reference():
    check_loss_and_gradient(ARCH)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_step_matches_reference(optimizer):
    check_train_step(ARCH, optimizer)

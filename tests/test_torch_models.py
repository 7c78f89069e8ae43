"""repro_torch's Mamba-2 serving path held against the JAX reference,
and the port's architecture registry.

The weights come from the reference's ``init_params`` (PRNGKey 0) and are
carried over with ``params_from_numpy``; prompts are made with numpy.
Both models run on the CPU: the reference in JAX, the port with
``device="cpu"``, where the SSD scan runs its plain version.  fp32
comparisons are tight; bf16 ones (the config's own dtype) are looser,
because XLA and torch round bf16 intermediates at different places.
Each tolerance is stated with the largest error measured here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as ref_config
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.models import cache as ref_cache
from repro.models import layers as ref_layers
from repro.train.serve_step import decode_loop as ref_decode_loop
from repro_torch import config
from repro_torch.configs import ARCH_IDS, PORTED, get_config, smoke_config
from repro_torch.launch import serve
from repro_torch.models import api, cache, layers
from repro_torch.models.convert import params_from_numpy, ssm_state_from_numpy
from repro_torch.train.serve_step import decode_loop, make_serve_fns

torch.set_num_threads(1)

ARCH = "mamba2-130m"
# fp32 logits: largest measured 2.3e-6 (logits up to ~1.1).
ATOL32 = 1e-4
# fp32 cache h and conv (values up to ~11): largest measured 7.6e-6.
ATOL32_STATE = 1e-4
# bf16 logits: largest measured 0.0283, under four bf16 steps at 1.0
# (one step is 2^-7 = 0.0078).
ATOL16 = 0.05
# bf16 model, fp32 cache h and conv (values up to ~11): largest measured
# 0.072.
ATOL16_STATE = 0.25
# bf16 last logits of a narrow 24-layer model against the reference's
# rounded per op, as a fraction of the largest fp32 logit: measured 0.070;
# a change of the scan's rounding alone reads 0.047.
BF16_DEPTH_TOL = 0.1


def _cfgs(dtype="float32"):
    return (dataclasses.replace(ref_smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(smoke_config(ARCH), dtype=dtype))


@pytest.fixture(scope="module")
def ref_params():
    return ref_api.init_params(jax.random.PRNGKey(0), ref_smoke_config(ARCH))


def _port_params(ref_params, cfg):
    return params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, "cpu")


def _tokens(seed, b=2, s=40, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _np(x):
    return x.detach().cpu().numpy()


# --------------------------------------------------------------------------
# configs and layers
# --------------------------------------------------------------------------
def test_arch_ids_and_ported_configs_equal_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    for cfg_fn, ref_fn in ((get_config, ref_get_config),
                           (smoke_config, ref_smoke_config)):
        assert (dataclasses.asdict(cfg_fn(ARCH))
                == dataclasses.asdict(ref_fn(ARCH)))
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    assert cfg.padded_vocab == ref.padded_vocab == 51200
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert (cfg.attention_free, cfg.sub_quadratic, cfg.is_moe) == (
        ref.attention_free, ref.sub_quadratic, ref.is_moe)


TRANSFORMER_ARCHS = ("llama4-scout-17b-a16e", "kimi-k2-1t-a32b",
                     "qwen2.5-3b", "qwen3-4b", "llama3-8b", "qwen2-1.5b",
                     "llava-next-mistral-7b")


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2",
                                  "recurrentgemma-9b"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP 1.9"):
        get_config(arch)
    # A config of another family, built by hand, is refused by the API.
    cfg = dataclasses.replace(get_config(ARCH), family=ref_get_config(arch)
                              .family)
    with pytest.raises(NotImplementedError, match="ROADMAP 1.9"):
        api.module_for(cfg)


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_ported_configs_equal_reference(arch):
    assert set(PORTED) == set(TRANSFORMER_ARCHS) | {ARCH}
    for cfg_fn, ref_fn in ((get_config, ref_get_config),
                           (smoke_config, ref_smoke_config)):
        assert (dataclasses.asdict(cfg_fn(arch))
                == dataclasses.asdict(ref_fn(arch)))
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert cfg.padded_vocab == ref.padded_vocab
    assert cfg.padded_vocab % 2048 == 0 and cfg.padded_vocab >= cfg.vocab_size
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert api.module_for(cfg) is api.module_for(smoke_config(arch))


def test_shapes_and_cells_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in config.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_config.SHAPES.items()}
    fields = {f.name for f in dataclasses.fields(config.ModelConfig)}
    assert fields == {f.name for f in dataclasses.fields(
        ref_config.ModelConfig)}
    assert not hasattr(config, "HW")
    for arch in REF_ARCH_IDS:
        ref = ref_get_config(arch)
        mine = config.ModelConfig(**dataclasses.asdict(ref))
        for shape in config.SHAPES:
            assert config.cell_is_runnable(mine, config.SHAPES[shape]) == \
                ref_config.cell_is_runnable(ref, ref_config.SHAPES[shape])


def test_rms_norm_and_cast_params_match_reference():
    r = np.random.default_rng(1)
    x = r.standard_normal((3, 5, 16)).astype(np.float32)
    scale = (r.standard_normal(16) * 0.1).astype(np.float32)
    want = ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = layers.rms_norm(torch.as_tensor(x), torch.as_tensor(scale), 1e-6)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)
    tree = {"A_log": torch.zeros(2), "w": torch.zeros(2),
            "n": {"D": torch.ones(2), "scale": torch.ones(2)},
            "ids": torch.zeros(2, dtype=torch.int32)}
    cast = layers.cast_params(tree, "bfloat16")
    assert cast["A_log"].dtype == cast["n"]["D"].dtype == torch.float32
    assert cast["w"].dtype == cast["n"]["scale"].dtype == torch.bfloat16
    assert cast["ids"].dtype == torch.int32


def test_init_cache_layout_and_bytes_match_reference():
    rcfg, cfg = _cfgs()
    rc = ref_api.init_cache(rcfg, 3, 64)
    c = api.init_cache(cfg, 3, 64, device="cpu")
    for k in ("h", "conv"):
        assert tuple(c[k].shape) == rc[k].shape
        assert str(c[k].dtype).removeprefix("torch.") == str(rc[k].dtype)
    assert c["len"].dtype == torch.int32 and int(c["len"]) == 0
    assert cache.cache_bytes(c) == ref_cache.cache_bytes(rc)


def test_init_params_shapes_match_reference(ref_params):
    _, cfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    mine = api.init_params(gen, cfg).param_tree()
    ref = jax.tree.map(np.asarray, ref_params)
    assert mine["embed"].shape == ref["embed"].shape
    assert len(mine["layers"]) == cfg.num_layers
    for k, v in ref["layers"].items():
        got = mine["layers"][0][k]
        if isinstance(v, dict):
            assert {kk: tuple(t.shape) for kk, t in got.items()} == {
                kk: t.shape[1:] for kk, t in v.items()}
        else:
            assert tuple(got.shape) == v.shape[1:], k
    # The reference's fixed leaves (zeros, ones) come out the same.
    np.testing.assert_array_equal(_np(mine["layers"][1]["D"]),
                                  ref["layers"]["D"][1])


def test_params_from_numpy_carries_every_leaf(ref_params):
    _, cfg = _cfgs()
    ref = jax.tree.map(np.asarray, ref_params)
    mine = _port_params(ref_params, cfg).param_tree()
    np.testing.assert_array_equal(_np(mine["embed"]), ref["embed"])
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(_np(mine["layers"][i]["in_proj"]),
                                      ref["layers"]["in_proj"][i])
        np.testing.assert_array_equal(
            _np(mine["layers"][i]["ssm_norm"]["scale"]),
            ref["layers"]["ssm_norm"]["scale"][i])
    with pytest.raises(ValueError, match="depth"):
        params_from_numpy(ref, dataclasses.replace(cfg, num_layers=3), "cpu")


# --------------------------------------------------------------------------
# forward, prefill, decode against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,atol", [("float32", ATOL32),
                                        ("bfloat16", ATOL16)])
def test_forward_logits_match_reference(ref_params, dtype, atol):
    rcfg, cfg = _cfgs(dtype)
    toks = _tokens(2)
    want, _, _ = ref_api.forward(ref_params, {"tokens": jnp.asarray(toks)},
                                 rcfg)
    got, aux, new_cache = api.forward(
        _port_params(ref_params, cfg), {"tokens": torch.as_tensor(toks)}, cfg)
    assert got.dtype == torch.float32 and new_cache is None
    assert tuple(got.shape) == (2, 40, cfg.padded_vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol,atol_state", [
    ("float32", ATOL32, ATOL32_STATE), ("bfloat16", ATOL16, ATOL16_STATE)])
def test_prefill_and_decode_match_reference(ref_params, dtype, atol,
                                            atol_state):
    rcfg, cfg = _cfgs(dtype)
    params = _port_params(ref_params, cfg)
    toks = _tokens(3, s=37)               # ragged against ssm_chunk=16
    rc = ref_api.init_cache(rcfg, 2, 64)
    c = ssm_state_from_numpy(jax.tree.map(np.asarray, rc), "cpu")
    want, rc = ref_api.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                               rcfg, rc)
    got, c = api.prefill(params, {"tokens": torch.as_tensor(toks)}, cfg, c)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol, rtol=0)
    for _ in range(2):
        for k, tol in (("h", atol_state), ("conv", atol_state)):
            assert str(c[k].dtype).removeprefix("torch.") == str(rc[k].dtype)
            np.testing.assert_allclose(_np(c[k]), np.asarray(rc[k]),
                                       atol=tol, rtol=0)
        assert int(c["len"]) == int(rc["len"])
        nxt = np.argmax(np.asarray(want), -1).astype(np.int32)[:, None]
        want, rc = ref_api.decode_step(ref_params, jnp.asarray(nxt), rcfg, rc)
        got, c = api.decode_step(params, torch.as_tensor(nxt), cfg, c)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol,
                                   rtol=0)


def test_decode_matches_forward(ref_params):
    """Prefill + one decode step == the full forward's last logits (the
    property tests/test_models.py holds the reference to), at fp32."""
    _, cfg = _cfgs()
    params = _port_params(ref_params, cfg)
    toks = torch.as_tensor(_tokens(4, s=17))
    c = api.init_cache(cfg, 2, 32, device="cpu")
    _, c = api.prefill(params, {"tokens": toks[:, :16]}, cfg, c)
    lg_dec, c = api.decode_step(params, toks[:, 16:], cfg, c)
    lg_full, _, _ = api.forward(params, {"tokens": toks}, cfg)
    # The reference's own test allows 0.02; measured here: 3.9e-7.
    torch.testing.assert_close(lg_dec, lg_full[:, -1].detach(), atol=1e-4,
                               rtol=0)


def test_decode_loop_greedy_tokens_equal_reference(ref_params):
    rcfg, cfg = _cfgs()
    params = _port_params(ref_params, cfg)
    toks = _tokens(5, s=24)
    rc = ref_api.init_cache(rcfg, 2, 40)
    logits, rc = ref_api.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                                 rcfg, rc)
    first = jnp.argmax(logits, -1).astype(jnp.int32)
    want, _ = ref_decode_loop(ref_params, first, rc, rcfg, 12)

    prefill_fn, _ = make_serve_fns(cfg)
    c = api.init_cache(cfg, 2, 40, device="cpu")
    got_first, c = prefill_fn(params, {"tokens": torch.as_tensor(toks)}, c)
    assert got_first.dtype == torch.int32
    np.testing.assert_array_equal(_np(got_first), np.asarray(first))
    got, c = decode_loop(params, got_first, c, cfg, 12)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 12)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert int(c["len"]) == 24 + 12


def test_seq_parallel_raises(ref_params):
    _, cfg = _cfgs()
    params = _port_params(ref_params, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP 1.9"):
        api.forward(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                    dataclasses.replace(cfg, ssm_seq_parallel=True))


def test_model_module_forward_and_explicit_cuda_backend(ref_params):
    _, cfg = _cfgs()
    params = _port_params(ref_params, cfg)
    toks = torch.as_tensor(_tokens(6, s=8))
    logits, _, _ = params(toks)
    want, _, _ = api.forward(params, {"tokens": toks}, cfg, backend="torch")
    assert torch.equal(logits, want)
    with pytest.raises(ValueError, match="backend='cuda'"):
        api.forward(params, {"tokens": toks}, cfg, backend="cuda")


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def test_serve_main_smoke_on_cpu(capsys):
    toks = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "20", "--gen", "4",
                       "--seed", "1"])
    assert tuple(toks.shape) == (2, 4) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0
    assert int(toks.max()) < smoke_config(ARCH).padded_vocab
    out = capsys.readouterr().out
    assert "arch=mamba2-130m-smoke" in out and "prefill:" in out
    # The same seed gives the same request.
    again = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "20", "--gen", "4",
                        "--seed", "1"])
    assert torch.equal(toks, again)


def test_serve_make_request_is_seeded():
    cfg = smoke_config(ARCH)
    p1, r1 = serve.make_request(cfg, 2, 8, seed=3, device="cpu")
    p2, r2 = serve.make_request(cfg, 2, 8, seed=3, device="cpu")
    t1, t2 = r1["tokens"], r2["tokens"]
    assert sorted(r1) == ["tokens"]
    assert torch.equal(t1, t2) and t1.dtype == torch.int32
    assert int(t1.max()) < cfg.vocab_size
    assert torch.equal(p1.embed, p2.embed)
    # a vlm's request draws its prefix after the prompt, from the same
    # generator
    vlm = smoke_config("llava-next-mistral-7b")
    _, r3 = serve.make_request(vlm, 2, 8, seed=3, device="cpu")
    _, r4 = serve.make_request(vlm, 2, 8, seed=3, device="cpu")
    pe = r3["prefix_embeds"]
    assert pe.dtype == torch.bfloat16 and tuple(pe.shape) == (2, 8, 128)
    assert torch.equal(pe, r4["prefix_embeds"])
    assert 0.01 < float(pe.float().std()) < 0.03
    assert serve.cache_len(vlm, 32, 16) == 8 + 32 + 16
    assert serve.cache_len(cfg, 32, 16) == 32 + 16


def _ref_logits_rounded_per_op(params, toks, rcfg):
    """The reference's logits with XLA's excess precision off.  By default
    XLA on the CPU computes a fused chain of bf16 elementwise ops in f32
    and rounds only its end; torch, on the CPU as on the card, rounds
    every op's result to bf16.  With the option off XLA rounds every op
    too, which is what the port's casts are held to."""
    f = jax.jit(lambda p, t: ref_api.forward(p, {"tokens": t}, rcfg)[0])
    t = jnp.asarray(toks)
    compiled = f.lower(params, t).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(compiled(params, t))


def test_bf16_one_layer_rounds_like_reference():
    """One layer in bf16: the port's logits are the reference's (rounded
    per op) except at a few places, by one bf16 step of a logit.  So the
    casts are the reference's; what differs is the summation order of
    the bf16 matmuls.  Measured here: 0.0034% of the logits differ, by at
    most 2.4e-4 (logits up to ~0.9)."""
    cfg_kw = dict(num_layers=1, ssm_state=32, ssm_head_dim=32, ssm_chunk=32)
    rcfg = dataclasses.replace(ref_smoke_config(ARCH), dtype="bfloat16",
                               **cfg_kw)
    cfg = dataclasses.replace(smoke_config(ARCH), dtype="bfloat16", **cfg_kw)
    ref_p = ref_api.init_params(jax.random.PRNGKey(0), rcfg)
    toks = _tokens(7, s=64)
    want = _ref_logits_rounded_per_op(ref_p, toks, rcfg)
    with torch.no_grad():
        got, _, _ = api.forward(_port_params(ref_p, cfg),
                                {"tokens": torch.as_tensor(toks)}, cfg)
    diff = np.abs(_np(got) - want)
    assert (diff > 0).mean() < 1e-3 and diff.max() < 1e-3


def test_bf16_drift_at_depth_matches_reference():
    """At the served depth (24 layers, narrow widths) bf16 activations move
    the last logits far from fp32: 48.2% of the largest fp32 logit in the
    port, 46.5% in the reference rounded per op (32.9% with XLA's excess
    precision, its default on the CPU).  The port's bf16 logits lie 7.0%
    from the reference's rounded per op: a one-step difference in a
    bf16 sum grows through the layers, as a change of the scan's
    rounding alone (chunk 32 vs 16) moves the port's by 4.7%.  These are
    the scales behind chip_smoke.py's LM_SCAN16 and LM_PREC16."""
    kw = dict(num_layers=24, ssm_state=32, ssm_head_dim=32, ssm_chunk=32)
    base = dataclasses.replace(ref_smoke_config(ARCH), **kw)
    ref_p = ref_api.init_params(jax.random.PRNGKey(0), base)
    toks = _tokens(7, s=64)
    last = {}
    for dtype, chunk in (("float32", 32), ("bfloat16", 32),
                         ("bfloat16", 16)):
        cfg = dataclasses.replace(smoke_config(ARCH), dtype=dtype,
                                  **{**kw, "ssm_chunk": chunk})
        with torch.no_grad():
            got, _, _ = api.forward(_port_params(ref_p, cfg),
                                    {"tokens": torch.as_tensor(toks)}, cfg)
        last[dtype, chunk] = _np(got)[:, -1]
    r32 = _ref_logits_rounded_per_op(
        ref_p, toks, dataclasses.replace(base, dtype="float32"))[:, -1]
    r16 = _ref_logits_rounded_per_op(
        ref_p, toks, dataclasses.replace(base, dtype="bfloat16"))[:, -1]
    t32, t16 = last["float32", 32], last["bfloat16", 32]
    np.testing.assert_allclose(t32, r32, atol=ATOL32, rtol=0)
    scale = np.abs(r32).max()
    port_drift = np.abs(t16 - t32).max() / scale
    scan_drift = np.abs(last["bfloat16", 16] - t16).max() / scale
    # Twice the scan-rounding reading: measured 7.0%.
    assert np.abs(t16 - r16).max() / scale < BF16_DEPTH_TOL
    assert scan_drift < 0.1 < 0.5 * port_drift

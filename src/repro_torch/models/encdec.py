"""Encoder-decoder backbone (the audio family, SeamlessM4T-v2).

Port of ``repro/models/encdec.py``.  The audio frontend is a stub:
``src_embeds`` are precomputed frame embeddings (B, S_src, d_model); the
backbone is a transformer encoder-decoder.  The reference's layout:

    {"embed", "enc_norm", "final_norm", ["lm_head"],
     "encoder": {"layers": ...}, "decoder": {"layers": ...}}   # stacked

The model is a ``transformer.TreeLM`` over that tree (each ``layers`` a
list of per-layer dicts); ``forward`` casts it to ``cfg.dtype`` on every
call and runs the layers in a plain loop; the encoder's layers and the
decoder's without a cache run under ``cfg.remat`` when they train
(``layers.remat``).  No kernel of ours runs here: the reference computes
these layers with XLA.

Decode-time cross-attention K/V are computed once from the encoder
memory at prefill and written into the cache (``cross_k``/``cross_v``,
(L, B, S_src, Hkv, D)); the decoder's self-attention uses a stacked KV
cache.  The cache is a ``cache.EncDecCache``: a write past its
self-attention positions raises before any launch (the reference clamps
it), and the cross K/V are no positions.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.cache import EncDecCache
from repro_torch.models.transformer import TreeLM


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
def _enc_layer(gen: torch.Generator, cfg, dtype) -> dict:
    d, ln, dev = cfg.d_model, cfg.use_layer_norm, gen.device
    return {
        "norm1": L.norm_params(d, ln, dtype, dev),
        "attn": L.attention_params(gen, cfg, dtype=dtype),
        "norm2": L.norm_params(d, ln, dtype, dev),
        "mlp": L.mlp_params(gen, d, cfg.d_ff, dtype=dtype),
    }


def _dec_layer(gen: torch.Generator, cfg, dtype) -> dict:
    d, ln, dev = cfg.d_model, cfg.use_layer_norm, gen.device
    return {
        "norm1": L.norm_params(d, ln, dtype, dev),
        "self_attn": L.attention_params(gen, cfg, dtype=dtype),
        "norm_c": L.norm_params(d, ln, dtype, dev),
        "cross_attn": L.attention_params(gen, cfg, dtype=dtype),
        "norm2": L.norm_params(d, ln, dtype, dev),
        "mlp": L.mlp_params(gen, d, cfg.d_ff, dtype=dtype),
    }


class EncDecLM(TreeLM):
    """The encoder-decoder model: fp32 master parameters and ``cfg``."""

    def __init__(self, cfg, tree: dict):
        for part, n in (("encoder", cfg.num_encoder_layers),
                        ("decoder", cfg.num_decoder_layers)):
            if len(tree[part]["layers"]) != n:
                raise ValueError(f"{part}: {len(tree[part]['layers'])} "
                                 f"layers for a config of {n}")
        super().__init__(cfg, tree)


LM = EncDecLM


def init_params(gen: torch.Generator, cfg, dtype=torch.float32) -> EncDecLM:
    """Random weights from ``gen`` (a seeded ``torch.Generator``), on its
    device."""
    d, v, ln, dev = cfg.d_model, cfg.padded_vocab, cfg.use_layer_norm, \
        gen.device
    tree = {
        "embed": L.embed_init(gen, (v, d), dtype),
        "encoder": {"layers": [_enc_layer(gen, cfg, dtype)
                               for _ in range(cfg.num_encoder_layers)]},
        "enc_norm": L.norm_params(d, ln, dtype, dev),
        "decoder": {"layers": [_dec_layer(gen, cfg, dtype)
                               for _ in range(cfg.num_decoder_layers)]},
        "final_norm": L.norm_params(d, ln, dtype, dev),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = L.dense_init(gen, (d, v), in_axis=0, dtype=dtype)
    return EncDecLM(cfg, tree)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------
def encode(p: dict, src_embeds: torch.Tensor, cfg) -> torch.Tensor:
    """src_embeds: (B, S_src, d) stub frontend output -> memory.  ``p`` is
    the parameter tree cast to the compute dtype."""
    b, s, _ = src_embeds.shape
    x = src_embeds.to(L.as_dtype(cfg.dtype))
    positions = torch.arange(s, device=x.device,
                             dtype=torch.int32)[None, :].expand(b, s)

    def body(h, lp):
        hh = L.norm(h, lp["norm1"], cfg.norm_eps, cfg.use_layer_norm)
        hh, _ = L.attention_block(hh, lp["attn"], cfg, positions=positions,
                                  causal=False)
        h = h + hh
        hh = L.norm(h, lp["norm2"], cfg.norm_eps, cfg.use_layer_norm)
        return h + L.swiglu(hh, lp["mlp"])

    body = L.remat(body, cfg)
    for lp in p["encoder"]["layers"]:
        x = body(x, lp)
    return L.norm(x, p["enc_norm"], cfg.norm_eps, cfg.use_layer_norm)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------
def _cross_kv(memory, p):
    return L._proj(memory, p["wk"]), L._proj(memory, p["wv"])


def _cross_attend(x, p, ck, cv, cfg):
    """Cross-attention with precomputed memory K/V (no rope, full mask).
    Long memories take the online-softmax path."""
    b, s, _ = x.shape
    q = L._proj(x, p["wq"])
    zq = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    zk = torch.zeros((b, ck.shape[1]), dtype=torch.int32, device=x.device)
    if s * ck.shape[1] >= cfg.flash_min_seq ** 2:
        out = L.attention_chunked(q, ck, cv, positions_q=zq, positions_kv=zk,
                                  causal=False, block_kv=cfg.attn_block_kv)
    else:
        out = L.attention(q, ck, cv, positions_q=zq, positions_kv=zk,
                          causal=False)
    wo = p["wo"]
    return L._proj(out.reshape(b, s, -1), wo.reshape(-1, wo.shape[-1]))


def _dec_block(x, p, cfg, *, positions, memory=None, cache_layer=None,
               cross_kv=None):
    h = L.norm(x, p["norm1"], cfg.norm_eps, cfg.use_layer_norm)
    h, _ = L.attention_block(h, p["self_attn"], cfg, positions=positions,
                             causal=True, cache=cache_layer)
    x = x + h
    h = L.norm(x, p["norm_c"], cfg.norm_eps, cfg.use_layer_norm)
    ck, cv = (cross_kv if cross_kv is not None
              else _cross_kv(memory, p["cross_attn"]))
    x = x + _cross_attend(h, p["cross_attn"], ck, cv, cfg)
    h = L.norm(x, p["norm2"], cfg.norm_eps, cfg.use_layer_norm)
    return x + L.swiglu(h, p["mlp"]), (ck, cv)


def forward(params: EncDecLM, tokens, cfg, *, src_embeds=None, memory=None,
            cache=None, positions=None, backend: str = "auto"):
    """Train/prefill: pass ``src_embeds`` (or a precomputed ``memory``).
    Decode: pass the cache only (cross K/V come from it).

    Returns (logits fp32 (B, S, padded_vocab), aux=0, new_cache or None).
    A cache (``init_cache``'s ``EncDecCache``) without room for S more
    positions, or whose cross K/V do not hold the source's length, raises
    ValueError before any launch; it is updated in place.  ``backend`` is
    accepted for the API's uniform call: no kernel of ours runs here."""
    b, s = tokens.shape
    src = memory if memory is not None else src_embeds
    if cache is not None:
        if not isinstance(cache, EncDecCache):
            raise TypeError("an encoder-decoder's cache is an EncDecCache "
                            "(init_cache)")
        cache.check_room(s)
        if src is not None and src.shape[1] != cache["cross_k"].shape[2]:
            raise ValueError(
                f"a source of {src.shape[1]} frames for cross K/V of "
                f"{cache['cross_k'].shape[2]}: size the cache's src_len to "
                "the source")
    elif src is None:
        raise ValueError("an encoder-decoder forward without a cache needs "
                         "src_embeds or memory")
    dtype = L.as_dtype(cfg.dtype)
    tree = params.param_tree()
    if memory is not None or src_embeds is None:
        # no encoder runs: leave its weights uncast (the reference's jit
        # drops the unused casts)
        tree = {k: v for k, v in tree.items()
                if k not in ("encoder", "enc_norm")}
    p = L.cast_params(tree, dtype)
    if memory is None and src_embeds is not None:
        memory = encode(p, src_embeds, cfg)
    x = p["embed"][tokens].to(dtype)
    if cfg.scale_embeddings:
        x = x * float(torch.tensor(math.sqrt(cfg.d_model)).to(dtype))
    if positions is None:
        steps = torch.arange(s, device=x.device, dtype=torch.int32)
        if cache is not None:
            steps = cache["len"] + steps
        positions = steps[None, :].expand(b, s)

    new_cache = None
    if cache is None:
        def body(h, lp):
            return _dec_block(h, lp, cfg, positions=positions,
                              memory=memory)[0]

        body = L.remat(body, cfg)
        for lp in p["decoder"]["layers"]:
            x = body(x, lp)
    else:
        ln = cache["len"]
        for i, lp in enumerate(p["decoder"]["layers"]):
            cl = {"k": cache["k"][i], "v": cache["v"][i], "len": ln}
            ckv = (None if memory is not None
                   else (cache["cross_k"][i], cache["cross_v"][i]))
            x, (ck, cv) = _dec_block(x, lp, cfg, positions=positions,
                                     memory=memory, cache_layer=cl,
                                     cross_kv=ckv)
            if memory is not None:             # prefill: cross K/V, once
                cache["cross_k"][i].copy_(ck)
                cache["cross_v"][i].copy_(cv)
        new_cache = EncDecCache({**cache, "len": ln + s}, cache.written + s)

    x = L.norm(x, p["final_norm"], cfg.norm_eps, cfg.use_layer_norm)
    if cfg.tie_embeddings:
        logits = x @ p["embed"].to(dtype).T
    else:
        logits = x @ p["lm_head"].to(dtype)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits.float(), aux, new_cache


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None, src_len: int | None = None) -> EncDecCache:
    """An empty cache of ``max_len`` self-attention positions and cross
    K/V of ``src_len`` source frames (``max_len`` unless given); on the
    card unless ``device`` names another."""
    dev = resolve_device(device)
    lyr, hkv, hd = cfg.num_decoder_layers, cfg.num_kv_heads, cfg.head_dim
    src_len = src_len or max_len

    def zeros(n):
        return torch.zeros((lyr, batch, n, hkv, hd), dtype=dtype, device=dev)

    return EncDecCache({"k": zeros(max_len), "v": zeros(max_len),
                        "cross_k": zeros(src_len), "cross_v": zeros(src_len),
                        "len": torch.zeros((), dtype=torch.int32,
                                           device=dev)})

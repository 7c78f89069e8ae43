"""Shared layers of the model zoo.

Port of ``repro/models/layers.py``: initializers, the mixed-precision
cast, norms, rotary embeddings, attention (dense and chunked online
softmax, GQA-general, with a KV or ring cache), the MLPs and the logit
softcap.  Parameters are nested dicts of tensors (what a model's
``param_tree`` returns); activations compute in ``cfg.dtype`` (bf16 by
default), norms, softmax and attention scores in fp32.  Products the
reference asks in fp32 (``preferred_element_type``) are taken on fp32
copies of their operands, exact for bf16 inputs.

The reference's ``scan_or_unroll`` is left out: the port runs layers in
a Python loop.  So are ``_expand_kv_for_tp`` and the ``constrain`` calls:
under a sharding context they only annotate activations for GSPMD, and
one process computes every activation whole (``sharding/rules.py``'s
``constrain`` is the identity).  Grouped-query
attention never materializes repeated KV: query head ``j * G + i`` reads
KV head ``j``, as the reference's reshape does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a config's dtype name, or the dtype itself."""
    return DTYPES[dtype] if isinstance(dtype, str) else dtype


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, in_axis=-2,
               dtype=torch.float32) -> torch.Tensor:
    """Normal / sqrt(fan_in), drawn on ``gen``'s device."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    scale = 1.0 / max(fan_in, 1) ** 0.5
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32):
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Mixed precision: fp32 master params, compute-dtype working copy
# ---------------------------------------------------------------------------
# Leaves that must stay fp32 regardless of compute dtype: router logits,
# SSD decay rates and step biases, RG-LRU gate parameters.
_FP32_LEAVES = frozenset(
    {"router", "A_log", "D", "dt_bias", "lam", "g_a", "b_a", "g_x", "b_x"}
)


def cast_params(params, dtype):
    """Cast float params (nested dicts and lists of tensors) to the
    compute dtype, except numerics-critical leaves (kept fp32).  Integer
    leaves pass through."""
    dtype = as_dtype(dtype)

    def f(x, leaf):
        if isinstance(x, dict):
            return {k: f(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [f(v, leaf) for v in x]
        if leaf in _FP32_LEAVES or not x.is_floating_point():
            return x
        return x.to(dtype)

    return f(params, None)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMSNorm with the ``(1 + scale)`` gain of the reference (scale is
    initialised to zero)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def norm_params(d: int, use_layer_norm: bool, dtype=torch.float32,
                device=None) -> dict:
    if use_layer_norm:
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def layer_norm(x, scale, bias, eps: float = 1e-6):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def norm(x, p: dict, eps: float, use_layer_norm: bool):
    if use_layer_norm:
        return layer_norm(x, p["scale"], p["bias"], eps)
    return rms_norm(x, p["scale"], eps)


# ---------------------------------------------------------------------------
# Layer stacks: the reference's layout (every ``layers`` leaf stacked on a
# leading L axis) and the port's (``layers`` a list of per-layer dicts)
# ---------------------------------------------------------------------------
def stack_layers(tree: dict) -> dict:
    """A ``param_tree()`` in the reference's layout: every ``layers`` list,
    at any depth, stacked leaf by leaf on a leading L axis (a copy,
    detached)."""
    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return torch.stack([it.detach() for it in items])

    def walk(t):
        if isinstance(t, dict):
            return {k: stack(v) if k == "layers" else walk(v)
                    for k, v in t.items()}
        return t.detach()

    return walk(tree)


def unstack_layers(tree: dict) -> dict:
    """The reference's layout as the port's: layer ``i`` of every stacked
    leaf under a ``layers`` key, as views.  Stacks of unequal depth raise
    ValueError."""
    def split(t):
        if isinstance(t, dict):
            parts = {k: split(v) for k, v in t.items()}
            return [dict(zip(parts, layer))
                    for layer in zip(*parts.values(), strict=True)]
        return list(t.unbind(0))

    def walk(t):
        if isinstance(t, dict):
            return {k: split(v) if k == "layers" else walk(v)
                    for k, v in t.items()}
        return t

    return walk(tree)


def _f32(v: float) -> float:
    """``v`` rounded to fp32: a Python scalar that an fp32 op takes as it
    is (a scalar, not a tensor: no copy to the card)."""
    return float(torch.tensor(v, dtype=torch.float32))


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over x's last axis and w's first, the rest of w kept:
    the reference's ``einsum("bsd,dhe->bshe")`` and ``("bsd,df->bsf")``
    as one matmul, with its dtype promotion (bf16 with fp32 gives fp32),
    which torch's matmul does not do."""
    dt = torch.promote_types(x.dtype, w.dtype)
    out = x.to(dt) @ w.to(dt).reshape(w.shape[0], -1)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, D); positions: (B, S) or (S,). Rotate-half convention."""
    half = x.shape[-1] // 2
    freq = torch.pow(_f32(theta), -torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freq              # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA / MHA, causal / bidirectional / sliding / cross)
# ---------------------------------------------------------------------------
def _mask(pq, pkv, causal, sliding_window, kv_valid_len):
    """Which (query, key) pairs attend, from absolute positions: pq
    (B, 1, 1, Sq, 1) against pkv (B, 1, 1, 1, Skv); None for all."""
    conds = []
    if causal:
        conds.append(pkv <= pq)
    if sliding_window is not None:
        conds.append(pq - pkv < sliding_window)
    if kv_valid_len is not None:
        conds.append(pkv < kv_valid_len[:, None, None, None, None])
    mask = conds[0] if conds else None
    for c in conds[1:]:
        mask = mask & c
    return mask


def attention_chunked(q, k, v, *, positions_q, positions_kv,
                      causal: bool = True, sliding_window=None,
                      kv_valid_len=None, block_kv: int = 1024):
    """Online-softmax attention over KV blocks of ``block_kv``.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D).  Memory is
    O(Sq * block_kv) instead of O(Sq * Skv): the long-context prefill
    path.  fp32 running (max, sum, acc); exact softmax.  Padded keys get
    position int32 max and never attend, bidirectional attention included
    (the reference's attends to them there: ROADMAP Queue 3); a fully
    masked row gives 0.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    real_kv = skv
    if skv % block_kv:
        pad = (-skv) % block_kv
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        positions_kv = F.pad(positions_kv, (0, pad),
                             value=torch.iinfo(torch.int32).max)
        skv += pad
    qg = q.reshape(b, sq, hkv, g, d).float()
    scale = _f32(1.0 / _f32(math.sqrt(d)))
    pqx = positions_q[:, None, None, :, None]

    m = torch.full((b, hkv, g, sq), -math.inf, device=q.device)
    lse = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), device=q.device)
    for j in range(0, skv, block_kv):
        kblk, vblk = k[:, j:j + block_kv], v[:, j:j + block_kv]
        pkx = positions_kv[:, None, None, None, j:j + block_kv]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kblk.float()) * scale
        mask = _mask(pqx, pkx, causal, sliding_window, kv_valid_len)
        if j + block_kv > real_kv:         # the padded keys of the last block
            real = torch.arange(j, j + block_kv, device=q.device) < real_kv
            mask = real if mask is None else mask & real
        if mask is not None:
            s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new == -inf): scale-factor 0
        dead = torch.isinf(m_new)
        alpha = torch.where(dead, 0.0, torch.exp(m - m_new))
        p = torch.where(dead[..., None], 0.0, torch.exp(s - m_new[..., None]))
        lse = lse * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(vblk.dtype).float(), vblk.float())
        m = m_new
    out = acc / torch.clamp(lse, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    return out.to(q.dtype)


def attention(q, k, v, *, positions_q, positions_kv, causal: bool = True,
              sliding_window=None, kv_valid_len=None):
    """Dense attention. q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D);
    positions_q (B, Sq) and positions_kv (B, Skv) absolute; kv_valid_len
    (B,) the valid cache length.  Masked scores are -1e30 (a fully masked
    row attends uniformly, as in the reference)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, q.shape[2] // hkv, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) / _f32(math.sqrt(d))
    mask = _mask(positions_q[:, None, None, :, None],
                 positions_kv[:, None, None, None, :], causal,
                 sliding_window, kv_valid_len)
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", weights, v)
    return out.reshape(b, sq, hq, d)


def _write_kv(cache_kv: torch.Tensor, new: torch.Tensor, at: torch.Tensor):
    """``new`` (B, S, H, D) written into ``cache_kv`` (B, L, H, D) at
    slots ``at`` (S,), a device tensor: in place, no host sync."""
    cache_kv.index_copy_(1, at.long(), new.to(cache_kv.dtype))
    return cache_kv


def attention_block(x, p: dict, cfg, *, positions, causal: bool = True,
                    sliding_window=None, cache: dict | None = None,
                    kv_source=None):
    """Full attention sub-block: projections + rope + attn + out-proj.

    x: (B, S, d_model).  ``cache`` is one layer's {"k", "v", "len"} (a KV
    cache, written in place at ``len``) or {"k", "v", "pos", "len"} (a
    ring buffer of sliding-window keys).  Returns (out, updated_cache).
    """
    b, s, _ = x.shape
    q = _proj(x, p["wq"])
    kv_in = x if kv_source is None else kv_source
    k = _proj(kv_in, p["wk"])
    v = _proj(kv_in, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    use_rope = kv_source is None  # no rope on cross-attention memory
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    flash_min = getattr(cfg, "flash_min_seq", 8192)

    if cache is not None and "pos" in cache:
        # ring-buffer cache (sliding-window layers): slot = pos % window
        from repro_torch.models.cache import ring_update

        if use_rope:
            k = apply_rope(k, positions, cfg.rope_theta)
        window = cache["k"].shape[1]
        if s == 1:
            upd = ring_update(cache, k, v, cache["len"])
            out = attention(q, upd["k"], upd["v"], positions_q=positions,
                            positions_kv=upd["pos"], causal=True,
                            sliding_window=sliding_window)
        else:
            # prefill: attend over the full (windowed) sequence, then store
            # only the last `window` keys in the ring.
            out = attention(q, k, v, positions_q=positions,
                            positions_kv=positions, causal=True,
                            sliding_window=sliding_window)
            keep = min(s, window)
            upd = ring_update(cache, k[:, -keep:], v[:, -keep:],
                              cache["len"] + s - keep)
        new_cache = {**upd, "len": cache["len"] + s}
    elif cache is not None:
        # decode: write new k/v at position cache["len"], attend over cache
        if use_rope:
            k = apply_rope(k, positions, cfg.rope_theta)
        at = cache["len"] + torch.arange(s, device=x.device,
                                         dtype=torch.int32)
        ck = _write_kv(cache["k"], k, at)
        cv = _write_kv(cache["v"], v, at)
        skv = ck.shape[1]
        pos_kv = torch.arange(skv, device=x.device,
                              dtype=torch.int32)[None, :].expand(b, skv)
        valid = (cache["len"] + s).to(torch.int32).expand(b)
        # long prefill into a cache: online-softmax path (dense S x S
        # scores at 32k would be ~17 GiB)
        use_chunked = s > 1 and skv >= flash_min
        attn_fn = attention_chunked if use_chunked else attention
        kw = {"block_kv": cfg.attn_block_kv} if use_chunked else {}
        out = attn_fn(q, ck, cv, positions_q=positions, positions_kv=pos_kv,
                      causal=causal, sliding_window=sliding_window,
                      kv_valid_len=valid, **kw)
        new_cache = {"k": ck, "v": cv, "len": cache["len"] + s}
    else:
        if use_rope:
            kv_pos = positions
            k = apply_rope(k, kv_pos, cfg.rope_theta)
        else:
            n = kv_in.shape[1]
            kv_pos = torch.arange(n, device=x.device,
                                  dtype=torch.int32)[None, :].expand(b, n)
        use_chunked = s >= flash_min and k.shape[1] >= flash_min
        attn_fn = attention_chunked if use_chunked else attention
        kw = {"block_kv": cfg.attn_block_kv} if use_chunked else {}
        out = attn_fn(q, k, v, positions_q=positions, positions_kv=kv_pos,
                      causal=causal and kv_source is None,
                      sliding_window=sliding_window, **kw)
        new_cache = None

    wo = p["wo"]
    return _proj(out.reshape(b, s, -1), wo.reshape(-1, wo.shape[-1])), \
        new_cache


def attention_params(gen: torch.Generator, cfg, d_model=None,
                     dtype=torch.float32) -> dict:
    d = d_model or cfg.d_model
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d, hq, hd), in_axis=0, dtype=dtype),
        "wk": dense_init(gen, (d, hkv, hd), in_axis=0, dtype=dtype),
        "wv": dense_init(gen, (d, hkv, hd), in_axis=0, dtype=dtype),
        "wo": dense_init(gen, (hq, hd, d), in_axis=1, dtype=dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((hkv, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((hkv, hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=dev)
    return p


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def _gated(x, p, act):
    gate = _proj(x, p["w_gate"])
    up = _proj(x, p["w_up"])
    h = act(gate.float()).to(x.dtype) * up
    return _proj(h, p["w_down"])


def swiglu(x: torch.Tensor, p: dict) -> torch.Tensor:
    return _gated(x, p, F.silu)


def geglu(x: torch.Tensor, p: dict) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return _gated(x, p, lambda t: F.gelu(t, approximate="tanh"))


def mlp_params(gen: torch.Generator, d: int, f: int,
               dtype=torch.float32) -> dict:
    return {
        "w_gate": dense_init(gen, (d, f), in_axis=0, dtype=dtype),
        "w_up": dense_init(gen, (d, f), in_axis=0, dtype=dtype),
        "w_down": dense_init(gen, (f, d), in_axis=0, dtype=dtype),
    }


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)

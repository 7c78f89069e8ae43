"""Decoder-only LM: dense, MoE and multimodal-prefix variants.

Port of ``repro/models/transformer.py``, which serves 7 of the 10
architectures (qwen2/2.5/3, llama3, llama4-scout, kimi-k2 and the
llava-next backbone).  Layers come in *segments*, uniform runs of
identical blocks (kimi-k2 = 1 dense layer + 60 MoE layers); the
reference's layout stacks each segment's layers on a leading L axis:

    {"embed", "final_norm", ["lm_head"],
     "segments": {"seg{i}": {"layers": {... stacked leaves ...}}}}

The model is an ``nn.Module`` (``TransformerLM``) whose parameters carry
those names, with each segment's layers as a ``ModuleList``, so
``param_tree()`` gives the same dict with ``layers`` a list of per-layer
dicts (``layers.stack_layers`` stacks it back).  ``forward`` casts it to
``cfg.dtype`` on every call, as the reference does (``router`` stays
fp32), and runs the layers in a plain loop.  No kernel of ours runs here:
attention, RoPE, SwiGLU and the MoE dispatch are plain torch, as they are
plain ``jnp`` in the reference.

The decode cache is a ``cache.KVCache``: ``{"seg{i}": {"k", "v", "len"}}``
with each segment's layers stacked, written in place; a write past its
end raises ValueError before any launch.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.cache import KVCache, kv_cache


# ---------------------------------------------------------------------------
# Segments: uniform runs of identical blocks.
# ---------------------------------------------------------------------------
def segments_spec(cfg) -> tuple[tuple[str, int], ...]:
    """((kind, num_layers), ...) with kind in {"dense", "moe"}."""
    if cfg.is_moe:
        segs = []
        if cfg.first_k_dense:
            segs.append(("dense", cfg.first_k_dense))
        segs.append(("moe", cfg.num_layers - cfg.first_k_dense))
        return tuple(segs)
    return (("dense", cfg.num_layers),)


def layer_params(gen: torch.Generator, cfg, kind: str,
                 dtype=torch.float32) -> dict:
    """One block's parameters, drawn on ``gen``'s device."""
    d, dev = cfg.d_model, gen.device
    p = {
        "attn_norm": L.norm_params(d, cfg.use_layer_norm, dtype, dev),
        "attn": L.attention_params(gen, cfg, dtype=dtype),
        "mlp_norm": L.norm_params(d, cfg.use_layer_norm, dtype, dev),
    }
    if kind == "moe":
        p["moe"] = moe.moe_params(gen, cfg, dtype=dtype)
    else:
        p["mlp"] = L.mlp_params(gen, d, cfg.d_ff, dtype=dtype)
    return p


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: each tensor a parameter
    (sharing its storage), each dict a child module, under the dict's
    keys."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def param_tree(self) -> dict:
        t = dict(self.named_parameters(recurse=False))
        t.update({k: m.param_tree() for k, m in self.named_children()})
        return t


class TransformerLM(nn.Module):
    """The decoder LM: fp32 master parameters and ``cfg``.

    ``tree`` is the nested parameter dict of ``init_params`` (each
    segment's ``layers`` a list of per-layer dicts); ``models/convert.py``
    builds one from the reference's stacked numpy pytree."""

    def __init__(self, cfg, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(tree["embed"])
        self.final_norm = ParamTree(tree["final_norm"])
        self.lm_head = (None if cfg.tie_embeddings
                        else nn.Parameter(tree["lm_head"]))
        spec = segments_spec(cfg)
        if sorted(tree["segments"]) != [f"seg{i}" for i in range(len(spec))]:
            raise ValueError(f"segments {sorted(tree['segments'])} for a "
                             f"config of {len(spec)}")
        self.segments = nn.ModuleDict()
        for i, (_, n) in enumerate(spec):
            layers = tree["segments"][f"seg{i}"]["layers"]
            if len(layers) != n:
                raise ValueError(f"seg{i}: {len(layers)} layers for a "
                                 f"segment of {n}")
            self.segments[f"seg{i}"] = nn.ModuleList(
                ParamTree(t) for t in layers)

    def param_tree(self) -> dict:
        t = {"embed": self.embed, "final_norm": self.final_norm.param_tree(),
             "segments": {name: {"layers": [blk.param_tree() for blk in seg]}
                          for name, seg in self.segments.items()}}
        if self.lm_head is not None:
            t["lm_head"] = self.lm_head
        return t

    @classmethod
    def over(cls, cfg, params: dict) -> "TransformerLM":
        """The model over ``params`` in the reference's layout (each
        segment's layers stacked on a leading L axis): its parameters are
        views of those tensors."""
        return cls(cfg, unstack_layers(params))

    def grad_tree(self) -> dict:
        """The parameters' gradients in the reference's layout (layers
        stacked, a copy); zeros where a parameter has none."""
        def grads(t):
            if isinstance(t, dict):
                return {k: grads(v) for k, v in t.items()}
            if isinstance(t, list):
                return [grads(v) for v in t]
            return torch.zeros_like(t) if t.grad is None else t.grad
        return stack_layers(grads(self.param_tree()))


LM = TransformerLM
stack_layers = L.stack_layers
unstack_layers = L.unstack_layers


def init_params(gen: torch.Generator, cfg,
                dtype=torch.float32) -> TransformerLM:
    """Random weights from ``gen`` (a seeded ``torch.Generator``), on its
    device."""
    d, v = cfg.d_model, cfg.padded_vocab
    tree = {
        "embed": L.embed_init(gen, (v, d), dtype),
        "final_norm": L.norm_params(d, cfg.use_layer_norm, dtype, gen.device),
        "segments": {},
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = L.dense_init(gen, (d, v), in_axis=0, dtype=dtype)
    for i, (kind, n) in enumerate(segments_spec(cfg)):
        tree["segments"][f"seg{i}"] = {
            "layers": [layer_params(gen, cfg, kind, dtype) for _ in range(n)]}
    return TransformerLM(cfg, tree)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _block(x, p, cfg, kind, *, positions, cache_layer=None):
    """One transformer block. Returns (x, new_cache_layer, aux_loss)."""
    h = L.norm(x, p["attn_norm"], cfg.norm_eps, cfg.use_layer_norm)
    h, new_cache = L.attention_block(
        h, p["attn"], cfg, positions=positions, causal=True,
        sliding_window=cfg.sliding_window, cache=cache_layer)
    x = x + h
    h = L.norm(x, p["mlp_norm"], cfg.norm_eps, cfg.use_layer_norm)
    if kind == "moe":
        h, aux = moe.moe_block(h, p["moe"], cfg)
    else:
        h = L.swiglu(h, p["mlp"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, new_cache, aux


def _run_segment(x, layers, cfg, kind, *, positions, seg_cache=None):
    """Run a uniform segment's layers. Returns (x, new_seg_cache, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p_layer in enumerate(layers):
        layer_cache = None if seg_cache is None else {
            "k": seg_cache["k"][i], "v": seg_cache["v"][i],
            "len": seg_cache["len"]}
        x, _, a = _block(x, p_layer, cfg, kind, positions=positions,
                         cache_layer=layer_cache)
        aux = aux + a
    if seg_cache is None:
        return x, None, aux
    # the layers wrote their k and v into the stacked tensors in place
    return x, {"k": seg_cache["k"], "v": seg_cache["v"],
               "len": seg_cache["len"] + positions.shape[-1]}, aux


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def forward(params: TransformerLM, tokens, cfg, *, prefix_embeds=None,
            cache=None, positions=None, backend: str = "auto"):
    """tokens: (B, S) int. prefix_embeds: (B, P, d) for the VLM stub.

    Returns (logits fp32 (B, S_total, padded_vocab), aux_loss, new_cache).
    With a cache (``init_cache``'s ``KVCache``), S is the new-token count
    and positions default to cache len + arange(S); a cache without room
    for S_total more positions raises ValueError before any launch.
    ``backend`` is accepted for the API's uniform call: no kernel of ours
    runs on this path."""
    b, s = tokens.shape
    s_total = s + (0 if prefix_embeds is None else prefix_embeds.shape[1])
    if cache is not None:
        if not isinstance(cache, KVCache):
            raise TypeError("a transformer's cache is a KVCache "
                            "(init_cache, convert.kv_cache_from_numpy)")
        cache.check_room(s_total)
    dtype = L.as_dtype(cfg.dtype)
    p = L.cast_params(params.param_tree(), dtype)
    x = p["embed"][tokens].to(dtype)
    if cfg.scale_embeddings:
        # sqrt(d) in fp32, rounded to the compute dtype, as the reference
        x = x * float(torch.tensor(math.sqrt(cfg.d_model)).to(dtype))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dtype), x], dim=1)
    if positions is None:
        steps = torch.arange(s_total, device=x.device, dtype=torch.int32)
        if cache is not None:
            steps = cache["seg0"]["len"] + steps
        positions = steps[None, :].expand(b, s_total)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = {}
    for i, (kind, _) in enumerate(segments_spec(cfg)):
        x, seg_new, aux = _run_segment(
            x, p["segments"][f"seg{i}"]["layers"], cfg, kind,
            positions=positions,
            seg_cache=None if cache is None else cache[f"seg{i}"])
        aux_total = aux_total + aux
        if seg_new is not None:
            new_cache[f"seg{i}"] = seg_new

    x = L.norm(x, p["final_norm"], cfg.norm_eps, cfg.use_layer_norm)
    if cfg.tie_embeddings:
        logits = x @ p["embed"].to(dtype).T
    else:
        logits = x @ p["lm_head"].to(dtype)
    logits = L.softcap(logits.float(), cfg.logits_softcap)
    if cache is None:
        return logits, aux_total, None
    return logits, aux_total, KVCache(new_cache, cache.written + s_total)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> KVCache:
    """An empty KV cache of ``max_len`` positions per segment (the
    sliding window's, if shorter); on the card unless ``device`` names
    another."""
    dev = resolve_device(device)
    segs = {}
    for i, (_, n) in enumerate(segments_spec(cfg)):
        ln = min(max_len, cfg.sliding_window) if cfg.sliding_window \
            else max_len
        segs[f"seg{i}"] = kv_cache(n, batch, ln, cfg.num_kv_heads,
                                   cfg.head_dim, dtype, dev)
    return KVCache(segs)

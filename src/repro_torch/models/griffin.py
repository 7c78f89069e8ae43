"""Griffin / RecurrentGemma: RG-LRU recurrent blocks + local attention
(the hybrid family).

Port of ``repro/models/griffin.py``.  The layer pattern
(``cfg.block_pattern``, e.g. ("rec", "rec", "attn")) tiles the depth:
full pattern groups are stacked in the reference's layout, the remainder
is a short unstacked tail (38 = 12 x (rec, rec, attn) + (rec, rec)):

    {"embed", "final_norm", ["lm_head"],
     "groups": {"layers": {"b0": ..., "b1": ..., "b2": ...}},   # stacked
     ["tail": {"b0": ..., "b1": ...}]}

The model is a ``transformer.TreeLM`` over that tree, with
``groups.layers`` a list of per-group dicts.  ``forward`` casts it to
``cfg.dtype`` on every call (the RG-LRU's ``lam``, ``g_a``, ``b_a``,
``g_x`` and ``b_x`` stay fp32) and runs the layers in a plain loop.  No
kernel of ours runs here: the reference computes these layers with XLA.

The RG-LRU prefill is a 1-D gated linear recurrence computed chunk-wise:
an inclusive scan inside each chunk, then a sequential carry over chunk
boundaries.  The reference scans a chunk with ``associative_scan``; the
port with a log-depth (Hillis-Steele) scan of the same combine over all
chunks at once, so fp32 results agree to rounding, not bit for bit.
Decode is a single-step recurrence.  The local-attention layers use ring
KV caches of ``min(sliding_window, max_len)`` slots.

The decode state is updated in place: each step writes the recurrent
layers' ``h`` and conv tail into the cache's tensors and the attention
layers' keys into their rings, so a cache is consumed by the step it is
given to.  With ``cfg.rnn_seq_parallel`` under a ``sharding_context``
whose model axis divides S (S > 1), the RG-LRU prefill runs
``_rglru_seq_parallel``: S split over the model axis, B over the batch
axes, each shard scanned on its device of the mesh, and the shards'
boundary states carried across by ``ssm.decay_ladder``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.cache import rglru_state, ring_kv_cache
from repro_torch.models.ssm import (
    _causal_conv, _seq_parallel_ctx, _split_rows, decay_ladder,
)
from repro_torch.models.transformer import TreeLM
from repro_torch.sharding.rules import shard_grid

_C = 8.0  # RG-LRU exponent scale (Griffin paper)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
def _rec_mixer_params(gen: torch.Generator, cfg, dtype) -> dict:
    d, w, dev = cfg.d_model, cfg.rnn_width, gen.device

    def f32(v):
        return torch.full((w,), v, dtype=torch.float32, device=dev)

    return {
        "w_branch_gate": L.dense_init(gen, (d, w), in_axis=0, dtype=dtype),
        "w_branch_x": L.dense_init(gen, (d, w), in_axis=0, dtype=dtype),
        "conv_w": L.dense_init(gen, (cfg.conv_kernel, w), in_axis=0,
                               dtype=dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        # a = sigmoid(lam); init so a^c ~ 0.9..0.999 (long memory)
        "lam": torch.linspace(2.0, 6.0, w, dtype=torch.float32, device=dev),
        "g_a": f32(0.0), "b_a": f32(0.0), "g_x": f32(0.0), "b_x": f32(0.0),
        "w_out": L.dense_init(gen, (w, d), in_axis=0, dtype=dtype),
    }


def _layer_params(gen: torch.Generator, cfg, kind: str, dtype) -> dict:
    d, dev = cfg.d_model, gen.device
    p = {
        "norm1": L.norm_params(d, False, dtype, dev),
        "norm2": L.norm_params(d, False, dtype, dev),
        "mlp": L.mlp_params(gen, d, cfg.d_ff, dtype=dtype),
    }
    if kind == "rec":
        p["rec"] = _rec_mixer_params(gen, cfg, dtype)
    else:
        p["attn"] = L.attention_params(gen, cfg, dtype=dtype)
    return p


def _pattern(cfg):
    """(pattern, number of full groups, the tail's kinds)."""
    p = cfg.block_pattern or ("rec", "rec", "attn")
    n_groups = cfg.num_layers // len(p)
    rem = cfg.num_layers - n_groups * len(p)
    return p, n_groups, p[:rem]


class GriffinLM(TreeLM):
    """The Griffin language model: fp32 master parameters and ``cfg``.

    ``tree`` is the nested parameter dict of ``init_params``
    (``groups.layers`` a list of per-group dicts); ``models/convert.py``
    builds one from the reference's stacked numpy pytree."""

    def __init__(self, cfg, tree: dict):
        pat, n_groups, tail = _pattern(cfg)
        groups = tree["groups"]["layers"]
        if len(groups) != n_groups:
            raise ValueError(f"{len(groups)} pattern groups for a config of "
                             f"{n_groups}")
        want_tail = [f"b{j}" for j in range(len(tail))]
        if sorted(tree.get("tail", {})) != want_tail:
            raise ValueError(f"tail {sorted(tree.get('tail', {}))} for a "
                             f"config whose tail is {list(tail)}")
        super().__init__(cfg, tree)


LM = GriffinLM


def init_params(gen: torch.Generator, cfg, dtype=torch.float32) -> GriffinLM:
    """Random weights from ``gen`` (a seeded ``torch.Generator``), on its
    device."""
    pat, n_groups, tail = _pattern(cfg)
    tree = {
        "embed": L.embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype),
        "final_norm": L.norm_params(cfg.d_model, False, dtype, gen.device),
        "groups": {"layers": [
            {f"b{j}": _layer_params(gen, cfg, kind, dtype)
             for j, kind in enumerate(pat)} for _ in range(n_groups)]},
    }
    if tail:
        tree["tail"] = {f"b{j}": _layer_params(gen, cfg, kind, dtype)
                        for j, kind in enumerate(tail)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = L.dense_init(
            gen, (cfg.d_model, cfg.padded_vocab), in_axis=0, dtype=dtype)
    return GriffinLM(cfg, tree)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------
def _rglru_gates(u: torch.Tensor, p: dict):
    """u: (B, S, w) fp32. Returns (log_a, b) of the linear recurrence
    h_t = exp(log_a_t) h_{t-1} + b_t."""
    r = torch.sigmoid(u * p["g_a"] + p["b_a"])
    i = torch.sigmoid(u * p["g_x"] + p["b_x"])
    log_a = -_C * r * F.softplus(-p["lam"])                   # <= 0
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * u)
    return log_a, b


def _scan_chunks(la: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``combine((la1, b1), (la2, b2)) = (la1 + la2,
    exp(la2) * b1 + b2)`` along axis -2 (a chunk's steps), every chunk at
    once: log2(Q) rounds, step t taking in step t - d at distance d."""
    q, d = la.shape[-2], 1
    while d < q:
        b = torch.cat([b[..., :d, :],
                       torch.exp(la[..., d:, :]) * b[..., :-d, :]
                       + b[..., d:, :]], dim=-2)
        la = torch.cat([la[..., :d, :], la[..., :-d, :] + la[..., d:, :]],
                       dim=-2)
        d *= 2
    return la, b


def _rglru_chunked(u: torch.Tensor, p: dict, chunk: int, h0: torch.Tensor):
    """Chunked linear scan. u: (B, S, w) fp32; h0: (B, w).

    Returns (h_seq (B, S, w), h_last (B, w)): an inclusive scan inside
    each chunk, a sequential carry across chunks."""
    bsz, s, w = u.shape
    # gates BEFORE padding: padded steps get (log_a=0, b=0) = identity,
    # so the carried state is exact for any (s % chunk).
    log_a, bgate = _rglru_gates(u, p)
    pad = (-s) % chunk
    if pad:
        log_a = F.pad(log_a, (0, 0, 0, pad))
        bgate = F.pad(bgate, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    la_cum, b_cum = _scan_chunks(log_a.reshape(bsz, nc, chunk, w),
                                 bgate.reshape(bsz, nc, chunk, w))
    decay = torch.exp(la_cum)
    h, hs = h0, []
    for c in range(nc):
        h_seq = b_cum[:, c] + decay[:, c] * h[:, None, :]
        h = h_seq[:, -1, :]
        hs.append(h_seq)
    return torch.cat(hs, dim=1)[:, :s], h


def _rglru_seq_parallel(u: torch.Tensor, p: dict, chunk: int, mesh, rules,
                        h0: torch.Tensor | None = None):
    """Sequence-parallel RG-LRU: S sharded over the model axis, B over the
    rules' batch axes (``sharding.rules.shard_grid``).

    Each shard computes its gates and scans its steps on its device with
    the log-depth scan (``_scan_chunks`` over the whole shard, as the
    reference's ``associative_scan`` runs over it; ``chunk`` is unused
    there too): rank 0 of each batch shard from ``h0`` (None: zero), the
    others from zero.  The shards' (summed log-decay, last state) pairs
    run the exclusive ladder (``ssm.decay_ladder``), and each rank but the
    first adds ``exp(cumsum log_a) * h_in`` to its states.

    Returns (h_seq (B, S, w), h_last (B, w)) on ``u``'s device."""
    grid = shard_grid(mesh, rules)
    nb, d = grid.shape
    bsz, s, w = u.shape
    bl = _split_rows(bsz, nb, "batch")
    sl = _split_rows(s, d, "sequence")
    gates = ("lam", "g_a", "b_a", "g_x", "b_x")
    hs_out, h_fins = [], []
    for j in range(nb):
        rows = slice(j * bl, (j + 1) * bl)
        hs, la_cum, la_sum, h_last = [], [], [], []
        for i in range(d):
            dev = grid[j, i]
            p_i = {k: p[k].to(dev) for k in gates}
            log_a, bgate = _rglru_gates(
                u[rows, i * sl:(i + 1) * sl].to(dev), p_i)
            cum = torch.cumsum(log_a, dim=1)                # (b, S_loc, w)
            _, b_cum = _scan_chunks(log_a, bgate)
            if i == 0 and h0 is not None:
                b_cum = b_cum + torch.exp(cum) * h0[rows].to(dev)[:, None, :]
            hs.append(b_cum)
            la_cum.append(cum)
            la_sum.append(cum[:, -1, :])
            h_last.append(b_cum[:, -1, :])
        prefix = decay_ladder(la_sum, h_last)
        for i in range(1, d):
            hs[i] = hs[i] + torch.exp(la_cum[i]) * prefix[i][:, None, :]
        hs_out.append(torch.cat([t.to(u.device) for t in hs], dim=1))
        h_fins.append(hs[-1][:, -1, :].to(u.device))
    return torch.cat(hs_out, dim=0), torch.cat(h_fins, dim=0)


def _rec_mixer(x, p, cfg, state_layer=None):
    """Griffin recurrent block mixer. Returns (out, new_state): no state,
    a prefill into ``state_layer`` (the scan seeded with its ``h``) or a
    one-step decode; ``new_state`` is None without a state."""
    gate = F.gelu(L._proj(x, p["w_branch_gate"]).float(), approximate="tanh")
    u = L._proj(x, p["w_branch_x"])
    conv_tail = state_layer["conv"] if state_layer is not None else None
    u, new_tail = _causal_conv(u, p["conv_w"], p["conv_b"], conv_tail)
    u = u.float()
    s_len = u.shape[1]
    sp = (_seq_parallel_ctx(cfg.rnn_seq_parallel, s_len) if s_len > 1
          else None)
    if state_layer is None:
        if sp is not None:
            h, _ = _rglru_seq_parallel(u, p, cfg.rnn_scan_chunk, sp.mesh,
                                       sp.rules)
        else:
            h0 = torch.zeros((x.shape[0], u.shape[-1]), dtype=torch.float32,
                             device=x.device)
            h, _ = _rglru_chunked(u, p, cfg.rnn_scan_chunk, h0)
        new_state = None
    elif s_len > 1:
        if sp is not None:
            h, h_last = _rglru_seq_parallel(u, p, cfg.rnn_scan_chunk,
                                            sp.mesh, sp.rules,
                                            state_layer["h"])
        else:
            h, h_last = _rglru_chunked(u, p, cfg.rnn_scan_chunk,
                                       state_layer["h"])
        new_state = {"h": h_last, "conv": new_tail}
    else:
        log_a, b = _rglru_gates(u, p)                         # (B, 1, w)
        h1 = torch.exp(log_a[:, 0]) * state_layer["h"] + b[:, 0]
        h = h1[:, None, :]
        new_state = {"h": h1, "conv": new_tail}
    out = (h * gate).to(x.dtype)
    return L._proj(out, p["w_out"]), new_state


# ---------------------------------------------------------------------------
# Blocks / forward
# ---------------------------------------------------------------------------
def _layer(x, p, cfg, kind, *, positions, cache_layer=None):
    h = L.rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
    if kind == "rec":
        h, new_cache = _rec_mixer(h, p["rec"], cfg, cache_layer)
        if new_cache is not None:              # the state, carried in place
            cache_layer["h"].copy_(new_cache["h"])
            cache_layer["conv"].copy_(new_cache["conv"])
    else:
        h, new_cache = L.attention_block(
            h, p["attn"], cfg, positions=positions, causal=True,
            sliding_window=cfg.sliding_window, cache=cache_layer)
    x = x + h
    h = L.rms_norm(x, p["norm2"]["scale"], cfg.norm_eps)
    return x + L.geglu(h, p["mlp"])


def _layer_cache(c: dict, kind: str, ln, i=None) -> dict:
    """One layer's cache: layer ``i`` of a stacked group's (views, so the
    layer writes into the stack), or a tail layer's; an attention layer's
    with the step's ``len``."""
    cl = {k: v if i is None else v[i] for k, v in c.items()}
    if kind == "attn":
        cl["len"] = ln
    return cl


def forward(params: GriffinLM, tokens, cfg, *, prefix_embeds=None,
            cache=None, positions=None, backend: str = "auto"):
    """tokens: (B, S) int.  Returns (logits fp32 (B, S, padded_vocab),
    aux=0, new_cache).  With a cache (``init_cache``'s), positions default
    to cache len + arange(S) and the cache is updated in place (the new
    cache holds the same tensors and the advanced ``len``).  ``backend``
    is accepted for the API's uniform call: no kernel of ours runs on this
    path."""
    dtype = L.as_dtype(cfg.dtype)
    p = L.cast_params(params.param_tree(), dtype)
    pat, _, tail = _pattern(cfg)
    b, s = tokens.shape
    x = p["embed"][tokens].to(dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dtype), x], dim=1)
        s = x.shape[1]
    if cfg.scale_embeddings:
        # sqrt(d) in fp32, rounded to the compute dtype, as the reference
        x = x * float(torch.tensor(math.sqrt(cfg.d_model)).to(dtype))
    if positions is None:
        steps = torch.arange(s, device=x.device, dtype=torch.int32)
        if cache is not None:
            steps = cache["len"] + steps
        positions = steps[None, :].expand(b, s)

    ln = None if cache is None else cache["len"]
    for i, group in enumerate(p["groups"]["layers"]):
        for j, kind in enumerate(pat):
            cl = (None if cache is None else
                  _layer_cache(cache["groups"][f"b{j}"], kind, ln, i))
            x = _layer(x, group[f"b{j}"], cfg, kind, positions=positions,
                       cache_layer=cl)
    for j, kind in enumerate(tail):
        cl = (None if cache is None else
              _layer_cache(cache["tail"][f"b{j}"], kind, ln))
        x = _layer(x, p["tail"][f"b{j}"], cfg, kind, positions=positions,
                   cache_layer=cl)

    x = L.rms_norm(x, p["final_norm"]["scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ p["embed"].to(dtype).T
    else:
        logits = x @ p["lm_head"].to(dtype)
    logits = L.softcap(logits.float(), cfg.logits_softcap)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    if cache is None:
        return logits, aux, None
    return logits, aux, {**cache, "len": ln + s}


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """The decode state, on the card unless ``device`` names another:
    ``{"groups": {"b{j}": ...}, "len", ["tail": {"b{j}": ...}]}``, a ring
    of ``min(sliding_window, max_len)`` slots (``dtype``) for an attention
    layer, the RG-LRU state (fp32) for a recurrent one; the groups'
    stacked on a leading axis, the tail's not."""
    dev = resolve_device(device)
    pat, n_groups, tail = _pattern(cfg)
    window = min(cfg.sliding_window or max_len, max_len)

    def layer_cache(kind, n):
        if kind == "attn":
            c = ring_kv_cache(n, batch, window, cfg.num_kv_heads,
                              cfg.head_dim, dtype, dev)
            del c["len"]
            return c
        return rglru_state(n, batch, cfg.rnn_width, cfg.conv_kernel,
                           device=dev)

    cache = {"groups": {f"b{j}": layer_cache(kind, n_groups)
                        for j, kind in enumerate(pat)},
             "len": torch.zeros((), dtype=torch.int32, device=dev)}
    if tail:
        cache["tail"] = {f"b{j}": {k: v[0] for k, v in
                                   layer_cache(kind, 1).items()}
                         for j, kind in enumerate(tail)}
    return cache

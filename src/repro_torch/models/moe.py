"""Mixture-of-Experts block: sort-based capacity dispatch.

Port of ``repro/models/moe.py``'s mesh-free path (the expert-parallel
``shard_map`` path comes with the sharding item, ROADMAP 1.9b; the port
has no sharding context, so nothing reaches it).

Dispatch is sort-based: a *stable* argsort over the flat token -> expert
assignments (the reference's ``jnp.argsort`` is stable) gives each
assignment its position in its expert's buffer, and the first ``cap`` of
each expert are kept.  Tokens over capacity are dropped: their slot is the
buffer's one spare row, thrown away.  Each token's k expert outputs are
summed in assignment order, k adds in the compute dtype (the reference's
``segment_sum`` rounds after each add); no atomics, so a bf16 run gives
the same bits every time.

Capacity: cap = ceil(T * k / E * capacity_factor), rounded up to 8.  A
Switch-style load-balance aux loss is returned.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def moe_params(gen: torch.Generator, cfg, dtype=torch.float32) -> dict:
    d, fe, e = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    p = {
        "router": dense_init(gen, (d, e), in_axis=0, dtype=torch.float32),
        "we_gate": dense_init(gen, (e, d, fe), in_axis=1, dtype=dtype),
        "we_up": dense_init(gen, (e, d, fe), in_axis=1, dtype=dtype),
        "we_down": dense_init(gen, (e, fe, d), in_axis=1, dtype=dtype),
    }
    if cfg.num_shared_experts:
        fs = fe * cfg.num_shared_experts
        p["ws_gate"] = dense_init(gen, (d, fs), in_axis=0, dtype=dtype)
        p["ws_up"] = dense_init(gen, (d, fs), in_axis=0, dtype=dtype)
        p["ws_down"] = dense_init(gen, (fs, d), in_axis=0, dtype=dtype)
    return p


def _capacity(num_tokens: int, cfg) -> int:
    cap = num_tokens * cfg.num_experts_per_token / cfg.num_experts
    cap = int(cap * cfg.capacity_factor) + 1
    return max(8, -(-cap // 8) * 8)


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, cfg):
    """Returns (weights (T, k), experts (T, k), aux_loss scalar), in fp32.

    The top k are taken by a stable descending sort: among equal
    probabilities the lower expert comes first, as ``lax.top_k`` does."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    k = cfg.num_experts_per_token
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = ranked[:, :k], order[:, :k]
    weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    e = cfg.num_experts
    one_hot = experts[:, :1] == torch.arange(e, device=experts.device)
    dispatch_frac = one_hot.float().mean(dim=0)
    prob_frac = probs.mean(dim=0)
    aux = e * torch.sum(dispatch_frac * prob_frac)
    return weights, experts, aux


def _expert_ffn(buf: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """buf: (E_local, cap, d) -> (E_local, cap, d); batched SwiGLU."""
    gate = torch.bmm(buf, wg)
    up = torch.bmm(buf, wu)
    h = F.silu(gate.float()).to(buf.dtype) * up
    return torch.bmm(h, wd)


def _dispatch_compute_combine(x_flat, weights, experts, wg, wu, wd, cfg, *,
                              lo: int, e_local: int):
    """Sort-based dispatch for experts [lo, lo+e_local); returns (T, d)."""
    t, d = x_flat.shape
    k = cfg.num_experts_per_token
    n = t * k
    cap = _capacity(t, cfg)

    e_flat = experts.reshape(-1)
    w_flat = weights.reshape(-1).to(x_flat.dtype)

    # position of each assignment within its expert's buffer; an
    # expert's start is where it first appears in sorted order (the
    # reference's exclusive cumsum of a bincount, which would read the
    # assignments' max back to the host on the card)
    perm = torch.argsort(e_flat, stable=True)
    ranks = torch.empty_like(perm).scatter_(
        0, perm, torch.arange(n, device=e_flat.device))
    starts = torch.searchsorted(e_flat[perm], torch.arange(
        cfg.num_experts, device=e_flat.device, dtype=e_flat.dtype))
    pos = ranks - starts[e_flat]

    local_e = e_flat - lo
    valid = (local_e >= 0) & (local_e < e_local) & (pos < cap)
    slot = torch.where(valid, local_e * cap + pos,
                       torch.full_like(pos, e_local * cap))  # OOB -> drop

    # one spare row (index e_local * cap) takes every dropped assignment
    buf = x_flat.new_zeros((e_local * cap + 1, d))
    buf.index_copy_(0, slot, x_flat[:, None].expand(t, k, d).reshape(n, d))
    out = _expert_ffn(buf[:-1].view(e_local, cap, d), wg, wu, wd)
    out_flat = out.reshape(e_local * cap, d)

    y = torch.where(valid[:, None],
                    out_flat[torch.clamp(slot, max=e_local * cap - 1)],
                    x_flat.new_zeros(())) * w_flat[:, None]
    y = y.view(t, k, d)
    acc = x_flat.new_zeros((t, d))
    for j in range(k):                 # segment_sum's adds, in order
        acc = acc + y[:, j]
    return acc


def _shared_expert(x_flat, p):
    gate = x_flat @ p["ws_gate"]
    up = x_flat @ p["ws_up"]
    h = F.silu(gate.float()).to(x_flat.dtype) * up
    return h @ p["ws_down"]


def moe_block(x: torch.Tensor, p: dict, cfg):
    """MoE FFN. x: (B, S, d). Returns (out, aux_loss)."""
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    weights, experts, aux = _route(x_flat, p["router"], cfg)
    out = _dispatch_compute_combine(
        x_flat, weights, experts, p["we_gate"], p["we_up"], p["we_down"],
        cfg, lo=0, e_local=cfg.num_experts)
    if cfg.num_shared_experts:
        out = out + _shared_expert(x_flat, p)
    return out.reshape(b, s, d), aux


def moe_block_plain(x: torch.Tensor, p: dict, cfg):
    """``moe_block``'s output restated without the sort: the plain version
    the card checks hold the dispatch against.  Returns (out, dropped).

    Each token's k experts by repeated first-argmax (the lower expert wins
    a tie); each expert keeps its assignments in flat order (token t's
    j-th is ``t * k + j``) up to the capacity and drops the rest
    (``dropped`` counts them); each kept assignment's SwiGLU, weighted, is
    summed over j in order, then the shared expert is added.  A loop over
    the experts and the k slots; it reads the kept sets back to the host.
    """
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    t, k, e = b * s, cfg.num_experts_per_token, cfg.num_experts
    probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)
    left, experts, weights = probs.clone(), [], []
    for _ in range(k):
        top = left.argmax(dim=-1)
        experts.append(top)
        weights.append(probs.gather(1, top[:, None])[:, 0])
        left.scatter_(1, top[:, None], -1.0)
    experts = torch.stack(experts, 1).reshape(-1)           # (t * k,)
    w = torch.stack(weights, 1)
    w = (w / (w.sum(dim=-1, keepdim=True) + 1e-9)).reshape(-1).to(x.dtype)
    cap = _capacity(t, cfg)
    y = xf.new_zeros((t * k, d))
    kept = 0
    for ex in range(e):
        mine = torch.nonzero(experts == ex)[:cap, 0]
        kept += mine.numel()
        rows = xf[mine // k]
        gate = rows @ p["we_gate"][ex]
        h = F.silu(gate.float()).to(x.dtype) * (rows @ p["we_up"][ex])
        y[mine] = (h @ p["we_down"][ex]) * w[mine, None]
    y = y.view(t, k, d)
    out = xf.new_zeros((t, d))
    for j in range(k):
        out = out + y[:, j]
    if cfg.num_shared_experts:
        out = out + _shared_expert(xf, p)
    return out.reshape(b, s, d), t * k - kept

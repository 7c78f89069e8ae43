"""Mamba-2 (SSD, state-space duality): the attention-free ssm family.

Port of ``repro/models/ssm.py``.  The model is an
``nn.Module`` (``Mamba2LM``: the embedding, a ``ModuleList`` of
``Mamba2Block`` and the final norm) whose parameters carry the
reference's pytree names, so ``param_tree()`` gives back the nested dict
the plain functions below take.  ``forward`` casts it to ``cfg.dtype``
on every call, as the reference does (``layers.cast_params``: ``A_log``,
``D`` and ``dt_bias`` stay fp32), and runs the layers in a plain loop
(the reference's ``scan_layers`` changes how XLA compiles it, not what it
computes).  Without a cache each layer runs under ``cfg.remat`` when it
trains (``layers.remat``): under "full" the backward runs the layer
again, K5 included (two K5 launches a layer a step, one K5-bwd); under
"dots" K5's outputs are kept like a matmul's and K5 runs once.

The SSD chunked scan of each layer (``ssd_chunked``) goes through
``kernels.ops.ssd_scan``, which runs K5 (``kernels/ssd_scan.py``) for a
CUDA tensor: one launch per layer per prefill or forward, none per decode
step, whose single-step recurrence is plain torch.

Training keeps the parameters in the reference's layout (the layers
stacked on a leading L axis, ``stack_layers``) and runs
``Mamba2LM.over`` them: a model whose parameters are views of the stacked
tensors, whose gradients ``grad_tree`` stacks back.  Under autograd a CUDA
scan runs through ``SSDScanFunction`` (K5 forward, K5-bwd backward).

Shapes: d_inner = expand * d_model; H = d_inner / ssm_head_dim heads;
B/C projections are per group (ssm_groups, ssm_state).  fp32 state math.

With ``cfg.ssm_seq_parallel`` under a ``sharding_context`` whose model
axis divides S, a prefill or forward runs ``ssd_seq_parallel``: B split
over the rules' batch axes, S over the model axis, each shard's chunked
scan (K5 on the card) on its device of the mesh, then the shards'
boundary states carried across by an exclusive Hillis-Steele ladder and
folded into each shard's outputs.  A mesh listing one card four times
runs four K5 launches a layer on it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import segsum_decay as _segsum_decay  # noqa: F401
from repro_torch.models import layers as L
from repro_torch.models.cache import ssm_state
from repro_torch.sharding.rules import (
    current_context, note_collective, shard_grid,
)


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    conv_ch = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_in, nheads, conv_ch


def layer_params(gen: torch.Generator, cfg, dtype=torch.float32) -> dict:
    """One layer's parameters, drawn on ``gen``'s device."""
    d = cfg.d_model
    d_in, nheads, conv_ch = _dims(cfg)
    proj_out = 2 * d_in + 2 * cfg.ssm_groups * cfg.ssm_state + nheads
    dev = gen.device
    return {
        "norm": L.norm_params(d, False, dtype, dev),
        "in_proj": L.dense_init(gen, (d, proj_out), in_axis=0, dtype=dtype),
        "conv_w": L.dense_init(gen, (cfg.conv_kernel, conv_ch), in_axis=0,
                               dtype=dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.zeros((nheads,), device=dev),         # A = -exp(0) = -1
        "D": torch.ones((nheads,), device=dev),
        "dt_bias": torch.zeros((nheads,), device=dev),
        "ssm_norm": L.norm_params(d_in, False, dtype, dev),
        "out_proj": L.dense_init(gen, (d_in, d), in_axis=0, dtype=dtype),
    }


def _param_dict(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})


class Mamba2Block(nn.Module):
    """One layer's parameters under the reference's leaf names."""

    LEAVES = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
              "out_proj")
    NORMS = ("norm", "ssm_norm")

    def __init__(self, tree: dict):
        super().__init__()
        for k in self.LEAVES:
            setattr(self, k, nn.Parameter(tree[k]))
        for k in self.NORMS:
            setattr(self, k, _param_dict(tree[k]))

    def param_tree(self) -> dict:
        t = {k: getattr(self, k) for k in self.LEAVES}
        t.update({k: dict(getattr(self, k).items()) for k in self.NORMS})
        return t


class Mamba2LM(nn.Module):
    """The Mamba-2 language model: fp32 master parameters and ``cfg``.

    ``tree`` is the nested parameter dict of ``init_params`` (layers as a
    list of per-layer dicts); ``models/convert.py`` builds one from the
    reference's stacked numpy pytree."""

    def __init__(self, cfg, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(tree["embed"])
        self.final_norm = _param_dict(tree["final_norm"])
        self.layers = nn.ModuleList(Mamba2Block(t) for t in tree["layers"])
        if len(self.layers) != cfg.num_layers:
            raise ValueError(f"{len(self.layers)} layers for a "
                             f"{cfg.num_layers}-layer config")
        self.lm_head = (None if cfg.tie_embeddings
                        else nn.Parameter(tree["lm_head"]))

    def param_tree(self) -> dict:
        t = {"embed": self.embed, "final_norm": dict(self.final_norm.items()),
             "layers": [blk.param_tree() for blk in self.layers]}
        if self.lm_head is not None:
            t["lm_head"] = self.lm_head
        return t

    def forward(self, tokens, cache=None, *, backend: str = "auto"):
        return forward(self, tokens, self.cfg, cache=cache, backend=backend)

    @classmethod
    def over(cls, cfg, params: dict) -> "Mamba2LM":
        """The model over ``params`` in the reference's layout (layers
        stacked on a leading L axis, as ``stack_layers`` gives them): its
        parameters are views of those tensors, so an in-place update of
        ``params`` is an update of the model.  What a train step runs."""
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


LM = Mamba2LM
stack_layers = L.stack_layers
unstack_layers = L.unstack_layers


def init_params(gen: torch.Generator, cfg, dtype=torch.float32) -> Mamba2LM:
    """Random weights from ``gen`` (a seeded ``torch.Generator``), on its
    device."""
    tree = {
        "embed": L.embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype),
        "final_norm": L.norm_params(cfg.d_model, False, dtype, gen.device),
        "layers": [layer_params(gen, cfg, dtype)
                   for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = L.dense_init(
            gen, (cfg.d_model, cfg.padded_vocab), in_axis=0, dtype=dtype)
    return Mamba2LM(cfg, tree)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None = None):
    """Depthwise causal conv1d. x: (B, S, C); w: (K, C).

    tail: (B, K-1, C) previous inputs (decode); returns (y, new_tail).
    A float32 tail promotes the sum to float32, as in the reference.
    """
    k = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    new_tail = xp[:, -(k - 1):, :] if k > 1 else tail
    return y + b, new_tail


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None, *,
                backend: str = "auto"):
    """Chunked SSD scan (fp32), through ``ops.ssd_scan`` (K5 on the card).

    x:  (B, S, H, P) values            dt: (B, S, H) positive step sizes
    A:  (H,) negative decay rates      Bm/Cm: (B, S, G, N)
    h0: optional (B, H, N, P) initial state (prefill-into-state).
    Returns (y (B, S, H, P), h_last (B, H, N, P)).
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T;  y_t = C_t h_t.
    S is padded to a multiple of ``chunk`` with dt = 0 (identity steps).
    """
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    y, h_last = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                             h0=None if h0 is None else h0.contiguous(),
                             backend=backend)
    return y[:, :s], h_last


def _note_permute(log_decay: torch.Tensor, state: torch.Tensor) -> None:
    """A (log-decay, state) pair moved to another rank's device."""
    note_collective("collective-permute",
                    log_decay.numel() * log_decay.element_size()
                    + state.numel() * state.element_size(), mirrored=True)


def decay_ladder(log_decays: list, states: list) -> list:
    """The exclusive prefix over sequence shards of (log-decay, state)
    pairs, by a Hillis-Steele ladder: rank i receives the state that
    everything before it leaves at its boundary, on rank i's device (None
    for rank 0: nothing comes before it).

    ``log_decays[i]`` is rank i's summed log-decay over its steps (B, H)
    or (B, w), ``states[i]`` its final state from a zero start (B, H, N,
    P) or (B, w).  Composing an earlier interval (in) with a later one
    decays the incoming state through the later:
    ``hs = exp(ld) * hs_in + hs; ld = ld + ld_in``.  log2(D) rounds, each
    combining rank i with rank i - step as the reference's ``ppermute``
    ladder does; a rank whose partner is rank 0's empty prefix keeps its
    value, which the reference reaches by adding zeros.  Each move of a
    (log-decay, state) pair to the next rank is a collective-permute of a
    multi-process run (``note_collective``)."""
    d = len(states)
    for i in range(1, d):               # rank i - 1's pair moves to rank i
        _note_permute(log_decays[i - 1], states[i - 1])
    ld = [None] + [log_decays[i - 1].to(states[i].device)
                   for i in range(1, d)]
    hs = [None] + [states[i - 1].to(states[i].device) for i in range(1, d)]
    step = 1
    while step < d:
        new_ld, new_hs = list(ld), list(hs)
        for i in range(step, d):
            if ld[i - step] is None:
                continue
            _note_permute(ld[i - step], hs[i - step])
            dev = hs[i].device
            decay = torch.exp(ld[i])
            decay = decay.reshape(decay.shape
                                  + (1,) * (hs[i].ndim - decay.ndim))
            new_hs[i] = decay * hs[i - step].to(dev) + hs[i]
            new_ld[i] = ld[i] + ld[i - step].to(dev)
        ld, hs = new_ld, new_hs
        step *= 2
    return hs


def _split_rows(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} of {n} does not split into {parts} shards")
    return n // parts


def ssd_seq_parallel(xh, dt, A, Bm, Cm, chunk: int, mesh, rules, h0=None, *,
                     backend: str = "auto"):
    """Sequence-parallel SSD: S sharded over the model axis, B over the
    rules' batch axes (``sharding.rules.shard_grid``).

    Each shard runs ``ssd_chunked`` (K5 on the card) on its device: rank
    0 of each batch shard from the incoming ``h0`` (None: zero), every
    other rank from a zero state (``h0=None``).  The shards' (summed
    log-decay, final state) pairs then run the exclusive ladder
    (``decay_ladder``), and each rank but the first folds its incoming
    state into its outputs, ``y += (C . hs) * exp(cumsum a)``.  The final
    state is the last rank's inclusive prefix.

    Returns (y (B, S, H, P), h_final (B, H, N, P)) on ``xh``'s device.
    """
    grid = shard_grid(mesh, rules)
    nb, d = grid.shape
    b, s, h, pdim = xh.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hg = h // g
    bl = _split_rows(b, nb, "batch")
    sl = _split_rows(s, d, "sequence")
    ys, h_fins = [], []
    for j in range(nb):
        rows = slice(j * bl, (j + 1) * bl)
        y_loc, h_last, a_loc, a_sum, c_loc = [], [], [], [], []
        for i in range(d):
            dev = grid[j, i]
            steps = slice(i * sl, (i + 1) * sl)

            def part(t):
                return t[rows, steps].to(dev)

            x_i, dt_i, B_i, C_i = part(xh), part(dt), part(Bm), part(Cm)
            A_i = A.to(dev)
            h_i = h0[rows].to(dev) if (i == 0 and h0 is not None) else None
            y, hl = ssd_chunked(x_i, dt_i, A_i, B_i, C_i, chunk, h0=h_i,
                                backend=backend)
            a = dt_i * A_i                                  # (b, S_loc, H)
            y_loc.append(y)
            h_last.append(hl)
            a_loc.append(a)
            a_sum.append(a.sum(dim=1))
            c_loc.append(C_i)
        prefix = decay_ladder(a_sum, h_last)
        out = [y_loc[0]]
        for i in range(1, d):
            corr = torch.einsum("bsgn,bghnp->bsghp", c_loc[i],
                                prefix[i].reshape(bl, g, hg, n, pdim))
            decay = torch.exp(torch.cumsum(a_loc[i], dim=1))
            corr = corr * decay.reshape(bl, sl, g, hg)[..., None]
            out.append(y_loc[i] + corr.reshape(bl, sl, h, pdim))
        last = h_last[-1] if d == 1 else (
            torch.exp(a_sum[-1])[..., None, None] * prefix[-1] + h_last[-1])
        ys.append(torch.cat([t.to(xh.device) for t in out], dim=1))
        h_fins.append(last.to(xh.device))
    return torch.cat(ys, dim=0), torch.cat(h_fins, dim=0)


def _seq_parallel_ctx(enabled: bool, s: int):
    """The sharding context when a sequence-parallel scan applies: the
    flag is set, a context is present and its model axis divides S (the
    reference's condition); None otherwise, where the single-device scan
    runs."""
    ctx = current_context()
    if not enabled or ctx is None:
        return None
    tp = ctx.rules.present(ctx.mesh, ctx.rules.tp_axes)[0]
    return ctx if s % ctx.mesh.shape[tp] == 0 else None


def _mixer(x, p, cfg, state_layer=None, *, backend: str = "auto"):
    """Mamba-2 mixer. x: (B, S, d). Returns (out, new_state_layer)."""
    b, s, d = x.shape
    d_in, nheads, conv_ch = _dims(cfg)
    g, n, phd = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim

    proj = x @ p["in_proj"]
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + conv_ch]
    dt = proj[..., d_in + conv_ch:]
    conv_tail = state_layer["conv"] if state_layer is not None else None
    xbc, new_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_tail)
    xbc = F.silu(xbc.float()).to(x.dtype)
    xs = xbc[..., :d_in]
    Bm = xbc[..., d_in:d_in + g * n].reshape(b, s, g, n)
    Cm = xbc[..., d_in + g * n:].reshape(b, s, g, n)
    dt = F.softplus(dt.float() + p["dt_bias"])                    # (B,S,H)
    A = -torch.exp(p["A_log"])                                    # (H,)
    xh = xs.reshape(b, s, nheads, phd).float()
    Bm32, Cm32 = Bm.float(), Cm.float()

    sp = _seq_parallel_ctx(cfg.ssm_seq_parallel, s)

    def scan(h0=None):
        if sp is not None:
            return ssd_seq_parallel(xh, dt, A, Bm32, Cm32, cfg.ssm_chunk,
                                    sp.mesh, sp.rules, h0=h0,
                                    backend=backend)
        return ssd_chunked(xh, dt, A, Bm32, Cm32, cfg.ssm_chunk, h0=h0,
                           backend=backend)

    if state_layer is None:
        y, _ = scan()
        new_state = None
    elif s > 1:
        # prefill into an existing state: chunked scan seeded with it.
        # Note: prefill assumes an empty conv tail (fresh sequence).
        y, h_last = scan(state_layer["h"].transpose(-1, -2))
        new_state = {"h": h_last.transpose(-1, -2), "conv": new_tail}
    else:
        # decode: s == 1 single-step recurrence (plain torch)
        h0 = state_layer["h"]                                     # (B,H,P,N)
        a = torch.exp(dt[:, 0] * A)                               # (B,H)
        hg = nheads // g
        xdt = (xh[:, 0] * dt[:, 0][..., None]).reshape(b, g, hg, phd)
        binp = torch.einsum("bgn,bghp->bghpn", Bm32[:, 0], xdt)
        h1 = h0 * a[..., None, None] + binp.reshape(b, nheads, phd, n)
        y = torch.einsum("bgn,bghpn->bghp", Cm32[:, 0],
                         h1.reshape(b, g, hg, phd, n)).reshape(
                             b, 1, nheads, phd)
        new_state = {"h": h1, "conv": new_tail}
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(b, s, d_in).to(x.dtype)
    y = L.rms_norm(y * F.silu(z.float()).to(x.dtype),
                   p["ssm_norm"]["scale"], cfg.norm_eps)
    return y @ p["out_proj"], new_state


def _block(x, p, cfg, state_layer=None, *, backend: str = "auto"):
    h = L.rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    h, new_state = _mixer(h, p, cfg, state_layer, backend=backend)
    return x + h, new_state


def forward(params: Mamba2LM, tokens, cfg, *, prefix_embeds=None,
            cache=None, positions=None, backend: str = "auto"):
    """Returns (logits fp32 (B, S, padded_vocab), aux=0, new_cache).

    cache = ``init_cache``'s dict.  ``backend`` picks the SSD scan's
    implementation (``ops.ssd_scan``).  ``positions`` is accepted and
    unused, as in the reference."""
    dtype = L.as_dtype(cfg.dtype)
    p = L.cast_params(params.param_tree(), dtype)
    x = p["embed"][tokens].to(dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dtype), x], dim=1)

    if cache is None:
        def body(h, p_layer):
            return _block(h, p_layer, cfg, backend=backend)[0]

        body = L.remat(body, cfg)
        for p_layer in p["layers"]:
            x = body(x, p_layer)
        new_cache = None
    else:
        hs, convs = [], []
        for i, p_layer in enumerate(p["layers"]):
            x, st = _block(x, p_layer, cfg,
                           {"h": cache["h"][i], "conv": cache["conv"][i]},
                           backend=backend)
            hs.append(st["h"])
            convs.append(st["conv"])
        new_cache = {"h": torch.stack(hs), "conv": torch.stack(convs),
                     "len": cache["len"] + tokens.shape[1]}

    x = L.rms_norm(x, p["final_norm"]["scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ p["embed"].to(dtype).T
    else:
        logits = x @ p["lm_head"].to(dtype)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits.float(), aux, new_cache


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """The decode state (fp32, whatever ``dtype`` says, as the reference);
    on the card unless ``device`` names another."""
    d_in, nheads, conv_ch = _dims(cfg)
    return ssm_state(cfg.num_layers, batch, nheads, cfg.ssm_head_dim,
                     cfg.ssm_state, conv_ch, cfg.conv_kernel,
                     device=resolve_device(device))

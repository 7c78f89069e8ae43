"""Mamba-2 (SSD, state-space duality): the attention-free ssm family.

Port of ``repro/models/ssm.py``.  The model is an
``nn.Module`` (``Mamba2LM``: the embedding, a ``ModuleList`` of
``Mamba2Block`` and the final norm) whose parameters carry the
reference's pytree names, so ``param_tree()`` gives back the nested dict
the plain functions below take.  ``forward`` casts it to ``cfg.dtype``
on every call, as the reference does (``layers.cast_params``: ``A_log``,
``D`` and ``dt_bias`` stay fp32), and runs the layers in a plain loop:
the reference's ``scan_layers`` and ``remat`` change how XLA compiles it,
not what it computes.

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
The sequence-parallel scan (``ssd_seq_parallel``) comes with the mesh
side of training (ROADMAP 1.9, sharding): ``cfg.ssm_seq_parallel``
raises.
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

    if state_layer is None:
        y, _ = ssd_chunked(xh, dt, A, Bm32, Cm32, cfg.ssm_chunk,
                           backend=backend)
        new_state = None
    elif s > 1:
        # prefill into an existing state: chunked scan seeded with it.
        # Note: prefill assumes an empty conv tail (fresh sequence).
        y, h_last = ssd_chunked(xh, dt, A, Bm32, Cm32, cfg.ssm_chunk,
                                h0=state_layer["h"].transpose(-1, -2),
                                backend=backend)
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
    if cfg.ssm_seq_parallel:
        raise NotImplementedError(
            "ssm_seq_parallel: the sequence-parallel SSD scan "
            "(ssd_seq_parallel) is not ported yet: it comes with the "
            "sharding item of ROADMAP 1.9")
    dtype = L.as_dtype(cfg.dtype)
    p = L.cast_params(params.param_tree(), dtype)
    x = p["embed"][tokens].to(dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dtype), x], dim=1)

    if cache is None:
        for p_layer in p["layers"]:
            x, _ = _block(x, p_layer, cfg, backend=backend)
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

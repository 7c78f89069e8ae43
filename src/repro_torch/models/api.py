"""Family dispatch: one uniform API over the model families.

Port of ``repro/models/api.py``:

  init_params(gen, cfg)                  -> params (an nn.Module)
  forward(params, batch, cfg, cache)     -> (logits, aux, new_cache)
  init_cache(cfg, batch, max_len, ...)   -> decode-state dict
  prefill / decode_step                  -> serving entry points
  loss_fn(params, batch, cfg)            -> (scalar, metrics)

and, for training, the parameters in the reference's layout (layers
stacked): ``stacked_params(model)`` copies them out, ``model_over(params,
cfg)`` is a model whose parameters are views of them.

batch keys: "tokens" (B, S) int, "labels" (B, S) int and an optional
"loss_mask" (B, S); "prefix_embeds" (B, P, d) and "positions" pass
through.  Only the ssm family (Mamba-2) is ported; every other family
raises ``NotImplementedError`` (ROADMAP 1.9).  ``backend`` (forward,
prefill, loss_fn) picks the SSD scan's implementation
(``kernels.ops.ssd_scan``: K5 on the card, with K5-bwd under autograd).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import ssm

_FAMILY = {"ssm": ssm}


def module_for(cfg):
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP 1.9); ported families: {sorted(_FAMILY)}")
    return _FAMILY[cfg.family]


def init_params(gen: torch.Generator, cfg, dtype=torch.float32):
    """Random weights from a seeded ``torch.Generator``, on its device."""
    return module_for(cfg).init_params(gen, cfg, dtype)


def forward(params, batch, cfg, cache=None, *, backend: str = "auto"):
    mod = module_for(cfg)
    kw = {k: batch[k] for k in ("prefix_embeds", "positions") if k in batch}
    return mod.forward(params, batch["tokens"], cfg, cache=cache,
                       backend=backend, **kw)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """On the card unless ``device`` names another."""
    return module_for(cfg).init_cache(cfg, batch, max_len, dtype,
                                      device=device)


@torch.no_grad()
def prefill(params, batch, cfg, cache, *, backend: str = "auto"):
    """Run the prompt through the model, filling the cache.

    Returns (last-position logits (B, V), new_cache).
    """
    logits, _, new_cache = forward(params, batch, cfg, cache=cache,
                                   backend=backend)
    return logits[:, -1, :], new_cache


@torch.no_grad()
def decode_step(params, tokens, cfg, cache):
    """One decode step. tokens: (B, 1). Returns (logits (B, V), new_cache).

    The single-step recurrence is plain torch: no scan kernel runs."""
    logits, _, new_cache = forward(params, {"tokens": tokens}, cfg,
                                   cache=cache)
    return logits[:, -1, :], new_cache


def stacked_params(params) -> dict:
    """The model's parameters in the reference's layout (a detached copy,
    layers stacked on a leading L axis): a train state's ``params``."""
    return module_for(params.cfg).stack_layers(params.param_tree())


def model_over(params: dict, cfg):
    """The model whose parameters are views of ``params`` (the
    reference's layout): what a train step differentiates."""
    return module_for(cfg).Mamba2LM.over(cfg, params)


def loss_fn(params, batch, cfg, *, backend: str = "auto"):
    """Causal-LM cross entropy (fp32), prefix positions masked for VLM.

    ``params`` is the model.  Returns (total_loss, metrics dict) with
    ``loss``, ``aux_loss`` and ``tokens`` (the mask's sum)."""
    logits, aux, _ = forward(params, batch, cfg, backend=backend)
    labels = batch["labels"].long()
    s_total = logits.shape[1]
    if labels.shape[1] < s_total:               # multimodal prefix present
        pad = s_total - labels.shape[1]
        labels = F.pad(labels, (pad, 0))
        mask = F.pad(torch.ones(batch["labels"].shape, dtype=torch.float32,
                                device=logits.device), (pad, 0))
    else:
        mask = batch.get("loss_mask")
        mask = (torch.ones(labels.shape, dtype=torch.float32,
                           device=logits.device)
                if mask is None else mask.float())
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt_logit = torch.gather(logits, -1, labels[..., None])[..., 0]
    ll = tgt_logit - lse
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = -(ll * mask).sum() / denom
    total = ce + cfg.router_aux_coef * aux
    return total, {"loss": ce, "aux_loss": aux, "tokens": denom}

"""Family dispatch: one uniform API over the model families.

Port of ``repro/models/api.py`` for serving:

  init_params(gen, cfg)                  -> params (an nn.Module)
  forward(params, batch, cfg, cache)     -> (logits, aux, new_cache)
  init_cache(cfg, batch, max_len, ...)   -> decode-state dict
  prefill / decode_step                  -> serving entry points

batch keys: "tokens" (B, S) int; "prefix_embeds" (B, P, d) and
"positions" pass through.  Only the ssm family (Mamba-2) is ported; every
other family raises ``NotImplementedError`` (ROADMAP 1.9), as does
``loss_fn``, which comes with training.  ``backend`` (forward and
prefill) picks the SSD scan's implementation (``kernels.ops.ssd_scan``:
K5 on the card).
"""

from __future__ import annotations

import torch

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

"""Serving steps: batched prefill + greedy decode.

Port of ``repro/train/serve_step.py``.  ``make_serve_fns(cfg)`` returns
(prefill_fn, decode_fn):

  prefill_fn(params, batch, cache)          -> (next_tokens, cache)
  decode_fn(params, tokens, cache)          -> (next_tokens, cache)

Sampling is greedy (argmax, int32), deterministic.  ``decode_loop`` runs
N steps as a Python loop of ``decode_fn`` (the reference's ``lax.scan``);
each step launches its kernels eagerly.
"""

from __future__ import annotations

import torch

from repro_torch.models import api


def make_serve_fns(cfg, *, backend: str = "auto"):
    """``backend`` picks the prefill's SSD scan (``api.prefill``); decode
    runs no kernel of ours."""
    def prefill_fn(params, batch, cache):
        logits, cache = api.prefill(params, batch, cfg, cache,
                                    backend=backend)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    def decode_fn(params, tokens, cache):
        logits, cache = api.decode_step(params, tokens, cfg, cache)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return prefill_fn, decode_fn


def decode_loop(params, first_tokens, cache, cfg, num_steps: int):
    """Greedy-decode ``num_steps`` tokens after ``first_tokens`` (B,).

    Returns (tokens (B, num_steps) int32, final_cache).
    """
    _, decode_fn = make_serve_fns(cfg)
    toks, out = first_tokens, []
    for _ in range(num_steps):
        toks, cache = decode_fn(params, toks[:, None], cache)
        out.append(toks)
    if not out:
        return first_tokens.new_zeros((first_tokens.shape[0], 0)), cache
    return torch.stack(out, dim=1), cache

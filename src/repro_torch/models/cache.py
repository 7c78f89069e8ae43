"""Decode-time state of the SSM family.

Port of ``repro/models/cache.py``'s ``ssm_state`` and ``cache_bytes``,
with the same layouts: states are stacked along a leading layer dim L;
``len`` is a scalar int32, the number of tokens already written.  KV
caches and ring buffers come with the attention families (ROADMAP 1.9).
"""

from __future__ import annotations

import torch


def ssm_state(num_layers: int, batch: int, num_heads: int, head_dim: int,
              state: int, conv_channels: int, conv_kernel: int,
              dtype=torch.float32, device=None) -> dict:
    """Mamba-2 decode state: SSD state ``h`` (L, B, H, P, N) and the
    causal-conv tail ``conv`` (L, B, K-1, C)."""
    return {
        "h": torch.zeros((num_layers, batch, num_heads, head_dim, state),
                         dtype=dtype, device=device),
        "conv": torch.zeros((num_layers, batch, conv_kernel - 1,
                             conv_channels), dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_bytes(tree) -> int:
    """Bytes held by the tensors of a (nested) cache."""
    if isinstance(tree, dict):
        return sum(cache_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(cache_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()

"""Decode-time state: KV caches, ring buffers, SSM and RG-LRU states.

Port of ``repro/models/cache.py``, with the same layouts: caches are
stacked along a leading layer dim L; ``len`` is a scalar int32 on the
device, the number of tokens already written (= the absolute position of
the next token).  KV caches store bf16 by default (attention accumulates
in fp32); sliding-window layers use a ring of exactly ``window`` slots.

Writes are in place (``index_copy_`` at slots computed on the device from
``len``): a step writes the positions at and past the ``len`` it was
given, which no step reads before writing them, so a KV cache may be
decoded from again (a ring, whose slots are reused, and Griffin's RG-LRU
state, updated in place, may not).  A transformer's cache is a
``KVCache``, which also counts on the host the positions written: a
write past the end raises before any launch, where the reference's
``dynamic_update_slice`` clamps it onto the last slots.  An
encoder-decoder's cache is an ``EncDecCache``, which counts its
decoder's self-attention positions the same way; its cross K/V are
written once, at prefill, and are no positions.
"""

from __future__ import annotations

import torch

# Sentinel absolute position for never-written ring slots: larger than any
# real position, so causal masking (pos_kv <= pos_q) hides them.
EMPTY_SLOT: int = 2**30


class KVCache(dict):
    """A transformer's decode cache, ``{"seg{i}": {"k", "v", "len"}}`` as
    the reference lays it out, and ``written``: the positions written, as
    the host counts them (``len`` on the device holds the same number)."""

    def __init__(self, segs: dict, written: int = 0):
        super().__init__(segs)
        self.written = int(written)

    @property
    def max_len(self) -> int:
        return min(seg["k"].shape[2] for seg in self.values())

    def check_room(self, s: int) -> None:
        """Raise ValueError unless ``s`` more positions fit."""
        if self.written + s > self.max_len:
            raise ValueError(
                f"{s} new positions after {self.written} written overrun a "
                f"{self.max_len}-position KV cache: size it for the prefix, "
                "the prompt and every generated token")


class EncDecCache(KVCache):
    """An encoder-decoder's decode cache, the reference's layout:
    ``{"k", "v", "cross_k", "cross_v", "len"}`` with the decoder's layers
    stacked, and ``written``: the self-attention positions written (the
    cross K/V of the source are not counted)."""

    @property
    def max_len(self) -> int:
        return self["k"].shape[2]


def kv_cache(num_layers: int, batch: int, max_len: int, num_kv_heads: int,
             head_dim: int, dtype=torch.bfloat16, device=None) -> dict:
    """Standard (non-ring) KV cache for full-attention layers."""
    shape = (num_layers, batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def ring_kv_cache(num_layers: int, batch: int, window: int,
                  num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                  device=None) -> dict:
    """Ring-buffer KV cache for sliding-window layers.

    Slot for absolute position p is p % window; ``pos`` tracks absolute
    positions per slot so attention can mask stale/empty slots exactly.
    """
    shape = (num_layers, batch, window, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((num_layers, batch, window), EMPTY_SLOT,
                              dtype=torch.int32, device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def ring_update(layer_cache: dict, k: torch.Tensor, v: torch.Tensor,
                start: torch.Tensor) -> dict:
    """Write S new steps into a single layer's ring cache (no leading L),
    in place.

    k, v: (B, S, Hkv, D); start: scalar absolute position of k[:, 0] (a
    device tensor).  S must be <= window.  Returns the layer's
    {"k", "v", "pos"} (without ``len``, which the caller advances once for
    all layers).
    """
    b, s = k.shape[:2]
    window = layer_cache["k"].shape[1]
    absolute = start + torch.arange(s, device=k.device, dtype=torch.int32)
    slots = (absolute % window).long()
    layer_cache["k"].index_copy_(1, slots, k.to(layer_cache["k"].dtype))
    layer_cache["v"].index_copy_(1, slots, v.to(layer_cache["v"].dtype))
    layer_cache["pos"].index_copy_(
        1, slots, absolute.to(torch.int32)[None, :].expand(b, s))
    return {k_: layer_cache[k_] for k_ in ("k", "v", "pos")}


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


def rglru_state(num_layers: int, batch: int, width: int, conv_kernel: int,
                dtype=torch.float32, device=None) -> dict:
    """RG-LRU decode state of ``num_layers`` recurrent layers: the hidden
    vector ``h`` (L, B, w) and the causal-conv tail ``conv``
    (L, B, K-1, w)."""
    return {
        "h": torch.zeros((num_layers, batch, width), dtype=dtype,
                         device=device),
        "conv": torch.zeros((num_layers, batch, conv_kernel - 1, width),
                            dtype=dtype, device=device),
    }


def cache_bytes(tree) -> int:
    """Bytes held by the tensors of a (nested) cache."""
    if isinstance(tree, dict):
        return sum(cache_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(cache_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()

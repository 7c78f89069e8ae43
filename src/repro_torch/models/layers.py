"""Shared layers of the model zoo, the part the SSM family uses.

Port of ``repro/models/layers.py``: initializers, the mixed-precision
cast and RMSNorm.  Parameters are nested dicts of tensors (what
``Mamba2LM.param_tree`` returns); activations compute in ``cfg.dtype``
(bf16 by default), norms in fp32.  Attention, MLP and RoPE helpers come
with the transformer family (ROADMAP 1.9).
"""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a config's dtype name, or the dtype itself."""
    return DTYPES[dtype] if isinstance(dtype, str) else dtype


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, in_axis=-2,
               dtype=torch.float32) -> torch.Tensor:
    """Normal / sqrt(fan_in), drawn on ``gen``'s device."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    scale = 1.0 / max(fan_in, 1) ** 0.5
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32):
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Mixed precision: fp32 master params, compute-dtype working copy
# ---------------------------------------------------------------------------
# Leaves that must stay fp32 regardless of compute dtype: router logits,
# SSD decay rates and step biases, RG-LRU gate parameters.
_FP32_LEAVES = frozenset(
    {"router", "A_log", "D", "dt_bias", "lam", "g_a", "b_a", "g_x", "b_x"}
)


def cast_params(params, dtype):
    """Cast float params (nested dicts and lists of tensors) to the
    compute dtype, except numerics-critical leaves (kept fp32).  Integer
    leaves pass through."""
    dtype = as_dtype(dtype)

    def f(x, leaf):
        if isinstance(x, dict):
            return {k: f(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [f(v, leaf) for v in x]
        if leaf in _FP32_LEAVES or not x.is_floating_point():
            return x
        return x.to(dtype)

    return f(params, None)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMSNorm with the ``(1 + scale)`` gain of the reference (scale is
    initialised to zero)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def norm_params(d: int, use_layer_norm: bool, dtype=torch.float32,
                device=None) -> dict:
    if use_layer_norm:
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}

"""Gradient machinery: global-norm clipping, microbatch accumulation,
int8 error-feedback compression.

Port of ``repro/train/grad.py``.  Gradients are trees in the reference's
layout (nested dicts of fp32 tensors, layers stacked).  ``compress_grads``
quantizes them to int8 with a persistent error-feedback buffer (the
quantization error is re-injected next step, so long-run training is
unbiased).  ``compressed_psum`` is the reference's int8 all-reduce over
a mesh axis: each rank quantizes its part on its device, and the int8
values and fp32 scales are what cross to the others.
"""

from __future__ import annotations

import torch

from repro_torch.train.tree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# Clipping
# ---------------------------------------------------------------------------
def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    """Returns (clipped_grads, pre_clip_norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# int8 error-feedback quantization
# ---------------------------------------------------------------------------
def _quantize(x: torch.Tensor):
    """Symmetric per-tensor int8.  Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def init_error_buffer(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(grads, err):
    """Quantize grads to int8 (error feedback).  Returns (deq_grads,
    new_err): the dequantized fp32 values actually applied, and the
    residual (g + e) - deq carried to the next step."""
    def leaf(g, e):
        g32 = g.float() + e
        q, scale = _quantize(g32)
        d = q.float() * scale
        return d, g32 - d

    pairs = tree_map(leaf, grads, err)
    return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)


def compressed_psum(partials: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """All-reduce of int8-quantized per-rank partials over a mesh axis.

    partials: (|axis|, ...), row i rank i's contribution (its local
    gradient, say).  Rank i quantizes row i on its device of the mesh
    (``Mesh.grid((axis,))``) with ``_quantize``; the int8 values and the
    scales are gathered, and the result is ``sum_i scale_i * q_i`` (fp32),
    the replicated value, computed once on rank 0's device.  Wire bytes:
    1 an element and one fp32 scale a rank, against 4 for fp32."""
    devices = mesh.grid((axis,))
    d = len(devices)
    if partials.shape[0] != d:
        raise ValueError(f"{partials.shape[0]} partials for a {d}-rank axis "
                         f"{axis!r}")
    home = devices[0]
    qs, scales = [], []
    for i, dev in enumerate(devices):
        q, scale = _quantize(partials[i].to(dev).float())
        qs.append(q.to(home))
        scales.append(scale.to(home))
    return torch.tensordot(torch.stack(scales), torch.stack(qs).float(),
                           dims=([0], [0]))


# ---------------------------------------------------------------------------
# Microbatch accumulation
# ---------------------------------------------------------------------------
def accumulate_grads(loss_fn, params, batch, num_microbatches: int):
    """Split the batch dim into microbatches and sum their fp32 gradients.

    ``params`` is the model (``api.model_over``): each microbatch's
    backward adds into its parameters' ``.grad``, and ``params.grad_tree()``
    reads them in the reference's layout.  loss_fn: (params, batch) ->
    (loss, metrics).  Returns (loss, metrics, grads) averaged over the
    microbatches, detached.
    """
    params.zero_grad(set_to_none=True)
    n = max(num_microbatches, 1)
    if n > 1:
        for k, v in batch.items():
            if v.shape[0] % n:
                raise ValueError(f"batch[{k!r}] of {v.shape[0]} rows does not "
                                 f"split into {n} microbatches")
    micro = [{k: v.chunk(n, dim=0)[i] for k, v in batch.items()}
             for i in range(n)]
    total, metrics_all = None, []
    for mb in micro:
        loss, metrics = loss_fn(params, mb)
        loss.backward()
        loss = loss.detach().float()
        total = loss if total is None else total + loss
        metrics_all.append({k: v.detach() for k, v in metrics.items()})
    grads = params.grad_tree()
    if n == 1:
        return total, metrics_all[0], grads
    inv = 1.0 / n
    metrics = {k: torch.stack([m[k].float() for m in metrics_all]).mean()
               for k in metrics_all[0]}
    return total * inv, metrics, tree_map(lambda g: g * inv, grads)

"""Hand-rolled optimizers: AdamW and Adafactor.

Port of ``repro/train/optimizer.py``.  Optimizer states are fp32 dicts
that mirror the parameter tree leaf for leaf (the reference's layout,
layers stacked on a leading L axis: a stacked leaf is one tensor, so the
``p.ndim >= 2`` rules and Adafactor's factoring read the shapes the
reference reads).  All moment math is fp32 whatever the parameter dtype.

Where the reference is pure (``update`` returns new trees), the port
updates the parameters and moments in place under ``torch.no_grad()``
and returns the same trees: one copy of the state on the card, not two.

Learning rates and bias corrections are computed in numpy float32, as the
reference computes them on float32 arrays, and handed to torch as Python
floats.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.train.tree import tree_map

_F = np.float32


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------
def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> Callable:
    def lr(step) -> float:
        step = _F(int(step))
        warm = _F(peak_lr) * (step + _F(1)) / _F(max(warmup_steps, 1))
        t = np.clip((step - _F(warmup_steps))
                    / _F(max(total_steps - warmup_steps, 1)), _F(0), _F(1))
        cos = _F(peak_lr) * (_F(floor) + _F((1 - floor) * 0.5)
                             * (_F(1) + np.cos(_F(np.pi) * t)))
        return float(warm if step < warmup_steps else cos)
    return lr


def constant_lr(lr: float) -> Callable:
    return lambda step: float(_F(lr))


# ---------------------------------------------------------------------------
# Optimizer interface
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable     # params -> opt_state
    update: Callable   # (grads, opt_state, params, step) -> (params, state)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    lr_fn = lr if callable(lr) else constant_lr(lr)

    def init(params):
        return {"mu": tree_map(_zeros, params), "nu": tree_map(_zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = lr_fn(step)
        t = _F(int(step) + 1)
        bc1 = float(_F(1) - _F(b1) ** t)
        bc2 = float(_F(1) - _F(b2) ** t)

        def upd(g, mu, nu, p):
            g = g.float()
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * g * g)
            step_ = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            if weight_decay and p.ndim >= 2:   # no decay on norms/biases
                step_ = step_ + weight_decay * p.float()
            p.copy_(p.float() - lr_t * step_)

        tree_map(upd, grads, state["mu"], state["nu"], params)
        return params, state

    return Optimizer(init=init, update=update)


def adafactor(lr: Callable | float, eps: float = 1e-30,
              decay: float = 0.8, weight_decay: float = 0.0,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second moments for >=2-D params: O(n+m) state instead of
    O(nm), the memory-saving option."""
    lr_fn = lr if callable(lr) else constant_lr(lr)

    def _factored(p) -> bool:
        return p.ndim >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1

    def init(params):
        def leaf(p):
            if _factored(p):
                return {"vr": _zeros(p[..., 0]), "vc": _zeros(p[..., 0, :])}
            return {"v": _zeros(p)}
        return tree_map(leaf, params)

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = lr_fn(step)
        t = _F(int(step) + 1)
        beta = float(_F(1) - t ** _F(-decay))

        def upd(g, s, p):
            g = g.float()
            g2 = g * g + eps
            if _factored(p):
                s["vr"].mul_(beta).add_((1 - beta) * g2.mean(-1))
                s["vc"].mul_(beta).add_((1 - beta) * g2.mean(-2))
                rfac = s["vr"] / torch.clamp(
                    s["vr"].mean(-1, keepdim=True), min=eps)
                u = g / (torch.sqrt(rfac)[..., None]
                         * torch.sqrt(s["vc"])[..., None, :] + eps)
            else:
                s["v"].mul_(beta).add_((1 - beta) * g2)
                u = g / (torch.sqrt(s["v"]) + eps)
            rms = torch.sqrt((u * u).mean() + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay and p.ndim >= 2:
                u = u + weight_decay * p.float()
            p.copy_(p.float() - lr_t * u)

        tree_map(upd, grads, state, params)
        return params, state

    return Optimizer(init=init, update=update)


OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor}

"""Train step factory: loss -> grads -> clip -> (compress) -> optimizer.

Port of ``repro/train/train_step.py``.  ``make_train_step(cfg, ...)``
returns ``step_fn(state, batch) -> (state, metrics)``.  The state is a
flat dict (params / opt / step / err), the reference's: ``params`` in the
reference's layout (layers stacked on a leading L axis), the optimizer's
moments and the error buffer mirroring it, ``step`` an int32 scalar.  So
checkpoints of either package restore in the other (train/checkpoint.py).

Each step runs ``api.model_over(params)`` (a model whose parameters are
views of the state's tensors), differentiates ``api.loss_fn`` with
autograd (on the card the SSD scan runs K5 forward and K5-bwd backward in
every layer) and updates the parameters and moments in place: the state
passed in is the state returned, as the reference's ``donate_argnums``
hands its buffers over.  The reference's ``state_shardings`` and
``batch_shardings`` come with the sharding item of ROADMAP 1.9.
"""

from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.train import grad as G
from repro_torch.train.optimizer import OPTIMIZERS, Optimizer, warmup_cosine


def make_optimizer(cfg, *, peak_lr: float = 3e-4, warmup: int = 100,
                   total_steps: int = 10_000) -> Optimizer:
    sched = warmup_cosine(peak_lr, warmup, total_steps)
    return OPTIMIZERS[cfg.optimizer](sched)


def init_state(gen: torch.Generator, cfg, optimizer: Optimizer, *,
               compress: bool = False) -> dict:
    """Random weights from ``gen`` (a seeded ``torch.Generator``, on the
    device the state lives on), as ``api.init_params`` draws them."""
    params = api.stacked_params(api.init_params(gen, cfg))
    state = {
        "params": params,
        "opt": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=gen.device),
    }
    if compress:
        state["err"] = G.init_error_buffer(params)
    return state


def make_train_step(cfg, optimizer: Optimizer, *, clip_norm: float = 1.0,
                    num_microbatches: int = 1, compress: bool = False):
    """Returns step_fn(state, batch) -> (new_state, metrics).  ``batch``
    holds "tokens" and "labels" (B, S) as tensors or numpy arrays; they go
    to the parameters' device."""

    def loss_fn(model, batch):
        return api.loss_fn(model, batch, cfg)

    def step_fn(state, batch):
        params = state["params"]
        dev = params["embed"].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        model = api.model_over(params, cfg)
        loss, metrics, grads = G.accumulate_grads(
            loss_fn, model, batch, num_microbatches)
        grads, gnorm = G.clip_by_global_norm(grads, clip_norm)
        if compress:
            grads, new_err = G.compress_grads(grads, state["err"])
        new_params, new_opt = optimizer.update(
            grads, state["opt"], params, state["step"])
        new_state = {
            "params": new_params,
            "opt": new_opt,
            "step": state["step"] + 1,
        }
        if compress:
            new_state["err"] = new_err
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["loss_total"] = loss
        return new_state, metrics

    return step_fn

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
hands its buffers over.

Under a mesh, ``state_shardings`` and ``batch_shardings`` give the
reference's specs for a state and a batch (``launch/train.py --mesh``
builds them); a sharded run holds its state whole on the mesh's first
device and runs each step inside ``sharding_context``, where the
model's sharded paths split their work over the mesh.
"""

from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.sharding.rules import (
    NamedSharding, PartitionSpec as P, ShardingRules, param_shardings,
)
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
                    num_microbatches: int = 1, compress: bool = False,
                    backend: str = "auto"):
    """Returns step_fn(state, batch) -> (new_state, metrics).  ``batch``
    holds "tokens" and "labels" (B, S) and the family's extras
    ("prefix_embeds", "src_embeds") as tensors or numpy arrays; each goes
    to the parameters' device in its own dtype.  ``backend`` picks the SSD
    scan's implementation (``api.loss_fn``): the dry run passes "cuda" on
    meta tensors, so K5 and K5-bwd are counted as the kernels."""

    def loss_fn(model, batch):
        return api.loss_fn(model, batch, cfg, backend=backend)

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


# ---------------------------------------------------------------------------
# Sharding helpers
# ---------------------------------------------------------------------------
def state_shardings(state_shape, mesh, rules: ShardingRules = ShardingRules()):
    """NamedShardings for a full train state (params and opt mirror;
    scalars replicated).  ``state_shape``: a train state, or a tree of
    anything with a ``.shape`` in its layout (``eval_shape``)."""
    p_shard = param_shardings(state_shape["params"], mesh, rules)
    out = {"params": p_shard, "step": NamedSharding(mesh, P())}

    if "opt" in state_shape:
        # AdamW: mu/nu mirror params exactly.  Adafactor: factored moments
        # drop the last/second-to-last dim; a moment whose rank differs
        # from its parameter's is replicated.
        def walk(o, ps):
            if isinstance(o, dict) and all(
                    k in ("mu", "nu", "v", "vr", "vc") for k in o):
                return {k: walk(v, ps) for k, v in o.items()}
            if isinstance(o, dict) and isinstance(ps, dict):
                return {k: walk(v, ps.get(k)) for k, v in o.items()}
            if isinstance(ps, NamedSharding) and hasattr(o, "shape"):
                if len(ps.spec) == len(o.shape):
                    return ps
                return NamedSharding(mesh, P())
            if isinstance(o, dict):
                return {k: walk(v, None) for k, v in o.items()}
            return NamedSharding(mesh, P())
        out["opt"] = walk(state_shape["opt"], p_shard)
    if "err" in state_shape:
        out["err"] = p_shard
    return out


def batch_shardings(batch_shape, mesh, rules: ShardingRules = ShardingRules()):
    """Batch-dim sharding over the DP axes for every batch leaf (a dict
    of anything with a ``.shape``)."""
    axes = rules.present(mesh, rules.batch_axes)
    ax = axes if len(axes) > 1 else (axes[0] if axes else None)
    n = 1
    for a in axes:
        n *= mesh.shape[a]

    def leaf(x):
        ndim = len(x.shape)
        if ndim == 0:
            return NamedSharding(mesh, P())
        if n > 1 and x.shape[0] % n == 0:
            return NamedSharding(mesh, P(ax, *([None] * (ndim - 1))))
        return NamedSharding(mesh, P())

    def visit(node):
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        return leaf(node)

    return visit(batch_shape)


def eval_shape(fn):
    """``fn()``'s tree with every tensor replaced by one of its shape and
    dtype that holds no memory (torch's fake tensors), as
    ``jax.eval_shape`` gives the reference: what ``state_shardings``
    reads before a state exists."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return fn()

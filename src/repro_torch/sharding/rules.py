"""Logical-axis sharding rules (MaxText-style) for the model zoo.

Port of ``repro/sharding/rules.py``.  Mesh axes: ``("data", "model")``
on one pod or host, ``("pod", "data", "model")`` across pods.  Logical
activation and parameter axes map to mesh axes:

  batch    -> ("pod", "data")     activations: pure DP
  fsdp     -> ("data",)           parameters: ZeRO-3 shard of a non-TP dim
  tp       -> ("model",)          parameters: tensor-parallel dim
  experts  -> ("model",)          MoE expert-parallel dim

Head-count quirk: TP over attention heads needs heads % |model| == 0
(true for llama3/qwen3/seamless/griffin, false for llama4-scout's 40 and
qwen2-1.5b's 12).  A spec then falls back to sharding head_dim.

A mesh here is a ``device.Mesh``: one process drives a list of torch
devices, which may name one card several times (logical shards).
``PartitionSpec`` and ``NamedSharding`` are the reference's spec tuple
and its pairing with a mesh; ``param_shardings``, ``cache_shardings``
and ``train_step.state_shardings`` give the reference's specs leaf for
leaf.  What they place is held whole on the mesh's first device
(``NamedSharding.device``): the model's sharded paths (the
sequence-parallel SSD and RG-LRU scans, the expert-parallel MoE) split
their work over the mesh themselves, per shard on ``Mesh.grid``'s
devices, and gather the result back.

The sharded paths name the collectives a multi-process run would make
where they move a shard's data to another shard's device
(``note_collective``): the dry run's counting mode (launch/analysis.py)
reads them, nothing else does.

``constrain`` returns its input.  The reference's constraint only
annotates an activation for GSPMD, which never changes its values; one
process computes every activation whole, so there is nothing to place,
and the port's models do not call it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

from repro_torch.device import Mesh


class PartitionSpec(tuple):
    """One entry per dimension: a mesh axis name, a tuple of names, or
    None (replicated), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def device(self):
        """Where the port holds the value: the mesh's first device."""
        return self.mesh.devices.flat[0]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    batch_axes: tuple = ("pod", "data")
    fsdp_axes: tuple = ("data",)
    tp_axes: tuple = ("model",)
    expert_axes: tuple = ("model",)
    shard_heads: bool = True     # False -> head_dim fallback for attention
    # Decode KV-cache layout: "heads" (heads, else head_dim, on the model
    # axis) or "seq" (flash-decode: the sequence dim on the model axis).
    decode_cache_layout: str = "heads"

    def present(self, mesh: Mesh, axes: tuple) -> tuple:
        return tuple(a for a in axes if a in mesh.axis_names)


_TLS = threading.local()


@dataclasses.dataclass
class _Ctx:
    mesh: Mesh
    rules: ShardingRules


#: Observers of the sharded paths' collectives (``note_collective``).
COLLECTIVE_OBSERVERS: list = []


def note_collective(kind: str, nbytes: int, *, mirrored: bool) -> None:
    """A sharded path's collective: one device receives ``nbytes`` (the
    result bytes of an ``all-to-all`` or a ``collective-permute``).
    ``mirrored``: the backward of a training step makes the same transfer
    again, reversed.  Each observer is called; with none, nothing
    happens."""
    for observer in COLLECTIVE_OBSERVERS:
        observer(kind, nbytes, mirrored)


def current_context() -> Optional[_Ctx]:
    return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def sharding_context(mesh: Mesh, rules: ShardingRules = ShardingRules()):
    prev = current_context()
    _TLS.ctx = _Ctx(mesh, rules)
    try:
        yield
    finally:
        _TLS.ctx = prev


def _axis_size(mesh: Mesh, axes: tuple) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _entry(axes: tuple):
    """A spec entry for ``axes``: the one name, or the tuple of them."""
    return axes if len(axes) > 1 else axes[0]


def shard_grid(mesh: Mesh, rules: ShardingRules):
    """The devices of a mapping over the rules' batch axes and the model
    axis: an (nb, m) array, row j the batch shard j (the batch axes
    flattened, the first one major, as a spec entry of several names
    reads), column i the model axis's rank i.  Each entry is where that
    shard computes (``Mesh.grid``)."""
    batch = rules.present(mesh, rules.batch_axes)
    model = rules.present(mesh, rules.tp_axes)[0]
    grid = mesh.grid(batch + (model,))
    return grid.reshape(-1, mesh.shape[model])


def constrain(x, *logical):
    """The reference's sharding constraint by logical axis names
    ("batch" | "tp" | "fsdp" | "experts" | None): the input itself, with
    or without a context (see the module's docstring)."""
    return x


# ---------------------------------------------------------------------------
# Decode-cache shardings
# ---------------------------------------------------------------------------
def cache_shardings(cache_shape, mesh: Mesh,
                    rules: ShardingRules = ShardingRules()):
    """Decode-state shardings.

    KV caches (L, B, S, H, hd): batch over DP axes; heads over `model`
    when divisible, else head_dim over `model` (the GQA fallback); the
    sequence dim under ``decode_cache_layout="seq"``.  SSM and RG-LRU
    states shard batch and channel dims.  ``cache_shape``: a nested dict
    of anything with a ``.shape``.
    """
    batch = rules.present(mesh, rules.batch_axes)
    tp = rules.present(mesh, rules.tp_axes)
    b_n = _axis_size(mesh, batch) if batch else 1
    tp_n = _axis_size(mesh, tp) if tp else 1
    b_ax = _entry(batch) if batch else None
    tp_ax = _entry(tp) if tp else None

    def ok(n, d):
        return d > 1 and n % d == 0

    def visit(path_parts, node):
        if isinstance(node, dict):
            return {k: visit(path_parts + (k,), v) for k, v in node.items()}
        leaf = path_parts[-1]
        shape = tuple(node.shape)
        spec = [None] * len(shape)
        if len(shape) == 0:                      # scalars ("len")
            return NamedSharding(mesh, P())
        if leaf in ("k", "v", "cross_k", "cross_v") and len(shape) == 5:
            # (L, B, S, H, hd)
            if ok(shape[1], b_n):
                spec[1] = b_ax
            if rules.decode_cache_layout == "seq" and ok(shape[2], tp_n):
                spec[2] = tp_ax        # flash-decode: shard the sequence
            elif ok(shape[3], tp_n):
                spec[3] = tp_ax
            elif ok(shape[4], tp_n):
                spec[4] = tp_ax
        elif leaf == "pos" and len(shape) == 3:   # (L, B, W)
            if ok(shape[1], b_n):
                spec[1] = b_ax
        elif leaf == "h" and len(shape) == 5:     # SSD state (L,B,H,P,N)
            if ok(shape[1], b_n):
                spec[1] = b_ax
            if ok(shape[2], tp_n):
                spec[2] = tp_ax
        elif leaf == "h" and len(shape) == 3:     # RG-LRU state (L,B,w)
            if ok(shape[1], b_n):
                spec[1] = b_ax
            if ok(shape[2], tp_n):
                spec[2] = tp_ax
        elif leaf == "conv" and len(shape) == 4:  # (L, B, K-1, C)
            if ok(shape[1], b_n):
                spec[1] = b_ax
            if ok(shape[3], tp_n):
                spec[3] = tp_ax
        return NamedSharding(mesh, P(*spec))

    return visit((), cache_shape)


# ---------------------------------------------------------------------------
# Parameter shardings: param-tree paths to PartitionSpecs.
# ---------------------------------------------------------------------------
def _spec_for(path: str, shape: tuple, mesh: Mesh,
              rules: ShardingRules) -> PartitionSpec:
    """Choose a spec for one parameter.

    Convention (see models/*.py init functions): the stacked layer dim
    (leading, path through 'layers' or 'blocks') is never sharded; TP goes
    on the 'wide' dim (ff / heads / experts / vocab); FSDP on the d_model
    dim when divisible.
    """
    tp = rules.present(mesh, rules.tp_axes)
    fsdp = rules.present(mesh, rules.fsdp_axes)
    ep = rules.present(mesh, rules.expert_axes)
    tp_n = _axis_size(mesh, tp) if tp else 1
    fsdp_n = _axis_size(mesh, fsdp) if fsdp else 1
    ep_n = _axis_size(mesh, ep) if ep else 1

    def ok(dim_size, n):
        return n > 1 and dim_size % n == 0

    leaf = path.split("/")[-1]
    spec = [None] * len(shape)
    stacked = (path.startswith("layers") or "/layers/" in path
               or "blocks" in path)
    dim0 = 1 if stacked else 0

    if leaf in ("embed", "unembed", "lm_head"):
        # (vocab, d) or (d, vocab): TP on vocab, FSDP on d_model
        vdim = 0 if shape[0] > shape[-1] else len(shape) - 1
        ddim = len(shape) - 1 - vdim if len(shape) == 2 else None
        if ok(shape[vdim], tp_n):
            spec[vdim] = _entry(tp)
        if ddim is not None and ok(shape[ddim], fsdp_n):
            spec[ddim] = _entry(fsdp)
    elif leaf.startswith("we_") or leaf == "router":
        # MoE: we_* (L, E, d, f)/(L, E, f, d) -> experts on E, FSDP on d
        if leaf == "router":
            if ok(shape[dim0], fsdp_n):
                spec[dim0] = _entry(fsdp)
        else:
            e_dim = dim0
            if ok(shape[e_dim], ep_n):
                spec[e_dim] = _entry(ep)
            # FSDP on the larger of the two trailing dims (d_model-like)
            d_dim = (e_dim + 1 if shape[e_dim + 1] >= shape[e_dim + 2]
                     else e_dim + 2)
            if ok(shape[d_dim], fsdp_n):
                spec[d_dim] = _entry(fsdp)
    elif leaf in ("wq", "wk", "wv", "wo", "w_qkv"):
        # (L, d, H, hd) or (L, H, hd, d): TP on heads if divisible else hd
        hd_dim = len(shape) - 2 if leaf != "wo" else dim0 + 1
        h_dim = hd_dim - 1 if leaf != "wo" else dim0
        d_dim = len(shape) - 1 if leaf == "wo" else dim0
        if rules.shard_heads and ok(shape[h_dim], tp_n):
            spec[h_dim] = _entry(tp)
        elif ok(shape[hd_dim], tp_n):
            spec[hd_dim] = _entry(tp)
        if ok(shape[d_dim], fsdp_n):
            spec[d_dim] = _entry(fsdp)
    elif leaf in ("w_gate", "w_up", "w_in", "w_branch_x", "w_branch_gate",
                  "w_xbc_dt", "in_proj"):
        # (L, d, f): TP on f, FSDP on d
        if ok(shape[-1], tp_n):
            spec[-1] = _entry(tp)
        if ok(shape[-2], fsdp_n):
            spec[-2] = _entry(fsdp)
    elif leaf in ("w_down", "w_out", "out_proj"):
        # (L, f, d): TP on f, FSDP on d
        if ok(shape[-2], tp_n):
            spec[-2] = _entry(tp)
        if ok(shape[-1], fsdp_n):
            spec[-1] = _entry(fsdp)
    # 1-D (norms, biases, gates) and anything unmatched stays replicated.
    return P(*spec)


def param_shardings(params_shape, mesh: Mesh,
                    rules: ShardingRules = ShardingRules()):
    """A tree of ``NamedSharding`` matching a tree of parameters (anything
    with a ``.shape``) in the reference's layout (layers stacked)."""

    def visit(path_parts, node):
        if isinstance(node, dict):
            return {k: visit(path_parts + (k,), v) for k, v in node.items()}
        path = "/".join(path_parts)
        return NamedSharding(mesh, _spec_for(path, tuple(node.shape), mesh,
                                             rules))

    return visit((), params_shape)

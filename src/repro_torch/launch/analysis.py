"""Roofline terms of a dry-run step, over the H100's figures.

Port of ``repro/launch/analysis.py``.  Three terms per (arch x shape x
mesh) cell, each a per-card quantity over ``config.HW``:

  compute    = FLOPs / 989e12 FLOP/s (dense bf16 tensor cores)
  memory     = bytes / 3.35e12 B/s (HBM3)
  collective = collective bytes / 50e9 B/s (one 400 Gb/s port a card)

``roofline_terms``, ``model_flops`` and ``summarize`` are the reference's.
The reference reads its FLOPs, bytes and collectives off XLA's compiled
module; the port has no compiled module, so ``StepCounter`` counts them
while one step runs eagerly on meta tensors (nothing allocated, nothing
launched):

* **flops**: ``torch.utils.flop_counter``'s formulas for mm, bmm, addmm,
  baddbmm and the attention ops (``matmul_flops``), plus one per output
  element of elementwise arithmetic and one per input element of a
  reduction, as XLA's cost analysis counts them.  A kernel of ours given
  meta tensors counts its own work instead (the ``*_work`` function beside
  its wrapper, through ``kernels.specs.abstract_launch``): K5 and K5-bwd
  are counted as the kernels, not as the plain chunk loop.
* **bytes**: inputs plus outputs of every aten op that moves data (views,
  ``expand``, ``permute`` and ``detach`` move none; an input is counted
  over the elements its strides reach).  Eager torch fuses nothing, so
  this is what the port's eager step moves, and it is larger than XLA's
  count over its fused module.
* **peak live bytes**: every storage an op makes is live until torch frees
  it (autograd's saved tensors included); the step's arguments are not
  counted here.
* **collectives**, per kind, from the sharding specs on the mesh, with
  the reference's ring costs (all-reduce 2R, the others 1R of the result
  bytes R a card; a reduce-scatter, the first of an all-reduce's two
  phases, 1R of the bytes it reduces, its input):

  - FSDP: a parameter sharded over the FSDP axes is all-gathered in the
    forward and again in the backward, and its gradient reduce-scattered;
  - a gradient replicated over a batch axis outside FSDP is all-reduced;
  - a matmul whose operand is a parameter (through its casts and views)
    with its contracted dimension on a tensor-parallel axis has its
    output all-reduced.  The backward's matmuls follow the same rule, so
    a column-parallel layer's input gradient is all-reduced there; a
    lookup into a parameter along such a dimension (a vocab-parallel
    embedding) likewise;
  - the sharded paths name their own (``sharding.rules.note_collective``):
    the expert-parallel MoE's all-reduce of the model ranks' partial
    outputs (the reference's ``psum``), and the sequence-parallel scans'
    collective-permute of a state per ladder step; a training step's
    backward mirrors them.

A matmul's result is split over the batch shards when the batch divides
over them; the FLOPs, bytes and live bytes are global counts, which the
dry run divides evenly over the cards.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.config import HW
from repro_torch.kernels import specs as kernel_specs
from repro_torch.sharding import rules as sharding_rules
from repro_torch.train.tree import tree_leaves

_aten = torch.ops.aten
_MATMULS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm}
# Ops that make a tensor without writing it.
_NO_DATA = {_aten.empty, _aten.empty_like, _aten.empty_strided,
            _aten.new_empty, _aten.new_empty_strided, _aten.lift_fresh,
            _aten.detach, _aten.alias, _aten.expand, _aten.permute,
            _aten.set_}
_LOOKUPS = {_aten.index, _aten.embedding, _aten.index_select}
# Ops that copy their input into a new storage of the same shape.
_COPIES = {_aten._to_copy, _aten.clone, _aten.copy}


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> dict:
    """Seconds per step for each roofline term (per-card quantities)."""
    t_compute = flops_per_dev / HW["peak_flops_bf16"]
    t_memory = bytes_per_dev / HW["hbm_bw"]
    t_coll = coll_bytes_per_dev / HW["link_bw"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom.replace("_s", "")
    total = max(t_compute, t_memory, t_coll)
    terms["bound_s"] = total
    terms["roofline_fraction"] = (t_compute / total) if total > 0 else 0.0
    return terms


def model_flops(cfg, shape, kind: str) -> float:
    """6*N*D with N = active params, D = tokens processed this step."""
    n = cfg.active_param_count()
    if kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d              # forward only
    d = shape.global_batch * 1          # decode: one token per request
    return 2.0 * n * d


def summarize(result: dict) -> str:
    """One text row for a results table."""
    t = result["terms"]
    return (
        f"| {result['arch']} | {result['shape']} | {result['mesh']} "
        f"| {t['compute_s']*1e3:9.3f} | {t['memory_s']*1e3:9.3f} "
        f"| {t['collective_s']*1e3:9.3f} | {t['dominant']:10s} "
        f"| {result.get('useful_flops_ratio', 0):5.2f} "
        f"| {result['memory'].get('per_device_total_gb', -1):7.2f} |"
    )


# ---------------------------------------------------------------------------
# Collectives from the specs
# ---------------------------------------------------------------------------
def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _spec_axes(spec) -> set:
    return {a for entry in spec for a in _axes(entry)}


def axes_size(mesh, axes) -> int:
    """Shards of a mapping over ``axes`` of ``mesh``."""
    return math.prod(mesh.shape[a] for a in axes)


def tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


def sharded_bytes(t, sharding) -> int:
    """Bytes of ``t`` on one card under ``sharding``: its bytes over the
    product of the mesh axes its spec names (a spec shards a dimension
    only where it divides, so nothing is padded)."""
    return tensor_bytes(t) // axes_size(sharding.mesh,
                                         _spec_axes(sharding.spec))


def param_collectives(params, shardings, mesh, rules, *,
                      training: bool) -> dict:
    """The per-card collectives of the parameters, from their specs:
    {kind: [wire bytes, count]}.  FSDP's all-gathers (once in an
    inference step, which the dry run runs without FSDP anyway; in the
    forward and again in the backward of a training step) and, in
    training, each gradient's reduce-scatter over the FSDP axes and
    all-reduce over the batch axes outside its spec."""
    fsdp = {a for a in rules.present(mesh, rules.fsdp_axes)
            if mesh.shape[a] > 1}
    batch = {a for a in rules.present(mesh, rules.batch_axes)
             if mesh.shape[a] > 1}
    out: dict = defaultdict(lambda: [0, 0])

    def add(kind, result_bytes, times=1):
        ring = 2 if kind == "all-reduce" else 1
        out[kind][0] += ring * result_bytes * times
        out[kind][1] += times

    for p, sh in zip(tree_leaves(params), tree_leaves(shardings),
                     strict=True):
        named = _spec_axes(sh.spec)
        shard = tensor_bytes(p) // axes_size(mesh, named)
        on_fsdp = named & fsdp
        if on_fsdp:
            gathered = shard * axes_size(mesh, on_fsdp)
            add("all-gather", gathered, 2 if training else 1)
            if training:
                add("reduce-scatter", gathered)
        outside = batch - named
        if training and outside:
            add("all-reduce", shard)
    return dict(out)


# ---------------------------------------------------------------------------
# The counting mode
# ---------------------------------------------------------------------------
def _tensors(items) -> list:
    """The tensors among ``items`` and inside its lists and tuples (the
    shapes aten's arguments and results take)."""
    out = []
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _dim(d: int, ndim: int) -> int:
    return d + ndim if d < 0 else d


@dataclasses.dataclass
class Counts:
    """What one step did, as ``StepCounter`` counted it: FLOPs, bytes and
    the peak of live storage over the whole mesh; ``kernels``: each
    kernel's calls, bytes and FLOPs; ``collectives``: per card, each
    kind's [wire bytes, count]."""

    flops: float = 0.0
    matmul_flops: float = 0.0
    bytes: float = 0.0
    peak_bytes: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)
    collectives: dict = dataclasses.field(default_factory=dict)


class StepCounter(TorchDispatchMode):
    """Counts a step's FLOPs, bytes, peak live bytes and collectives (see
    the module's docstring).

    ``params``/``shardings``: the parameter leaves and their
    ``NamedSharding``s (the tensor-parallel rule reads which dimensions
    sit on the rules' tensor- or expert-parallel axes); ``chips``: the
    cards the work is split over; ``batch_shards``: the batch's split;
    ``training``: the backward mirrors the sharded paths' transfers;
    ``external``: tensors made before the step (its arguments), whose
    storages are not live bytes of the step."""

    def __init__(self, *, mesh=None, rules=None, params=(), shardings=(),
                 chips: int = 1, batch_shards: int = 1,
                 training: bool = False, external=()):
        super().__init__()
        self.counts = Counts()
        self.chips = chips
        self.batch_shards = batch_shards
        self.training = training
        self._coll: dict = defaultdict(lambda: [0.0, 0.0])
        self._tags: dict = {}       # id(storage) -> (shape, strides, flags)
        self._live: dict = {}       # id(storage) -> bytes
        self._live_bytes = 0
        self._external = {id(t.untyped_storage()) for t in external}
        tp = set()
        if mesh is not None:
            tp = {a for a in rules.present(
                mesh, tuple(rules.tp_axes) + tuple(rules.expert_axes))
                if mesh.shape[a] > 1}
        for p, sh in zip(params, shardings, strict=True):
            flags = tuple(bool(set(_axes(e)) & tp) for e in sh.spec)
            if any(flags):
                self._tag(p, flags)

    # -- observers ---------------------------------------------------------
    def __enter__(self):
        kernel_specs.ABSTRACT_LAUNCH_OBSERVERS.append(self._kernel)
        sharding_rules.COLLECTIVE_OBSERVERS.append(self._noted)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_specs.ABSTRACT_LAUNCH_OBSERVERS.remove(self._kernel)
        sharding_rules.COLLECTIVE_OBSERVERS.remove(self._noted)
        self.counts.collectives.update(
            {k: [v[0], round(v[1])] for k, v in self._coll.items()})
        return super().__exit__(*exc)

    def _kernel(self, name: str, work: dict) -> None:
        k = self.counts.kernels.setdefault(
            name, {"calls": 0, "bytes": 0, "flops": 0})
        k["calls"] += 1
        k["bytes"] += work["bytes"]
        k["flops"] += work["flops"]
        self.counts.flops += work["flops"]
        self.counts.bytes += work["bytes"]

    def _noted(self, kind: str, nbytes: int, mirrored: bool) -> None:
        times = 2 if (mirrored and self.training) else 1
        self._collective(kind, times * nbytes / self.chips,
                         times / self.chips)

    def _collective(self, kind, result_bytes, count=1.0) -> None:
        ring = 2 if kind == "all-reduce" else 1
        self._coll[kind][0] += ring * result_bytes
        self._coll[kind][1] += count

    # -- tensor-parallel tags ----------------------------------------------
    # A tag is held per storage: the shape, strides and flags (on a
    # tensor- or expert-parallel axis or not) of the tensor it was
    # registered with.  Any tensor on that storage (a view, a
    # ``nn.Parameter`` over it, a layer's slice) reads its dimensions'
    # flags off its strides: its dimension j spans the registered
    # dimensions whose strides lie in [stride_j, stride_j * size_j).
    def _tag(self, t, flags) -> None:
        st = t.untyped_storage()
        key = id(st)
        fresh = key not in self._tags
        self._tags[key] = (tuple(t.shape), tuple(t.stride()), tuple(flags))
        if fresh:
            weakref.finalize(st, self._tags.pop, key, None)

    def _flags(self, t):
        if not isinstance(t, torch.Tensor):
            return None
        tag = self._tags.get(id(t.untyped_storage()))
        if tag is None:
            return None
        shape, strides, flags = tag
        out = []
        for size, stride in zip(t.shape, t.stride()):
            out.append(size > 1 and stride > 0 and any(
                f and n > 1 and stride <= s < stride * size
                for n, s, f in zip(shape, strides, flags)))
        return tuple(out)

    def _carry(self, func, args, out) -> None:
        """Tag a copy or cast of a tagged tensor (a new storage) with its
        dimensions' flags; views need nothing (they share the storage)."""
        if func.overloadpacket not in _COPIES or not args:
            return
        flags = self._flags(args[0])
        if flags is not None and isinstance(out, torch.Tensor) \
                and out.ndim == len(flags):
            self._tag(out, flags)

    def _tensor_parallel(self, func, args, out) -> None:
        """The all-reduce of a matmul contracting, or a lookup indexing,
        a dimension on a tensor-parallel axis."""
        packet = func.overloadpacket
        if packet in _MATMULS:
            a, b = args[-2], args[-1]
            fa, fb = self._flags(a), self._flags(b)
            if not ((fa is not None and fa[-1]) or
                    (fb is not None and fb[-2])):
                return
        elif packet in _LOOKUPS:
            src = args[0]
            fs = self._flags(src)
            dim = _dim(args[1], src.ndim) if packet is _aten.index_select \
                else 0
            if fs is None or not fs[dim]:
                return
        else:
            return
        rows = out.shape[0] if out.ndim else 1
        split = self.batch_shards if rows % self.batch_shards == 0 else 1
        self._collective("all-reduce", tensor_bytes(out) / split)

    # -- bytes and live storage --------------------------------------------
    @staticmethod
    def _reach(t) -> int:
        """Bytes of the elements ``t``'s strides reach (a broadcast input
        is read once)."""
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            if stride != 0:
                n *= size
        return n * t.element_size()

    def _allocated(self, t) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._external or key in self._live:
            return
        nbytes = st.nbytes()
        self._live[key] = nbytes
        self._live_bytes += nbytes
        self.counts.peak_bytes = max(self.counts.peak_bytes,
                                     self._live_bytes)
        weakref.finalize(st, self._freed, key)

    def _freed(self, key) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors((out,))
        c = self.counts
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            c.flops += f
            c.matmul_flops += f
        elif torch.Tag.pointwise in func.tags:
            c.flops += sum(t.numel() for t in outs)
        elif torch.Tag.reduction in func.tags and ins:
            c.flops += ins[0].numel()
        if not (func.is_view or packet in _NO_DATA):
            c.bytes += (sum(self._reach(t) for t in ins)
                        + sum(tensor_bytes(t) for t in outs))
        for t in outs:
            self._allocated(t)
        self._carry(func, args, out)
        if isinstance(out, torch.Tensor):
            self._tensor_parallel(func, args, out)
        return out

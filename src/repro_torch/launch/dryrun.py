"""Dry run: count every (arch x shape x mesh) cell's step on meta tensors.

Port of ``repro/launch/dryrun.py``.  It says, before anything runs,
whether a 256- or 512-card deployment of each architecture fits and
which roofline term (compute, memory or collectives) sets its pace, over
the H100 SXM's data-sheet figures (``config.HW``).  For each cell the
train step (train shapes) or prefill / decode (serve shapes) runs once,
eagerly, on full-size tensors on the ``meta`` device: state, parameters,
batch and cache hold no memory, and no kernel launches.  The step runs
inside ``sharding_context`` on ``make_production_mesh(devices=["meta"] *
n)`` with the SSD scan's ``backend="cuda"``, so K5 and K5-bwd take their
meta branches and are counted as the kernels; ``launch/analysis.py``'s
``StepCounter`` counts FLOPs, bytes, peak live bytes and collectives.
The dry run runs on the CPU by nature, as the reference's runs on forced
host devices.

Per card:

* argument bytes are exact from the specs: each leaf's bytes over its
  shards (state and batch; parameters, batch and cache when serving);
* FLOPs, bytes and temporary (peak live) bytes are the global counts
  divided evenly over the cards the work is split across;
* collectives are counted from the specs (``analysis``).

The port keeps every activation (``remat`` changes nothing in it), so its
memory figure is its own, not the reference's.  Eager counting sees every
layer, so the reference's two reduced-depth compiles, which exist only
because XLA counts a loop body once, have no counterpart
(``scan_correction`` says so).  ``state["step"]`` stays a host scalar, as
the optimizers read it with ``int()``.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch

``--jobs N`` counts N cells at once, each in a process of its own (the
expert-parallel MoE cells count 256 or 512 shards a layer, minutes a
cell on one core).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import time
import traceback

import torch

from repro_torch.config import SHAPES, cell_is_runnable
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.sharding.rules import (
    ShardingRules, cache_shardings, param_shardings, sharding_context,
)
from repro_torch.train import train_step as TS
from repro_torch.train.serve_step import make_serve_fns
from repro_torch.train.tree import tree_leaves

META = torch.device("meta")


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads meta: the models' init
    functions make their tensors on ``gen.device``, and torch draws meta
    tensors with a CPU generator (nothing is drawn)."""

    @property
    def device(self):
        return META


# ---------------------------------------------------------------------------
# Input specs (meta tensors: never allocated)
# ---------------------------------------------------------------------------
def input_specs(cfg, shape, kind: str) -> dict:
    """The batch of an (arch x shape) cell, as meta tensors."""
    gb, s = shape.global_batch, shape.seq_len

    def t(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device=META)

    if kind == "decode":
        return {"tokens": t((gb, 1))}
    batch = {}
    if cfg.family == "vlm":
        p = cfg.num_prefix_embeds
        batch["prefix_embeds"] = t((gb, p, cfg.d_model), torch.bfloat16)
        s = s - p
    elif cfg.family == "audio":
        batch["src_embeds"] = t((gb, s, cfg.d_model), torch.bfloat16)
    batch["tokens"] = t((gb, s))
    if kind == "train":
        batch["labels"] = t((gb, s))
    return batch


def _cache_specs(cfg, shape):
    gb, s = shape.global_batch, shape.seq_len
    kw = {"src_len": s} if cfg.family == "audio" else {}
    return api.init_cache(cfg, gb, s, device=META, **kw)


def _args_bytes(tree, shardings) -> int:
    """Bytes on one card of a tree of tensors under its shardings."""
    return sum(analysis.sharded_bytes(t, sh) for t, sh in zip(
        tree_leaves(tree), tree_leaves(shardings), strict=True))


# ---------------------------------------------------------------------------
# One counted step
# ---------------------------------------------------------------------------
def _measure(cfg, shape, mesh, rules, kind, microbatches: int = 1, *,
             backend: str = "cuda") -> dict:
    """Count one step of ``kind`` on meta tensors; return the per-card
    cost, memory and collective record."""
    if kind != "train":
        # Inference layout: no optimizer state, so no FSDP (the
        # reference's serving layout): parameters on the model axis only.
        rules = dataclasses.replace(rules, fsdp_axes=())
    chips = mesh.size
    t0 = time.perf_counter()
    gen = _MetaGenerator().manual_seed(0)
    if kind == "train":
        opt = TS.make_optimizer(cfg)
        state = TS.init_state(gen, cfg, opt)
        state["step"] = torch.zeros((), dtype=torch.int32)   # host scalar
        shardings = TS.state_shardings(state, mesh, rules)
        batch = input_specs(cfg, shape, "train")
        b_sh = TS.batch_shardings(batch, mesh, rules)
        params, p_sh = state["params"], shardings["params"]
        args, arg_sh = (state, batch), (shardings, b_sh)
        step = TS.make_train_step(cfg, opt, num_microbatches=microbatches,
                                  backend=backend)

        def run():
            step(state, batch)
    else:
        params = api.stacked_params(api.init_params(gen, cfg))
        p_sh = param_shardings(params, mesh, rules)
        cache = _cache_specs(cfg, shape)
        c_sh = cache_shardings(cache, mesh, rules)
        prefill_fn, decode_fn = make_serve_fns(cfg, backend=backend)
        if kind == "prefill":
            batch = input_specs(cfg, shape, "prefill")
        else:
            batch = input_specs(cfg, shape, "decode")
        b_sh = TS.batch_shardings(batch, mesh, rules)
        args, arg_sh = (params, batch, cache), (p_sh, b_sh, c_sh)

        def run():
            model = api.model_over(params, cfg)     # views of ``params``
            if kind == "prefill":
                prefill_fn(model, batch, cache)
            else:
                decode_fn(model, batch["tokens"], cache)
    t_setup = time.perf_counter() - t0

    bshards = analysis.axes_size(mesh, rules.present(mesh, rules.batch_axes))
    counter = analysis.StepCounter(
        mesh=mesh, rules=rules, params=tree_leaves(params),
        shardings=tree_leaves(p_sh), chips=chips,
        batch_shards=bshards if shape.global_batch % bshards == 0 else 1,
        training=kind == "train",
        external=[t for a in args for t in tree_leaves(dict(a))])
    with sharding_context(mesh, rules), counter:
        run()
    counts = counter.counts
    t_count = time.perf_counter() - t0 - t_setup

    coll = dict(counts.collectives)
    for k, (nbytes, n) in analysis.param_collectives(
            params, p_sh, mesh, rules, training=kind == "train").items():
        have = coll.get(k, [0, 0])
        coll[k] = [have[0] + nbytes, have[1] + n]
    coll_rec = {k: float(v[0]) for k, v in sorted(coll.items())}
    coll_rec["total"] = float(sum(coll_rec.values()))
    coll_rec["counts"] = {k: int(v[1]) for k, v in sorted(coll.items())}
    arg_bytes = sum(_args_bytes(a, sh) for a, sh in zip(args, arg_sh))
    temp = counts.peak_bytes / chips
    mem_rec = {"argument_size_in_bytes": int(arg_bytes),
               "temp_size_in_bytes": int(temp),
               "per_device_total_gb": (arg_bytes + temp) / 2**30}
    return {
        "flops": counts.flops / chips,
        "bytes": counts.bytes / chips,
        "matmul_flops_global": counts.matmul_flops,
        "kernels": counts.kernels,
        "coll": coll_rec,
        "memory": mem_rec,
        "setup_s": round(t_setup, 2),
        "count_s": round(t_count, 2),
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             rules: ShardingRules = ShardingRules(), *,
             cfg_overrides: dict | None = None,
             microbatches: int = 1,
             verbose: bool = True) -> dict:
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": why}

    multi = mesh_kind == "multipod"
    mesh = make_production_mesh(multi_pod=multi,
                                devices=[META] * (512 if multi else 256))
    chips = mesh.size
    kind = shape.kind
    full = _measure(cfg, shape, mesh, rules, kind, microbatches)
    flops_dev, bytes_dev = full["flops"], full["bytes"]
    coll_dev = full["coll"]["total"]
    terms = analysis.roofline_terms(flops_dev, bytes_dev, coll_dev)
    mflops = analysis.model_flops(cfg, shape, kind)
    flops_global = flops_dev * chips
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok", "kind": kind, "chips": int(chips),
        "count_s": full["count_s"],
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "collectives": {k: v for k, v in full["coll"].items()
                        if k not in ("total", "counts")},
        "collective_counts": full["coll"]["counts"],
        "matmul_flops_global": full["matmul_flops_global"],
        "kernels": full["kernels"],
        "scan_correction": "none: every layer counted",
        "memory": full["memory"],
        "terms": terms,
        "model_flops_6nd": mflops,
        "useful_flops_ratio": (mflops / flops_global
                               if flops_global else 0.0),
        "hw": "H100 SXM data-sheet figures (config.HW), not measured",
    }
    if verbose:
        t = terms
        print(f"[{arch} x {shape_name} x {mesh_kind}] "
              f"count={full['count_s']:.1f}s "
              f"compute={t['compute_s']*1e3:.2f}ms "
              f"memory={t['memory_s']*1e3:.2f}ms "
              f"collective={t['collective_s']*1e3:.2f}ms "
              f"dominant={t['dominant']} "
              f"useful={result['useful_flops_ratio']:.2f} "
              f"mem/dev={full['memory']['per_device_total_gb']:.2f}GiB")
        print("  memory:", full["memory"])
        print("  counted: flops=%.3e bytes=%.3e coll=%.3e" %
              (flops_dev, bytes_dev, coll_dev), flush=True)
    return result


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------
def _parse_overrides(pairs) -> dict:
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            overrides[k] = v.lower() == "true"
        else:
            try:
                overrides[k] = int(v)
            except ValueError:
                try:
                    overrides[k] = float(v)
                except ValueError:
                    overrides[k] = v
    return overrides


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="",
                    help="suffix for result filenames (perf variants)")
    ap.add_argument("--override", nargs="*", default=(),
                    help="ModelConfig overrides, e.g. "
                         "flash_min_seq=4096 ssm_seq_parallel=true")
    ap.add_argument("--cache-layout", choices=("heads", "seq"),
                    default="heads")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, a process each")
    args = ap.parse_args(argv)

    overrides = _parse_overrides(args.override)
    rules = ShardingRules(decode_cache_layout=args.cache_layout)
    os.makedirs(args.out, exist_ok=True)
    meshes = ("pod", "multipod") if args.mesh == "both" else (args.mesh,)
    if args.all:
        cells = [(a, s, m) for a in ARCH_IDS for s in SHAPES for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape required unless --all")
        cells = [(args.arch, args.shape, m) for m in meshes]

    tag = f"__{args.tag}" if args.tag else ""
    todo = []
    for a, s, m in cells:
        path = os.path.join(args.out, f"{a}__{s}__{m}{tag}.json")
        if os.path.exists(path) and not args.force:
            print(f"[{a} x {s} x {m}] exists, skipping")
        else:
            todo.append(((a, s, m), path))
    variant = None
    if overrides or args.cache_layout != "heads" or args.tag \
            or args.microbatches != 1:
        variant = {"overrides": overrides, "cache_layout": args.cache_layout,
                   "microbatches": args.microbatches, "tag": args.tag}
    job = (rules, overrides, args.microbatches, variant)
    if args.jobs > 1:
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")) \
                as pool:
            ok = list(pool.map(_write_cell, [(c, p, job) for c, p in todo]))
    else:
        ok = [_write_cell((c, p, job)) for c, p in todo]
    return 0 if all(ok) else 1


def _write_cell(item) -> bool:
    """Count one cell and write its JSON; an error is recorded, not
    raised, so the sweep goes on.  Returns whether it did not fail."""
    (a, s, m), path, (rules, overrides, microbatches, variant) = item
    try:
        res = run_cell(a, s, m, rules, cfg_overrides=overrides,
                       microbatches=microbatches)
        if variant is not None:
            res["variant"] = variant
    except Exception as e:  # record the failure, keep sweeping
        res = {"arch": a, "shape": s, "mesh": m, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        print(f"[{a} x {s} x {m}] FAILED: {res['error']}", flush=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return res["status"] != "error"


if __name__ == "__main__":
    raise SystemExit(main())

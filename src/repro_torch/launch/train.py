"""End-to-end training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --steps 200 --batch 8 --seq 256 [--smoke] [--device cpu] [--mesh host]

Port of ``repro/launch/train.py`` with the same flags and default
(``--arch qwen2-1.5b``), plus ``--device``: the card unless ``cpu`` (or
another torch device) is named.  Every family trains: the data stream is
the family's (``data.make_stream``: a vlm's prefix embeddings, an
encoder-decoder's source frames), seekable, checkpoints are atomic, and
the loop restarts on failure (train/fault.py).  Weights are random from
a ``torch.Generator`` seeded with ``--seed`` on the device.

``--mesh host`` builds ``launch/mesh.make_host_mesh()`` over the visible
cards (over ``--device`` alone when one is named), computes the state's
and the batch's shardings (``state_shardings``, ``batch_shardings``, from
the state's shapes) and runs each step inside
``sharding_context(mesh, ShardingRules())``, where the sharded paths
(``ssm_seq_parallel``, ``rnn_seq_parallel``, the MoE's experts) split
their work over the mesh.  The state is held whole on the mesh's first
device, and a restore puts it there.  ``--mesh pod|multipod`` builds
``launch/mesh.make_production_mesh`` over the visible cards, (16, 16) or
(2, 16, 16): with fewer than its 256 (512) cards it raises ValueError
before anything is allocated.  ``launch/dryrun.py`` counts such a step
on meta devices instead.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.data import make_stream
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.sharding.rules import ShardingRules, sharding_context
from repro_torch.train import (
    CheckpointManager, FaultInjector, Watchdog, batch_shardings, init_state,
    make_optimizer, make_train_step, run_training, state_shardings,
)
from repro_torch.train.train_step import eval_shape


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=("none", "host", "pod", "multipod"),
                    default="none")
    ap.add_argument("--fail-at", type=int, nargs="*", default=(),
                    help="inject failures at these steps (demo/testing)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; the GPU when not given")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    mesh = None
    if args.mesh == "host":
        mesh = make_host_mesh(
            devices=None if args.device is None else [args.device])
        dev = mesh.devices.flat[0]
    elif args.mesh in ("pod", "multipod"):
        mesh = make_production_mesh(multi_pod=args.mesh == "multipod")
        dev = mesh.devices.flat[0]
    else:
        dev = resolve_device(args.device)
    opt = make_optimizer(cfg, peak_lr=args.lr, warmup=max(args.steps // 20, 5),
                         total_steps=args.steps)
    stream = make_stream(cfg, args.batch, args.seq, args.seed)
    step_fn = make_train_step(cfg, opt, num_microbatches=args.microbatches,
                              compress=args.compress_grads)

    def init_fn(device=dev):
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return init_state(gen, cfg, opt, compress=args.compress_grads)

    st_sh = None
    run_step = step_fn
    if mesh is not None:
        rules = ShardingRules()
        st_sh = state_shardings(eval_shape(lambda: init_fn("cpu")), mesh,
                                rules)
        b_sh = batch_shardings(stream.batch_at(0), mesh, rules)

        def run_step(state, batch):
            batch = {k: torch.as_tensor(v).to(b_sh[k].device)
                     for k, v in batch.items()}
            with sharding_context(mesh, rules):
                return step_fn(state, batch)

    ckpt = CheckpointManager(args.ckpt_dir, keep_last=3)
    state, history = run_training(
        init_state_fn=init_fn,
        train_step=run_step,
        stream=stream,
        ckpt=ckpt,
        num_steps=args.steps,
        ckpt_every=args.ckpt_every,
        device=dev,
        state_shardings=st_sh,
        injector=FaultInjector(tuple(args.fail_at)) if args.fail_at else None,
        watchdog=Watchdog(),
    )
    print(f"done: step={int(state['step'])} "
          f"final loss={history[-1]['loss'] if history else float('nan'):.4f}")
    return state, history


if __name__ == "__main__":
    main()

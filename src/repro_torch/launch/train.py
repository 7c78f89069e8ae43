"""End-to-end training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --steps 200 --batch 4 --seq 1024 [--smoke] [--device cpu]

Port of ``repro/launch/train.py`` with the same flags, plus ``--device``:
the card unless ``cpu`` (or another torch device) is named.  The data
stream is seekable, checkpoints are atomic, and the loop restarts on
failure (train/fault.py).  Weights are random from a ``torch.Generator``
seeded with ``--seed`` on the device.  The default ``--arch`` is
``mamba2-130m``, the one family the port trains (the reference defaults
to ``qwen2-1.5b``): an arch of another family raises, its training (with
the reference's ``MultimodalStream``) being ROADMAP 1.9c.  ``--mesh``
other than ``none`` raises: state and batch shardings come with the
sharding item of ROADMAP 1.9.
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
from repro_torch.train import (
    CheckpointManager, FaultInjector, Watchdog, init_state, make_optimizer,
    make_train_step, run_training,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="mamba2-130m")
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
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training (sharding/rules.py, state "
            "and batch shardings) is the sharding item of ROADMAP 1.9, not "
            "ported yet")

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{cfg.name}: training the {cfg.family!r} family (with "
            "MultimodalStream for vlm) is ROADMAP 1.9c, not ported yet; "
            "only the ssm family trains")

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    dev = resolve_device(args.device)
    opt = make_optimizer(cfg, peak_lr=args.lr, warmup=max(args.steps // 20, 5),
                         total_steps=args.steps)
    stream = make_stream(cfg, args.batch, args.seq, args.seed)
    step_fn = make_train_step(cfg, opt, num_microbatches=args.microbatches,
                              compress=args.compress_grads)

    def init_fn():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        return init_state(gen, cfg, opt, compress=args.compress_grads)

    ckpt = CheckpointManager(args.ckpt_dir, keep_last=3)
    state, history = run_training(
        init_state_fn=init_fn,
        train_step=step_fn,
        stream=stream,
        ckpt=ckpt,
        num_steps=args.steps,
        ckpt_every=args.ckpt_every,
        device=dev,
        injector=FaultInjector(tuple(args.fail_at)) if args.fail_at else None,
        watchdog=Watchdog(),
    )
    print(f"done: step={int(state['step'])} "
          f"final loss={history[-1]['loss'] if history else float('nan'):.4f}")
    return state, history


if __name__ == "__main__":
    main()

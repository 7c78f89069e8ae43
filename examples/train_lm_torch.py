"""End-to-end LM training driver on the PyTorch port: a dense llama-family
model through the full substrate — seekable data, AdamW, checkpointing,
fault injection.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 40
    PYTHONPATH=src python examples/train_lm_torch.py --steps 40 --device cpu \
        --d-model 128 --layers 2

The twin of ``examples/train_lm.py``, with the same flags plus
``--device`` (the GPU unless ``cpu`` or another torch device is named),
through ``init_state``, ``make_train_step`` and ``run_training``.  The
default config is an 8-layer / d=512 member of the llama family; weights
are random from a seeded ``torch.Generator`` on the device.
"""

import argparse
import tempfile

import torch

from repro_torch.config import ModelConfig
from repro_torch.data import make_stream
from repro_torch.device import resolve_device
from repro_torch.train import (
    CheckpointManager, FaultInjector, init_state, make_optimizer,
    make_train_step, run_training,
)


def small_lm(d_model: int, layers: int) -> ModelConfig:
    return ModelConfig(
        name=f"demo-{d_model}x{layers}",
        family="dense",
        num_layers=layers,
        d_model=d_model,
        num_heads=8,
        num_kv_heads=4,
        head_dim=d_model // 8,
        d_ff=4 * d_model,
        vocab_size=32768,
        tie_embeddings=True,
        remat="none",
        flash_min_seq=1 << 30,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--fail-at", type=int, nargs="*", default=())
    ap.add_argument("--device", default=None,
                    help="torch device; the GPU when not given")
    args = ap.parse_args(argv)

    cfg = small_lm(args.d_model, args.layers)
    dev = resolve_device(args.device)
    n = cfg.param_count()
    print(f"model: {cfg.name}  ~{n/1e6:.0f}M params  device: {dev}")

    opt = make_optimizer(cfg, peak_lr=args.lr,
                         warmup=max(args.steps // 10, 5),
                         total_steps=args.steps)
    step_fn = make_train_step(cfg, opt)
    stream = make_stream(cfg, args.batch, args.seq, seed=0)

    def init_fn():
        return init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                          opt)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        state, history = run_training(
            init_state_fn=init_fn,
            train_step=step_fn,
            stream=stream,
            ckpt=CheckpointManager(ckpt_dir, keep_last=2),
            num_steps=args.steps,
            ckpt_every=max(args.steps // 4, 10),
            device=dev,
            injector=(FaultInjector(tuple(args.fail_at))
                      if args.fail_at else None),
            log_every=max(args.steps // 10, 1),
        )
    first, last = history[0], history[-1]
    print(f"steps {first['step']}..{last['step']}: "
          f"loss {first['loss']:.3f} -> {last['loss']:.3f} "
          f"({last['dt']*1e3:.0f} ms/step at the end)")
    k = max(len(history) // 4, 1)
    early = sum(h["loss"] for h in history[:k]) / k
    late = sum(h["loss"] for h in history[-k:]) / k
    if not late < early:
        raise RuntimeError(f"loss must trend down ({early:.3f} -> "
                           f"{late:.3f})")
    print("training loss decreased; checkpoint/restart exercised" +
          (" with injected failures" if args.fail_at else ""))
    return state


if __name__ == "__main__":
    main()

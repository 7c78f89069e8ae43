#!/usr/bin/env python3
"""Where the host's time goes in Mamba2-130M's train step under each
``remat`` setting, on one GPU.

    python3 scripts/remat_host_profile.py [--steps N] [--json PATH]

Runs chip_smoke's train step (``make_train_step`` at TRAIN_BATCH x
TRAIN_SEQ, 4 x 1024) in bf16 under remat "none" and "full" and in fp32
under "none", "dots" and "full".  For each cell: the median host-clock ms
of 5 steps, to the step's return (the host's issue time) and to the end
of a ``torch.cuda.synchronize()`` after it; then ``cProfile`` over
``--steps`` steps, its self time (``tottime``) a step summed by where the
function lives (the checkpoint module, the selective checkpoint's
dispatch mode, autograd's Python, other torch Python, repro_torch, and C
functions called from Python: ``{built-in ...}`` and ``{method ...}``,
which hold the aten ops' dispatch) and its TOP functions by self time.
cProfile slows Python code, so its totals exceed the unprofiled step;
read the shares.  On Python 3.12 cProfile sees every thread: the
backward's Python (checkpoint's unpack hook and the recompute, on
autograd's device thread) is counted, and the main thread's
``run_backward`` self time is its wait for that thread.  Prints one JSON
line as its last, and writes it to ``--json`` when given.
"""

from __future__ import annotations

import argparse
import cProfile
import dataclasses
import json
import pathlib
import pstats
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402  (stdlib-only at import)

CELLS = (("bfloat16", "none"), ("bfloat16", "full"), ("float32", "none"),
         ("float32", "dots"), ("float32", "full"))
TOP = 12


def where(file: str) -> str:
    """The group a profiled function's self time is summed under."""
    if file == "~":
        return "C functions (aten dispatch)"
    if file.endswith("torch/utils/checkpoint.py"):
        return "torch.utils.checkpoint"
    if "torch/utils/_python_dispatch" in file or "_ops.py" in file:
        return "dispatch modes and op overloads"
    if "torch/autograd" in file:
        return "torch.autograd (Python)"
    if "repro_torch" in file:
        return "repro_torch"
    if "/torch/" in file:
        return "other torch Python"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--json", help="also write the JSON line to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("remat_host_profile: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.data import make_stream
    from repro_torch.train import init_state, make_optimizer, make_train_step

    dev = torch.device("cuda")
    result = {"card": smoke.card_line(), "steps": args.steps,
              "shape": [smoke.TRAIN_BATCH, smoke.TRAIN_SEQ], "cells": {}}
    base = get_config(smoke.LM_ARCH)
    for dtype, remat in CELLS:
        cfg = dataclasses.replace(base, dtype=dtype, remat=remat)
        opt = make_optimizer(cfg)
        state = init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                           opt)
        stream = make_stream(cfg, smoke.TRAIN_BATCH, smoke.TRAIN_SEQ, 0)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in stream.batch_at(0).items()}
        step = make_train_step(cfg, opt)
        for _ in range(2):
            step(state, batch)
        torch.cuda.synchronize()
        issue, done = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            step(state, batch)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            issue.append((t1 - t0) * 1e3)
            done.append((time.perf_counter() - t0) * 1e3)
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(args.steps):
            step(state, batch)
        torch.cuda.synchronize()
        prof.disable()
        groups: dict[str, float] = {}
        rows = []
        for (file, line, name), (_, ncalls, tt, _, _) in pstats.Stats(
                prof).stats.items():
            g = where(file)
            groups[g] = groups.get(g, 0.0) + tt * 1e3 / args.steps
            rows.append((tt * 1e3 / args.steps, ncalls / args.steps,
                         f"{pathlib.Path(file).name}:{line}({name})"))
        rows.sort(reverse=True)
        r = {"issue_ms": statistics.median(issue),
             "step_ms": statistics.median(done),
             "profiled_self_ms_by_group": dict(
                 sorted(groups.items(), key=lambda kv: -kv[1])),
             "top": [{"self_ms": t, "calls": c, "function": f}
                     for t, c, f in rows[:TOP]]}
        cell = f"{dtype} {remat}"
        result["cells"][cell] = r
        print(f"{cell}: issue {r['issue_ms']:.3f} ms, step "
              f"{r['step_ms']:.3f} ms (host clock, median of 5) | card "
              f"{result['card']}", flush=True)
        for g, t in r["profiled_self_ms_by_group"].items():
            print(f"   {g}: {t:.3f} ms a step under cProfile", flush=True)
        for row in r["top"]:
            print(f"   {row['self_ms']:8.3f} ms {row['calls']:8.0f} calls "
                  f"{row['function']}", flush=True)
        del state, step, opt, batch
        torch.cuda.empty_cache()
    line = json.dumps(result)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

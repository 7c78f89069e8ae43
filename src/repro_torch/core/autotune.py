"""Launch-shape autotuner: configs measured on the card, loaded by the
planner as priors.

Port of ``repro/core/autotune.py``.  The paper's §4.2/§4.5 point is that
the tile shape decides throughput and the best shape depends on the
hardware and the geometry.  ``autotune()`` times K1 (the WF-TiS kernel,
``kernels/wf_tis.py``) over its knobs, the bins a CTA scans
(``bin_block`` 1, 2, 4, 8, or ``None`` for the shape's own choice), and a
band-height sweep when a memory budget applies; it persists the winners
to JSON.  ``plan()`` consults that file (:func:`prior_for`) and takes the
tuned ``bin_block`` when the caller left it at ``None``, stamping the
plan's ``tuned`` field so ``explain()`` shows where it came from.  An
entry may also carry ``delta_threshold``, the dirty fraction up to which
``plan()`` updates a cached predecessor H instead of recomputing it.

The priors file is the port's own, named by ``$REPRO_TORCH_TUNED_CONFIGS``
(or an explicit path): winners measured on a TPU (the reference's
``$REPRO_TUNED_CONFIGS``) never apply to the card.  With no file, plans
and their ``explain()`` are unchanged.

Format (one entry per workload geometry)::

    {"version": 1,
     "configs": {"480x640x32": {"bin_block": 8, "band_h": 120,
                                "seconds": 0.0003, "gbps": 2100.0}}}

CLI::

    python -m repro_torch.core.autotune --height 480 --width 640 --bins 32 \\
        --out tuned.json
    REPRO_TORCH_TUNED_CONFIGS=tuned.json python ...   # the planner reads it
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

#: environment variable naming the priors file ``plan()`` consults.
ENV_VAR = "REPRO_TORCH_TUNED_CONFIGS"

#: K1's bins a CTA (``None``: the launch shape's own choice).
BIN_BLOCK_CANDIDATES = (None, 1, 2, 4, 8)

# (path, mtime) -> parsed configs; reloads only when the file changes.
_cache: dict[tuple[str, float], dict] = {}


def config_key(height: int, width: int, num_bins: int) -> str:
    return f"{height}x{width}x{num_bins}"


def load_priors(path: str | None = None) -> dict:
    """The tuned-config table, or ``{}`` when no file is configured.

    ``path=None`` reads ``$REPRO_TORCH_TUNED_CONFIGS``; a missing or
    unreadable file is an empty table, not an error: priors are advisory.
    """
    path = path or os.environ.get(ENV_VAR)
    if not path:
        return {}
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return {}
    key = (os.path.abspath(path), mtime)
    if key not in _cache:
        try:
            with open(path) as f:
                data = json.load(f)
            configs = data.get("configs", {})
        except (OSError, ValueError):
            configs = {}
        _cache.clear()           # one live file; stale mtimes drop out
        _cache[key] = configs
    return _cache[key]


def prior_for(spec, path: str | None = None) -> dict | None:
    """The tuned config for ``spec``'s geometry, if the caller left
    ``bin_block`` at ``None`` (an explicit one is a decision the prior
    must not override)."""
    if spec.bin_block is not None:
        return None
    return load_priors(path).get(
        config_key(spec.height, spec.width, spec.num_bins))


def _time_call(fn, repeats: int, device) -> float:
    """Best seconds of ``repeats`` calls after a warm-up: CUDA events on
    the card, the host clock on the CPU."""
    import torch

    fn()
    best = float("inf")
    on_card = device.type == "cuda"
    for _ in range(repeats):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            sec = time.perf_counter() - t0
        best = min(best, sec)
    return best


def autotune(
    height: int,
    width: int,
    num_bins: int,
    *,
    method: str = "wf_tis",
    backend: str = "auto",
    memory_budget_bytes: int | None = None,
    bin_blocks=BIN_BLOCK_CANDIDATES,
    repeats: int = 3,
    rng=None,
    device=None,
) -> dict:
    """Measure the candidate grid on ``device`` (``None`` = the card) and
    return the winner: one priors-file entry with the fastest
    ``bin_block`` for a full-frame launch, the fastest ``band_h`` under
    ``memory_budget_bytes`` (when given), the winning seconds and the
    effective bandwidth (bytes the function moves / time: the uint8 frame
    read once and the fp32 H written once)."""
    from repro_torch.core.bands import plan_bands
    from repro_torch.device import as_tensor, resolve_device
    from repro_torch.kernels.ops import integral_histogram

    dev = resolve_device(device)
    rng = np.random.default_rng(0) if rng is None else rng
    frame = as_tensor(rng.integers(0, 256, (height, width), np.uint8), dev)
    touched = height * width + 4 * num_bins * height * width

    def call(bb, budget=None):
        return lambda: integral_histogram(
            frame, num_bins, method=method, backend=backend, bin_block=bb,
            memory_budget_bytes=budget, device=dev)

    best = None
    for bb in bin_blocks:
        sec = _time_call(call(bb), repeats, dev)
        if best is None or sec < best["seconds"]:
            best = {"bin_block": bb, "seconds": sec}

    if memory_budget_bytes is not None:
        budget_plan = plan_bands(height, width, num_bins,
                                 memory_budget_bytes=memory_budget_bytes)
        cands = sorted({bh for bh in (budget_plan.band_h,
                                      budget_plan.band_h // 2)
                        if 1 <= bh <= budget_plan.band_h})
        best_bh = None
        for bh in cands:
            sec = _time_call(call(best["bin_block"],
                                  4 * num_bins * bh * width), repeats, dev)
            if best_bh is None or sec < best_bh[1]:
                best_bh = (bh, sec)
        best["band_h"] = best_bh[0]

    best["gbps"] = touched / best["seconds"] / 1e9
    return best


def save_priors(path: str, configs: dict) -> None:
    with open(path, "w") as f:
        json.dump({"version": 1, "configs": configs}, f, indent=2,
                  sort_keys=True)
        f.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.autotune",
        description="tune K1's bin block and the band height for one "
                    "workload geometry on the card and persist the winner "
                    "as a planner prior")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--bins", type=int, default=32)
    ap.add_argument("--budget", type=int, default=None,
                    help="memory budget (bytes) to tune a band height under")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="where to measure (default: the card)")
    ap.add_argument("--out", default="tuned.json",
                    help="priors file to merge the result into")
    args = ap.parse_args(argv)

    entry = autotune(args.height, args.width, args.bins,
                     memory_budget_bytes=args.budget, repeats=args.repeats,
                     device=args.device)
    configs = dict(load_priors(args.out))
    key = config_key(args.height, args.width, args.bins)
    configs[key] = entry
    save_priors(args.out, configs)
    print(f"{key}: {entry}")
    print(f"wrote {args.out}: export {ENV_VAR}={args.out} to use it")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

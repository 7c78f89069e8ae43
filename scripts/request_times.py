#!/usr/bin/env python3
"""Time the clip's requests of ``chip_smoke.py`` for any tree of the repo
on one GPU, host clock, many repetitions.

    python3 scripts/request_times.py [--src DIR] [--label NAME] [--reps N]
                                     [--json PATH]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so that another tree, such as a parent commit unpacked with ``git
archive``, answers the same requests: ``HistogramEngine(num_bins=32).run``
on chip_smoke's 16-frame 480x640 clip with its fused queries (two rects, a
stride-16 likelihood map, a 3-scale search) and its dense query (24x24
windows), the fused queries on the clip's first frame alone, and those
queries applied to that frame's fused source with no scan at all (the
analytics alone).  Each reading is the median and quartiles over
``--reps`` calls (after 3 warm-up calls), each call ended by a
``torch.cuda.synchronize()``.  Run parent, change, change, parent on one
machine to compare two trees.  Prints one JSON line as its last, and
writes it to ``--json`` when given.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (stdlib-only at import)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--json", help="also write the JSON line to this file")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("request_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    eng_mod = importlib.import_module("repro_torch.core.engine")
    ref = importlib.import_module("repro_torch.kernels.ref")
    data = importlib.import_module("repro_torch.data")

    n, h, w, nb = 16, 480, 640, 32
    clip_np = data.video_frames(h, w, n, seed=0)
    clip = torch.as_tensor(clip_np, device="cuda")
    rects = np.array([[100, 120, 219, 279], [0, 0, 479, 639]])
    r0, c0 = 160, 256
    target = ref.region_histogram_ref(clip[0], nb, r0, c0, r0 + 63, c0 + 63)
    fused_queries = [
        eng_mod.RegionQuery(rects),
        eng_mod.LikelihoodQuery(target, (64, 64), stride=16),
        eng_mod.MultiScaleQuery(target, ((32, 32), (64, 64), (96, 96)),
                                stride=8),
    ]
    dense_queries = [eng_mod.SlidingWindowQuery((24, 24), stride=1)]
    engine = eng_mod.HistogramEngine(num_bins=nb)
    source = engine.run(clip_np[0], fused_queries).source

    requests = {
        "fused clip": lambda: engine.run(clip_np, fused_queries),
        "fused one frame": lambda: engine.run(clip_np[0], fused_queries),
        "dense clip": lambda: engine.run(clip_np, dense_queries),
        "analytics one frame": lambda: [q.apply(source)
                                        for q in fused_queries],
    }
    result = {"label": args.label, "src": args.src,
              "card": smoke.card_line(), "reps": args.reps, "ms": {}}
    for label, fn in requests.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        q1, med, q3 = statistics.quantiles(times, n=4)
        result["ms"][label] = {"median": med, "q1": q1, "q3": q3}
        print(f"{args.label}: {label}: median {med:.4f} ms (quartiles "
              f"{q1:.4f}, {q3:.4f}) over {args.reps} | card "
              f"{result['card']}", flush=True)
    line = json.dumps(result)
    if args.json:
        pathlib.Path(args.json).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

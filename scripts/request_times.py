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
windows), the fused queries on the clip's first frame alone, those
queries applied to that frame's fused source with no scan at all (the
analytics alone), and chip_smoke's video stream (30 frames of 480x640 at
32 bins, each rewriting a 48-row block, a stride-2 24x24 likelihood map)
run incrementally, each frame with its predecessor (``prev=``), read as
ms a frame.  Those repeat the same inputs, so every plan after the first
call is one the engine has seen.  Three more give each repetition inputs
of its own, made before its clock starts: the one-frame fused request
with its first rect moved down a row a repetition (new corner rows), a
new video stream (new seed), and chip_smoke's one-target
``FragmentTracker.step_fused`` over 32 frames from a box moved down a row
a repetition (16 bins, radius 12: new corner rows every frame), read as
ms a frame.  Each reading is the median and quartiles over ``--reps``
calls (after 3 warm-up calls), each call ended by a
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
    tracking = importlib.import_module("repro_torch.core.tracking")

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
    video = smoke.low_motion_stream(h, w, 30, 48, seed=4)
    patch = video[0][200:224, 300:324].astype(np.int64)
    v_target = np.bincount((patch * nb // 256).ravel(),
                           minlength=nb).astype(np.float32)
    v_queries = [eng_mod.LikelihoodQuery(v_target, (24, 24), stride=2)]
    v_engine = eng_mod.HistogramEngine(num_bins=nb)
    v_seed = v_engine.run(video[0], v_queries)

    def video_chain(stream, seed_out):
        out = seed_out
        for t in range(1, len(stream)):
            out = v_engine.run(stream[t], v_queries,
                               prev=(stream[t - 1], out))

    def moved_rects(i):
        moved = rects.copy()
        moved[0, [0, 2]] += i
        queries = [eng_mod.RegionQuery(moved)] + fused_queries[1:]
        return lambda: engine.run(clip_np[0], queries)

    def new_stream(i):
        stream = smoke.low_motion_stream(h, w, 30, 48, seed=100 + i)
        first = v_engine.run(stream[0], v_queries)
        return lambda: video_chain(stream, first)

    t_clip = data.video_frames(h, w, 33, seed=8)
    tracker = tracking.FragmentTracker(tracking.TrackerConfig(
        num_bins=16, search_radius=12))

    def moved_box(i):
        st0 = tracker.init(t_clip[0], [150 + i, 200, 213 + i, 271])

        def steps():
            st = dict(st0)
            for f in t_clip[1:]:
                st = tracker.step_fused(st, f)
        return steps

    # label -> (rep index -> the request to time, frames it answers: a
    # reading is ms a frame)
    requests = {
        "fused clip": (lambda i: lambda: engine.run(clip_np, fused_queries),
                       1),
        "fused one frame": (
            lambda i: lambda: engine.run(clip_np[0], fused_queries), 1),
        "dense clip": (lambda i: lambda: engine.run(clip_np, dense_queries),
                       1),
        "analytics one frame": (
            lambda i: lambda: [q.apply(source) for q in fused_queries], 1),
        "video incremental frame": (
            lambda i: lambda: video_chain(video, v_seed), len(video) - 1),
        "fused one frame, new rows": (moved_rects, 1),
        "video incremental frame, new stream": (new_stream, len(video) - 1),
        "tracker step_fused frame, new box": (moved_box, len(t_clip) - 1),
    }
    result = {"label": args.label, "src": args.src,
              "card": smoke.card_line(), "reps": args.reps, "ms": {}}
    for label, (make, frames) in requests.items():
        for i in range(3):
            make(args.reps + i)()
        torch.cuda.synchronize()
        times = []
        for i in range(args.reps):
            fn = make(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / frames)
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

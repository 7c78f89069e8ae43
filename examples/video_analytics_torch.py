"""End-to-end real-time video analytics on the PyTorch port, driven
through the plan/execute engine (core/engine.py).

    PYTHONPATH=src python examples/video_analytics_torch.py [--frames 40]
                   [--batch auto|N] [--targets 2] [--large-scale 2]
                   [--device cpu]

The twin of ``examples/video_analytics.py``, with the same flags and
stages plus ``--device`` (the GPU unless ``cpu`` or another torch device
is named):

  1. WF-TiS integral histograms streamed by ``HistogramEngine.map_frames``
     (K1 on the card; pinned staging and a copy stream, core/runtime.py)
  2. the multi-target fragments tracker on the same engine via
     ``step_on_h``: each frame's H is computed once and shared by every
     target's O(1) candidate queries
  3. one batched ``likelihood_map`` over the trailing frames' H
  4. the large-frame regime (paper §4.6): a frame ``--large-scale`` times
     the stream's size scored under an eighth of its full H's bytes; the
     planner bands it (``plan.explain()``) and H never exists whole
  5. serving: an ``AnalyticsService`` over the engine answers a burst of
     concurrent requests (same-frame queries coalesce, hot frames answer
     from the cache)

Timings are read after ``torch.cuda.synchronize()``.  ``main(argv)``
returns what it prints: the deterministic results (tracks, maps, the
large frame's plan) and the service's counts, which depend on thread
timing.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import distances
from repro_torch.core.engine import (
    HistogramEngine, LikelihoodQuery, RegionQuery,
)
from repro_torch.core.region_query import likelihood_map, region_histogram
from repro_torch.core.tracking import FragmentTracker, TrackerConfig
from repro_torch.data import video_frames
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--hw", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--bins", type=int, default=16)
    ap.add_argument("--batch", default="auto",
                    help='frames per dispatch: "auto" (planner) or an int')
    ap.add_argument("--depth", type=int, default=2,
                    help="dispatches kept in flight (1 = synchronous)")
    ap.add_argument("--targets", type=int, default=2,
                    help="simultaneously tracked targets")
    ap.add_argument("--map-frames", type=int, default=4,
                    help="trailing frames scored by one batched "
                         "likelihood_map call")
    ap.add_argument("--large-scale", type=int, default=2,
                    help="stage-4 frame is this multiple of --hw "
                         "(0 skips the banded large-frame demo)")
    ap.add_argument("--serve-requests", type=int, default=60,
                    help="stage-5 query burst against the AnalyticsService "
                         "(0 skips the serving demo)")
    ap.add_argument("--device", default=None,
                    help="torch device; the GPU when not given")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    device = str(dev)
    h, w = args.hw

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    frames = video_frames(h, w, args.frames, seed=3)
    print(f"{args.frames} frames of {h}x{w}, {args.bins} bins, "
          f"batch={args.batch}, depth={args.depth}, "
          f"targets={args.targets}")
    out = {}

    # --- stage 1: one engine plans + streams the integral histograms ------
    engine = HistogramEngine(args.bins, method="wf_tis", backend="auto",
                             device=device)

    # --- stage 2: multi-target tracker rides the same engine ---------------
    tracker = FragmentTracker(
        TrackerConfig(num_bins=args.bins, search_radius=10), engine=engine)
    size = 48
    bboxes = np.stack([
        [r, c, r + size - 1, c + size - 1]
        for r, c in zip(
            np.linspace(h // 4, 3 * h // 4 - size, args.targets).astype(int),
            np.linspace(w // 4, 3 * w // 4 - size, args.targets).astype(int))
    ])
    state = tracker.init(frames[0], bboxes)
    target_hists = region_histogram(engine.compute_dense(frames[0]),
                                    state["bbox"])

    sync()
    t0 = time.perf_counter()
    boxes, tail_H = [], []
    if args.batch == "auto":
        stream = engine.map_frames(frames, depth=args.depth)
    else:
        # explicit microbatch: bypass the planner's choice for comparison
        from repro_torch.core.integral_histogram import IntegralHistogram

        stream = IntegralHistogram(
            num_bins=args.bins, method="wf_tis", backend="auto",
            device=device,
        ).map_frames(frames, batch_size=int(args.batch), depth=args.depth)
    for H in stream:
        state = tracker.step_on_h(state, H)     # H shared across targets
        boxes.append(state["bbox"].cpu().numpy())
        tail_H.append(H)
        if len(tail_H) > args.map_frames:
            tail_H.pop(0)
    sync()
    dt = time.perf_counter() - t0
    if args.batch == "auto" and engine.last_plan is not None:
        print(f"planned microbatch: {engine.last_plan.microbatch} "
              f"frame(s)/dispatch ({engine.last_plan.representation})")

    # --- stage 3: one batched likelihood_map over the trailing frames ----
    Hs = torch.stack(tail_H)                    # (k, bins, h, w)
    lmap = likelihood_map(Hs, target_hists[0], (size, size),
                          distances.intersection, stride=16)
    sync()

    print(f"pipeline: {args.frames/dt:.2f} frames/sec "
          f"({dt/args.frames*1e3:.1f} ms/frame) on {dev}")
    for t in range(args.targets):
        print(f"track[{t}]: start {boxes[0][t][:2]} -> end {boxes[-1][t][:2]}")
    lmap_np = lmap.cpu().numpy()
    peak = tuple(int(i) for i in np.unravel_index(int(np.argmax(lmap_np[-1])),
                                                  lmap_np.shape[1:]))
    print(f"likelihood maps {lmap_np.shape} (batched over {lmap_np.shape[0]} "
          f"frames), last-frame peak={float(lmap_np[-1].max()):.3f} at {peak}")
    out.update(boxes=np.stack(boxes), lmap=lmap_np, pipeline_s=dt,
               microbatch=getattr(engine.last_plan, "microbatch", None))

    # --- stage 4: the large-frame regime, planned under a budget ----------
    if args.large_scale:
        big_h, big_w = h * args.large_scale, w * args.large_scale
        big = np.tile(frames[-1], (args.large_scale, args.large_scale))
        full_bytes = 4 * args.bins * big_h * big_w
        budget = full_bytes // 8
        big_engine = HistogramEngine(args.bins, method="wf_tis",
                                     backend="auto",
                                     memory_budget_bytes=budget,
                                     device=device)
        sync()
        t0 = time.perf_counter()
        res = big_engine.run(big, [LikelihoodQuery(
            target_hists[0], (size, size), distances.intersection,
            stride=16)])
        blmap = res.results[0]
        sync()
        dt = time.perf_counter() - t0
        print(f"\nlarge-frame plan ({big_h}x{big_w}, budget "
              f"{budget / 2**20:.0f} MB vs full H "
              f"{full_bytes / 2**20:.0f} MB):")
        print(res.plan.explain())
        print(f"banded likelihood map {tuple(blmap.shape)} in {dt:.2f}s — "
              "full H never materialized")
        out.update(large_plan=res.plan.representation,
                   large_lmap=blmap.cpu().numpy(), large_s=dt)

    # --- stage 5: serving front-end over the engine -----------------------
    if args.serve_requests:
        from repro_torch.serve import AnalyticsService

        store = {i: f for i, f in enumerate(frames)}
        svc = AnalyticsService(engine, store, cache_size=8,
                               max_pending=args.serve_requests)
        rng = np.random.default_rng(11)
        burst = []
        hot = min(4, args.frames)
        for i in range(args.serve_requests):
            # hot-set traffic: most queries land on the newest `hot` frames
            ref = (args.frames - 1 - int(rng.integers(0, hot))
                   if rng.random() < 0.8
                   else int(rng.integers(0, args.frames)))
            if i % 2:
                # the planner reads a region query's rects on the host
                burst.append((ref, RegionQuery(state["bbox"].cpu())))
            else:
                burst.append((ref, LikelihoodQuery(
                    target_hists[0], (size, size), distances.intersection,
                    stride=32)))
        sync()
        t0 = time.perf_counter()
        with svc:
            # two waves: the first computes (coalescing same-frame
            # queries), the second mostly answers from the HSource cache
            half = len(burst) // 2
            for wave in (burst[:half], burst[half:]):
                futs = [svc.submit(ref, q, block=True) for ref, q in wave]
                for f in futs:
                    f.result()
        sync()
        dt = time.perf_counter() - t0
        s = svc.stats.snapshot()
        print(f"\nserving: {len(burst)} concurrent requests in {dt:.2f}s "
              f"({len(burst) / dt:.1f} req/s)")
        print(f"  engine runs {s['engine_runs']} "
              f"(coalesced {s['coalesced']}, "
              f"cache hit rate {100 * s['cache_hit_rate']:.0f}%), "
              f"p95 latency {1e3 * s['latency_p95_s']:.1f} ms")
        out.update(service=s, serve_s=dt)
    return out


if __name__ == "__main__":
    main()

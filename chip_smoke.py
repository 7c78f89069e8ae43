#!/usr/bin/env python3
"""Drive the repro_torch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each ended by ``torch.cuda.synchronize()``; any failure exits
non-zero before the result line is printed:

  build   compile the CUDA kernels (src/repro_torch/kernels/csrc) with nvcc,
          one nvcc per source, all started together; each one's seconds
  k1      the WF-TiS kernel against its plain torch version (torch.equal):
          a 16-frame 480x640 clip at 32 bins (the paper's geometry), four
          1080x1920 frames at 64 bins, ragged shapes, a float frame and a
          non-zero carry_in; K1_SHAPES, the shapes the paths launch it at
          (the clip, one frame, a 48-row dirty run with its carry, a
          273x3840x128 band with its carry) and 1080p, with their strips
          and CTAs; and strips of one frame's R rows at heights R - 1, R,
          R + 1 and 1
  k2      the query-fused kernel against the plain H's rows (torch.equal):
          the clip's fused request, K2_SHAPES (the clip's 62 corner rows,
          one frame with the same rows, one frame with one rect's rows,
          the clip at the fuse bound of 120 rows) with each one's chunks
          and pass-A CTAs (at least two an SM at one frame), and the early
          cut (bands_computed < bands_total)
  k3      the delta_apply kernel against its plain version (torch.equal) at
          the clip's H with a random integer delta, on ragged shapes, and
          from a row band of one H into a row band of another
  k4      the CW-TiS kernels (hscan, then vscan) against the plain cw_tis
          and against K1 (torch.equal): the clip, 4x1080x1920x64, K1's
          ragged shapes, a float frame and a non-zero carry_in
  k5      the SSD scan kernel (3xTF32 tensor cores) against its plain
          version (TF32 off) at the Mamba2-130M prefill's shape, B=4,
          S=1024, H=24, P=64, N=128, chunk 256: y and h_last with h0 = 0
          and with a random h0, and ssd_chunked on a ragged S=1000; max
          abs and rel errors against K5_ATOL / K5_RTOL; K5's operation
          bound at the 3xTF32 rate beside the fp32 one
  k5_bwd  the SSD scan's backward kernel (K5-bwd, no TPU counterpart)
          against its plain version (TF32 off) at the same shape, from
          the chunk-entry states K5 keeps: h0 = None without a gradient
          of h_last (a training step's call), a random h0 and g_hlast,
          and a ragged S=1000; each gradient's largest error over its
          largest magnitude against K5BWD_RTOL, all finite, and the
          kernel equal to itself run twice (no atomics); then
          ops.ssd_scan under autograd (SSDScanFunction: K5, then K5-bwd
          once) against autograd of the plain scan at Mamba2-130M's init,
          dt = 0.69 and A = -1 over 256-step chunks
  main    HistogramEngine(num_bins=32).run on the clip: a request that
          plans "fused" and one that plans "dense"; the fused request on
          one frame (a real-time stream's request); answers held against
          backend="torch" on the same card and against a direct count;
          distances.bin_sum against the in-order loop, and every metric on
          the card against the CPU's
  bands   one 2160x3840 frame at 128 bins (dense H 4.25 GB) under a
          512 MiB budget: the engine plans 8 bands of 273 rows and streams
          them through K1 (one launch a band); rows of the BandedH and
          ops.integral_histogram(memory_budget_bytes=...) equal one dense
          K1 launch; map_bands(prefetch=1) gives the same rows, with both
          times; a storage="uint16" engine plans "spilled" and answers
          region queries of at most 65535 px exactly, past the wrap
  video   a low-motion stream of 30 frames of 480x640 at 32 bins, each
          rewriting a 48-row block of its predecessor, through
          engine.run(frame, [LikelihoodQuery], prev=...): from frame 1 the
          plan is incremental, K1 launches once per dirty run, K3 once when
          clean rows lie below (never when the block touches the bottom),
          K2 never; H equals a fresh K1 launch, maps equal backend="torch";
          a frame with half its rows rewritten falls back (K3 never)
  cw_tis  HistogramEngine(method="cw_tis") on the dense request (hscan and
          vscan once each, K1 never) and on the fused one (4 tile-high
          bands through K4, K2 never); answers equal the WF-TiS engine's
  stream  64 host uint8 frames of video_frames(480, 640) at 32 bins through
          HistogramEngine.map_frames at depth 1 and 2 and with
          adaptive_microbatch: K1 once a dispatch, every staged host buffer
          pinned, H at frames 0, 31 and 63 equal to K1 on the frame, every
          frame's histogram in order; frames/s and the adaptive
          controller's sizes
  tracker FragmentTracker (16 bins, radius 12, 2x2 fragments) on 480x640,
          two targets then one, over 32 frames: track, a step loop,
          step_fused (K2, one target) and track(incremental=True) on a
          low-motion stream (K1 on the dirty run, K3 below) give the same
          boxes, and track equals backend="torch" on the card; the
          number of distinct plans step_fused asked the gate for
  service AnalyticsService over the clip (4 queries a frame: two region
          queries, a stride-16 likelihood map, a grid of rects; frames 9
          and 14 again, as cache hits) and a 16-frame low-motion chain:
          answers equal engine.run's, counts of engine runs, coalesced
          requests, hits, updates and recomputes as expected, a full queue
          raises ServiceOverloaded; p50 and p95 latency and requests/s of
          requests made through submit()
  mesh    meshes that list the card 4 times (logical shards,
          launch.mesh.make_host_mesh): HistogramEngine(mesh=...).run on
          the 2160x3840x128 frame bin-sharded, spatially sharded (4 strips
          of 540 rows) and banded under 512 MiB both ways; each H and its
          region histograms equal one dense K1 launch bit for bit, K1
          once a shard a band; bin-sharded cw_tis (K4) and spatial bands
          staged at prefetch=1 with the ppermute scan equal it too.  The
          paper's §4.6 frame, 8192x8192 at 128 bins (32 GiB of H), dense
          with no mesh, bin-sharded and spatially sharded (4 strips of
          2048 rows): H's bottom row against per-column bincounts of the
          frame, its last column against per-row bincount prefix sums, 64
          seeded regions against direct counts, the largest bin at most
          2^24 px; ms by CUDA events and host clock, frames/s and the
          share of the byte bound.  DistributedAnalyticsService on a 2x2
          mesh (2 replica groups x 2 bin shards: K1) and on 4 one-device
          replicas (K2 a frame; the video chain pinned to one replica, K1
          and K3) against one AnalyticsService on the clip's trace
  analysis every plan that the main, bands, video, cw_tis, stream,
          tracker, service and mesh phases ran passed the engines' deep
          gate (run and map_frames validate before the first launch:
          analysis/plancheck.py with analysis/kernelcheck.py's proofs);
          kernelcheck proves K1-K4's specs at the default geometries and
          at K1_SHAPES, K2_SHAPES and the clip's K3 and K4 shapes, each
          verdict printed; three requests are refused with
          PlanValidationError and every launch counter at 0 (a 64-frame
          microbatch under a 1 MiB budget from a planner forced to it, a
          400x400 region on a uint16 engine, a 1x20000 frame); the gate's
          host µs warm, on a video frame's new plan, on a fused plan with
          new corner rows and on its first call, beside the one-frame
          fused request; python -m
          repro_torch.analysis --check exits 0.  Its launch check comes at
          the end of timing: each spec's grid, threads and shared bytes
          against the kernel events of an exported torch.profiler trace of
          one call at each of those shapes, the shared memory against the
          card's opt-in limit, registers x threads against an SM's 65,536
  lm      repro_torch.launch.serve.main on mamba2-130m at full size (24
          layers, d_model 768, vocab 50280), batch 4, 1024-token prompts,
          32 greedy tokens, seed 0: K5 once per layer of the prefill (24)
          and never in decode; the same request's prefill logits held
          against the fp32 model with the plain scan (fp32 with K5 within
          LM_ATOL32, the served bf16 within LM_PREC16 of the largest
          logit, which another prompt's logits and the model less its
          last layer must fail) and against the bf16 model with the
          plain scan (within LM_SCAN16), the greedy tokens the served and
          fp32 runs agree on, and warm prefill ms, decode ms per token
          and tokens/s beside the card line; the launch counts are read
          again where serve hands the prefilled cache to decode_loop, so
          prefill and decode are two paths of the kernels line
  transformer
          the dense, moe and vlm families, which run no kernel of ours
          (every request's counts all 0: paths tf_prefill, tf_decode,
          moe_prefill, moe_decode, tf_long_prefill): (a) the seven smoke
          configs in fp32, seed-0 weights made on the CPU and copied to the
          card, a 70-token prefill (chunked attention) and 4 decode steps
          against the port on the CPU (TF_CARD_ATOL), each step run with
          CUDA's sync debug mode at "error" (no host sync); (d)
          attention_chunked against attention at B=1, S=8192, 32/8 heads
          of 128, fp32 and bf16, with both times; the models at scale are
          served last (transformer at scale)
  train   repro_torch.launch.train.main on mamba2-130m at full size (bf16
          compute over fp32 master weights, AdamW), batch 4 x 1024
          tokens, 8 steps, a checkpoint every 4 steps into a temporary
          directory and a fault injected at step 6 (restored at step 4:
          10 steps run): K5 and K5-bwd once a layer in every step (24
          each); an uninterrupted run of the same 8 steps ends equal to
          the restarted one bit for bit; step 1 again out of the run
          (its state from the seed, the stream's batch 0): every
          parameter's gradient finite and non-zero somewhere (A_log and
          dt_bias included), equal to the run's step 1, and held against
          the fp32 model with the plain scan (the fp32 model with K5 and
          K5-bwd within TRAIN_*32_RTOL, the run's bf16 loss and grad norm
          within TRAIN_*16_RTOL); warm step ms, tokens/s and peak memory
          beside the card line
  timing  each kernel's median time (CUDA events) beside its bound, K1
          also at K1_SHAPES and K2 at K2_SHAPES with their launches per
          run; K1 and K2 at each shape and K5 profiled (torch.profiler:
          CUDA launches and device time a call); K1 in one strip against
          strips at K1_SWEEP_HEIGHTS, where launch_shape's strip threshold
          comes from; then host-clock request times (median of 5):
          incremental vs full recompute per video frame, the fused request
          on the clip and on one frame, the banded request, and the dense
          request with method="cw_tis" vs "wf_tis" (the paper's Fig. 7/8
          pair); a torch.profiler trace of 10 requests of each video kind
          and of the one-frame fused request (kernel launches, device busy
          and idle share, top CPU ops); the repair step of one video frame
          with K3 writing into the new H against the same walk joined by a
          torch.cat; last, the new phases' profiler sessions: a trace of
          the stream at each depth (the host-to-device copies on a stream
          other than K1's, how many overlap a K1 kernel, the device's idle
          share) and profiles of a stream frame, a tracker step, a
          service frame group, the §4.6 frame dense, bin-sharded and
          spatially sharded, and two train steps; then the analysis
          phase's launch check, and K5-bwd's two launches (the reverse
          state pass and the chunk kernel: grid, threads and shared bytes
          against ssd_scan.bwd_launches).  K5-bwd is timed at the training
          shape beside its plain version, its bound at the 3xTF32 rate
          with the fp32 one beside it and its chunk form's GFLOP, and the
          train step's share of it logged
  transformer at scale
          last, because after half a minute of this serving the card's
          kernel timestamps leave the profiler's window (Kineto counts
          them out of range and drops them, in this process or another)
          and every earlier trace would lose its kernels: profiles of a
          prefill and of decode steps of llava-next-mistral-7b and of the
          2-layer llama4-scout (kernel launches, device busy and idle
          share); then (b) llava-next-mistral-7b at full size through
          serve.main (batch 4, 576 prefix embeddings + 1024-token prompts,
          32 greedy tokens, seed 0; dense attention every layer and step),
          a prompt + gen cache refusing the prefill before any launch, the
          fp32 model's prefill + 4 decode steps through an fp32 cache
          against one full forward (TF_CACHE_ATOL32), the served bf16
          prefill within TF_PREC16 of the largest fp32 logit (another
          prompt's logits and the model less its last layer must fail it),
          warm prefill ms, decode ms a token, tokens/s and peak memory, and
          one bf16 prefill of 1 x 8192 tokens (chunked attention in every
          layer); (c) llama4-scout-17b-a16e at its published widths cut to
          2 layers, the same request: each MoE layer of the fp32 prefill
          against moe_block_plain (TF_MOE_RTOL), its dropped assignments
          and aux loss, the cache against the full forward (capacity factor
          16: no drops), the bf16 reading and times; the kernels line's
          launches_by_path are read after it

Every request of the main, bands, video, cw_tis, stream, tracker,
service, mesh, lm, transformer, train and transformer at scale phases
runs with all seven launch counters set to 0 just before it and read
just after; the kernels line carries each kernel's counts per path
(``launches_by_path``).

The line before the last is the per-kernel JSON record, the last line
``{"ok": true, "device": {...}}``.  Without a GPU, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data sheet: HBM3 bandwidth, fp32 (non-tensor-core) peak, and
# the dense TF32 tensor-core peak over 3: K5 computes each needed product
# as three TF32 products (3xTF32).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32X3_OPS_PER_S = 495e12 / 3
MAP_RTOL, MAP_ATOL = 1e-6, 1e-7
# K5 against its plain version (TF32 off): the kernel's 3xTF32 products
# keep about fp32 accuracy, the sums run in another order, and the kernel
# takes 64-step chunks where the plain loop takes 256;
# |got - want| <= K5_ATOL + K5_RTOL * |want| elementwise.
K5_ATOL, K5_RTOL = 1e-4, 1e-4
# K5-bwd against its plain version (TF32 off), and SSDScanFunction's
# gradients against autograd of the plain scan: each gradient's largest
# error over its largest magnitude.  The kernel takes the chunk form's
# products in 3xTF32 over 64-step chunks and sums gB and gC over groups
# of heads, the plain version takes fp32 products over 256-step chunks;
# gA sums B x S terms with cancellation.  Largest measured on the H100
# 1.41e-5 (gA of SSDScanFunction at dt = 0.69, chunk 256).
K5BWD_RTOL = 1e-4
# Mamba2-130M prefill logits (last position).  The fp32 model with K5
# against the fp32 model with the plain scan: the scan's rounding only.
LM_ATOL32 = 1e-3
# The served bf16 model, as fractions of the largest |logit| of the fp32
# reference.  Against the bf16 model with the plain scan: a change of the
# scan's rounding alone (chunk 32 vs 16) moves a narrow 24-layer model of
# this family by 4.7% of it in bf16.  Against the fp32 model with the
# plain scan: bf16 activations through 24 layers read 12.4% at full width
# on the H100, and the fp32 model less its last layer reads 23.7% (another
# prompt's logits 138.8%); the gate lies between the sound reading and the
# faults, and the phase checks that both faults fail it.  On the CPU the
# port's bf16 rounds like the reference compiled without XLA's excess
# precision
# (tests/test_torch_models.py::test_bf16_drift_at_depth_matches_reference).
LM_SCAN16 = 0.15
LM_PREC16 = 0.18
# The lm phase's request (the issue's serving geometry).
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN, LM_SEED = "mamba2-130m", 4, 1024, 32, 0
# The train phase (the issue's training geometry): Mamba2-130M at full
# size, bf16 compute over fp32 master weights, AdamW; steps, batch,
# tokens a row, checkpoint interval, the step a fault is injected at.
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 1024
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT, TRAIN_SEED = 4, 6, 0
# Step 1 of the training run held against the same step of the fp32 model
# with the plain scan on the card.  The fp32 model with K5 and K5-bwd: the
# scan's rounding only (relative: loss, grad norm, each gradient over its
# largest magnitude).  The trained bf16 model: bf16 activations through 24
# layers (relative: loss, grad norm).
# Measured on the H100: fp32 loss equal, grad norm 3.9e-6, largest
# gradient error 1.5e-4 (the norms' scales); bf16 loss 1.1e-4, grad norm
# 1.7e-2.
TRAIN_LOSS32_RTOL, TRAIN_GNORM32_RTOL, TRAIN_GRAD32_RTOL = 1e-5, 1e-4, 1e-3
TRAIN_LOSS16_RTOL, TRAIN_GNORM16_RTOL = 1e-3, 0.05
# The transformer phase (no kernel of ours runs on it).  (a) The seven
# smoke configs in fp32 (seed-0 weights made on the CPU and copied to the
# card): a prefill of TF_SMOKE_PROMPT tokens (the chunked attention path)
# and TF_SMOKE_STEPS decode steps, the card's logits against the CPU's
# (|logit| up to ~5; TF32 off, matmuls sum in another order; measured on
# the H100 4.2e-6).
TF_ARCHS = ("qwen2-1.5b", "qwen2.5-3b", "qwen3-4b", "llama3-8b",
            "llama4-scout-17b-a16e", "kimi-k2-1t-a32b",
            "llava-next-mistral-7b")
TF_SMOKE_PROMPT, TF_SMOKE_STEPS = 70, 4
TF_CARD_ATOL = 1e-4
# (b) llava-next-mistral-7b at its published widths and depth and (c)
# llama4-scout-17b-a16e at its published widths, its 48 layers cut to
# TF_MOE_LAYERS (109B parameters do not fit in 80 GB), each served through
# serve.main: batch, prompt tokens (after llava's 576 prefix embeddings),
# greedy tokens, seed.
TF_VLM_ARCH, TF_MOE_ARCH, TF_MOE_LAYERS = (
    "llava-next-mistral-7b", "llama4-scout-17b-a16e", 2)
TF_BATCH, TF_PROMPT, TF_GEN, TF_SEED = 4, 1024, 32, 0
# fp32 prefill + TF_CACHE_STEPS decode steps through an fp32 cache against
# one full forward with no cache (logits up to ~5): the sums' order only;
# measured on the H100 1.2e-5 (llava), 2.1e-5 (scout).
TF_CACHE_STEPS, TF_CACHE_ATOL32 = 4, 1e-4
# llava's served bf16 prefill logits against the fp32 model, as a fraction
# of the largest fp32 logit: 1.3% on the H100, where the fp32 model less
# its last layer reads 19.0% and another prompt's logits 132.5%; the gate
# lies between the sound reading and the faults (near their geometric
# mean), and the phase checks that both faults fail it.
TF_PREC16 = 0.05
# Each MoE layer's output on the fp32 prefill against moe_block_plain (a
# per-expert loop), as a fraction of its largest |output|: measured on
# the H100 3.4e-6.
TF_MOE_RTOL = 1e-4
# (d) attention_chunked against attention at B=1, S=TF_LONG, llava's
# heads (32 query, 8 kv, 128 wide), max abs error: measured on the H100
# 7.7e-7 in fp32, 1.6e-2 in bf16 (the chunked path rounds unnormalized
# probabilities to bf16, the dense path normalized ones); then one bf16
# prefill of 1 x TF_LONG tokens through llava.
TF_LONG = 8192
TF_CHUNK_ATOL32, TF_CHUNK_ATOL16 = 1e-5, 0.05
# K1's shapes, (n, h, w, bins, with a carry), and the paths whose launches
# each one counts: the dense clip; one frame (the first video frame and
# the 50% fallback); a video frame's 48-row dirty run with its carry; one
# band of the 4K frame with its carry; a bin shard and a row strip of the
# §4.6 frame over 4 shards (the strip with its prefix as the carry); and
# 1080p, on no path of this run.
K1_SHAPES = {
    "clip": ((16, 480, 640, 32, False), ("dense",)),
    "frame": ((1, 480, 640, 32, False),
              ("video_first", "video_fallback", "stream_d1", "stream_d2")),
    "dirty run": ((1, 48, 640, 32, True), ("video", "video_bottom")),
    "band": ((1, 273, 3840, 128, True),
             ("bands", "bands_rows", "spilled", "bands_prefetch")),
    "tracker frame": ((1, 480, 640, 16, False),
                      ("tracker_init", "tracker_track", "tracker_step")),
    "4.6 bin shard": ((1, 8192, 8192, 32, False), ("mesh_frame_bin",)),
    "4.6 row strip": ((1, 2048, 8192, 128, True), ("mesh_frame_spatial",)),
    "1080p": ((4, 1080, 1920, 64, False), ()),
}
# K2's shapes, (n, h, w, bins, rows), and the paths whose launches each one
# counts: the clip's fused request (its 62 corner rows: every 8th row and a
# rect's rows 99 and 219); one frame with the same rows (a real-time
# stream's request, the main phase's one-frame request); one frame with one
# rect's rows; and the clip at the fuse bound, h / 4 = 120 rows.
CLIP_ROWS = tuple(sorted(set(range(7, 480, 8)) | {99, 219}))
K2_SHAPES = {
    "clip": ((16, 480, 640, 32, CLIP_ROWS), ("fused",)),
    "frame": ((1, 480, 640, 32, CLIP_ROWS), ("fused_frame",)),
    "rect": ((1, 480, 640, 32, (99, 219)), ()),
    "clip 120": ((16, 480, 640, 32, tuple(range(3, 480, 4))), ()),
}
# Heights of a 640-column run at 32 bins with a carry, timed in one strip
# and in strips: the video's dirty runs, up to the 50% fallback, and a
# whole frame.
K1_SWEEP_HEIGHTS = (48, 64, 80, 96, 112, 128, 160, 192, 240, 480)
# K5 at the Mamba2-130M prefill: batch, steps, heads, P, N, and the chunk
# of the plain loop.
K5_SHAPE = (4, 1024, 24, 64, 128, 256)
# The mesh phase: logical shards of one card, and the paper's §4.6 frame
# (FRAME_46 x FRAME_46 at 128 bins, 32 GiB of H).
MESH_SHARDS = 4
FRAME_46 = 8192
# The stream phase: host frames of the paper's geometry through
# HistogramEngine.map_frames.
STREAM_FRAMES = 64
# Traces a launch check takes at most when the profiler drops a call's
# kernel events.
TRACE_ATTEMPTS = 3
# The tracker phase: frames tracked after the first, its bins and radius.
TRACK_FRAMES, TRACK_BINS, TRACK_RADIUS = 32, 16, 12


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = 11, launches: int = 10) -> float:
    """Median over ``runs`` of the per-launch time of ``launches``
    back-to-back calls between two CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def request_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of ``reps`` calls of ``fn``, each ended by a
    synchronize, after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def low_motion_stream(h: int, w: int, n: int, dirty_rows: int, seed: int):
    """n uint8 frames; each rewrites ``dirty_rows`` rows of its predecessor
    at a seeded random position (as benchmarks/bench_delta.py builds its
    low-motion streams)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (h, w), dtype=np.uint8)]
    for _ in range(n - 1):
        nxt = frames[-1].copy()
        r = int(rng.integers(0, h - dirty_rows + 1))
        nxt[r:r + dirty_rows] = rng.integers(0, 256, (dirty_rows, w),
                                             dtype=np.uint8)
        frames.append(nxt)
    return frames


def profile_requests(torch, requests, n: int = 10) -> str:
    """Where ``n`` requests spend their time, from one torch.profiler
    trace (CPU and CUDA activity): kernel launches and device busy time
    per request, the device's idle share of the wall time, and the CPU
    ops with the most self time.  Device time is summed over the device's
    own events (kernels, copies, sets) only: an op that launches a kernel
    carries that kernel's time as its own self device time too.  The
    profiler's own cost inflates the CPU times; "not measured" when the
    trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        requests()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(device_us(e) for e in events
               if e.device_type != DeviceType.CPU)
    both = sum(device_us(e) for e in events)     # ops and kernels alike
    if busy <= 0:
        return "not measured (the trace holds no device time)"
    launches = sum(e.count for e in events if "LaunchKernel" in e.key)
    top = sorted((e for e in events if e.self_cpu_time_total > 0),
                 key=lambda e: -e.self_cpu_time_total)[:6]
    ops = ", ".join(f"{e.key} {e.self_cpu_time_total / n / 1e3:.3f}"
                    for e in top)
    return (f"{launches / n:.1f} kernel launches, device busy "
            f"{busy / n / 1e3:.4f} ms of {wall_us / n / 1e3:.3f} ms wall "
            f"(idle {1 - busy / wall_us:.1%}; summed over ops and kernels "
            f"alike {both / n / 1e3:.4f} ms) a request; most CPU self "
            f"time a request (ms, profiled): {ops}")


def k1_inputs(torch, dev, n, h, w, bins, with_carry, seed=11):
    """Seeded (n, h, w) int32 bin ids and, ``with_carry``, an (n, bins, w)
    fp32 carry of integer counts (None without)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(rng.integers(0, bins, (n, h, w)),
                          dtype=torch.int32, device=dev)
    carry = (torch.as_tensor(rng.integers(0, 5000, (n, bins, w)),
                             dtype=torch.float32, device=dev)
             if with_carry else None)
    return ids, carry


def k1_bytes(ids, bins, carry) -> int:
    """Bytes K1's function moves: the ids and the carry read once, H
    written once (a pre-pass's second read of the ids is the kernel's
    cost, not the function's)."""
    return 4 * ids.numel() * (bins + 1) + (
        4 * carry.numel() if carry is not None else 0)


def k2_bytes(ids, bins, rows, carry) -> int:
    """Bytes K2's function moves: the ids of rows [0, rows[-1]] and the
    carry read once, the requested rows written once."""
    n, _, w = ids.shape
    return 4 * n * w * (rows[-1] + 1 + bins * len(rows)) + (
        4 * carry.numel() if carry is not None else 0)


def ssd_inputs(torch, dev, seed, s=K5_SHAPE[1]):
    """K5's inputs at K5_SHAPE with ``s`` steps, in the ranges the model
    hands the scan: x, softplus step sizes dt, A = -exp(small), B and C
    of the conv + silu's scale, and a random h0."""
    import numpy as np

    sb, _, sh, sp, sn, _ = K5_SHAPE
    r = np.random.default_rng(seed)
    arrays = (r.standard_normal((sb, s, sh, sp)),
              np.log1p(np.exp(r.standard_normal((sb, s, sh)))),
              -np.exp(r.standard_normal(sh) * 0.2),
              r.standard_normal((sb, s, 1, sn)) * 0.3,
              r.standard_normal((sb, s, 1, sn)) * 0.3,
              r.standard_normal((sb, sh, sn, sp)))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in arrays]


def device_kernels(torch, fn, calls: int = 10):
    """What one call of ``fn`` runs on the device, from a torch.profiler
    trace: its kernel launches a call (copies and sets left out), and the
    device µs a call of its device events (kernels, copies, sets) by name,
    over ``calls`` warm calls inside one
    ``record_function`` range.  The range's mark on the device's timeline
    spans the device work of its calls, on the kernels' own clock, and is
    the window (the range on the host's clock where the trace has no such
    mark).  Left out of the count: the trace's first call (a trace can
    miss the launches just after it starts), every event outside the
    window, and the mark itself.  None and {} when the window holds no
    device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = "chip_smoke.device_kernels"
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function(mark):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    marks = sorted((e for e in events if e.name == mark),
                   key=lambda e: e.device_type == DeviceType.CPU)
    window = marks[0].time_range                # the device's mark first
    inside = [e for e in events         # 1 µs for the clocks' rounding
              if e.device_type != DeviceType.CPU and e.name != mark
              and window.start - 1 <= e.time_range.start <= window.end + 1]
    if not inside:
        return None, {}
    us: dict[str, float] = {}
    for e in inside:
        us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us() / calls
    kernels = [e for e in inside if not e.name.startswith(("Memcpy",
                                                           "Memset"))]
    return len(kernels) / calls, us


def trace_streams(torch, fn):
    """Run ``fn`` under torch.profiler and read its device timeline from
    the exported trace: (host-to-device copies, K1 kernels, every device
    event), each a list of (stream, start µs, end µs), and the run's wall
    µs on the host's clock.  K1's kernels are its count pre-pass and its
    strip scan."""
    import re
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    k1 = re.compile(r"\b(?:scan|count)_kernel\b")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    copies, kernels, device = [], [], []
    for e in events:
        cat = str(e.get("cat", "")).lower()
        if e.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy",
                                             "gpu_memset"):
            continue
        span = (e.get("args", {}).get("stream"), float(e["ts"]),
                float(e["ts"]) + float(e.get("dur", 0.0)))
        device.append(span)
        name = str(e.get("name", ""))
        if cat == "gpu_memcpy" and "HtoD" in name:
            copies.append(span)
        elif cat == "kernel" and k1.search(name.split("(")[0]):
            kernels.append(span)
    return copies, kernels, device, wall_us


def traced_launches(torch, fn, per_call: int) -> list[dict]:
    """The CUDA launches of one call of ``fn`` as an exported
    torch.profiler trace records them: each kernel event's name, grid,
    block, shared memory and registers per thread.  ``fn`` runs twice in
    the trace (its first launch is often missed as the trace starts); the
    last ``per_call`` kernel events are the second call's.  A trace that
    misses more than that first launch (the profiler can drop a
    session's events, even all of them) is taken again, up to
    ``TRACE_ATTEMPTS`` traces; the last one is read whatever it holds."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = pathlib.Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text()).get("traceEvents", [])
        kernels = sorted((e for e in events if e.get("ph") == "X" and str(
            e.get("cat", "")).lower() == "kernel"), key=lambda e: e["ts"])
        if len(kernels) >= 2 * per_call - 1:
            break
        log(f"   (trace {attempt + 1}: {len(kernels)} kernel events of the "
            f"two calls' {2 * per_call}; "
            + ("taken again)" if attempt + 1 < TRACE_ATTEMPTS
               else "read as is)"))
    out = []
    for e in kernels[-per_call:] if per_call else []:
        a = e.get("args", {})
        out.append({"name": str(e.get("name", "")),
                    "grid": a.get("grid"), "block": a.get("block"),
                    "smem": a.get("shared memory"),
                    "regs": a.get("registers per thread")})
    return out


def smem_optin_bytes(torch) -> tuple[int, str]:
    """The card's opt-in shared memory a block may use, and where it was
    read: the device properties, else ``cudaDeviceGetAttribute``
    (cudaDevAttrMaxSharedMemoryPerBlockOptin) from the CUDA runtime."""
    import ctypes

    props = torch.cuda.get_device_properties(0)
    value = getattr(props, "shared_memory_per_block_optin", None)
    if value:
        return int(value), "torch.cuda.get_device_properties"
    for name in ("libcudart.so", "/usr/local/cuda/lib64/libcudart.so"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        out = ctypes.c_int(0)
        if lib.cudaDeviceGetAttribute(ctypes.byref(out), 97, 0) == 0:
            return out.value, "cudaDeviceGetAttribute"
    raise SmokeFailure("could not read the card's opt-in shared memory")


def busy_us(spans) -> float:
    """Time covered by the union of (stream, start, end) spans."""
    total, end = 0.0, None
    for _, a, b in sorted(spans, key=lambda x: x[1]):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def phase(name: str):
    import torch

    class _Phase:
        def __enter__(self):
            self.t0 = time.perf_counter()
            phase.current = name
            log(f"== {name}")

        def __exit__(self, *exc):
            torch.cuda.synchronize()
            if exc[0] is None:
                log(f"   {name} ok in {time.perf_counter() - self.t0:.1f} s")
            return False

    return _Phase()


phase.current = None        # the name of the phase that is running


def tree_to(tree, dev):
    """A nested dict of tensors copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def no_sync(torch, fn, what: str):
    """``fn()`` with CUDA's sync debug mode at "error": a call that waits
    for the card on the host (an ``.item()``, a copy to the host, a
    bincount's size) raises, and the phase fails."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        raise SmokeFailure(f"{what} waits for the card on the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")


class CallCount:
    """Counts the calls of a module's function while it is installed
    (``with CallCount(mod, "name") as c: ...; c.calls``)."""

    def __init__(self, mod, name: str):
        self.mod, self.name, self.calls = mod, name, 0
        self.orig = getattr(mod, name)

    def __enter__(self):
        def wrapped(*args, **kwargs):
            self.calls += 1
            return self.orig(*args, **kwargs)
        setattr(self.mod, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)
        return False


def transformer_phase(torch, dev, counted, tally, read_counts, only):
    """The transformer phase (see the module docstring): (a) the seven
    smoke configs on the card against the CPU, (d) chunked against dense
    attention at llava's head shape.  The models at scale are served last
    (``transformer_at_scale``)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import api, layers

    def zero(counts, what):
        tf_zero(counts, what, only)

    # (a) the seven smoke configs in fp32: the card against the CPU, each
    # prefill and decode step on the card with the sync debug mode on.
    smoke_errs = {}
    for arch in TF_ARCHS:
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        cpu_model = api.init_params(torch.Generator().manual_seed(TF_SEED),
                                    cfg)
        card_model = api.model_over(
            tree_to(api.stacked_params(cpu_model), dev), cfg)
        rng = np.random.default_rng(21)
        toks = rng.integers(0, cfg.vocab_size,
                            (2, TF_SMOKE_PROMPT + TF_SMOKE_STEPS))
        prefix = (rng.standard_normal((2, cfg.num_prefix_embeds,
                                       cfg.d_model)) * 0.02
                  if cfg.family == "vlm" else None)
        max_len = (cfg.num_prefix_embeds + TF_SMOKE_PROMPT + TF_SMOKE_STEPS)
        out = {}
        for where, model, d in (("cpu", cpu_model, torch.device("cpu")),
                                ("card", card_model, dev)):
            t = torch.as_tensor(toks, dtype=torch.int32, device=d)
            batch = {"tokens": t[:, :TF_SMOKE_PROMPT]}
            if prefix is not None:
                batch["prefix_embeds"] = torch.as_tensor(
                    prefix, dtype=torch.float32, device=d)
            cache = api.init_cache(cfg, 2, max_len, dtype=torch.float32,
                                   device=d)
            steps = []

            def prefill():
                return api.prefill(model, batch, cfg, cache)

            if where == "card":
                (lg, cache), _, counts = counted(tf_path(cfg, "prefill"), (
                    lambda: no_sync(torch, prefill, f"{arch}'s prefill")))
                zero(counts, f"{arch}'s prefill")
            else:
                lg, cache = prefill()
            steps.append(lg)
            for i in range(TF_SMOKE_PROMPT, TF_SMOKE_PROMPT + TF_SMOKE_STEPS):
                def step(i=i, cache=cache):
                    return api.decode_step(model, t[:, i:i + 1], cfg, cache)
                if where == "card":
                    (lg, cache), _, counts = counted(
                        tf_path(cfg, "decode"), lambda: no_sync(
                            torch, step, f"{arch}'s decode step"))
                    zero(counts, f"{arch}'s decode step")
                else:
                    lg, cache = step()
                steps.append(lg)
            out[where] = torch.stack(steps, 1).cpu()
        err = float((out["card"] - out["cpu"]).abs().max())
        smoke_errs[arch] = err
        check(bool(torch.isfinite(out["card"]).all()), f"{arch}: logits")
        check(err <= TF_CARD_ATOL, f"{arch}: the card's logits are off the "
              f"CPU's by {err}")
        del cpu_model, card_model, cache
    log(f"   (a) smoke configs, fp32, prefill {TF_SMOKE_PROMPT} tokens "
        f"(chunked attention) + {TF_SMOKE_STEPS} decode steps, card vs CPU "
        f"(tolerance {TF_CARD_ATOL}), no host sync in any step: "
        + ", ".join(f"{a} {e:.3e}" for a, e in smoke_errs.items()))

    # (d) chunked against dense attention at llava's head shape.
    vcfg = get_config(TF_VLM_ARCH)
    g = torch.Generator(device=dev).manual_seed(TF_SEED)
    hq, hkv, hd = vcfg.num_heads, vcfg.num_kv_heads, vcfg.head_dim
    q = torch.randn((1, TF_LONG, hq, hd), generator=g, device=dev)
    k = torch.randn((1, TF_LONG, hkv, hd), generator=g, device=dev)
    v = torch.randn((1, TF_LONG, hkv, hd), generator=g, device=dev)
    pos = torch.arange(TF_LONG, device=dev, dtype=torch.int32)[None]
    for dt, atol in ((torch.float32, TF_CHUNK_ATOL32),
                     (torch.bfloat16, TF_CHUNK_ATOL16)):
        qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
        kw = dict(positions_q=pos, positions_kv=pos, causal=True)
        dense = layers.attention(qd, kd, vd, **kw)
        chunked = layers.attention_chunked(qd, kd, vd,
                                           block_kv=vcfg.attn_block_kv, **kw)
        err = float((dense.float() - chunked.float()).abs().max())
        del dense, chunked
        torch.cuda.empty_cache()
        dense_ms = time_ms(lambda: layers.attention(qd, kd, vd, **kw),
                           runs=3, launches=1)
        torch.cuda.empty_cache()
        chunked_ms = time_ms(lambda: layers.attention_chunked(
            qd, kd, vd, block_kv=vcfg.attn_block_kv, **kw), runs=3,
            launches=1)
        log(f"   (d) attention_chunked vs attention, B=1, S={TF_LONG}, "
            f"Hq={hq}, Hkv={hkv}, D={hd}, {dt}: max abs err {err:.3e} "
            f"(tolerance {atol}); dense {dense_ms:.3f} ms, chunked (blocks "
            f"of {vcfg.attn_block_kv}) {chunked_ms:.3f} ms (CUDA events, "
            f"median of 3)")
        check(err <= atol, f"chunked attention off dense by {err} in {dt}")
        del qd, kd, vd
    del q, k, v
    torch.cuda.empty_cache()


def transformer_at_scale(torch, dev, counted, tally, read_counts, only):
    """The profiles of a prefill and a decode step of both models, then
    (b) llava-next-mistral-7b served at full size, with the 8192-token
    prefill, and (c) llama4-scout at its published widths and
    TF_MOE_LAYERS layers.  The last phase: after half a minute of this
    serving the card's kernel timestamps leave the profiler's window
    (Kineto counts them out of range and drops them), in this process and
    in any other, so every profiler trace comes before it."""
    transformer_profiles(torch, dev)
    for arch in (TF_VLM_ARCH, TF_MOE_ARCH):
        serve_at_scale(torch, dev, arch, counted, tally, read_counts, only)


def tf_path(cfg, stage: str) -> str:
    """The kernels line's path of a transformer request: tf_prefill,
    tf_decode, moe_prefill or moe_decode."""
    return f"{'moe' if cfg.is_moe else 'tf'}_{stage}"


def tf_zero(counts, what: str, only) -> None:
    check(counts == only(), f"{what} launched {counts}, want no kernel of "
          "ours (no TPU kernel lies on this path)")


def tf_config(arch):
    """The config the phase serves: the published one, llama4-scout's
    depth cut to TF_MOE_LAYERS."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch == TF_MOE_ARCH:
        cfg = dataclasses.replace(cfg, num_layers=TF_MOE_LAYERS)
    return cfg


def serve_at_scale(torch, dev, arch, counted, tally, read_counts, only):
    """(b) or (c): ``arch`` served through serve.main, its logits held
    against the fp32 model, warm times; llava's 8192-token prefill."""
    import dataclasses

    from repro_torch.launch import serve
    from repro_torch.models import api, layers, moe, transformer
    from repro_torch.train.serve_step import decode_loop, make_serve_fns

    def zero(counts, what):
        tf_zero(counts, what, only)

    cfg = tf_config(arch)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    argv = ["--arch", arch, "--batch", str(TF_BATCH), "--prompt-len",
            str(TF_PROMPT), "--gen", str(TF_GEN), "--seed", str(TF_SEED)]
    at_decode = {}
    serve_decode_loop, serve_get_config = serve.decode_loop, serve.get_config

    def observed_decode_loop(*args, **kwargs):
        torch.cuda.synchronize()
        at_decode.update(read_counts())
        return serve_decode_loop(*args, **kwargs)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    serve.decode_loop = observed_decode_loop
    serve.get_config = tf_config
    try:
        with CallCount(layers, "attention") as dense_calls, \
                CallCount(layers, "attention_chunked") as chunked_calls:
            served, t_serve, counts = counted(None, lambda: serve.main(argv))
    finally:
        serve.decode_loop, serve.get_config = (serve_decode_loop,
                                               serve_get_config)
    serve_peak = torch.cuda.max_memory_allocated()
    decode_counts = {k: counts[k] - at_decode[k] for k in counts}
    tally(tf_path(cfg, "prefill"), at_decode)
    tally(tf_path(cfg, "decode"), decode_counts)
    zero(at_decode, f"{arch}'s served prefill")
    zero(decode_counts, f"{arch}'s {TF_GEN} decode steps")
    attn_calls = cfg.num_layers * (1 + TF_GEN)
    check(dense_calls.calls == attn_calls and chunked_calls.calls == 0,
          f"serve.main ran dense attention {dense_calls.calls} times and "
          f"chunked {chunked_calls.calls}, want {attn_calls} and 0")
    check(tuple(served.shape) == (TF_BATCH, TF_GEN)
          and served.dtype == torch.int32 and 0 <= int(served.min())
          and int(served.max()) < cfg.padded_vocab,
          f"served tokens {tuple(served.shape)} {served.dtype}")
    log(f"   {arch} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, vocab "
        f"{cfg.vocab_size}" + (f", {cfg.num_experts} experts top-"
                                f"{cfg.num_experts_per_token} + "
                                f"{cfg.num_shared_experts} shared"
                                if cfg.is_moe else "")
        + (f", {cfg.num_prefix_embeds} prefix embeddings"
           if cfg.family == "vlm" else "")
        + f"): serve.main (cold) {t_serve * 1e3:.1f} ms, batch "
        f"{TF_BATCH}, {TF_PROMPT}-token prompts, {TF_GEN} greedy tokens; "
        f"launched {at_decode} then {decode_counts}; peak device memory "
        f"{serve_peak / 1e9:.2f} GB")
    del served

    # The same request again (weights, prompts, prefix from the seed).
    params, request = serve.make_request(cfg, TF_BATCH, TF_PROMPT, TF_SEED,
                                         dev)
    max_len = serve.cache_len(cfg, TF_PROMPT, TF_GEN)
    s_total = max_len - TF_GEN

    def fresh(dtype=torch.bfloat16):
        return api.init_cache(cfg, TF_BATCH, max_len, dtype=dtype)

    if cfg.family == "vlm":
        # the reference's sizing (prompt + gen) is refused before a launch
        small = api.init_cache(cfg, TF_BATCH, TF_PROMPT + TF_GEN)
        try:
            api.prefill(params, request, cfg, small)
            refused = False
        except ValueError as e:
            refused = "overrun" in str(e)
        check(refused and small.written == 0
              and int(small["seg0"]["len"]) == 0
              and not bool(small["seg0"]["k"].any()),
              "a prefill past a prompt + gen cache was not refused")
        log(f"   a {TF_PROMPT + TF_GEN}-position cache (the reference's "
            f"prompt + gen) refuses the {s_total}-position prefill with "
            "ValueError before any launch; serve.cache_len sizes it "
            f"{max_len}")
        del small
    (logits, cache), _, counts = counted(
        tf_path(cfg, "prefill"), lambda: api.prefill(params, request, cfg,
                                                     fresh()))
    zero(counts, f"{arch}'s prefill")
    check(tuple(logits.shape) == (TF_BATCH, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()), "prefill logits")
    first = torch.argmax(logits, dim=-1).to(torch.int32)

    # The fp32 model, prefill then TF_CACHE_STEPS decode steps through an
    # fp32 cache, against one full forward with no cache; for the moe, a
    # capacity factor that drops nothing (drops differ between a
    # T-token prefill and a longer forward), as the reference's own test.
    records = []
    if cfg.is_moe:
        moe_block = moe.moe_block

        def recording(x, p, c):
            out, aux = moe_block(x, p, c)
            records.append((x, p, out, aux))
            return out, aux

        moe.moe_block = recording
    try:
        (ref_logits, _), _, counts = counted(None, lambda: api.prefill(
            params, request, cfg32, fresh(torch.float32)))
    finally:
        if cfg.is_moe:
            moe.moe_block = moe_block
    zero(counts, f"{arch}'s fp32 prefill")
    if cfg.is_moe:
        for i, (x, p, out, aux) in enumerate(records):
            with torch.no_grad():
                want, dropped = moe.moe_block_plain(x, p, cfg32)
            err = float((out - want).abs().max())
            scale = float(want.abs().max())
            tokens = x.shape[0] * x.shape[1]
            log(f"   (c) MoE layer {i} of the fp32 prefill ({tokens} "
                f"tokens, capacity {moe._capacity(tokens, cfg32)}) vs the "
                f"plain per-expert loop: max abs err {err:.3e} (|out| up to "
                f"{scale:.3f}, tolerance {TF_MOE_RTOL} of it); {dropped} of "
                f"{tokens * cfg.num_experts_per_token} assignments dropped; "
                f"aux loss {float(aux):.6f}")
            check(err <= TF_MOE_RTOL * scale,
                  f"MoE layer {i} off the plain loop by {err}")
        del records
    cfg_cache = (dataclasses.replace(cfg32, capacity_factor=float(
        cfg.num_experts // cfg.num_experts_per_token))
        if cfg.is_moe else cfg32)
    steps_tok = torch.cat([first[:, None], torch.randint(
        0, cfg.vocab_size, (TF_BATCH, TF_CACHE_STEPS - 1),
        generator=torch.Generator(device=dev).manual_seed(TF_SEED + 1),
        device=dev, dtype=torch.int32)], 1)
    with torch.no_grad():
        lg, c = api.prefill(params, request, cfg_cache, fresh(torch.float32))
        steps = [lg]
        for i in range(TF_CACHE_STEPS):
            lg, c = api.decode_step(params, steps_tok[:, i:i + 1], cfg_cache,
                                    c)
            steps.append(lg)
        full_req = {**request, "tokens": torch.cat([request["tokens"],
                                                    steps_tok], 1)}
        full, _, _ = api.forward(params, full_req, cfg_cache)
        full = full[:, -(TF_CACHE_STEPS + 1):]
    err_cache = float((torch.stack(steps, 1) - full).abs().max())
    log(f"   fp32 prefill + {TF_CACHE_STEPS} decode steps through an fp32 "
        f"cache vs one full forward with no cache"
        + (f" (capacity factor {cfg_cache.capacity_factor})"
           if cfg.is_moe else "")
        + f": max abs err {err_cache:.3e} (|logit| up to "
        f"{float(full.abs().max()):.3f}, tolerance {TF_CACHE_ATOL32})")
    check(err_cache <= TF_CACHE_ATOL32,
          f"decode through the cache off the full forward by {err_cache}")
    del steps, full, c, full_req

    # The served bf16 prefill against the fp32 model, beside two wrong
    # answers the gate must refuse (another prompt's fp32 logits, the fp32
    # model less its last layer).
    tree = params.param_tree()
    last = f"seg{len(tree['segments']) - 1}"
    short_tree = {**tree, "segments": {
        **tree["segments"],
        last: {"layers": tree["segments"][last]["layers"][:-1]}}}
    cfg_short = dataclasses.replace(cfg32, num_layers=cfg.num_layers - 1)
    short = transformer.TransformerLM(cfg_short, short_tree)
    short_logits, _ = api.prefill(short, request, cfg_short, api.init_cache(
        cfg_short, TF_BATCH, max_len, dtype=torch.float32))
    scale = float(ref_logits.abs().max())
    err16 = float((logits - ref_logits).abs().max())
    err_other = float((logits - ref_logits.roll(1, 0)).abs().max())
    err_short = float((logits - short_logits).abs().max())
    log(f"   served bf16 prefill logits vs the fp32 model (|logit| up to "
        f"{scale:.3f}): {err16:.3e} ({err16 / scale:.1%}"
        + (f", gate {TF_PREC16:.0%}" if arch == TF_VLM_ARCH else
           ", not gated")
        + f"); wrong answers: another prompt's fp32 logits "
        f"{err_other / scale:.1%}, the fp32 model less its last layer "
        f"{err_short / scale:.1%}")
    if arch == TF_VLM_ARCH:
        check(err16 <= TF_PREC16 * scale,
              f"bf16 logits off the fp32 model by {err16}")
        check(min(err_other, err_short) > TF_PREC16 * scale,
              f"the bf16 gate passes a wrong answer (another prompt "
              f"{err_other}, one layer less {err_short})")
    agree = first == torch.argmax(ref_logits, dim=-1).to(torch.int32)
    log(f"   first greedy token, served bf16 vs fp32: {int(agree.sum())} of "
        f"{TF_BATCH} agree")
    del short, short_tree, tree, ref_logits, short_logits

    # Warm times of the served (bf16) request.
    prefill_fn, _ = make_serve_fns(cfg)
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = request_ms(lambda: prefill_fn(params, request, fresh()),
                            reps=3)
    decode_ms = request_ms(lambda: decode_loop(params, first, cache, cfg,
                                               TF_GEN), reps=3) / TF_GEN
    peak = torch.cuda.max_memory_allocated()
    log(f"   {arch}, bf16 over fp32 masters (cast every call), warm, host "
        f"clock, median of 3 | card {card_line()}")
    log(f"   prefill {TF_BATCH}x{s_total}: {prefill_ms:.3f} ms "
        f"({TF_BATCH * s_total / prefill_ms * 1e3:.0f} tokens/s); decode: "
        f"{decode_ms:.3f} ms per step of {TF_BATCH} tokens "
        f"({TF_BATCH / decode_ms * 1e3:.0f} tokens/s, {TF_GEN} steps); "
        f"peak device memory {peak / 1e9:.2f} GB")
    del cache, logits

    if cfg.family == "vlm":
        # (d) one bf16 prefill of TF_LONG tokens through the backbone: its
        # cache reaches flash_min_seq, so every layer takes the chunked path.
        long_req = {"tokens": torch.randint(
            0, cfg.vocab_size, (1, TF_LONG), dtype=torch.int32, device=dev,
            generator=torch.Generator(device=dev).manual_seed(TF_SEED))}

        def long_prefill():
            return prefill_fn(params, long_req,
                              api.init_cache(cfg, 1, TF_LONG))

        torch.cuda.reset_peak_memory_stats()
        with CallCount(layers, "attention") as dense_calls, \
                CallCount(layers, "attention_chunked") as chunked_calls:
            (toks, _), _, counts = counted("tf_long_prefill", long_prefill)
        zero(counts, "the long prefill")
        check(chunked_calls.calls == cfg.num_layers
              and dense_calls.calls == 0,
              f"the {TF_LONG}-token prefill ran chunked attention "
              f"{chunked_calls.calls} times and dense {dense_calls.calls}")
        long_ms = request_ms(long_prefill, reps=2)
        long_peak = torch.cuda.max_memory_allocated()
        log(f"   (d) {arch} bf16 prefill of 1x{TF_LONG} tokens (chunked "
            f"attention, blocks of {cfg.attn_block_kv}, in every layer): "
            f"{long_ms:.3f} ms warm, host clock, median of 2 "
            f"({TF_LONG / long_ms * 1e3:.0f} tokens/s); peak device memory "
            f"{long_peak / 1e9:.2f} GB | card {card_line()}")
        del toks
    del params, request, first
    torch.cuda.empty_cache()


def transformer_profiles(torch, dev):
    """The served models' profiles (the run's last): two bf16
    prefills and a few decode steps of each, its weights from the
    seed."""
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.train.serve_step import decode_loop, make_serve_fns

    for arch in (TF_VLM_ARCH, TF_MOE_ARCH):
        cfg = tf_config(arch)
        params, request = serve.make_request(cfg, TF_BATCH, TF_PROMPT,
                                             TF_SEED, dev)
        max_len = serve.cache_len(cfg, TF_PROMPT, TF_GEN)
        prefill_fn, _ = make_serve_fns(cfg)
        first, cache = prefill_fn(params, request, api.init_cache(
            cfg, TF_BATCH, max_len))
        steps = min(8, TF_GEN)          # the cache has room for TF_GEN
        decode_loop(params, first, cache, cfg, steps)
        log(f"   {arch} ({cfg.num_layers} layers) prefill "
            f"{TF_BATCH}x{max_len - TF_GEN}, torch.profiler over 2: "
            + profile_requests(torch, lambda: [
                prefill_fn(params, request, api.init_cache(
                    cfg, TF_BATCH, max_len)) for _ in range(2)], n=2))
        log(f"   {arch} decode step, batch {TF_BATCH}, torch.profiler over "
            f"{steps}: " + profile_requests(
                torch, lambda: decode_loop(params, first, cache, cfg, steps),
                n=steps)
            + f" | card {card_line()}")
        del params, request, cache, first
        torch.cuda.empty_cache()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # Exactness: no TF32 anywhere (the kernels use plain fp32 adds).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        kernels = run(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(torch) -> list[dict]:
    import dataclasses

    import numpy as np

    from repro_torch.core import bands as bands_mod
    from repro_torch.core import delta as delta_mod
    from repro_torch.core import distances
    from repro_torch.core import engine as eng_mod
    from repro_torch.core import region_query as rq
    from repro_torch.core.binning import bin_indices
    from repro_torch.core.integral_histogram import IntegralHistogram
    from repro_torch.data import video_frames
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.cw_tis import (
        cw_tis_cuda, cw_tis_hscan_cuda, cw_tis_hscan_plain, cw_tis_plain,
        cw_tis_vscan_cuda, cw_tis_vscan_plain,
    )
    from repro_torch.kernels.delta_apply import (
        delta_apply_cuda, delta_apply_plain,
    )
    from repro_torch.kernels.fused_rows import (
        chunk_plan, chunk_shape, fused_rows_cuda, fused_rows_plain,
    )
    from repro_torch.kernels.ref import region_histogram_ref
    from repro_torch.kernels.ssd_scan import (
        KERNEL_CHUNK, bwd_heads_per_cta, bwd_launches, ssd_scan_bwd_cuda,
        ssd_scan_bwd_plain, ssd_scan_cuda, ssd_scan_plain,
    )
    from repro_torch.kernels import wf_tis as wf_tis_mod
    from repro_torch.kernels.wf_tis import (
        launch as wf_tis_launch, launch_shape, strip_rows_for, wf_tis_cuda,
        wf_tis_plain,
    )

    dev = torch.device("cuda")
    wrappers = {"wf_tis": wf_tis_cuda, "fused_rows": fused_rows_cuda,
                "delta_apply": delta_apply_cuda,
                "cw_tis_hscan": cw_tis_hscan_cuda,
                "cw_tis_vscan": cw_tis_vscan_cuda,
                "ssd_scan": ssd_scan_cuda, "ssd_scan_bwd": ssd_scan_bwd_cuda}
    paths: dict[str, dict[str, int]] = {}      # path -> kernel -> launches

    def read_counts():
        return {k: wrapper.launches for k, wrapper in wrappers.items()}

    def tally(path, counts):
        total = paths.setdefault(path, dict.fromkeys(wrappers, 0))
        for k, v in counts.items():
            total[k] += v

    def counted(path, fn):
        """Run one request with every launch counter set to 0 just before
        it and read just after; add the counts to ``path``'s total (none
        when ``path`` is None)."""
        for wrapper in wrappers.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        if path is not None:
            tally(path, counts)
        return out, dt, counts

    def only(**launches):
        """The counts of a request that launches just these kernels."""
        want = dict.fromkeys(wrappers, 0)
        want.update(launches)
        return want

    # Every deep verdict of the engines' gate (run and map_frames validate
    # their plan with deep=True before the first launch), with its phase.
    gate_log: list = []
    gate_validate = eng_mod.HistogramEngine.validate

    def recording_validate(self, p=None, queries=(), *, deep=False):
        verdict = gate_validate(self, p, queries, deep=deep)
        if deep:
            gate_log.append((phase.current, self.last_plan if p is None
                             else p, verdict))
        return verdict

    eng_mod.HistogramEngine.validate = recording_validate

    log(f"device: {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} | CUDA {torch.version.cuda}")
    log(f"card: {card_line()}")

    with phase("build"):
        t0 = time.perf_counter()
        libs = _build.build_all()
        log(f"   built {sorted(libs)} in {time.perf_counter() - t0:.1f} s; "
            "nvcc seconds by source: " + (", ".join(
                f"{src} {sec:.1f}" for src, sec in sorted(
                    _build.build_seconds.items(), key=lambda kv: -kv[1]))
                or "none (all built before)"))

    n, h, w, nb = 16, 480, 640, 32
    clip_np = video_frames(h, w, n, seed=0)
    clip = torch.as_tensor(clip_np, device=dev)

    with phase("k1: wf_tis kernel vs its plain version"):
        idx = bin_indices(clip, nb).contiguous()
        got = wf_tis_cuda(idx, nb)
        want = wf_tis_plain(idx, nb)
        check(torch.equal(got, want), "K1 != plain at 16x480x640x32")
        k1_err = float((got - want).abs().max())
        log(f"   {n}x{h}x{w}x{nb}: equal (H {got.numel() * 4 / 1e6:.0f} MB)")
        del got, want

        big_np = video_frames(1080, 1920, 4, seed=1)
        big = bin_indices(torch.as_tensor(big_np, device=dev), 64).contiguous()
        got = wf_tis_cuda(big, 64)
        want = wf_tis_plain(big, 64)
        check(torch.equal(got, want), "K1 != plain at 4x1080x1920x64")
        log(f"   4x1080x1920x64: equal (H {got.numel() * 4 / 1e9:.2f} GB)")
        del got, want
        torch.cuda.empty_cache()

        rng = np.random.default_rng(2)
        cases = [((1, 1), 1, False), ((5, 7), 8, True),
                 ((3, 97, 131), 32, True), ((2, 33, 4099), 3, True)]
        for shape, bins, with_carry in cases:
            x = torch.as_tensor(rng.integers(0, 256, shape, np.uint8),
                                device=dev)
            carry = None
            if with_carry:
                carry = torch.as_tensor(
                    rng.integers(0, 5000, shape[:-2] + (bins, shape[-1])),
                    dtype=torch.float32, device=dev)
            got = ops.integral_histogram(x, bins, backend="cuda",
                                         carry_in=carry)
            want = ops.integral_histogram(x, bins, backend="torch",
                                          carry_in=carry)
            check(torch.equal(got, want), f"K1 != plain at {shape}x{bins}")
        xf = torch.as_tensor(rng.random((2, 61, 77)), device=dev)  # float64
        check(torch.equal(ops.integral_histogram(xf, 16, backend="cuda"),
                          ops.integral_histogram(xf, 16, backend="torch")),
              "K1 != plain on a float frame")
        log(f"   ragged {[c[0] for c in cases]}, carry_in, float frame: equal")

        # The shapes the paths launch K1 at, each as the wrapper cuts it.
        k1_in = {}
        for label, ((kn, kh, kw, bins, with_carry), _) in K1_SHAPES.items():
            ids, cin = k1_inputs(torch, dev, kn, kh, kw, bins, with_carry)
            k1_in[label] = (ids, bins, cin)
            shp = launch_shape(kw, bins, kn, h=kh)
            check(torch.equal(wf_tis_cuda(ids, bins, carry=cin),
                              wf_tis_plain(ids, bins, cin)),
                  f"K1 != plain at the {label} shape {tuple(ids.shape)}")
            log(f"   {label} {kn}x{kh}x{kw}x{bins}"
                f"{' + carry' if cin is not None else ''}: equal; "
                f"{shp.strips(kh)} strip(s) of {shp.strip_rows} rows, "
                f"bin block {shp.bin_block}, {shp.ctas(kn, bins, kh)} CTAs")
            torch.cuda.empty_cache()
        # Strip boundaries: one frame's strip height R, at heights R - 1,
        # R, R + 1 and 1, with and without a carry.
        R = launch_shape(w, nb, 1, h=h).strip_rows
        for kh in (R - 1, R, R + 1, 1):
            for with_carry in (False, True):
                bins = nb
                ids, cin = k1_inputs(torch, dev, 1, kh, w, bins, with_carry,
                                     seed=kh)
                shp = launch_shape(w, bins, 1, h=kh, strip_rows=R)
                check(torch.equal(wf_tis_launch(ids, bins, shp, cin),
                                  wf_tis_plain(ids, bins, cin)),
                      f"K1 != plain at height {kh} in strips of {R} rows "
                      f"(carry {with_carry})")
            log(f"   1x{kh}x{w}x{nb} in strips of {R} rows: "
                f"{shp.strips(kh)} strip(s), {shp.ctas(1, nb, kh)} CTAs; "
                "equal with and without a carry")

    # The main path's fused request (built once, used by k2/main/timing).
    rects = np.array([[100, 120, 219, 279], [0, 0, 479, 639]])
    r0, c0 = 160, 256                                 # on both lattices
    target = region_histogram_ref(clip[0], nb, r0, c0, r0 + 63, c0 + 63)
    fused_queries = [
        eng_mod.RegionQuery(rects),
        eng_mod.LikelihoodQuery(target, (64, 64), stride=16),
        eng_mod.MultiScaleQuery(target, ((32, 32), (64, 64), (96, 96)),
                                stride=8),
    ]
    fused_rows = np.asarray(eng_mod._declared_rows(fused_queries, h, w))

    with phase("k2: fused_rows kernel vs the plain H's rows"):
        check(tuple(fused_rows.tolist()) == K2_SHAPES["clip"][0][4],
              f"the fused request's rows {fused_rows} != K2_SHAPES' clip")
        got = fused_rows_cuda(idx, nb, fused_rows)
        H = wf_tis_plain(idx, nb)
        want = H[..., torch.as_tensor(fused_rows, device=dev), :]
        check(torch.equal(got, want), "K2 != plain H rows (fused request)")
        k2_err = float((got - want).abs().max())
        log(f"   {fused_rows.size} corner rows of {n}x{h}x{w}x{nb}: equal")
        # The shapes the paths launch K2 at, each with its chunk cut: pass A
        # runs a CTA per (frame, chunk, bin block).
        k2_in = {}
        for label, ((kn, kh, kw, bins, krows), _) in K2_SHAPES.items():
            ids, _ = k1_inputs(torch, dev, kn, kh, kw, bins, False)
            krows = np.asarray(krows)
            k2_in[label] = (ids, bins, krows)
            got = fused_rows_cuda(ids, bins, krows)
            want = fused_rows_plain(ids, bins, krows)
            check(torch.equal(got, want),
                  f"K2 != plain at the {label} shape {tuple(ids.shape)}")
            k2_err = max(k2_err, float((got - want).abs().max()))
            shp = chunk_shape(kw, bins, kn, krows.size, int(krows[-1]) + 1)
            chunks = chunk_plan(krows, shp.chunk_rows)[0].size
            ctas = kn * -(-bins // shp.bin_block) * chunks
            log(f"   {label} {kn}x{kh}x{kw}x{bins}, {krows.size} rows: "
                f"equal; {chunks} chunks of at most {shp.chunk_rows} rows"
                f"{' (pass B in place)' if chunks == krows.size else ''}, "
                f"bin block {shp.bin_block}, pass A {ctas} CTAs of "
                f"{shp.threads} threads ({ctas / 132:.2f} an SM)")
            if label == "frame":
                check(ctas >= 2 * 132, f"pass A at one frame: {ctas} CTAs")
        stats = {}
        early = np.array([10, 100, 200])
        got = ops.fused_corner_rows(clip, nb, early, stats=stats)
        check(torch.equal(got, H[..., torch.as_tensor(early, device=dev), :]),
              "fused_corner_rows != plain H rows (early cut)")
        check(stats["backend"] == "cuda", f"fused backend {stats['backend']}")
        check(stats["bands_computed"] < stats["bands_total"],
              f"no early cut: {stats}")
        log(f"   early cut: {stats['bands_computed']} of "
            f"{stats['bands_total']} bands scanned, rows equal")
        del H, got, want

    with phase("k3: delta_apply kernel vs its plain version"):
        rng = np.random.default_rng(5)
        k3_H = wf_tis_cuda(idx, nb)                    # the clip's H
        k3_d = torch.as_tensor(rng.integers(-5000, 5000, (n, nb, w)),
                               dtype=torch.float32, device=dev)
        got = delta_apply_cuda(k3_H, k3_d)
        want = delta_apply_plain(k3_H, k3_d)
        check(torch.equal(got, want), "K3 != plain at the clip's H")
        k3_err = float((got - want).abs().max())
        log(f"   {n}x{nb}x{h}x{w} H + random integer delta: equal")
        del got, want
        for shape in ((1, 1, 1, 1), (2, 3, 17, 131), (1, 5, 9, 4099),
                      (3, 32, 40, 641)):
            Hr = torch.as_tensor(rng.integers(0, 1 << 20, shape),
                                 dtype=torch.float32, device=dev)
            dr = torch.as_tensor(rng.integers(-999, 999, shape[:2]
                                              + shape[-1:]),
                                 dtype=torch.float32, device=dev)
            check(torch.equal(delta_apply_cuda(Hr, dr),
                              delta_apply_plain(Hr, dr)),
                  f"K3 != plain at {shape}")
        # Rows 100..299 of the clip's H, written into rows 4..203 of another.
        dst = torch.zeros((n, nb, h + 8, w), device=dev)
        res = delta_apply_cuda(k3_H[:, :, 100:300], k3_d,
                               out=dst[:, :, 4:204])
        check(res.data_ptr() == dst[:, :, 4:204].data_ptr(),
              "K3 did not write into the output view")
        check(torch.equal(dst[:, :, 4:204],
                          delta_apply_plain(k3_H[:, :, 100:300], k3_d)),
              "K3 != plain from a row band into a row band")
        check(not bool(dst[:, :, :4].any()) and not bool(dst[:, :, 204:].any()),
              "K3 wrote outside its output view")
        log("   ragged (1,1,1,1) (2,3,17,131) (1,5,9,4099) (3,32,40,641), "
            "row band into a row band: equal")
        del dst, res

    with phase("k4: cw_tis kernels vs the plain cw_tis and K1"):
        hh = cw_tis_hscan_cuda(idx, nb)
        want = cw_tis_hscan_plain(idx, nb)
        check(torch.equal(hh, want), "K4 hscan != plain at the clip")
        hscan_err = float((hh - want).abs().max())
        got = cw_tis_vscan_cuda(hh)
        want = cw_tis_vscan_plain(hh)
        check(torch.equal(got, want), "K4 vscan != plain at the clip")
        vscan_err = float((got - want).abs().max())
        check(torch.equal(got, cw_tis_plain(idx, nb)),
              "K4 != plain cw_tis at the clip")
        check(torch.equal(got, k3_H), "K4 != K1 at the clip")
        log(f"   {n}x{h}x{w}x{nb}: hscan, vscan, plain cw_tis and K1 equal")
        del got, want
        rng = np.random.default_rng(6)
        carry = torch.as_tensor(rng.integers(0, 5000, (n, nb, w)),
                                dtype=torch.float32, device=dev)
        got = cw_tis_cuda(idx, nb, carry=carry)
        check(torch.equal(got, wf_tis_cuda(idx, nb, carry=carry)),
              "K4 != K1 with a carry_in at the clip")
        check(torch.equal(got, cw_tis_plain(idx, nb, carry)),
              "K4 != plain cw_tis with a carry_in at the clip")
        del got, carry
        got = cw_tis_cuda(big, 64)
        check(torch.equal(got, wf_tis_cuda(big, 64)), "K4 != K1 at 1080p")
        check(torch.equal(got, cw_tis_plain(big, 64)),
              "K4 != plain cw_tis at 4x1080x1920x64")
        log("   4x1080x1920x64: equal to K1 and the plain cw_tis")
        del got
        torch.cuda.empty_cache()
        for shape, bins, with_carry in cases:
            x = torch.as_tensor(rng.integers(0, 256, shape, np.uint8),
                                device=dev)
            carry = None
            if with_carry:
                carry = torch.as_tensor(
                    rng.integers(0, 5000, shape[:-2] + (bins, shape[-1])),
                    dtype=torch.float32, device=dev)
            got = ops.integral_histogram(x, bins, method="cw_tis",
                                         backend="cuda", carry_in=carry)
            for backend, method in (("torch", "cw_tis"), ("cuda", "wf_tis")):
                check(torch.equal(got, ops.integral_histogram(
                    x, bins, method=method, backend=backend, carry_in=carry)),
                    f"K4 != {method}/{backend} at {shape}x{bins}")
        check(torch.equal(
            ops.integral_histogram(xf, 16, method="cw_tis", backend="cuda"),
            ops.integral_histogram(xf, 16, method="cw_tis", backend="torch")),
            "K4 != plain on a float frame")
        log(f"   ragged {[c[0] for c in cases]}, carry_in, float frame: equal")

    with phase("k5: ssd_scan kernel vs its plain version"):
        from repro_torch.models.ssm import ssd_chunked

        sb, ss, sh, sp, sn, sq = K5_SHAPE

        def scan_errors(label, got, want):
            errs = []
            for name, g, w_ in zip(("y", "h_last"), got, want):
                abs_err = float((g - w_).abs().max())
                rel_err = abs_err / float(w_.abs().max())
                log(f"   {label}: {name} max abs err {abs_err:.3e}, max rel "
                    f"err {rel_err:.3e} (|{name}| up to "
                    f"{float(w_.abs().max()):.3f})")
                check(torch.allclose(g, w_, atol=K5_ATOL, rtol=K5_RTOL),
                      f"K5 != plain ({label}, {name}) beyond atol {K5_ATOL} "
                      f"rtol {K5_RTOL}")
                errs.append(abs_err)
            return max(errs)

        k5_in = ssd_inputs(torch, dev, 9)
        sx, sdt, sA, sB, sC, sh0 = k5_in
        k5_err = 0.0
        for label, h0 in (("h0 = 0", None),
                          ("h0 = zeros", torch.zeros_like(sh0)),
                          ("random h0", sh0)):
            got = ssd_scan_cuda(sx, sdt, sA, sB, sC, chunk=sq, h0=h0)
            want = ssd_scan_plain(sx, sdt, sA, sB, sC, chunk=sq, h0=h0)
            k5_err = max(k5_err, scan_errors(
                f"{sb}x{ss}x{sh}x{sp}, N={sn}, {label}", got, want))
        check(torch.equal(ssd_scan_cuda(sx, sdt, sA, sB, sC, chunk=sq)[0],
                          ssd_scan_cuda(sx, sdt, sA, sB, sC, chunk=sq,
                                        h0=torch.zeros_like(sh0))[0]),
              "K5 with h0=None != K5 with h0=zeros")
        rx, rdt, rA, rB, rC, rh0 = ssd_inputs(torch, dev, 10, 1000)
        before = ssd_scan_cuda.launches
        got = ssd_chunked(rx, rdt, rA, rB, rC, sq, h0=rh0)
        check(ssd_scan_cuda.launches == before + 1,
              "ssd_chunked on CUDA tensors did not launch K5")
        want = ssd_chunked(rx, rdt, rA, rB, rC, sq, h0=rh0, backend="torch")
        k5_err = max(k5_err, scan_errors(
            "ssd_chunked, ragged S=1000 (padded to 1024), random h0", got,
            want))
        del got, want, rx, rdt, rB, rC, rh0
        # The operations the function needs, 4 N P flops a step, over the
        # rate of the unit K5 computes them on, and over fp32's.
        k5_flops = 4 * sb * sh * ss * sn * sp
        k5_bounds = {"3xTF32": k5_flops / TF32X3_OPS_PER_S * 1e3,
                     "fp32": k5_flops / FP32_OPS_PER_S * 1e3}
        log(f"   K5 operation bound: {k5_flops / 1e9:.2f} GFLOP at "
            f"{TF32X3_OPS_PER_S / 1e12:.0f} TFLOP/s (3xTF32 on the tensor "
            f"cores) = {k5_bounds['3xTF32']:.4f} ms; at "
            f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s fp32 = "
            f"{k5_bounds['fp32']:.4f} ms")

    with phase("k5_bwd: the SSD scan's backward kernel vs its plain version"):
        from repro_torch.kernels import ops as k5_ops

        def grad_errors(label, got, want):
            """Each gradient's max abs error and that over its largest
            magnitude, against K5BWD_RTOL; every gradient finite."""
            worst = 0.0
            for name, g, w_ in zip(("gx", "gdt", "gA", "gBm", "gCm", "gh0"),
                                   got, want):
                if w_ is None:
                    check(g is None, f"{label}: {name} given without h0")
                    continue
                check(bool(torch.isfinite(g).all()),
                      f"{label}: {name} not finite")
                abs_err = float((g - w_).abs().max())
                scale = float(w_.abs().max())
                log(f"   {label}: {name} max abs err {abs_err:.3e}, over its "
                    f"largest |{name}| {scale:.3e}: {abs_err / scale:.3e}")
                check(abs_err <= K5BWD_RTOL * scale,
                      f"K5-bwd != plain ({label}, {name}): {abs_err} > "
                      f"{K5BWD_RTOL} x {scale}")
                worst = max(worst, abs_err)
            return worst

        # The gradients of y and h_last at the training shape (K5_SHAPE).
        r = np.random.default_rng(12)
        k5b_gy = torch.as_tensor(r.standard_normal(tuple(sx.shape)),
                                 dtype=torch.float32, device=dev)
        k5b_gh = torch.as_tensor(r.standard_normal(tuple(sh0.shape)),
                                 dtype=torch.float32, device=dev)
        k5b_err = 0.0
        for label, h0, g_hlast in (("h0 = None, no g_hlast", None, None),
                                   ("random h0 and g_hlast", sh0, k5b_gh)):
            _, _, k5b_states = ssd_scan_cuda(sx, sdt, sA, sB, sC, chunk=sq,
                                             h0=h0, return_states=True)
            got = ssd_scan_bwd_cuda(sx, sdt, sA, sB, sC, k5b_gy,
                                    states=k5b_states, chunk=sq, h0=h0,
                                    g_hlast=g_hlast)
            want = ssd_scan_bwd_plain(sx, sdt, sA, sB, sC, k5b_gy,
                                      chunk=KERNEL_CHUNK, h0=h0,
                                      g_hlast=g_hlast)
            k5b_err = max(k5b_err, grad_errors(
                f"{sb}x{ss}x{sh}x{sp}, N={sn}, {label}", got, want))
            check(all(torch.equal(a, b) for a, b in zip(
                got[:5], ssd_scan_bwd_cuda(sx, sdt, sA, sB, sC, k5b_gy,
                                           states=k5b_states, chunk=sq,
                                           h0=h0, g_hlast=g_hlast)[:5])),
                  f"K5-bwd differs from itself on the same inputs ({label})")
        del got, want
        rx, rdt, rA, rB, rC, rh0 = ssd_inputs(torch, dev, 13, 1000)
        rgy = torch.as_tensor(r.standard_normal(tuple(rx.shape)),
                              dtype=torch.float32, device=dev)
        _, _, rst = ssd_scan_cuda(rx, rdt, rA, rB, rC, chunk=1000, h0=rh0,
                                  return_states=True)
        k5b_err = max(k5b_err, grad_errors(
            "ragged S=1000, random h0 and g_hlast",
            ssd_scan_bwd_cuda(rx, rdt, rA, rB, rC, rgy, states=rst,
                              chunk=1000, h0=rh0, g_hlast=k5b_gh),
            ssd_scan_bwd_plain(rx, rdt, rA, rB, rC, rgy, chunk=200, h0=rh0,
                               g_hlast=k5b_gh)))
        del rx, rdt, rB, rC, rh0, rgy, rst
        # SSDScanFunction under autograd against autograd of the plain
        # scan, at Mamba2-130M's init (dt = 0.69, A = -1) over 256-step
        # chunks, where the reference's gradient is NaN.
        fx, _, _, fB, fC, _ = ssd_inputs(torch, dev, 14)
        leaves = [fx, torch.full(tuple(sdt.shape), 0.69, device=dev),
                  -torch.ones(sh, device=dev), fB, fC]
        grads = []
        for use_kernel in (True, False):
            ins = [t.clone().requires_grad_() for t in leaves]
            before = ssd_scan_bwd_cuda.launches
            if use_kernel:
                y, _ = k5_ops.ssd_scan(*ins, chunk=sq)
                check(type(y.grad_fn).__name__ == "SSDScanFunctionBackward",
                      f"a grad-enabled CUDA scan ran {type(y.grad_fn)}")
            else:
                y, _ = ssd_scan_plain(*ins, chunk=sq)
            (y * k5b_gy).sum().backward()
            check(ssd_scan_bwd_cuda.launches == before + use_kernel,
                  "the Function's backward did not launch K5-bwd once")
            grads.append([t.grad for t in ins])
        k5b_err = max(k5b_err, grad_errors(
            "SSDScanFunction vs autograd of the plain scan, dt = 0.69, "
            "A = -1, chunk 256", grads[0] + [None], grads[1] + [None]))
        del grads, ins, y, fx, fB, fC, leaves
        torch.cuda.empty_cache()

    with phase("main: HistogramEngine.run on the GPU"):
        dense_queries = [eng_mod.SlidingWindowQuery((24, 24), stride=1)]
        engine = eng_mod.HistogramEngine(num_bins=nb)
        fused, t_fused, fused_counts = counted(
            "fused", lambda: engine.run(clip_np, fused_queries))
        dense, t_dense, dense_counts = counted(
            "dense", lambda: engine.run(clip_np, dense_queries))
        log(f"   launches: fused request {fused_counts}, dense request "
            f"{dense_counts}")
        check(fused_counts == only(fused_rows=1),
              f"fused request launched {fused_counts}, want one fused_rows")
        check(dense_counts == only(wf_tis=1),
              f"dense request launched {dense_counts}, want one wf_tis")
        check(fused.plan.representation == "fused",
              f"fused request planned {fused.plan.representation}")
        check(dense.plan.representation == "dense",
              f"dense request planned {dense.plan.representation}")
        check(fused.plan.backend == dense.plan.backend == "cuda",
              "main path did not resolve to the cuda backend")
        k = len(fused.plan.spec.query_rows)
        log(f"   fused: {k} corner rows (fuse bound {h // 4}); "
            f"{t_fused * 1e3:.1f} ms end to end")
        log(f"   dense: {t_dense * 1e3:.1f} ms end to end")
        log("   " + fused.plan.explain().replace("\n", "\n   "))

        plain = eng_mod.HistogramEngine(num_bins=nb, backend="torch")
        fused_t = plain.run(clip_np, fused_queries)
        dense_t = plain.run(clip_np, dense_queries)
        check(fused_t.plan.backend == "torch", "plain run not torch")
        check(torch.equal(fused.results[0], fused_t.results[0]),
              "region histograms differ from backend='torch'")
        check(torch.allclose(fused.results[1], fused_t.results[1],
                             rtol=MAP_RTOL, atol=MAP_ATOL),
              "likelihood maps differ from backend='torch'")
        rect, score, maps = fused.results[2]
        rect_t, score_t, maps_t = fused_t.results[2]
        check(torch.equal(rect, rect_t), "best rects differ")
        check(torch.allclose(score, score_t, rtol=MAP_RTOL, atol=MAP_ATOL),
              "best scores differ")
        for a, b in zip(maps, maps_t):
            check(torch.allclose(a, b, rtol=MAP_RTOL, atol=MAP_ATOL),
                  "multi-scale maps differ")
        check(torch.equal(dense.results[0], dense_t.results[0]),
              "sliding-window histograms differ from backend='torch'")
        del fused_t, dense_t

        # Right by the repo's own means: shapes, finiteness, direct counts.
        regions = fused.results[0]
        check(tuple(regions.shape) == (n, 2, nb), f"regions {regions.shape}")
        for f in (0, n - 1):
            for i, (a, b, c, d) in enumerate(rects):
                direct = region_histogram_ref(clip[f], nb, a, b, c, d)
                check(torch.equal(regions[f, i], direct),
                      f"region {i} of frame {f} != direct count")
        check(float(regions[0, 1].sum()) == h * w, "whole-frame count")
        lmap = fused.results[1]
        check(tuple(lmap.shape) == (n, (h - 64) // 16 + 1, (w - 64) // 16 + 1)
              and bool(torch.isfinite(lmap).all()), "likelihood map")
        check(rect[0].tolist() == [r0, c0, r0 + 63, c0 + 63],
              f"template not found in frame 0: {rect[0].tolist()}")
        wins = dense.results[0]
        check(tuple(wins.shape) == (n, h - 23, w - 23, nb), "window shape")
        check(bool((wins.sum(-1) == 24 * 24).all()), "window counts")
        log(f"   answers equal backend='torch' (maps within rtol "
            f"{MAP_RTOL}, atol {MAP_ATOL}); template found at "
            f"{rect[0].tolist()}")

        # A real-time stream's request: the fused queries on one frame.
        one, t_one, one_counts = counted(
            "fused_frame", lambda: engine.run(clip_np[0], fused_queries))
        check(one_counts == only(fused_rows=1),
              f"one-frame fused request launched {one_counts}")
        check(one.plan.representation == "fused"
              and tuple(one.plan.spec.query_rows) == K2_SHAPES["frame"][0][4],
              f"one-frame request planned {one.plan.representation} on "
              f"rows {one.plan.spec.query_rows}")
        check(torch.equal(one.results[0], regions[0]),
              "one-frame region histograms != the clip's frame 0")
        check(torch.allclose(one.results[1], lmap[0], rtol=MAP_RTOL,
                             atol=MAP_ATOL),
              "one-frame likelihood map != the clip's frame 0")
        check(torch.equal(one.results[2][0], rect[0]),
              "one-frame best rect != the clip's frame 0")
        log(f"   fused, one frame: {len(one.plan.spec.query_rows)} corner "
            f"rows, launches {one_counts}; answers equal the clip's frame 0; "
            f"{t_one * 1e3:.1f} ms end to end")

        # The metrics sum bins in order (distances.bin_sum: one cumsum down
        # the bin axis on the card): equal to the in-order loop on the
        # card, and every metric equal to the CPU's, bit for bit.
        def loop_sum(x):
            acc = x[..., 0]
            for i in range(1, x.shape[-1]):
                acc = acc + x[..., i]
            return acc

        g = torch.Generator(device=dev).manual_seed(12)
        planes = torch.rand((n, nb, 27, 37), device=dev, generator=g)
        for x in (planes.movedim(1, -1), planes[0, :, 0, 0],
                  planes[:1, :, :1, 0], planes.movedim(1, -1).contiguous()):
            check(torch.equal(distances.bin_sum(x), loop_sum(x)),
                  f"bin_sum != the in-order loop at {tuple(x.shape)}")
        a_hist = planes.movedim(1, -1) * 50
        t_hist = planes[1, :, 3, 4]
        for name, metric in {**distances.SIMILARITIES,
                             **distances.DISTANCES}.items():
            check(torch.equal(metric(a_hist, t_hist).cpu(),
                              metric(a_hist.cpu(), t_hist.cpu())),
                  f"{name} on the card != on the CPU")
        log("   distances: bin_sum equals the in-order loop on the card "
            "(window maps, one bin vector, a lone column); all five "
            "metrics equal the CPU's bit for bit")
        del fused, dense, wins, one
        torch.cuda.empty_cache()

    with phase("bands: 2160x3840 at 128 bins under a 512 MiB budget"):
        bh, bw, bnb, budget = 2160, 3840, 128, 512 << 20
        frame_4k = video_frames(bh, bw, 1, seed=3)[0]
        big_ids = bin_indices(torch.as_tensor(frame_4k, device=dev),
                              bnb).contiguous()
        bp = bands_mod.plan_bands(bh, bw, bnb, memory_budget_bytes=budget)
        check((bp.num_bands, bp.band_h) == (8, 273),
              f"plan_bands gave {bp.num_bands} x {bp.band_h}")
        b_target = region_histogram_ref(big_ids, bnb, 1000, 2000, 1063, 2063,
                                        value_range=None)
        band_queries = [eng_mod.LikelihoodQuery(b_target, (64, 64), stride=2)]
        banded_engine = eng_mod.HistogramEngine(num_bins=bnb,
                                                memory_budget_bytes=budget)
        banded, t_banded, counts = counted(
            "bands", lambda: banded_engine.run(frame_4k, band_queries))
        k = len(banded.plan.spec.query_rows)
        log(f"   plan: {banded.plan.representation}, "
            f"{banded.plan.band_plan.num_bands} x "
            f"{banded.plan.band_plan.band_h} rows, {k} corner rows (fuse "
            f"bound {bh // 4}); {t_banded * 1e3:.1f} ms end to end; "
            f"launches {counts}")
        check(banded.plan.representation == "banded" and k > bh // 4,
              f"banded request planned {banded.plan.representation}")
        check(banded.plan.band_plan.spans == bp.spans, "band spans differ")
        check(counts == only(wf_tis=8), f"banded request launched {counts}")
        dense_big = wf_tis_cuda(big_ids[None], bnb)[0]      # one K1 launch
        check(float(dense_big.max()) > 65535, "no count past 2^16 to wrap")
        rows = np.array([0, 272, 273, 545, 546, 1000, 1910, 1911, 2159])
        got, _, counts = counted("bands_rows",
                                 lambda: banded.source.rows(rows))
        check(counts == only(wf_tis=8), f"rows() stream launched {counts}")
        check(torch.equal(got, dense_big[:, torch.as_tensor(rows, device=dev)]),
              "BandedH rows != one dense K1 launch")
        want_map = eng_mod.DenseH(dense_big).likelihood_map(
            b_target, (64, 64), distances.intersection, 2)
        check(torch.allclose(banded.results[0], want_map, rtol=MAP_RTOL,
                             atol=MAP_ATOL),
              "banded likelihood map != the dense H's")
        del banded, want_map, got
        got = ops.integral_histogram(frame_4k, bnb, memory_budget_bytes=budget)
        check(torch.equal(got, dense_big),
              "integral_histogram(memory_budget_bytes) != dense K1")
        del got
        torch.cuda.empty_cache()
        log(f"   rows at band edges and integral_histogram(budget): equal "
            f"to one dense K1 launch (H {dense_big.numel() * 4 / 1e9:.2f} GB)")
        # The §4.4 overlap inside one frame: map_bands(prefetch=1) stages
        # the next band's rows (pinned buffers, a copy stream) while the
        # current band's K1 runs.
        ih_4k = IntegralHistogram(num_bins=bnb)

        def band_rows(prefetch):
            return eng_mod.BandedH(lambda: ih_4k.map_bands(
                frame_4k, memory_budget_bytes=budget,
                prefetch=prefetch)).rows(rows)

        rows0, _, _ = counted(None, lambda: band_rows(0))
        rows1, _, counts = counted("bands_prefetch", lambda: band_rows(1))
        check(counts == only(wf_tis=8), f"prefetch=1 launched {counts}")
        check(torch.equal(rows1, rows0)
              and torch.equal(rows1, dense_big[:, torch.as_tensor(
                  rows, device=dev)]),
              "map_bands(prefetch=1) rows != prefetch=0's")
        t_pf = {pf: request_ms(lambda: band_rows(pf), reps=3) for pf in (0, 1)}
        log(f"   map_bands(prefetch=1): rows equal prefetch=0's and the dense "
            f"K1's; {counts['wf_tis']} K1 launches; rows() over 8 bands "
            f"{t_pf[0]:.3f} ms at prefetch=0, {t_pf[1]:.3f} ms at prefetch=1 "
            f"(host clock, median of 3) | card {card_line()}")
        del rows0, rows1
        spill_engine = eng_mod.HistogramEngine(
            num_bins=bnb, memory_budget_bytes=budget, storage="uint16")
        sp_rects = np.array([[2000, 3000, 2159, 3399],    # 64000 px
                             [0, 0, 254, 256],            # 65535 px
                             [1500, 1800, 1699, 2099]])   # 60000 px
        spilled, t_spilled, counts = counted(
            "spilled", lambda: spill_engine.run(
                frame_4k, [eng_mod.RegionQuery(sp_rects)]))
        check(spilled.plan.representation == "spilled",
              f"uint16 request planned {spilled.plan.representation}")
        check(counts == only(wf_tis=8), f"spill launched {counts}")
        want = rq.region_histogram(dense_big, sp_rects).cpu()
        check(torch.equal(spilled.results[0], want),
              "uint16 spill region histograms != dense H")
        try:
            spilled.source.region_histogram(np.array([[0, 0, 255, 255]]))
            check(False, "a 65536-px region of a uint16 spill was answered")
        except ValueError:
            pass
        log(f"   uint16 spill: {len(spilled.source.bands)} host bands, "
            f"{spilled.source.nbytes / 1e9:.2f} GB; regions of 64000, 65535 "
            f"and 60000 px equal the dense H past the 2^16 wrap; a 65536-px "
            f"one refused; {t_spilled * 1e3:.1f} ms end to end")
        del spilled, dense_big, want
        torch.cuda.empty_cache()

    with phase("video: incremental updates of a low-motion stream"):
        vh, vw, vnb, block = 480, 640, 32, 48
        stream = low_motion_stream(vh, vw, 30, block, seed=4)
        patch = stream[0][200:224, 300:324].astype(np.int64)
        v_target = np.bincount((patch * vnb // 256).ravel(),
                               minlength=vnb).astype(np.float32)
        v_queries = [eng_mod.LikelihoodQuery(v_target, (24, 24), stride=2)]
        v_engine = eng_mod.HistogramEngine(num_bins=vnb)
        v_plain = eng_mod.HistogramEngine(num_bins=vnb, backend="torch")

        def check_frame(out, frame, what):
            check(torch.equal(out.source.dense(),
                              v_engine.compute_dense(frame)),
                  f"{what}: H != a fresh K1 launch")
            want = v_plain.run(frame, v_queries).results[0]
            check(torch.allclose(out.results[0], want, rtol=MAP_RTOL,
                                 atol=MAP_ATOL),
                  f"{what}: map != backend='torch'")

        out, _, counts = counted("video_first",
                                 lambda: v_engine.run(stream[0], v_queries))
        check(out.plan.representation == "dense"
              and len(out.plan.spec.query_rows) == 240,
              f"frame 0 planned {out.plan.representation}")
        check(counts == only(wf_tis=1), f"frame 0 launched {counts}")
        check_frame(out, stream[0], "frame 0")

        def step(path, prev_frame, prev_out, frame):
            spans = v_engine._delta_spans(v_engine.spec_for(frame.shape),
                                          prev_out.source)
            runs = delta_mod._merged_runs(
                delta_mod.diff_bands(prev_frame, frame, spans))
            dirty = [i for i, r in enumerate(runs) if r[2]]
            below = sum(1 for r in runs[dirty[0] + 1:] if not r[2]) \
                if dirty else 0
            new, dt, counts = counted(path, lambda: v_engine.run(
                frame, v_queries, prev=(prev_frame, prev_out)))
            return new, dt, counts, only(wf_tis=len(dirty),
                                         delta_apply=below)

        k3_frames = 0
        for t in range(1, len(stream)):
            out, _, counts, want = step("video", stream[t - 1], out,
                                        stream[t])
            check(out.plan.incremental and out.plan.representation == "dense",
                  f"frame {t} not incremental")
            check(counts == want, f"frame {t} launched {counts}, want {want}")
            check_frame(out, stream[t], f"frame {t}")
            k3_frames += counts["delta_apply"]
        log(f"   frames 1-29 incremental: {paths['video']} launches in all "
            f"(K3 on {k3_frames} frames with clean rows below the block)")
        rng = np.random.default_rng(7)
        bottom = stream[-1].copy()
        bottom[vh - block:] = rng.integers(0, 256, (block, vw), np.uint8)
        out, _, counts, want = step("video_bottom", stream[-1], out, bottom)
        check(out.plan.incremental and counts == want
              and counts == only(wf_tis=1),
              f"bottom block: incremental={out.plan.incremental}, {counts}")
        check_frame(out, bottom, "bottom block")
        half = bottom.copy()
        half[: vh // 2] = rng.integers(0, 256, (vh // 2, vw), np.uint8)
        fallback, _, counts = counted("video_fallback", lambda: v_engine.run(
            half, v_queries, prev=(bottom, out)))
        check(not fallback.plan.incremental and counts == only(wf_tis=1),
              f"50% frame: incremental={fallback.plan.incremental}, {counts}")
        check_frame(fallback, half, "50% frame")
        log(f"   bottom block: {paths['video_bottom']}; 50% frame falls "
            f"back to a full recompute: {paths['video_fallback']}")
        del out, fallback

    with phase("cw_tis: the dense and fused requests through K4"):
        cw_engine = eng_mod.HistogramEngine(num_bins=nb, method="cw_tis")
        cw_dense, _, counts = counted(
            "cw_tis_dense", lambda: cw_engine.run(clip_np, dense_queries))
        check(cw_dense.plan.representation == "dense"
              and cw_dense.plan.backend == "cuda",
              f"cw_tis dense request planned {cw_dense.plan.representation}")
        check(counts == only(cw_tis_hscan=1, cw_tis_vscan=1),
              f"cw_tis dense request launched {counts}")
        wf_dense = engine.run(clip_np, dense_queries)
        check(torch.equal(cw_dense.results[0], wf_dense.results[0]),
              "cw_tis window histograms != wf_tis")
        check(torch.equal(cw_dense.source.dense(), wf_dense.source.dense()),
              "cw_tis H != wf_tis H")
        del cw_dense, wf_dense
        cw_fused, _, counts = counted(
            "cw_tis_fused", lambda: cw_engine.run(clip_np, fused_queries))
        check(cw_fused.plan.representation == "fused",
              f"cw_tis fused request planned {cw_fused.plan.representation}")
        check(counts == only(cw_tis_hscan=4, cw_tis_vscan=4),
              f"cw_tis fused request launched {counts}")
        wf_fused = engine.run(clip_np, fused_queries)
        check(torch.equal(cw_fused.results[0], wf_fused.results[0]),
              "cw_tis region histograms != wf_tis")
        check(torch.equal(cw_fused.results[1], wf_fused.results[1]),
              "cw_tis likelihood map != wf_tis")
        check(torch.equal(cw_fused.results[2][0], wf_fused.results[2][0]),
              "cw_tis best rects != wf_tis")
        log(f"   dense request: {paths['cw_tis_dense']}; fused request: "
            f"{paths['cw_tis_fused']}; answers equal the wf_tis engine's")
        del cw_fused, wf_fused
        torch.cuda.empty_cache()

    with phase(f"stream: {STREAM_FRAMES} host frames through map_frames"):
        s_frames = list(video_frames(h, w, STREAM_FRAMES, seed=7))
        s_hists = torch.as_tensor(np.stack([
            np.bincount((f.astype(np.int64) * nb // 256).ravel(),
                        minlength=nb) for f in s_frames]),
            dtype=torch.float32)
        stream_engine = eng_mod.HistogramEngine(num_bins=nb)
        adaptive_engine = eng_mod.HistogramEngine(num_bins=nb,
                                                  adaptive_microbatch=True)
        list(stream_engine.map_frames(iter(s_frames[:4])))   # warm-up
        stream_fps = {}
        for path, eng, depth in (("stream_d1", stream_engine, 1),
                                 ("stream_d2", stream_engine, 2),
                                 ("stream_adaptive", adaptive_engine, 2)):
            outs, dt, counts = counted(path, lambda: list(
                eng.map_frames(iter(s_frames), depth=depth)))
            rt = eng.last_runtime
            st = rt.last_stats
            stager = rt.last_stager
            check(len(outs) == STREAM_FRAMES and st.items == STREAM_FRAMES,
                  f"{path}: {len(outs)} frames out, {st.items} items")
            check(eng.last_plan.representation == "dense"
                  and eng.last_plan.backend == "cuda",
                  f"{path} planned {eng.last_plan.representation}")
            check(counts == only(wf_tis=st.dispatches),
                  f"{path} launched {counts} for {st.dispatches} dispatches")
            held = [b for b in stager.buffers if b is not None]
            check(stager.copies == st.dispatches and held
                  and all(b.is_pinned() for b in held),
                  f"{path}: {stager.copies} staged copies for "
                  f"{st.dispatches} dispatches, pinned "
                  f"{[b.is_pinned() for b in held]}")
            corners = torch.stack([o[:, -1, -1] for o in outs]).cpu()
            check(torch.equal(corners, s_hists),
                  f"{path}: whole-frame histograms out of order or wrong")
            for f in (0, STREAM_FRAMES // 2 - 1, STREAM_FRAMES - 1):
                ids = bin_indices(torch.as_tensor(s_frames[f], device=dev),
                                  nb).contiguous()
                check(torch.equal(outs[f], wf_tis_cuda(ids[None], nb)[0]),
                      f"{path}: frame {f}'s H != K1 on that frame")
            stream_fps[path] = STREAM_FRAMES / dt
            extra = ""
            if rt.controller is not None:
                extra = (f"; adaptive sizes {st.batch_sizes}, settled at "
                         f"{rt.controller.size} (locked "
                         f"{rt.controller.locked})")
            log(f"   {path}: depth {depth}, {st.dispatches} dispatches of "
                f"{eng.last_plan.microbatch} frame(s) from the plan, "
                f"{stager.copies} pinned copies in a ring of "
                f"{len(stager.buffers)}; H at frames 0, "
                f"{STREAM_FRAMES // 2 - 1}, {STREAM_FRAMES - 1} equal K1, "
                f"every frame's histogram in order; "
                f"{STREAM_FRAMES / dt:.0f} frames/s{extra}")
            del outs
        del adaptive_engine
        torch.cuda.empty_cache()

    with phase(f"tracker: FragmentTracker over {TRACK_FRAMES} frames"):
        from repro_torch.core.tracking import FragmentTracker, TrackerConfig

        tcfg = TrackerConfig(num_bins=TRACK_BINS, search_radius=TRACK_RADIUS)
        t_clip = video_frames(h, w, TRACK_FRAMES + 1, seed=8)
        t_lowm = np.stack(low_motion_stream(h, w, TRACK_FRAMES + 1, 48,
                                            seed=9))
        two = [[150, 200, 213, 271], [300, 40, 371, 119]]
        tracker_ms = {}
        for targets in (two, two[0]):
            nt = len(targets) if np.ndim(targets) == 2 else 1
            label = f"{nt} target(s)"
            tracker = FragmentTracker(tcfg)
            st0, _, counts = counted(
                "tracker_init", lambda: tracker.init(t_clip[0], targets))
            check(counts == only(wf_tis=1), f"init launched {counts}")
            (_, boxes), dt, counts = counted(
                "tracker_track",
                lambda: tracker.track(dict(st0), t_clip[1:]))
            check(counts == only(wf_tis=TRACK_FRAMES),
                  f"track ({label}) launched {counts}")
            tracker_ms[f"track, {label}"] = dt * 1e3 / TRACK_FRAMES

            def step_loop(fn, plans=None):
                st, out = dict(st0), []
                for f in t_clip[1:]:
                    st = fn(st, f)
                    out.append(st["bbox"])
                    if plans is not None:
                        plans.add(tracker._step_engine.last_plan)
                return torch.stack(out)

            got, dt, counts = counted("tracker_step",
                                      lambda: step_loop(tracker.step))
            check(counts == only(wf_tis=TRACK_FRAMES),
                  f"step loop ({label}) launched {counts}")
            check(torch.equal(got, boxes), f"step != track ({label})")
            tracker_ms[f"step, {label}"] = dt * 1e3 / TRACK_FRAMES
            plain = FragmentTracker(dataclasses.replace(tcfg,
                                                        backend="torch"))
            _, want = plain.track(plain.init(t_clip[0], targets), t_clip[1:])
            check(torch.equal(want, boxes),
                  f"track ({label}) != backend='torch' on the card")
            if nt == 1:
                fused_plans = set()
                got, dt, counts = counted(
                    "tracker_fused",
                    lambda: step_loop(tracker.step_fused, fused_plans))
                check(tracker._step_engine.last_plan.representation
                      == "fused", "step_fused did not plan fused")
                check(counts == only(fused_rows=TRACK_FRAMES),
                      f"step_fused launched {counts}")
                check(torch.equal(got, boxes), "step_fused != track")
                tracker_ms["step_fused, 1 target"] = dt * 1e3 / TRACK_FRAMES
                t_rows = len(
                    tracker._step_engine.last_plan.spec.query_rows)
            lst0 = tracker.init(t_lowm[0], targets)
            _, want = tracker.track(dict(lst0), t_lowm)
            (_, got), dt, counts = counted(
                "tracker_incremental", lambda: tracker.track(
                    dict(lst0), list(t_lowm), incremental=True))
            check(tracker._step_engine.last_plan.incremental,
                  "the last incremental frame did not plan incremental")
            check(counts["wf_tis"] == TRACK_FRAMES + 1
                  and 0 < counts["delta_apply"] <= TRACK_FRAMES
                  and counts == only(wf_tis=counts["wf_tis"],
                                     delta_apply=counts["delta_apply"]),
                  f"track(incremental=True) launched {counts}")
            check(torch.equal(got, want),
                  f"track(incremental=True) != track ({label})")
            tracker_ms[f"incremental, {label}"] = dt * 1e3 / (TRACK_FRAMES
                                                              + 1)
            log(f"   {label}: track, step loop, backend='torch'"
                + (", step_fused" if nt == 1 else "")
                + f" and track(incremental=True) agree; last boxes "
                f"{boxes[-1].tolist()}")
        log(f"   step_fused: {t_rows} corner rows a frame (fuse bound "
            f"{h // 4}), {len(fused_plans)} distinct plans over "
            f"{TRACK_FRAMES} frames (each new one misses the gate's plan "
            f"cache); launches by path: " + ", ".join(
                f"{p} {paths[p]}" for p in paths if p.startswith("tracker")))
        log("   ms a frame (host clock, one run, first call of each path "
            "included): " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in tracker_ms.items())
            + f" | card {card_line()}")

    with phase("service: AnalyticsService over the clip and a video chain"):
        import threading

        from repro_torch.serve import AnalyticsService, ServiceOverloaded

        grid = np.array([[r, c, r + 31, c + 47] for r in (40, 360)
                         for c in range(0, 592, 96)])
        s_queries = [eng_mod.RegionQuery(rects[:1]),
                     eng_mod.RegionQuery(rects[1:]),
                     eng_mod.LikelihoodQuery(target, (64, 64), stride=16),
                     eng_mod.RegionQuery(grid)]
        store = {("clip", i): clip_np[i] for i in range(n)}
        svc_engine = eng_mod.HistogramEngine(num_bins=nb)
        svc = AnalyticsService(svc_engine, store)
        repeats = [("clip", 9), ("clip", 14)]
        order = [("clip", i) for i in range(n)] + repeats

        def serve_clip():
            return [svc.process([(ref, q) for q in s_queries])
                    for ref in order]

        answers, dt, counts = counted("service", serve_clip)
        snap = svc.stats.snapshot()
        check(svc_engine.last_plan.representation == "fused",
              f"service requests planned {svc_engine.last_plan}")
        want_counts = dict(requests=4 * len(order), engine_runs=n,
                           coalesced=3 * len(order),
                           cache_hits=4 * len(repeats), updated=0,
                           recomputed=n)
        check({k: snap[k] for k in want_counts} == want_counts,
              f"service counts {snap}, want {want_counts}")
        check(counts == only(fused_rows=n), f"service launched {counts}")
        for ref, got in zip(order, answers):
            want = eng_mod.HistogramEngine(num_bins=nb).run(
                store[ref], s_queries).results
            for g, w_ in zip(got, want):
                check(torch.equal(g, w_),
                      f"service answer for {ref} != engine.run's")
        log(f"   clip: {len(order)} frames x 4 queries, {n} engine runs "
            f"(K2 {counts['fused_rows']}), {snap['coalesced']} coalesced, "
            f"{snap['cache_hits']} cache hits; answers equal engine.run's; "
            f"{dt * 1e3 / len(order):.3f} ms a frame's group")

        chain_n = 16
        chain = dict(enumerate(low_motion_stream(h, w, chain_n, 48,
                                                 seed=10)))
        c_queries = [eng_mod.LikelihoodQuery(v_target, (24, 24), stride=2)]
        chain_svc = AnalyticsService(eng_mod.HistogramEngine(num_bins=nb),
                                     chain)
        got, _, counts = counted("service_chain", lambda: chain_svc.process(
            [(i, c_queries[0]) for i in range(chain_n)]))
        snap = chain_svc.stats.snapshot()
        check(snap["recomputed"] == 1 and snap["updated"] == chain_n - 1
              and snap["engine_runs"] == chain_n,
              f"chain counts {snap}")
        check(counts["wf_tis"] == chain_n and counts["delta_apply"] >= 1
              and counts == only(wf_tis=chain_n,
                                 delta_apply=counts["delta_apply"]),
              f"chain launched {counts}")
        for i in (0, chain_n // 2, chain_n - 1):
            want = v_engine.run(chain[i], c_queries).results[0]
            check(torch.equal(got[i], want),
                  f"chained answer {i} != engine.run's")
        log(f"   video chain: {chain_n} frames, {snap['recomputed']} "
            f"recomputed, {snap['updated']} updated (K1 {counts['wf_tis']}, "
            f"K3 {counts['delta_apply']}); answers equal engine.run's")

        gate = threading.Event()

        def slow(ref):
            gate.wait(timeout=60)
            return store[ref]

        busy_svc = AnalyticsService(svc_engine, slow, max_pending=2,
                                    max_coalesce=1).start()
        futs, overloaded = [], False
        try:
            futs.append(busy_svc.submit(("clip", 0), s_queries[0]))
            deadline = time.time() + 10
            while time.time() < deadline and not overloaded:
                try:
                    futs.append(busy_svc.submit(("clip", 1), s_queries[0]))
                except ServiceOverloaded:
                    overloaded = True
        finally:
            gate.set()
            busy_svc.close()
        for f in futs:
            f.result(timeout=60)
        check(overloaded and busy_svc.stats.rejected >= 1,
              "a full queue did not raise ServiceOverloaded")

        live = AnalyticsService(eng_mod.HistogramEngine(num_bins=nb), store)
        with live:
            futs = [live.submit(ref, q, block=True)
                    for ref in order for q in s_queries]
            for f in futs:
                f.result(timeout=120)
        snap = live.stats.snapshot()
        check(snap["completed"] == len(futs), f"submit: {snap}")
        log(f"   submit: {snap['completed']} requests, {snap['engine_runs']} "
            f"engine runs, {snap['coalesced']} coalesced; latency p50 "
            f"{snap['latency_p50_s'] * 1e3:.3f} ms, p95 "
            f"{snap['latency_p95_s'] * 1e3:.3f} ms (submit to answers on "
            f"the card); {snap['requests_per_s']:.0f} requests/s; a full "
            f"queue raised ServiceOverloaded | card {card_line()}")
        del chain_svc, live, answers, got
        torch.cuda.empty_cache()

    with phase("mesh: sharded H over 4 logical shards of one card"):
        from repro_torch.core import distributed
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.serve import (
            DistributedAnalyticsService, sharded_engine_factory,
        )

        card0 = torch.device("cuda", 0)
        bins4 = make_host_mesh((1, MESH_SHARDS), devices=[card0] * MESH_SHARDS)
        rows4 = make_host_mesh((MESH_SHARDS, 1), devices=[card0] * MESH_SHARDS)
        dense_big = wf_tis_cuda(big_ids[None], bnb)[0]      # one K1 launch
        m_rects = np.array([[0, 0, bh - 1, bw - 1], [100, 200, 1500, 3000],
                            [539, 0, 540, bw - 1], [1079, 7, 1620, 3838]])
        want_r = rq.region_histogram(dense_big, m_rects)
        # Bit-equality with the dense path, through the engine: bins over
        # "model", row strips over "data", and both under the budget.
        for path, mesh, sharding, m_budget in (
                ("mesh_bin", bins4, "bin", None),
                ("mesh_spatial", rows4, "spatial", None),
                ("mesh_banded_bin", bins4, "bin", budget),
                ("mesh_banded_spatial", rows4, "spatial", budget)):
            m_engine = eng_mod.HistogramEngine(
                num_bins=bnb, mesh=mesh, sharding=sharding,
                memory_budget_bytes=m_budget)
            out, t_m, counts = counted(path, lambda: m_engine.run(
                frame_4k, [eng_mod.RegionQuery(m_rects)]))
            p_m = out.plan
            bands_n = 1 if p_m.band_plan is None else p_m.band_plan.num_bands
            check(p_m.representation == "sharded" and p_m.sharding == sharding,
                  f"{path} planned {p_m.representation}/{p_m.sharding}")
            check(counts == only(wf_tis=MESH_SHARDS * bands_n),
                  f"{path} launched {counts}")
            check(torch.equal(out.results[0], want_r),
                  f"{path} region histograms != the dense H's")
            got = out.source.dense()
            check(torch.equal(got, dense_big), f"{path} H != dense K1")
            del out, got
            torch.cuda.empty_cache()
            log(f"   {path}: {p_m.sharding} over {MESH_SHARDS} shards"
                + (f", {bands_n} bands of {p_m.band_plan.band_h} rows"
                   if p_m.band_plan is not None else "")
                + f"; H and regions equal the dense K1 launch bit for bit; "
                f"K1 launches {counts['wf_tis']}; {t_m * 1e3:.1f} ms end to "
                "end (first call)")
        shards = distributed.bin_sharded_ih(frame_4k, bnb, bins4,
                                            method="cw_tis")
        check(torch.equal(torch.cat(shards, dim=0), dense_big),
              "bin-sharded cw_tis (K4) H != dense K1")
        banded = list(distributed.iter_banded_sharded_ih(
            frame_4k, bnb, rows4, sharding="spatial",
            memory_budget_bytes=budget, prefetch=1,
            scan_impl="ppermute"))
        for band in banded:
            check(torch.equal(band.H.dense(),
                              dense_big[:, band.r0:band.r1]),
                  f"spatial band {band.r0}:{band.r1} (prefetch=1, "
                  "ppermute) != dense K1")
        log(f"   bin-sharded cw_tis (K4) and {len(banded)} spatial bands "
            "staged at prefetch=1 with the ppermute scan: equal to the "
            "dense K1 launch")
        del shards, banded, dense_big, want_r
        torch.cuda.empty_cache()

        # Paper §4.6: one 8192x8192 frame at 128 bins, 32 GiB of H.  Two H
        # of it do not sit on the card together, so each is held against
        # counts taken from the frame itself.
        fh = fw = FRAME_46
        fnb = 128
        gen = torch.Generator(device=dev)
        gen.manual_seed(46)
        frame46 = torch.randint(0, 256, (fh, fw), generator=gen, device=dev,
                                dtype=torch.uint8)
        ids46 = bin_indices(frame46, fnb).to(torch.int64)
        ar_h = torch.arange(fh, device=dev)[:, None]
        ar_w = torch.arange(fw, device=dev)[None, :]
        per_col = torch.bincount((ar_w * fnb + ids46).reshape(-1),
                                 minlength=fw * fnb).reshape(fw, fnb)
        per_row = torch.bincount((ar_h * fnb + ids46).reshape(-1),
                                 minlength=fh * fnb).reshape(fh, fnb)
        bottom_want = per_col.cumsum(0).T.to(torch.float32)     # (b, w)
        right_want = per_row.cumsum(0).T.to(torch.float32)      # (b, h)
        largest = int(per_col.sum(0).max())
        check(largest <= 1 << 24,
              f"a bin holds {largest} pixels, past the fp32 exact-count "
              "bound 2^24")
        del per_col, per_row
        # Seeded rects of at most 4095 x 4095 px: a query must read fewer
        # than 2^24 px to be exact in fp32 (plancheck's query-validity).
        r46 = np.random.default_rng(46)
        top, left = r46.integers(0, fh, 64), r46.integers(0, fw, 64)
        rects46 = np.stack([
            top, left,
            np.minimum(top + r46.integers(0, 4095, 64), fh - 1),
            np.minimum(left + r46.integers(0, 4095, 64), fw - 1)], axis=1)
        want46 = torch.stack([
            torch.bincount(ids46[r0:r1 + 1, c0:c1 + 1].reshape(-1),
                           minlength=fnb)
            for r0, c0, r1, c1 in rects46.tolist()]).to(torch.float32)
        del ids46
        torch.cuda.empty_cache()

        def check46(label, bottom, right, regions):
            check(torch.equal(bottom, bottom_want),
                  f"{label}: H's bottom row != per-column counts")
            check(torch.equal(right, right_want),
                  f"{label}: H's last column != per-row counts")
            check(torch.equal(regions, want46),
                  f"{label}: 64 region histograms != direct counts")

        times46 = {}
        Hd, _, counts = counted("frame_dense", lambda: ops.integral_histogram(
            frame46, fnb))
        check(counts == only(wf_tis=1), f"dense 8192^2 launched {counts}")
        check46("dense", Hd[:, -1], Hd[:, :, -1],
                rq.region_histogram(Hd, rects46))
        del Hd
        torch.cuda.empty_cache()
        times46["dense, no mesh"] = (
            time_ms(lambda: ops.integral_histogram(frame46, fnb), runs=5,
                    launches=1),
            request_ms(lambda: ops.integral_histogram(frame46, fnb), reps=3))
        for path, mesh, sharding, fn in (
                ("mesh_frame_bin", bins4, "bin",
                 lambda: distributed.bin_sharded_ih(frame46, fnb, bins4)),
                ("mesh_frame_spatial", rows4, "spatial",
                 lambda: distributed.spatial_sharded_ih(frame46, fnb,
                                                        rows4))):
            f_engine = eng_mod.HistogramEngine(num_bins=fnb, mesh=mesh,
                                               sharding=sharding)
            torch.cuda.reset_peak_memory_stats()
            out, _, counts = counted(path, lambda: f_engine.run(
                frame46, [eng_mod.RegionQuery(rects46)]))
            peak = torch.cuda.max_memory_allocated() / 2**30
            check(out.plan.sharding == sharding
                  and counts == only(wf_tis=MESH_SHARDS),
                  f"{path}: {out.plan.sharding}, launched {counts}")
            grid = out.source.grid
            right = torch.cat([torch.cat([s[:, :, -1] for s in strip], dim=0)
                               for strip in grid], dim=-1)
            check46(path, out.source.rows([fh - 1])[:, 0], right,
                    out.results[0])
            check(out.source.nbytes == 4 * fnb * fh * fw,
                  f"{path}: {out.source.nbytes} B of H")
            del out, right, grid
            torch.cuda.empty_cache()
            times46[f"{sharding}-sharded, {MESH_SHARDS} logical shards"] = (
                time_ms(fn, runs=5, launches=1), request_ms(fn, reps=3))
            log(f"   {path}: bottom row, last column and 64 regions equal "
                f"the frame's counts; K1 launches {counts['wf_tis']}; peak "
                f"{peak:.2f} GiB allocated")
        f_bytes = fh * fw * (1 + 4 * fnb)        # the frame read, H written
        f_bound = f_bytes / HBM_BYTES_PER_S * 1e3
        log(f"   8192x8192x128 (H {4 * fnb * fh * fw / 2**30:.0f} GiB), "
            f"largest bin {largest} px (<= 2^24); K1 byte bound "
            f"{f_bound:.3f} ms a frame ({f_bound / MESH_SHARDS:.3f} a shard"
            ") | card " + card_line())
        for label, (ev_ms, host_ms) in times46.items():
            log(f"   {label}: {ev_ms:.3f} ms by CUDA events (median of 5), "
                f"{host_ms:.3f} ms host clock (median of 3), "
                f"{1e3 / ev_ms:.1f} frames/s, {f_bound / ev_ms:.1%} of the "
                "bound")

        # The service over a 2x2 mesh (2 replica groups x 2 bin shards:
        # K1) and over 4 one-device groups (K2 per frame, K1 + K3 on the
        # chain), each against one AnalyticsService on the same trace.
        single = AnalyticsService(eng_mod.HistogramEngine(num_bins=nb), store)
        want = [single.process([(ref, q) for q in s_queries])
                for ref in order]
        for path, svc_kw, want_counts in (
                ("mesh_service_2x2", dict(mesh=make_host_mesh(
                    (2, 2), devices=[card0] * 4)), only(wf_tis=2 * n)),
                ("mesh_service_replicas", dict(num_replicas=4),
                 only(fused_rows=n))):
            d_svc = DistributedAnalyticsService(sharded_engine_factory(nb),
                                                store, **svc_kw)
            got, dt, counts = counted(path, lambda: [
                d_svc.process([(ref, q) for q in s_queries])
                for ref in order])
            check(counts == want_counts, f"{path} launched {counts}")
            for ref, g_all, w_all in zip(order, got, want):
                for k, (g, w_) in enumerate(zip(g_all, w_all)):
                    same = (torch.allclose(g, w_, rtol=MAP_RTOL,
                                           atol=MAP_ATOL)
                            if k == 2 else torch.equal(g, w_))
                    check(same, f"{path}: answer {k} for {ref} != "
                          "AnalyticsService's")
            snap, one = d_svc.snapshot(), single.stats.snapshot()
            keys = ("requests", "engine_runs", "cache_hits", "coalesced")
            check({k: snap[k] for k in keys} == {k: one[k] for k in keys},
                  f"{path} counts {snap}")
            log(f"   {path}: {snap['num_replicas']} replica group(s); "
                f"answers equal one AnalyticsService's; {snap['engine_runs']}"
                f" engine runs, {snap['cache_hits']} hits; launches "
                f"{ {k: v for k, v in counts.items() if v} }; "
                f"{dt * 1e3 / len(order):.3f} ms a frame's group")
        r_svc = DistributedAnalyticsService(sharded_engine_factory(nb), chain,
                                            num_replicas=4)
        got, _, counts = counted("mesh_service_chain", lambda: r_svc.process(
            [(i, c_queries[0]) for i in range(chain_n)]))
        snap = r_svc.snapshot()
        check(snap["updated"] == chain_n - 1
              and sum(1 for p_ in snap["replicas"] if p_["updated"]) == 1
              and counts == only(wf_tis=chain_n,
                                 delta_apply=counts["delta_apply"]),
              f"chain on 4 replicas: {snap['updated']} updated, {counts}")
        for i in (0, chain_n - 1):
            check(torch.equal(got[i], v_engine.run(chain[i],
                                                   c_queries).results[0]),
                  f"replicated chain answer {i} != engine.run's")
        log(f"   mesh_service_chain: {chain_n} frames pinned to one of 4 "
            f"replicas, {snap['updated']} updated (K1 {counts['wf_tis']}, "
            f"K3 {counts['delta_apply']}); answers equal engine.run's")
        del single, want, got, d_svc, r_svc
        torch.cuda.empty_cache()

    with phase("analysis: the plan gate, the kernels' proofs, the lint"):
        from repro_torch.analysis import kernelcheck, plancheck
        from repro_torch.kernels.specs import KernelGeometry

        # Every plan of the earlier phases passed the deep gate.
        by_phase: dict[str, list] = {}
        for name, p, v in gate_log:
            by_phase.setdefault(name.split(":")[0], []).append((p, v))
        for key in ("main", "bands", "video", "cw_tis", "stream", "tracker",
                    "service", "mesh"):
            seen = by_phase.get(key, [])
            check(seen, f"no plan of the {key} phase went through the gate")
            bad = [v.render() for _, v in seen if not v.ok]
            check(not bad, f"{key}: a rejected plan ran: {bad[:1]}")
            proved = sum(1 for _, v in seen if any(
                c.name == "kernel-carry" and c.status == "ok"
                for c in v.checks))
            log(f"   {key}: {len(seen)} gated requests, "
                f"{len(set(p for p, _ in seen))} distinct plans, all OK "
                f"deep; {proved} with the kernels' proofs (cuda plans)")

        # The kernels' proofs at the default geometries and at the shapes
        # this run launches K1-K4 at.
        geoms = [("wf_tis", KernelGeometry(*shape[:4]))
                 for shape, _ in K1_SHAPES.values()]
        geoms += [("fused_rows", KernelGeometry(*shape[:4], rows=shape[4]))
                  for shape, _ in K2_SHAPES.values()]
        kn, knb, kh, kw = k3_H.shape
        geoms += [("delta_apply", KernelGeometry(kn, kh, kw, knb)),
                  ("cw_tis", KernelGeometry(n, h, w, nb))]
        t0 = time.perf_counter()
        verdicts = kernelcheck.check_kernels() + [
            kernelcheck.check_method(m, g) for m, g in geoms]
        for v in verdicts:
            log("   " + v.render().replace("\n", "\n   "))
        failed = [v.method for v in verdicts if not v.ok]
        check(not failed, f"kernelcheck rejected {failed}")
        log(f"   kernelcheck: {len(verdicts)} verdicts, all OK, in "
            f"{time.perf_counter() - t0:.2f} s")

        # Three requests the gate refuses before any launch.
        def refused(what, fn, check_name):
            def request():
                try:
                    fn()
                except eng_mod.PlanValidationError as e:
                    return str(e)
                return None
            msg, _, counts = counted(None, request)
            check(msg is not None and check_name in msg,
                  f"{what}: not refused by {check_name}: {msg}")
            check(counts == only(), f"{what}: launched {counts}")
            line = next(ln for ln in msg.splitlines() if "FAIL" in ln)
            log(f"   refused, launches {counts}: {what}: {line.strip()}")

        real_plan = eng_mod.plan
        eng_mod.plan = lambda spec: dataclasses.replace(real_plan(spec),
                                                        microbatch=64)
        try:
            refused("a microbatch of 64 frames of 64x64x32 under a 1 MiB "
                    "budget (a planner fault the gate must stop)",
                    lambda: eng_mod.HistogramEngine(
                        num_bins=32, memory_budget_bytes=1 << 20).run(
                            np.zeros((2, 64, 64), np.uint8)),
                    "memory-budget")
        finally:
            eng_mod.plan = real_plan
        refused("a 400x400 region on a uint16 engine",
                lambda: eng_mod.HistogramEngine(
                    num_bins=16, storage="uint16",
                    memory_budget_bytes=1 << 20).run(
                        np.zeros((512, 512), np.uint8),
                        [eng_mod.RegionQuery(np.array([[0, 0, 400, 400]]))]),
                "query-validity")
        refused("a 1x20000 frame",
                lambda: eng_mod.HistogramEngine(num_bins=32).run(
                    np.zeros((1, 20000), np.uint8)), "h-shape")

        # What the gate costs on the host: warm (the verdict cached by
        # plan), a video frame's plan (a new dirty fraction: only the
        # incremental line reads it), a fused plan with new rows, and the
        # first call.
        one = engine.run(clip_np[0], fused_queries)
        p_one = one.plan
        seed = v_engine.run(stream[0], v_queries)
        v_engine.run(stream[1], v_queries, prev=(stream[0], seed))
        p_inc = v_engine.last_plan
        check(p_one.representation == "fused" and p_inc.incremental
              and p_one.backend == p_inc.backend == "cuda",
              "gate timing: plans are not the fused and incremental ones")

        def gate_us(eng, plans, queries, k=1000):
            times = []
            for i in range(k):
                t0 = time.perf_counter()
                eng.validate(plans[i % len(plans)], queries, deep=True)
                times.append(time.perf_counter() - t0)
            return statistics.median(times) * 1e6

        warm_one = gate_us(engine, [p_one], fused_queries)
        warm_inc = gate_us(v_engine, [p_inc], v_queries)
        new_inc = gate_us(v_engine, [dataclasses.replace(
            p_inc, spec=dataclasses.replace(
                p_inc.spec, dirty_fraction=0.3 * i / 1000 + 1e-6))
            for i in range(1000)], v_queries)
        # The one-frame plan with two more corner rows, a different pair
        # each call (as new rects or a tracker's moving box ask): a new
        # plan every call, whose kernel proofs are cached by the canonical
        # geometry and meta evaluation by the rows' count and early cut.
        rows_one = set(p_one.spec.query_rows)
        free = [r for r in range(h) if r not in rows_one]
        pairs = np.random.default_rng(11).choice(len(free), (1000, 2))
        new_rows = gate_us(engine, [dataclasses.replace(
            p_one, spec=dataclasses.replace(p_one.spec, query_rows=tuple(
                sorted(rows_one | {free[a], free[b]}))))
            for a, b in pairs], fused_queries)
        first = {}
        for label, eng, p_, q_ in (("one-frame fused", engine, p_one,
                                    fused_queries),
                                   ("incremental video", v_engine, p_inc,
                                    v_queries)):
            plancheck.clear_caches()
            t0 = time.perf_counter()
            eng.validate(p_, q_, deep=True)
            first[label] = (time.perf_counter() - t0) * 1e3
        one_ms = request_ms(lambda: engine.run(clip_np[0], fused_queries),
                            reps=21)
        log(f"   gate, host µs (median of 1000): one-frame fused plan warm "
            f"{warm_one:.2f}, incremental video plan warm {warm_inc:.2f}, "
            f"a video frame's new plan (dirty fraction changed) "
            f"{new_inc:.2f}, the one-frame fused plan with 2 new corner "
            f"rows (a new plan each call) {new_rows:.2f}; first, uncached "
            f"call: " + ", ".join(
                f"{k} {v:.2f} ms" for k, v in first.items())
            + f" | the one-frame fused request {one_ms:.3f} ms (median of "
            f"21): the warm gate is {warm_one / 1e3 / one_ms:.2%} of it | "
            f"card {card_line()}")
        del one, seed

        # The port's lint, as a user runs it.
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--check"],
            cwd=str(ROOT), env={**os.environ, "PYTHONPATH": str(SRC)},
            capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0,
              f"lint --check exited {proc.returncode}: {proc.stdout[-500:]}")
        log(f"   python -m repro_torch.analysis --check: exit 0; "
            f"{proc.stdout.strip().splitlines()[-1]}")

    with phase(f"lm: {LM_ARCH} serving through repro_torch.launch.serve"):
        from repro_torch.configs import get_config
        from repro_torch.launch import serve
        from repro_torch.models import api, ssm
        from repro_torch.train.serve_step import decode_loop, make_serve_fns

        cfg = get_config(LM_ARCH)
        argv = ["--arch", LM_ARCH, "--batch", str(LM_BATCH), "--prompt-len",
                str(LM_PROMPT), "--gen", str(LM_GEN), "--seed", str(LM_SEED)]
        # serve.main is the main path's run.  The counters are read once
        # more where it hands the prefilled cache to decode_loop, which
        # splits its counts into the prefill's and the decode's.
        at_decode = {}
        serve_decode_loop = serve.decode_loop

        def observed_decode_loop(*args, **kwargs):
            torch.cuda.synchronize()
            at_decode.update(read_counts())
            return serve_decode_loop(*args, **kwargs)

        torch.cuda.reset_peak_memory_stats()
        serve.decode_loop = observed_decode_loop
        try:
            served, t_serve, counts = counted(None,
                                              lambda: serve.main(argv))
        finally:
            serve.decode_loop = serve_decode_loop
        decode_counts = {k: counts[k] - at_decode[k] for k in counts}
        tally("lm_prefill", at_decode)
        tally("lm_decode", decode_counts)
        lm_launches = {"prefill": at_decode["ssd_scan"],
                       "decode_step": decode_counts["ssd_scan"] / LM_GEN}
        log(f"   serve.main (cold, first call of the process): "
            f"{t_serve * 1e3:.1f} ms; prefill launched {at_decode}, "
            f"{LM_GEN} decode steps {decode_counts}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        check(at_decode == only(ssd_scan=cfg.num_layers),
              f"the prefill launched {at_decode}, want K5 "
              f"{cfg.num_layers} times (once per layer)")
        check(decode_counts == only(),
              f"decode launched {decode_counts}, want no kernel of ours")
        check(tuple(served.shape) == (LM_BATCH, LM_GEN)
              and served.dtype == torch.int32
              and 0 <= int(served.min())
              and int(served.max()) < cfg.padded_vocab,
              f"served tokens {tuple(served.shape)} {served.dtype}")

        # The same request again (weights and prompts from the same seed),
        # prefill and decode apart, for its logits.
        params, batch = serve.make_request(cfg, LM_BATCH, LM_PROMPT,
                                           LM_SEED, dev)
        max_len = LM_PROMPT + LM_GEN

        def fresh_cache():
            return api.init_cache(cfg, LM_BATCH, max_len)

        logits, cache = api.prefill(params, batch, cfg, fresh_cache())
        check(tuple(logits.shape) == (LM_BATCH, cfg.padded_vocab)
              and bool(torch.isfinite(logits).all()), "prefill logits")
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        toks, _ = decode_loop(params, first, cache, cfg, LM_GEN)
        rerun_same = int((toks == served).sum())
        log(f"   rerun tokens equal the served ones at {rerun_same} of "
            f"{toks.numel()} places")

        # The reference: the same weights and prompts in an fp32 copy of
        # the config with the plain scan.
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        ref_logits, ref_cache = api.prefill(params, batch, cfg32,
                                            fresh_cache(), backend="torch")
        k5_32, _ = api.prefill(params, batch, cfg32, fresh_cache())
        plain16, _ = api.prefill(params, batch, cfg, fresh_cache(),
                                 backend="torch")
        # Two wrong answers the bf16 gate must refuse: the fp32
        # reference's logits of the next prompt of the batch, and those of
        # the fp32 model with its last layer left out.
        tree = params.param_tree()
        cfg_short = dataclasses.replace(cfg32,
                                        num_layers=cfg.num_layers - 1)
        short = ssm.Mamba2LM(cfg_short,
                             {**tree, "layers": tree["layers"][:-1]})
        short_logits, _ = api.prefill(
            short, batch, cfg_short,
            api.init_cache(cfg_short, LM_BATCH, max_len), backend="torch")
        scale = float(ref_logits.abs().max())
        err32 = float((k5_32 - ref_logits).abs().max())
        err_scan16 = float((logits - plain16).abs().max())
        err16 = float((logits - ref_logits).abs().max())
        err_other = float((logits - ref_logits.roll(1, 0)).abs().max())
        err_short = float((logits - short_logits).abs().max())
        log(f"   last-position logits (|logit| up to {scale:.3f}): fp32 with "
            f"K5 vs fp32 with the plain scan: max abs err {err32:.3e} "
            f"(tolerance {LM_ATOL32}); served bf16 vs bf16 with the plain "
            f"scan: {err_scan16:.3e} ({err_scan16 / scale:.1%}, tolerance "
            f"{LM_SCAN16:.0%}); served bf16 vs the fp32 reference: "
            f"{err16:.3e} ({err16 / scale:.1%}, tolerance {LM_PREC16:.0%}); "
            f"wrong answers: another prompt's fp32 logits "
            f"{err_other / scale:.1%}, the fp32 model less its last layer "
            f"{err_short / scale:.1%}")
        check(err32 <= LM_ATOL32, f"fp32 K5 logits off by {err32}")
        check(err_scan16 <= LM_SCAN16 * scale,
              f"bf16 K5 logits off the bf16 plain scan's by {err_scan16}")
        check(err16 <= LM_PREC16 * scale,
              f"bf16 logits off the fp32 reference by {err16}")
        check(min(err_other, err_short) > LM_PREC16 * scale,
              f"the bf16 gate passes a wrong answer (another prompt "
              f"{err_other}, one layer less {err_short})")
        ref_first = torch.argmax(ref_logits, dim=-1).to(torch.int32)
        ref_toks, _ = decode_loop(params, ref_first, ref_cache, cfg32, LM_GEN)
        agree = (torch.cat([first[:, None], toks], 1)
                 == torch.cat([ref_first[:, None], ref_toks], 1))
        lead = [int(row.cumprod(0).sum()) for row in agree.int()]
        log(f"   greedy tokens, served bf16 vs the fp32 reference: "
            f"{int(agree.sum())} of {agree.numel()} agree; leading run per "
            f"sequence {lead} of {LM_GEN + 1}")
        del k5_32, plain16, ref_logits, ref_cache, ref_toks, short
        del short_logits, tree

        prefill_fn, _ = make_serve_fns(cfg)

        lm_prefill_ms = request_ms(
            lambda: prefill_fn(params, batch, fresh_cache()), reps=3)
        lm_decode_ms = request_ms(
            lambda: decode_loop(params, first, cache, cfg, LM_GEN),
            reps=3) / LM_GEN
        log(f"   {LM_ARCH} ({cfg.num_layers} layers, d_model {cfg.d_model}), "
            f"batch {LM_BATCH}, warm, host clock, median of 3 | card "
            f"{card_line()}")
        log(f"   prefill {LM_BATCH}x{LM_PROMPT}: {lm_prefill_ms:.3f} ms "
            f"({LM_BATCH * LM_PROMPT / lm_prefill_ms * 1e3:.0f} tokens/s); "
            f"its {cfg.num_layers} K5 calls are bound by "
            f"{cfg.num_layers * k5_bounds['3xTF32']:.3f} ms at the 3xTF32 "
            f"rate ({cfg.num_layers * k5_bounds['fp32']:.3f} ms at fp32's)")
        log(f"   decode: {lm_decode_ms:.3f} ms per step of {LM_BATCH} tokens "
            f"({LM_BATCH / lm_decode_ms * 1e3:.0f} tokens/s, {LM_GEN} steps)")
        log("   prefill, torch.profiler over 3: " + profile_requests(
            torch, lambda: [prefill_fn(params, batch, fresh_cache())
                            for _ in range(3)], n=3))
        log("   decode step, torch.profiler over 8: " + profile_requests(
            torch, lambda: decode_loop(params, first, cache, cfg, 8), n=8))
        del params, cache, logits, served, toks
        torch.cuda.empty_cache()

    with phase("transformer: the dense, moe and vlm families through "
               "repro_torch.launch.serve"):
        transformer_phase(torch, dev, counted, tally, read_counts, only)

    with phase(f"train: {LM_ARCH} training through repro_torch.launch.train"):
        import tempfile

        from repro_torch.data import make_stream
        from repro_torch.launch import train as train_launch
        from repro_torch.train import grad as train_grad
        from repro_torch.train import init_state, make_optimizer
        from repro_torch.train.tree import tree_leaves

        def flat(tree, prefix=""):
            if isinstance(tree, dict):
                return {k2: v2 for k in sorted(tree) for k2, v2 in flat(
                    tree[k], f"{prefix}/{k}" if prefix else k).items()}
            return {prefix: tree}

        # train.main is the main path's run.  Its step function is wrapped
        # to read the launch counters and the host clock around each step
        # (each ended by a synchronize) and keep the step's metrics.
        steps_log: list = []
        make_step = train_launch.make_train_step

        def observed_make_train_step(*args, **kwargs):
            step_fn = make_step(*args, **kwargs)

            def observed(state, batch):
                torch.cuda.synchronize()
                before, t0 = read_counts(), time.perf_counter()
                new_state, metrics = step_fn(state, batch)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                after = read_counts()
                steps_log.append((ms, {k: after[k] - before[k] for k in after},
                                  {k: float(v) for k, v in metrics.items()}))
                return new_state, metrics
            return observed

        train_argv = ["--arch", LM_ARCH, "--steps", str(TRAIN_STEPS),
                      "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                      "--ckpt-every", str(TRAIN_CKPT_EVERY), "--seed",
                      str(TRAIN_SEED)]

        def train_run(path, extra):
            steps_log.clear()
            train_launch.make_train_step = observed_make_train_step
            try:
                with tempfile.TemporaryDirectory() as ckpt_dir:
                    (state, history), secs, counts = counted(
                        path, lambda: train_launch.main(
                            train_argv + extra + ["--ckpt-dir", ckpt_dir]))
            finally:
                train_launch.make_train_step = make_step
            return state, history, secs, counts, list(steps_log)

        nl = cfg.num_layers
        torch.cuda.reset_peak_memory_stats()
        faulty, f_hist, f_secs, f_counts, f_steps = train_run(
            "train", ["--fail-at", str(TRAIN_FAIL_AT)])
        train_peak = torch.cuda.max_memory_allocated()
        # Steps 0..5, the fault before step 6, then 4..7 from the step-4
        # checkpoint.
        resumed = TRAIN_FAIL_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
        want_steps = TRAIN_FAIL_AT + TRAIN_STEPS - resumed
        log(f"   train.main with --fail-at {TRAIN_FAIL_AT}: {f_secs:.1f} s, "
            f"{len(f_steps)} steps run (restored at step {resumed}), "
            f"launched {f_counts}, final step {int(faulty['step'])}, "
            f"history {f_hist}; peak device memory {train_peak / 1e9:.2f} GB")
        check(len(f_steps) == want_steps and int(faulty["step"]) == TRAIN_STEPS,
              f"{len(f_steps)} steps run, want {want_steps}")
        for i, (_, c, _) in enumerate(f_steps):
            check(c == only(ssd_scan=nl, ssd_scan_bwd=nl),
                  f"step {i} of the run launched {c}, want K5 and K5-bwd "
                  f"{nl} times each (once a layer)")
        check(f_counts == only(ssd_scan=nl * want_steps,
                               ssd_scan_bwd=nl * want_steps),
              f"the run launched {f_counts}")
        clean, c_hist, c_secs, c_counts, c_steps = train_run(
            "train_uninterrupted", [])
        log(f"   train.main uninterrupted: {c_secs:.1f} s, {len(c_steps)} "
            f"steps, launched {c_counts}, history {c_hist}")
        check(c_counts == only(ssd_scan=nl * TRAIN_STEPS,
                               ssd_scan_bwd=nl * TRAIN_STEPS),
              f"the uninterrupted run launched {c_counts}")
        fa, cl = flat(faulty), flat(clean)
        diffs = {k: float((fa[k].double() - cl[k].double()).abs().max())
                 for k in cl}
        equal = sorted(fa) == sorted(cl) and all(
            torch.equal(fa[k], cl[k]) for k in cl)
        log(f"   restarted vs uninterrupted run after {TRAIN_STEPS} steps: "
            f"{len(cl)} leaves, bit for bit {'equal' if equal else 'unequal'}"
            f"; largest difference {max(diffs.values()):.3e} "
            f"({max(diffs, key=diffs.get)}); losses by step: restarted "
            f"{[round(m['loss'], 6) for _, _, m in f_steps]}, uninterrupted "
            f"{[round(m['loss'], 6) for _, _, m in c_steps]}")
        check(equal, "the restarted run does not end equal to the "
              "uninterrupted one (every op on the path is deterministic)")
        del faulty, fa

        # Step 1 again, out of the run: its state (init_state from the
        # seed) and batch (the stream's batch 0), the gradients of the bf16
        # model with K5 and K5-bwd, of the fp32 model with them, and of
        # the fp32 model with the plain scan.
        opt = make_optimizer(cfg, peak_lr=3e-4, warmup=5,
                             total_steps=TRAIN_STEPS)
        state0 = init_state(torch.Generator(device=dev).manual_seed(
            TRAIN_SEED), cfg, opt)
        batch0 = {k: v.to(dev) for k, v in make_stream(
            cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED).batch_at(0).items()}

        def step_grads(c, backend):
            model = api.model_over(state0["params"], c)
            loss, _, g = train_grad.accumulate_grads(
                lambda m, b: api.loss_fn(m, b, c, backend=backend), model,
                batch0, 1)
            return float(loss), g, float(train_grad.global_norm(g))

        cfg32 = dataclasses.replace(cfg, dtype="float32")
        l16, g16, n16 = step_grads(cfg, "auto")
        l32, g32, n32 = step_grads(cfg32, "auto")
        lp, gp, np_ = step_grads(cfg32, "torch")
        step1 = c_steps[0][2]
        g16f, g32f, gpf = flat(g16), flat(g32), flat(gp)
        leaf_err = {k: float((g32f[k] - gpf[k]).abs().max()
                             / gpf[k].abs().max()) for k in gpf}
        log(f"   step 1: the run's bf16 loss {step1['loss']:.6f}, grad norm "
            f"{step1['grad_norm']:.6f}; again out of the run "
            f"{l16:.6f}, {n16:.6f}; fp32 with K5 {l32:.6f}, {n32:.6f}; "
            f"fp32 with the plain scan {lp:.6f}, {np_:.6f}")
        log(f"   fp32 K5 vs plain: loss rel {abs(l32 - lp) / abs(lp):.3e} "
            f"(tolerance {TRAIN_LOSS32_RTOL}), grad norm rel "
            f"{abs(n32 - np_) / np_:.3e} ({TRAIN_GNORM32_RTOL}), largest "
            f"gradient error over its largest magnitude "
            f"{max(leaf_err.values()):.3e} ({max(leaf_err, key=leaf_err.get)}"
            f", tolerance {TRAIN_GRAD32_RTOL}); bf16 run vs fp32 plain: loss "
            f"rel {abs(step1['loss'] - lp) / abs(lp):.3e} (tolerance "
            f"{TRAIN_LOSS16_RTOL}), grad norm rel "
            f"{abs(step1['grad_norm'] - np_) / np_:.3e} "
            f"({TRAIN_GNORM16_RTOL})")
        for name, g in g16f.items():
            check(bool(torch.isfinite(g).all()) and bool((g != 0).any()),
                  f"step 1's gradient of {name} is not finite or all zero")
        check(all(k in g16f for k in ("layers/A_log", "layers/dt_bias")),
              f"no A_log / dt_bias gradient in {sorted(g16f)}")
        check(l16 == step1["loss"] and n16 == step1["grad_norm"],
              "step 1 out of the run differs from the run's step 1")
        check(abs(l32 - lp) <= TRAIN_LOSS32_RTOL * abs(lp)
              and abs(n32 - np_) <= TRAIN_GNORM32_RTOL * np_
              and max(leaf_err.values()) <= TRAIN_GRAD32_RTOL,
              "the fp32 model's step 1 with K5 and K5-bwd is off the plain "
              "scan's")
        check(abs(step1["loss"] - lp) <= TRAIN_LOSS16_RTOL * abs(lp)
              and abs(step1["grad_norm"] - np_) <= TRAIN_GNORM16_RTOL * np_,
              "the trained bf16 model's step 1 is off the fp32 reference's")
        train_step_ms = statistics.median(ms for ms, _, _ in c_steps[1:])
        log(f"   train step, {TRAIN_BATCH}x{TRAIN_SEQ} tokens, warm (host "
            f"clock, median of steps 2..{TRAIN_STEPS} of the uninterrupted "
            f"run): {train_step_ms:.3f} ms, "
            f"{TRAIN_BATCH * TRAIN_SEQ / train_step_ms * 1e3:.0f} tokens/s; "
            f"first step {c_steps[0][0]:.3f} ms | card {card_line()}")
        del g16, g32, gp, g16f, g32f, gpf, clean, cl
        train_profile_step = make_step(cfg, opt)
        torch.cuda.empty_cache()

    with phase("timing"):
        # K2 is timed as the main path calls it: host row ids, cut into the
        # chunk plan and copied without waiting on the card.
        k1_ms = time_ms(lambda: wf_tis_cuda(idx, nb))
        k1_plain = time_ms(lambda: wf_tis_plain(idx, nb), runs=5, launches=2)
        k2_ms = time_ms(lambda: fused_rows_cuda(idx, nb, fused_rows))
        k2_plain = time_ms(lambda: fused_rows_plain(idx, nb, fused_rows),
                           runs=5, launches=2)
        k3_ms = time_ms(lambda: delta_apply_cuda(k3_H, k3_d))
        k3_plain = time_ms(lambda: delta_apply_plain(k3_H, k3_d), runs=5)
        # The one PyTorch call that computes the same function: the same
        # broadcast add as the plain version, timed as the library yardstick.
        k3_library = time_ms(lambda: k3_H + k3_d[..., None, :])
        hs_ms = time_ms(lambda: cw_tis_hscan_cuda(idx, nb))
        hs_plain = time_ms(lambda: cw_tis_hscan_plain(idx, nb), runs=5,
                           launches=2)
        vs_ms = time_ms(lambda: cw_tis_vscan_cuda(hh))
        vs_plain = time_ms(lambda: cw_tis_vscan_plain(hh), runs=5, launches=2)
        # vscan without a carry is one PyTorch call: a cumsum down the rows.
        vs_library = time_ms(lambda: torch.cumsum(hh, dim=-2))
        k4_ms = time_ms(lambda: cw_tis_cuda(idx, nb))
        k5_ms = time_ms(lambda: ssd_scan_cuda(sx, sdt, sA, sB, sC, chunk=sq))
        k5_plain = time_ms(lambda: ssd_scan_plain(sx, sdt, sA, sB, sC,
                                                  chunk=sq),
                           runs=5, launches=2)
        # K5-bwd as the backward of a training step calls it (h0 = None,
        # no gradient of h_last), from the states K5 keeps.
        _, _, k5b_states0 = ssd_scan_cuda(sx, sdt, sA, sB, sC, chunk=sq,
                                          return_states=True)

        def k5b_call():
            return ssd_scan_bwd_cuda(sx, sdt, sA, sB, sC, k5b_gy,
                                     states=k5b_states0, chunk=sq)

        k5b_ms = time_ms(k5b_call)
        k5b_plain = time_ms(lambda: ssd_scan_bwd_plain(
            sx, sdt, sA, sB, sC, k5b_gy, chunk=KERNEL_CHUNK), runs=3,
            launches=2)
        log(f"   train step {train_step_ms:.3f} ms warm, "
            f"{TRAIN_BATCH * TRAIN_SEQ / train_step_ms * 1e3:.0f} tokens/s: "
            f"its {nl} K5 launches {nl * k5_ms:.3f} ms, its {nl} K5-bwd "
            f"launches {nl} x {k5b_ms:.4f} = {nl * k5b_ms:.3f} ms "
            f"({nl * k5b_ms / train_step_ms:.1%} of the step); peak device "
            f"memory of the run {train_peak / 1e9:.2f} GB | card "
            f"{card_line()}")
        log(f"   ssd_scan at {sb}x{ss}x{sh}x{sp}, N={sn}: {k5_ms:.4f} ms a "
            f"launch, {cfg.num_layers * k5_ms:.3f} ms for the "
            f"{cfg.num_layers} launches of a prefill "
            f"({cfg.num_layers * k5_ms / lm_prefill_ms:.1%} of its "
            f"{lm_prefill_ms:.3f} ms)")
        log(f"   cw_tis (hscan + vscan) at the clip: {k4_ms:.4f} ms, "
            f"{k4_ms / k1_ms:.2f}x wf_tis's {k1_ms:.4f} ms")
        # K1 at the shapes the paths launch it at, and at 1080p: bound by
        # bytes (k1_bytes), with the launches of this run's paths at that
        # shape and, from a profiler trace, the CUDA launches and device
        # time of one call.
        k1_by_shape, k1_calls = [], {}
        for label, (ids, bins, cin) in k1_in.items():
            kn, kh, kw = ids.shape
            shp = launch_shape(kw, bins, kn, h=kh)
            ms = time_ms(lambda: wf_tis_cuda(ids, bins, carry=cin))
            per_call, kernel_us = device_kernels(
                torch, lambda: wf_tis_cuda(ids, bins, carry=cin))
            k1_calls[label] = per_call
            bound = k1_bytes(ids, bins, cin) / HBM_BYTES_PER_S * 1e3
            runs = sum(paths.get(pth, {}).get("wf_tis", 0)
                       for pth in K1_SHAPES[label][1])
            k1_by_shape.append({
                "shape": f"{kn}x{kh}x{kw}x{bins}"
                         + (" + carry" if cin is not None else ""),
                "path": label, "ms": ms, "bound_ms": bound,
                "launches_per_run": runs,
                "device_us": sum(kernel_us.values()) if kernel_us else None})
            log(f"   wf_tis at the {label} shape {k1_by_shape[-1]['shape']}: "
                f"{ms:.4f} ms ({kn / ms * 1e3:.0f} frames/s) | bound "
                f"{bound:.4f} ms by bytes, {bound / ms:.1%} of it | "
                f"{shp.strips(kh)} strip(s), {shp.ctas(kn, bins, kh)} CTAs | "
                f"{runs} launches in this run's paths | profiled: "
                + (f"{per_call:g} CUDA launch(es) a call, device µs a call "
                   + ", ".join(f"{k[:48]} {v:.2f}"
                               for k, v in kernel_us.items())
                   if per_call is not None else "not measured"))
        # Where strips start to pay: one strip against the strip cut at
        # heights of a 640-column run at 32 bins with a carry (bins 0..31
        # a frame, one CTA a bin without strips).
        sweep = []
        for kh in K1_SWEEP_HEIGHTS:
            ids, cin = k1_inputs(torch, dev, 1, kh, w, nb, True, seed=kh)
            one = launch_shape(w, nb, 1, h=kh, strip_rows=kh)
            cut = launch_shape(w, nb, 1, h=kh,
                               strip_rows=strip_rows_for(kh, nb))
            pair = [time_ms(lambda: wf_tis_launch(ids, nb, one, cin)),
                    time_ms(lambda: wf_tis_launch(ids, nb, cut, cin))]
            pair += [time_ms(lambda: wf_tis_launch(ids, nb, one, cin)),
                     time_ms(lambda: wf_tis_launch(ids, nb, cut, cin))]
            sweep.append(f"{kh}: {min(pair[0], pair[2]):.4f} vs "
                         f"{min(pair[1], pair[3]):.4f} "
                         f"({cut.strips(kh)} strips)")
        log(f"   wf_tis strip sweep, 1xHx{w}x{nb} + carry, ms a call (best "
            f"of two medians), H: one strip vs strips: " + "; ".join(sweep)
            + f" | launch_shape cuts from {wf_tis_mod._STRIP_MIN_HEIGHT} rows")
        # K2 at its shapes likewise (k2_bytes), its plain version beside.
        k2_by_shape, k2_calls = [], {}
        for label, (ids, bins, krows) in k2_in.items():
            kn, kh, kw = ids.shape
            ms = time_ms(lambda: fused_rows_cuda(ids, bins, krows))
            plain_ms = time_ms(lambda: fused_rows_plain(ids, bins, krows),
                               runs=5, launches=2)
            per_call, kernel_us = device_kernels(
                torch, lambda: fused_rows_cuda(ids, bins, krows))
            k2_calls[label] = per_call
            bound = k2_bytes(ids, bins, krows, None) / HBM_BYTES_PER_S * 1e3
            runs = sum(paths.get(pth, {}).get("fused_rows", 0)
                       for pth in K2_SHAPES[label][1])
            k2_by_shape.append({
                "shape": f"{kn}x{kh}x{kw}x{bins}, {krows.size} rows",
                "path": label, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "launches_per_run": runs,
                "device_us": sum(kernel_us.values()) if kernel_us else None})
            log(f"   fused_rows at the {label} shape {k2_by_shape[-1]['shape']}"
                f": {ms:.4f} ms | bound {bound:.4f} ms by bytes "
                f"({k2_bytes(ids, bins, krows, None) / 1e6:.2f} MB), "
                f"{bound / ms:.1%} of it | plain {plain_ms:.4f} ms | {runs} "
                "launches in this run's paths | profiled: "
                + (f"{per_call:g} CUDA launch(es) a call, device µs a call "
                   + ", ".join(f"{k[:48]} {v:.2f}"
                               for k, v in kernel_us.items())
                   if per_call is not None else "not measured"))
        k5_calls, k5_kernel_us = device_kernels(
            torch, lambda: ssd_scan_cuda(sx, sdt, sA, sB, sC, chunk=sq))
        log(f"   ssd_scan profiled: "
            + (f"{k5_calls:g} CUDA launch(es) a call, device µs a call "
               + ", ".join(f"{k[:48]} {v:.2f}"
                           for k, v in k5_kernel_us.items())
               if k5_calls is not None else "not measured"))
        k5b_calls, k5b_kernel_us = device_kernels(torch, k5b_call)
        log(f"   ssd_scan_bwd profiled: "
            + (f"{k5b_calls:g} CUDA launch(es) a call (the two kernels, then "
               f"the parts' sums), device µs a call "
               + ", ".join(f"{k[:48]} {v:.2f}"
                           for k, v in k5b_kernel_us.items())
               if k5b_calls is not None else "not measured"))
        px = n * h * w
        h_run = int(fused_rows[-1]) + 1
        # Each input read once, each output written once.  Operations: one
        # add per element of a column walk, one per emitted element of a
        # row scan (and one compare per one-hot element); K3 one add per
        # element.
        work = {
            "wf_tis": (4 * px + 4 * px * nb, 2 * px * nb),
            "fused_rows": (k2_bytes(idx, nb, fused_rows, None),
                           n * nb * h_run * w + n * nb * fused_rows.size * w),
            "delta_apply": (4 * (2 * k3_H.numel() + k3_d.numel()),
                            k3_H.numel()),
            "cw_tis_hscan": (4 * px + 4 * px * nb, 2 * px * nb),
            "cw_tis_vscan": (2 * 4 * px * nb, px * nb),
            # The timed launch (h0 = None) reads x, dt, A, B and C and
            # writes y and h_last.  Operations: what the function needs,
            # the recurrence's decay, update and read-out of the (N, P)
            # state, 4 N P flops per (batch, head, step); the SSD form
            # of a chunked kernel does more, and more the longer its
            # chunk.
            "ssd_scan": (4 * (sx.numel() + sdt.numel() + sA.numel()
                              + sB.numel() + sC.numel()     # read
                              + sx.numel() + sb * sh * sn * sp),  # written
                         4 * sb * sh * ss * sn * sp),
            # The timed call reads x, dt, B, C, gy and the states K5 kept
            # and writes gx, gdt, gA, gB and gC.  Operations: what the
            # function needs, five multiply-adds per state element a step
            # (h, gC, lam, gB, gu), 10 N P flops per (batch, head, step).
            "ssd_scan_bwd": (4 * (sx.numel() + sdt.numel() + sB.numel()
                                  + sC.numel() + k5b_gy.numel()
                                  + k5b_states0.numel()            # read
                                  + sx.numel() + sdt.numel() + sh
                                  + sB.numel() + sC.numel()),      # written
                             10 * sb * sh * ss * sn * sp),
        }
        ssd_form = {q: 2 * sb * sh * ss * (q * (sn + sp) + 2 * sn * sp)
                    for q in (KERNEL_CHUNK, sq)}
        log(f"   ssd_scan operations: the function needs "
            f"{work['ssd_scan'][1] / 1e9:.2f} GFLOP (4 N P a step); the SSD "
            f"form's full products, 2 Q (Q N + Q P + 2 N P) a chunk, are "
            + ", ".join(f"{f / 1e9:.2f} GFLOP at Q = {q}"
                        for q, f in ssd_form.items()))
        # K5-bwd's chunk form, per 64-step chunk: per head C^T gy (the
        # reverse pass), gy u^T, M^T gy, B G, u G^T and gy H0^T, 2 Q (4 N P
        # + 2 Q P); per group of heads C B^T, W B and W^T C, 6 Q Q N.
        bwd_groups = -(-sh // bwd_heads_per_cta(sb, ss, sh, sp, sn))
        bwd_form = 2 * sb * ss * (sh * (4 * sn * sp + 2 * KERNEL_CHUNK * sp)
                                  + bwd_groups * 3 * KERNEL_CHUNK * sn)
        log(f"   ssd_scan_bwd operations: the function needs "
            f"{work['ssd_scan_bwd'][1] / 1e9:.2f} GFLOP (10 N P a step); the "
            f"chunk form's full products, 2 Q (4 N P + 2 Q P) a head and "
            f"6 Q Q N a group of heads ({bwd_groups} groups) a chunk, are "
            f"{bwd_form / 1e9:.2f} GFLOP at Q = {KERNEL_CHUNK}")
        timed = {
            "wf_tis": ("src/repro/kernels/wf_tis.py:253", "wf_tis.cu",
                       k1_ms, k1_plain, None, k1_err),
            "fused_rows": ("src/repro/kernels/fused_rows.py:294",
                           "fused_rows.cu", k2_ms, k2_plain, None, k2_err),
            "delta_apply": ("src/repro/kernels/delta_apply.py:112",
                            "delta_apply.cu", k3_ms, k3_plain, k3_library,
                            k3_err),
            "cw_tis_hscan": ("src/repro/kernels/cw_tis.py:173", "cw_tis.cu",
                             hs_ms, hs_plain, None, hscan_err),
            "cw_tis_vscan": ("src/repro/kernels/cw_tis.py:187", "cw_tis.cu",
                             vs_ms, vs_plain, vs_library, vscan_err),
            "ssd_scan": ("src/repro/kernels/ssd_scan.py:88", "ssd_scan.cu",
                         k5_ms, k5_plain, None, k5_err),
            "ssd_scan_bwd": ("none: ssd_scan_pallas (src/repro/kernels/"
                             "ssd_scan.py:88) has no backward; the reference "
                             "differentiates ssd_chunked through XLA",
                             "ssd_scan_bwd.cu", k5b_ms, k5b_plain, None,
                             k5b_err),
        }
        library_call = {"delta_apply": "H + delta[..., None, :]",
                        "cw_tis_vscan": "torch.cumsum(hh, dim=-2)"}
        # The rate of the unit each kernel computes on: K5's and K5-bwd's
        # products are 3xTF32 on the tensor cores, the others fp32 adds.
        op_rate = {"ssd_scan": (TF32X3_OPS_PER_S, "3xTF32"),
                   "ssd_scan_bwd": (TF32X3_OPS_PER_S, "3xTF32")}
        records = []
        for name, (site, src, ms, plain_ms, lib_ms, err) in timed.items():
            nbytes, nops = work[name]
            rate, unit = op_rate.get(name, (FP32_OPS_PER_S, "fp32"))
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / rate * 1e3
            bound = max(t_bytes, t_ops)
            by_path = {path: counts[name] for path, counts in paths.items()}
            by = "bytes" if t_bytes >= t_ops else "operations"
            records.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "replaces": site, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            })
            if name == "ssd_scan":
                records[-1].update(launches_per_request=lm_launches,
                                   launches_per_train_step=nl,
                                   cuda_launches_per_call=k5_calls)
            if name == "ssd_scan_bwd":
                records[-1].update(launches_per_train_step=nl,
                                   cuda_launches_per_call=k5b_calls)
            if name == "wf_tis":
                records[-1].update(cuda_launches_per_call=k1_calls,
                                   shapes=k1_by_shape)
            if name == "fused_rows":
                records[-1].update(cuda_launches_per_call=k2_calls,
                                   shapes=k2_by_shape)
            lib = (f"library_ms {lib_ms:.4f} ({library_call[name]})"
                   if lib_ms is not None else "library_ms: none, no single "
                   "PyTorch call computes the same function")
            achieved = (f"{nops / ms / 1e9:.2f} TFLOP/s of needed work"
                        if by == "operations"
                        else f"{n / ms * 1e3:.0f} frames/s")
            extra = ""
            if name in op_rate:
                fp32_bound = max(t_bytes, nops / FP32_OPS_PER_S * 1e3)
                extra = (f"; at fp32's 67 TFLOP/s the bound would be "
                         f"{fp32_bound:.4f} ms, {fp32_bound / ms:.1%} of it")
            log(f"   {name}: {ms:.4f} ms ({achieved}) | bound {bound:.4f} ms "
                f"by {by} ({nbytes / 1e6:.1f} MB at 3.35 TB/s, "
                f"{nops / 1e9:.3f} GFLOP at {rate / 1e12:.0f} TFLOP/s "
                f"{unit}), {bound / ms:.1%} of it{extra} | plain torch "
                f"version {plain_ms:.4f} ms (no yardstick) | {lib}")

        # End to end: requests from host uint8 frames to answers on the
        # card, warm, host clock around work that ends in a synchronize.
        for label, eng, queries, frames, count in (
                ("fused", engine, fused_queries, clip_np, n),
                ("fused, one frame", engine, fused_queries, clip_np[0], 1),
                ("dense", engine, dense_queries, clip_np, n),
                ("dense, method=cw_tis", cw_engine, dense_queries, clip_np,
                 n)):
            ms = request_ms(lambda: eng.run(frames, queries))
            log(f"   engine.run {label} request, {count}x{h}x{w}x{nb} from "
                f"host frames: {ms:.3f} ms median of 5 "
                f"({count / ms * 1e3:.0f} frames/s)")
        ms = request_ms(lambda: banded_engine.run(frame_4k, band_queries))
        log(f"   engine.run banded request, 1x{bh}x{bw}x{bnb} in 8 bands: "
            f"{ms:.3f} ms median of 5")

        seed_out = v_engine.run(stream[0], v_queries)

        def chain(prev_given: bool, stop: int = len(stream)):
            # Frames 1..stop-1 of the video stream, each with its
            # predecessor (incremental, chained from frame 0's result) or
            # without (full recompute).
            out = seed_out
            for t in range(1, stop):
                prev = (stream[t - 1], out) if prev_given else None
                out = v_engine.run(stream[t], v_queries, prev=prev)

        inc = request_ms(lambda: chain(True)) / (len(stream) - 1)
        full = request_ms(lambda: chain(False)) / (len(stream) - 1)
        log(f"   video {vh}x{vw}x{vnb}, 48-row block a frame: incremental "
            f"{inc:.3f} ms/frame vs full recompute {full:.3f} ms/frame "
            f"({full / inc:.2f}x; median of 5 runs of 29 requests)")
        for label, prev_given in (("incremental", True), ("full", False)):
            log(f"   video {label} request, torch.profiler over 10: "
                + profile_requests(torch, lambda: chain(prev_given, 11)))
        # After every host-clock timing, so that no timed request follows
        # a profiler session.
        log("   fused request on one frame, torch.profiler over 10: "
            + profile_requests(torch, lambda: [
                engine.run(clip_np[0], fused_queries) for _ in range(10)]))

        # The repair step of frame 1 alone: update_dense_ih's K3 walk as
        # the port runs it (one new H, K3 writing the rows below into it)
        # against the same walk joining per-run pieces with one torch.cat
        # (a foil: the layout the walk had before K3 wrote in place).
        H0 = seed_out.source.dense()
        spans = v_engine._delta_spans(v_engine.spec_for(stream[1].shape),
                                      seed_out.source)
        report = delta_mod.diff_bands(stream[0], stream[1], spans)

        def recompute(rows, carry):
            return ops.integral_histogram(rows, vnb, carry_in=carry,
                                          backend="cuda")

        def k3(slab, d, out=None):
            return ops.delta_apply(slab, d, backend="cuda", out=out)

        def walk_out():
            return delta_mod.update_dense_ih(H0, stream[1], report,
                                             recompute=recompute, apply_fn=k3)

        def walk_cat():
            pieces, new_carry, d = [], None, None
            for r0, r1, dirty in delta_mod._merged_runs(report):
                old_bottom = H0[..., r1 - 1, :]
                if dirty:
                    slab = recompute(stream[1][r0:r1], new_carry)
                    new_carry = slab[..., -1, :]
                    d = new_carry - old_bottom
                elif d is None:
                    slab, new_carry = H0[..., r0:r1, :], old_bottom
                else:
                    slab, new_carry = k3(H0[..., r0:r1, :], d), old_bottom + d
                pieces.append(slab)
            return torch.cat(pieces, dim=-2)

        check(torch.equal(walk_out(), walk_cat()), "the two walks differ")
        walks = {"in place": [], "cat": []}
        for _ in range(4):                  # alternating, to share drift
            for label, fn in (("in place", walk_out), ("cat", walk_cat)):
                walks[label].append(request_ms(
                    lambda: [fn() for _ in range(20)]) / 20)
        log(f"   update_dense_ih repair of frame 1 ({len(report.spans)} "
            f"spans, runs {[r[2] for r in delta_mod._merged_runs(report)]}), "
            f"host clock, median of 4x5 runs of 20: K3 into the new H "
            f"{statistics.median(walks['in place']):.4f} ms vs pieces + "
            f"torch.cat {statistics.median(walks['cat']):.4f} ms")

        # The new phases' profiler sessions last, after every host-clock
        # timing (a timing that follows a session reads slower).
        for depth in (1, 2):
            copies, kernels, device, wall_us = trace_streams(
                torch, lambda: [None for _ in stream_engine.map_frames(
                    iter(s_frames), depth=depth)])
            copy_streams = {c[0] for c in copies}
            k1_streams = {k[0] for k in kernels}
            overlap = sum(1 for _, a, b in copies
                          if any(ka < b and a < kb for _, ka, kb in kernels))
            check(copies and kernels, f"depth {depth}: the trace shows "
                  f"{len(copies)} copies and {len(kernels)} K1 kernels")
            check(not copy_streams & k1_streams,
                  f"host-to-device copies on K1's stream {k1_streams}")
            busy = busy_us(device)
            log(f"   stream depth {depth}, torch.profiler: {len(copies)} "
                f"host-to-device copies on stream(s) {sorted(copy_streams)}, "
                f"{len(kernels)} K1 kernels on {sorted(k1_streams)}; "
                f"{overlap} copies overlap a K1 kernel; device busy "
                f"{busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall (idle "
                f"{1 - busy / wall_us:.1%}) | card {card_line()}")
        log(f"   stream depth 2, torch.profiler over {STREAM_FRAMES} frames: "
            + profile_requests(torch, lambda: [
                None for _ in stream_engine.map_frames(iter(s_frames))],
                n=STREAM_FRAMES))
        log("   tracker step loop, 1 target, torch.profiler over 10 frames: "
            + profile_requests(torch, lambda: [
                tracker.step(dict(st0), f) for f in t_clip[1:11]]))
        svc.clear_cache()
        log("   service clip groups, torch.profiler over 8 frames: "
            + profile_requests(torch, lambda: [
                svc.process([(("clip", i), q) for q in s_queries])
                for i in range(8)], n=8))

        def frames46(fn, k=3):
            for _ in range(k):          # each 32 GiB H is freed at once
                fn()

        for label, fn in (
                ("dense", lambda: ops.integral_histogram(frame46, fnb)),
                ("bin-sharded", lambda: distributed.bin_sharded_ih(
                    frame46, fnb, bins4)),
                ("spatially sharded", lambda: distributed.spatial_sharded_ih(
                    frame46, fnb, rows4))):
            log(f"   8192x8192x128 {label} frame, torch.profiler over 3: "
                + profile_requests(torch, lambda: frames46(fn), n=3))

        # The analysis phase's last part, with the profiler sessions: each
        # kernel spec against the launch the card ran, from an exported
        # trace of one call at every shape above (grid, block, shared
        # memory), the shared memory against the card's opt-in limit and
        # the registers against an SM's 65,536.
        import re

        from repro_torch.kernels.specs import KernelGeometry, REGISTERS_PER_SM

        optin, optin_src = smem_optin_bytes(torch)
        calls = [("wf_tis", label, KernelGeometry(*ids.shape, bins),
                  lambda ids=ids, bins=bins, cin=cin: wf_tis_cuda(
                      ids, bins, carry=cin))
                 for label, (ids, bins, cin) in k1_in.items()]
        calls += [("fused_rows", label, KernelGeometry(
                       *ids.shape, bins, rows=tuple(int(r) for r in krows)),
                   lambda ids=ids, bins=bins, krows=krows: fused_rows_cuda(
                       ids, bins, krows))
                  for label, (ids, bins, krows) in k2_in.items()]
        kn, knb, kh, kw = k3_H.shape
        calls += [("delta_apply", "clip", KernelGeometry(kn, kh, kw, knb),
                   lambda: delta_apply_cuda(k3_H, k3_d)),
                  ("cw_tis", "clip", KernelGeometry(n, h, w, nb),
                   lambda: cw_tis_cuda(idx, nb))]
        static_read, launch_checks = set(), {}
        for method, label, geom, fn in calls:
            specs = ops.KERNEL_SPECS[method](geom)
            events = traced_launches(torch, fn, len(specs))
            check(len(events) == len(specs),
                  f"{method} at {label}: {len(events)} traced kernels, "
                  f"{len(specs)} in its spec")
            for spec, ev in zip(specs, events):
                what = f"{spec.name} at {label}"
                check(None not in (ev["grid"], ev["block"], ev["smem"],
                                   ev["regs"]),
                      f"{what}: the trace lacks a launch field: {ev}")
                check(re.search(rf"\b{spec.kernel}\b", ev["name"]),
                      f"{what}: traced kernel {ev['name'][:80]}")
                check(list(ev["grid"]) == list(spec.cuda_grid),
                      f"{what}: grid {ev['grid']} != spec {spec.cuda_grid}")
                check(list(ev["block"]) == [spec.threads, 1, 1],
                      f"{what}: block {ev['block']} != {spec.threads}")
                if spec.smem_static and not spec.smem_dynamic:
                    static_read.add(ev["smem"] == spec.smem_static)
                check(ev["smem"] in (spec.smem_bytes(), spec.smem_dynamic),
                      f"{what}: shared memory {ev['smem']} != spec "
                      f"{spec.smem_detail()}")
                check(spec.smem_bytes() <= optin,
                      f"{what}: {spec.smem_bytes()} B > the card's {optin}")
                check(ev["regs"] * spec.threads <= REGISTERS_PER_SM,
                      f"{what}: {ev['regs']} registers x {spec.threads} "
                      "threads pass an SM's")
                key = (spec.name.replace("/", "_") if method == "cw_tis"
                       else method)
                launch_checks.setdefault(key, []).append({
                    "shape": label, "kernel": spec.kernel,
                    "ctas": spec.ctas, "threads": spec.threads,
                    "smem_bytes": ev["smem"], "regs_per_thread": ev["regs"]})
                log(f"   launch {what}: grid {ev['grid']}, {spec.ctas} "
                    f"CTAs x {spec.threads} threads, shared {ev['smem']} B "
                    f"({spec.smem_detail()}), {ev['regs']} registers a "
                    f"thread: equal to its spec")
        check(len(static_read) == 1,
              f"the trace's shared memory reads static bytes inconsistently")
        log(f"   the trace's \"shared memory\" is "
            + ("static plus dynamic" if static_read == {True}
               else "the dynamic part only")
            + f" (kernels with only static shared memory read "
            f"{'their static bytes' if static_read == {True} else '0'}); "
            f"the card's opt-in limit {optin} B ({optin_src}) | card "
            f"{card_line()}")
        # K5-bwd's two launches from the same kind of trace (its call's
        # other launches are the wrapper's sums of the parts): the reverse
        # state pass and the chunk kernel, each one's grid, threads and
        # shared bytes against ssd_scan.bwd_launches, one CTA an SM.
        want_bwd = bwd_launches(sb, ss, sh, sp, sn)
        names_bwd = [d["kernel"] for d in want_bwd]
        events = [e for e in traced_launches(
                      torch, k5b_call, round(k5b_calls) if k5b_calls else 8)
                  if any(k in e["name"] for k in names_bwd)]
        check([next(k for k in names_bwd if k in e["name"]) for e in events]
              == names_bwd, f"K5-bwd's traced kernels {events}")
        k5b_checks = []
        for want, ev in zip(want_bwd, events):
            what = f"{want['kernel']} at {sb}x{ss}x{sh}x{sp}, N={sn}"
            log(f"   launch {what}: grid {ev['grid']}, block {ev['block']}, "
                f"shared {ev['smem']} B, {ev['regs']} registers a thread "
                f"(want grid {list(want['grid'])}, {want['threads']} "
                f"threads, {want['smem']} B)")
            check(list(ev["grid"]) == list(want["grid"])
                  and list(ev["block"]) == [want["threads"], 1, 1]
                  and ev["smem"] == want["smem"],
                  f"{what} launched {ev}, not {want}")
            check(want["smem"] <= optin
                  and ev["regs"] * want["threads"] <= REGISTERS_PER_SM,
                  f"{what}: {want['smem']} B, {ev['regs']} registers x "
                  f"{want['threads']} threads do not fit an SM")
            k5b_checks.append({
                "shape": "training", "kernel": want["kernel"],
                "ctas": math.prod(want["grid"]), "threads": want["threads"],
                "smem_bytes": ev["smem"], "regs_per_thread": ev["regs"]})
        next(r for r in records
             if r["name"] == "ssd_scan_bwd")["launch_checks"] = k5b_checks
        for rec in records:
            if rec["name"] in launch_checks:
                rec["launch_checks"] = launch_checks[rec["name"]]
        # Last: two train steps under the profiler (run before the launch
        # check above, it left that check's traces with no kernel event).
        log(f"   {LM_ARCH} train step, {TRAIN_BATCH}x{TRAIN_SEQ} tokens, "
            "torch.profiler over 2: " + profile_requests(
                torch, lambda: [train_profile_step(state0, batch0)
                                for _ in range(2)], n=2))
        del state0, batch0, train_profile_step
        torch.cuda.empty_cache()

    with phase("transformer at scale: llava-next-mistral-7b and "
               "llama4-scout through repro_torch.launch.serve"):
        transformer_at_scale(torch, dev, counted, tally, read_counts, only)
        # the kernels line carries this phase's paths too
        for rec in records:
            rec["launches_by_path"] = {path: counts[rec["name"]]
                                       for path, counts in paths.items()}
            rec["launches"] = sum(rec["launches_by_path"].values())
    return records


if __name__ == "__main__":
    sys.exit(main())

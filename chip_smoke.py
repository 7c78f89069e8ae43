#!/usr/bin/env python3
"""Drive the repro_torch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each ended by ``torch.cuda.synchronize()``; any failure exits
non-zero before the result line is printed:

  build   compile the CUDA kernels (src/repro_torch/kernels/csrc) with nvcc
  k1      the WF-TiS kernel against its plain torch version (torch.equal):
          a 16-frame 480x640 clip at 32 bins (the paper's geometry), four
          1080x1920 frames at 64 bins, ragged shapes, a float frame and a
          non-zero carry_in
  k2      the query-fused kernel against the plain H's rows, and the early
          cut (bands_computed < bands_total)
  main    HistogramEngine(num_bins=32).run on the clip: a request that
          plans "fused" and one that plans "dense"; the launch counters
          are set to 0 just before each request and read just after it:
          the fused one must launch fused_rows once and wf_tis never, the
          dense one the other way round; answers held against
          backend="torch" on the same card and against a direct count on
          frames of the clip
  timing  each kernel's median time (CUDA events) beside its bound, K1
          also on one frame of the clip and at 1080p

The line before the last is the per-kernel JSON record, the last line
``{"ok": true, "device": {...}}``.  Without a GPU, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data sheet: HBM3 bandwidth and fp32 (non-tensor-core) peak.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
MAP_RTOL, MAP_ATOL = 1e-6, 1e-7


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


def phase(name: str):
    import torch

    class _Phase:
        def __enter__(self):
            self.t0 = time.perf_counter()
            log(f"== {name}")

        def __exit__(self, *exc):
            torch.cuda.synchronize()
            if exc[0] is None:
                log(f"   {name} ok in {time.perf_counter() - self.t0:.1f} s")
            return False

    return _Phase()


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
    import numpy as np

    from repro_torch.core import engine as eng_mod
    from repro_torch.core.binning import bin_indices
    from repro_torch.data import video_frames
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.fused_rows import fused_rows_cuda, fused_rows_plain
    from repro_torch.kernels.ref import region_histogram_ref
    from repro_torch.kernels.wf_tis import wf_tis_cuda, wf_tis_plain

    dev = torch.device("cuda")
    log(f"device: {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} | CUDA {torch.version.cuda}")
    log(f"card: {card_line()}")

    with phase("build"):
        t0 = time.perf_counter()
        libs = _build.build_all()
        log(f"   built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

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
        got = fused_rows_cuda(idx, nb, fused_rows)
        H = wf_tis_plain(idx, nb)
        want = H[..., torch.as_tensor(fused_rows, device=dev), :]
        check(torch.equal(got, want), "K2 != plain H rows (fused request)")
        k2_err = float((got - want).abs().max())
        log(f"   {fused_rows.size} corner rows of {n}x{h}x{w}x{nb}: equal")
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

    with phase("main: HistogramEngine.run on the GPU"):
        dense_queries = [eng_mod.SlidingWindowQuery((24, 24), stride=1)]
        engine = eng_mod.HistogramEngine(num_bins=nb)

        def counted(queries):
            # Each path's own counts: set to 0 just before, read just after.
            wf_tis_cuda.launches = fused_rows_cuda.launches = 0
            t0 = time.perf_counter()
            out = engine.run(clip_np, queries)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0, {
                "wf_tis": wf_tis_cuda.launches,
                "fused_rows": fused_rows_cuda.launches}

        fused, t_fused, fused_counts = counted(fused_queries)
        dense, t_dense, dense_counts = counted(dense_queries)
        by_path = {name: {"fused": fused_counts[name],
                          "dense": dense_counts[name]}
                   for name in ("wf_tis", "fused_rows")}
        log(f"   launches: fused request {fused_counts}, dense request "
            f"{dense_counts}")
        check(fused_counts == {"wf_tis": 0, "fused_rows": 1},
              f"fused request launched {fused_counts}, want one fused_rows")
        check(dense_counts == {"wf_tis": 1, "fused_rows": 0},
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
        del fused, dense, wins
        torch.cuda.empty_cache()

    with phase("timing"):
        # K2 is timed as the main path calls it: host row ids, turned into
        # the row -> slot map and copied without waiting on the card.
        k1_ms = time_ms(lambda: wf_tis_cuda(idx, nb))
        k1_plain = time_ms(lambda: wf_tis_plain(idx, nb), runs=5, launches=2)
        k2_ms = time_ms(lambda: fused_rows_cuda(idx, nb, fused_rows))
        k2_plain = time_ms(lambda: fused_rows_plain(idx, nb, fused_rows),
                           runs=5, launches=2)
        for label, ids, bins in (("4x1080x1920x64", big, 64),
                                 (f"1x{h}x{w}x{nb}", idx[:1].contiguous(),
                                  nb)):
            ms = time_ms(lambda: wf_tis_cuda(ids, bins))
            bound = 4 * ids.numel() * (bins + 1) / HBM_BYTES_PER_S * 1e3
            log(f"   wf_tis at {label}: {ms:.4f} ms "
                f"({ids.shape[0] / ms * 1e3:.0f} frames/s) | bound "
                f"{bound:.4f} ms, {bound / ms:.1%} of it")
        px = n * h * w
        h_run = int(fused_rows[-1]) + 1
        # Each input read once, each output written once.
        k1_bytes = 4 * px + 4 * px * nb
        k2_bytes = 4 * n * h_run * w + 4 * n * nb * fused_rows.size * w
        # One add per element of the column walk, one per emitted element
        # of the row scan.
        k1_ops = 2 * px * nb
        k2_ops = n * nb * h_run * w + n * nb * fused_rows.size * w
        records = []
        for name, src, site, ms, plain_ms, nbytes, nops, err in (
            ("wf_tis", "src/repro_torch/kernels/csrc/wf_tis.cu",
             "src/repro/kernels/wf_tis.py:253", k1_ms, k1_plain, k1_bytes,
             k1_ops, k1_err),
            ("fused_rows", "src/repro_torch/kernels/csrc/fused_rows.cu",
             "src/repro/kernels/fused_rows.py:294", k2_ms, k2_plain,
             k2_bytes, k2_ops, k2_err),
        ):
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / FP32_OPS_PER_S * 1e3
            bound = max(t_bytes, t_ops)
            records.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": site, "launches": sum(by_path[name].values()),
                "launches_by_path": by_path[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
            })
            log(f"   {name}: {ms:.4f} ms ({n / ms * 1e3:.0f} frames/s) | "
                f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s)"
                f", {bound / ms:.1%} of it | plain torch version "
                f"{plain_ms:.4f} ms (no yardstick) | library_ms: none, no "
                "single PyTorch call computes an integral histogram")

        # End to end: one request from host uint8 frames to answers on the
        # card, warm, host clock around work that ends in a synchronize.
        for label, queries in (("fused", fused_queries),
                               ("dense", dense_queries)):
            def request():
                engine.run(clip_np, queries)
                torch.cuda.synchronize()

            request()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                request()
                times.append(time.perf_counter() - t0)
            ms = statistics.median(times) * 1e3
            log(f"   engine.run {label} request, {n}x{h}x{w}x{nb} from host "
                f"frames: {ms:.3f} ms median of 5 ({n / ms * 1e3:.0f} "
                "frames/s)")
    return records


if __name__ == "__main__":
    sys.exit(main())

"""The shared loop: one cell, run once, from set-up to the result line.

A cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
and a traffic mix; the harness reads ``configs/<config>.json`` and
``traffic/<traffic>.json`` and knows neither by name, nor anything they
name: the configuration's ``engine`` object goes to the port unchanged,
and the traffic names its client (``clients/<client>.py``: how a request
is made), its loop (``loops/<loop>.py``: how load is offered and each
request timed) and each query's kind (``kinds/<kind>.py``).  A request
hands over host frames, NumPy views of the pinned pool.

Order of a run:

1. set-up: imports, the CUDA context, the kernels' libraries (built into
   the checkout's ``src/repro_torch/kernels/build/`` on its first run),
   the frame pool and queries from the seed, warm-up requests of the
   cell's own traffic (the first timed apart).  ``setup_s`` ends here.
2. the window: requests until ``--seconds`` have passed.  With
   ``--trace 1`` the profiler covers a whole number of requests in the
   middle of it.  A seeded reservoir keeps the answers and H at a seeded
   sample of rows of a few requests.
3. after the window: the card's state, the memory peak; then the
   program's state is freed and the reference recomputes the kept
   requests' answers and H rows from the same frames.
4. the result: earlier lines (set-up parts, card state, window counts),
   the compared numbers with their limits as the last lines of standard
   error, and one JSON line last on standard output.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

from portbench import check, generate

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# Where in the window the traced stretch starts, and its longest length.
TRACE_START = 0.3
TRACE_SECONDS = 3.0
# The keys a configuration and a traffic file may hold; any other is
# refused, so that nothing a file states is dropped unseen.
CONFIG_KEYS = {"name", "source", "source_part", "deployment", "height",
               "width", "frame_dtype", "h_dtype", "engine", "guarantees",
               "assumed", "reduced"}
TRAFFIC_KEYS = {"name", "why", "source", "loop", "client",
                "frames_per_request", "pool_requests", "warmup_requests",
                "target", "queries", "check", "limits"}


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``)."""

    cell: dict
    setup_s: float
    window_s: float
    frames: int
    latencies: list
    timeline: object = None


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _known(d: dict, keys: set, what: str) -> dict:
    unknown = sorted(set(d) - keys)
    if unknown:
        raise ValueError(f"{what} has keys the harness does not read: "
                         f"{unknown}")
    return d


def load_cell(manifest: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` with its files read."""
    entries = {w["name"]: w for w in manifest["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    path = root / configs[entry["config"]]["file"]
    config = _known(json.loads(path.read_text()), CONFIG_KEYS, path.name)
    path = root / "portbench" / "traffic" / f"{entry['traffic']}.json"
    traffic = _known(json.loads(path.read_text()), TRAFFIC_KEYS, path.name)
    e2e = [m for m in manifest["end_to_end"] if _applies(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if _applies(m, workload) and m["moves"] in names]
    return Cell(workload, entry, config, traffic, e2e, layer)


def load_part(folder: str, name: str):
    """The module ``<folder>/<name>.py`` of ``clients`` or ``loops``."""
    if folder not in ("clients", "loops") or not name.isidentifier():
        raise ValueError(f"no {folder} module {name!r}")
    return importlib.import_module(f"portbench.{folder}.{name}")


def load_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + "".join(c if c.isalnum() else "_"
                                      for c in name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Reservoir:
    """A seeded uniform sample of ``k`` of the window's requests: of each
    request it takes, it keeps ``keep(slot, result)``, made only then."""

    def __init__(self, k: int, gen: np.random.Generator, keep):
        self.k, self.gen, self.keep, self.seen, self.kept = k, gen, keep, \
            0, []

    def offer(self, slot: int, result) -> None:
        if len(self.kept) < self.k:
            self.kept.append(self.keep(slot, result))
        else:
            j = int(self.gen.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = self.keep(slot, result)
        self.seen += 1


def sample_rows(h: int, k: int, seed: int) -> np.ndarray:
    """``k`` seeded rows of a stored H, the bottom one among them."""
    gen = generate.rng(seed, generate.ROWS)
    return np.unique(np.append(gen.choice(h, size=min(k, h) - 1,
                                          replace=False), h - 1))


def kept_outputs(rows: np.ndarray):
    """The reservoir's ``keep``: (slot, H at ``rows``, answers) of a
    request, the rows gathered on the device as it is kept."""
    def keep(slot, result):
        if result is None:
            return slot, None, None
        return slot, result.source.rows(rows).clone(), result.results

    return keep


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t0: float | None = None,
             wrap=None) -> dict:
    """Run the cell once; returns the record the result line is made of.

    ``wrap(request)`` may stand something else in the request's place
    (the harness's own tests break the timed path with it)."""
    t0 = time.perf_counter() if t0 is None else t0
    parts = {}
    mark = [t0]

    def lap(name):
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now

    import torch

    from portbench import cardstate, roofline, timeline
    from portbench.reference import plain
    lap("imports_s")

    cfg, traffic = cell.config, cell.traffic
    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()

        def sync():
            torch.cuda.synchronize()
    else:
        def sync():
            pass
    lap("cuda_context_s")
    if on_card:
        from repro_torch.kernels import _build

        for source in _build.build_all():
            _build.library(source)
    lap("libraries_s")

    n = int(traffic["frames_per_request"])
    h, w = int(cfg["height"]), int(cfg["width"])
    nb, vr = generate.num_bins(cfg), generate.value_range(cfg)
    inputs = generate.make_inputs(cfg, traffic, seed, device)
    specs = inputs.queries
    queries = [check.kind(s["kind"]).program(s, inputs.target)
               for s in specs]
    request = load_part("clients", traffic["client"]).make(
        cfg["engine"], queries, None if on_card else device)
    if wrap is not None:
        request = wrap(request)
    loop = load_part("loops", traffic["loop"])
    slots = inputs.pool.shape[0]
    views = [inputs.frames(s, n) for s in range(slots)]
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    lap("frame_pool_s")

    check_cfg = traffic["check"]
    k = int(check_cfg["requests"])
    rows = sample_rows(h, int(check_cfg["h_rows"]), seed)
    keep = kept_outputs(rows)
    warm = max(int(traffic["warmup_requests"]), k + 2)
    lat, failed, res, _, _ = loop.serve(
        request, views, sync, count=warm,
        reservoir=Reservoir(k, generate.rng(seed, generate.SAMPLE), keep))
    res = None
    parts["warmup_first_s"] = lat[0]
    parts["warmup_rest_s"] = lat[1:]
    lap("warmup_s")
    if failed:
        raise RuntimeError(f"{failed} warm-up request(s) failed")
    if trace and on_card:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda")
            sync()
    lap("profiler_s")
    card_before = cardstate.read() if on_card else {"error": "no card"}
    lap("card_state_s")

    start = time.perf_counter()
    setup_s = start - t0
    reservoir = Reservoir(k, generate.rng(seed, generate.SAMPLE), keep)
    stretch = None
    if trace:
        stretch = (start + TRACE_START * seconds,
                   min(TRACE_SECONDS, 0.4 * seconds))
    lat, failed, res, end, prof = loop.serve(
        request, views, sync, first=warm, until=start + seconds,
        reservoir=reservoir, trace=stretch)
    window_s = end - start
    card_after = cardstate.read() if on_card else {"error": "no card"}
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    rows_needed = roofline.needed_rows(specs, h)
    run = Run(cell={"frames": n, "height": h, "width": w, "num_bins": nb,
                    "rows": int(rows_needed.size),
                    "kind": torch.cuda.get_device_name(0) if on_card
                    else None},
              setup_s=setup_s, window_s=window_s,
              frames=n * (len(lat) - failed), latencies=lat)
    if prof is not None:
        run.timeline = timeline.summarize(timeline.raw_events(prof))
        del prof

    # The program's state is freed; its kept outputs are what is judged.
    plan = None if res is None else res.plan.representation
    kept = reservoir.kept
    res = request = None
    if on_card:
        torch.cuda.empty_cache()

    gaps = dict.fromkeys(check.numbers_for(specs), 0.0)
    for slot, got_rows, results in kept:
        ids = plain.bin_ids(inputs.pool[slot].to(device), nb, vr)
        if got_rows is None:
            gaps["count_gap"] = math.inf
        else:
            want = plain.h_rows(ids, nb, rows)
            gaps["count_gap"] = max(gaps["count_gap"], check.gap(
                got_rows if n > 1 else got_rows[None], want))
            del want
        got = check.program_answers(results, specs, n)
        want = check.reference_answers(ids, nb, specs, inputs.target)
        for name, value in check.compare(got, want, specs).items():
            gaps[name] = max(gaps[name], value)
        del ids, got, want
    ok, checks = check.judge(gaps, traffic["limits"], specs)
    return {"run": run, "checks": checks,
            "correct": bool(ok and failed == 0 and kept),
            "attempted": len(lat), "failed": failed,
            "memory_peak_bytes": memory_peak,
            "setup": parts, "card": {"before": card_before,
                                      "after": card_after,
                                      "host": cardstate.host()},
            "window": {"requests": len(lat), "frames": run.frames,
                       "plan": plan,
                       "seconds": window_s,
                       "p50_ms": 1e3 * float(np.median(lat)),
                       "max_ms": 1e3 * max(lat),
                       "memory_peak_bytes": memory_peak}}


def metrics_of(cell: Cell, run: Run, trace: bool) -> dict:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on), each from its reader; a reader that finds nothing to read
    leaves its metric out."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(args, t0: float) -> int:
    import torch

    manifest = load_manifest()
    cell = load_cell(manifest, args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    rec = run_cell(cell, args.seed, args.seconds, bool(args.trace), t0=t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 4
    run = rec["run"]
    print("portbench setup " + json.dumps(rec["setup"]))
    print("portbench card " + json.dumps(rec["card"]))
    print("portbench window " + json.dumps(rec["window"]))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": rec["memory_peak_bytes"]}
    result = {"correct": rec["correct"], "attempted": rec["attempted"],
              "failed": rec["failed"],
              "metrics": metrics_of(cell, run, bool(args.trace)),
              "device": device}
    if args.trace:
        tl = run.timeline
        if tl is None:
            print("portbench: the traced stretch recorded nothing",
                  file=sys.stderr)
            return 5
        device.update(busy_s=tl.busy_s, window_s=tl.window_s)
        result["breakdown"] = {"device_ops": tl.device_ops(),
                               "idle_gaps": tl.idle_gaps}
        print("portbench trace " + json.dumps(
            {"requests": tl.requests, "ops": len(tl.ops)}))
    result["checks"] = rec["checks"]
    sys.stdout.flush()
    for name, c in rec["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0

"""Readings that the limits of ``correct`` are set from, at a cell's own
size: the port's compared numbers over many seeds, and the control's.

    python3 portbench/control.py --workload <name> --program-seeds 1,2,...
        --control-seeds 7,8,9 --seconds 2 --out <file.json>

The port's readings are runs of the harness (``harness.run_cell``, a short
window each) in this one process.  The control is the reference put in
the port's place with its integral histogram held in bfloat16, one
precision below the fp32 the configurations state: it answers the same
sampled requests' queries and gives the same rows, and is held against
the exact reference by the same numbers.  The benchmark's own runs never
run it.  Needs the card.
"""

import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_gaps(cell, seed: int, device: str) -> dict:
    """The control's numbers on the requests a run keeps: its answers and
    H rows against the exact reference's."""
    import torch

    from portbench import check, generate, harness
    from portbench.reference import plain

    cfg, traffic = cell.config, cell.traffic
    nb, vr = generate.num_bins(cfg), generate.value_range(cfg)
    inputs = generate.make_inputs(cfg, traffic, seed, device)
    specs = inputs.queries
    gaps = dict.fromkeys(check.numbers_for(specs), 0.0)
    rows = harness.sample_rows(int(cfg["height"]),
                               int(traffic["check"]["h_rows"]), seed)
    k = int(traffic["check"]["requests"])
    for slot in range(min(k, inputs.pool.shape[0])):
        ids = plain.bin_ids(inputs.pool[slot].to(device), nb, vr)
        got = check.reference_answers(ids, nb, specs, inputs.target,
                                      h_dtype=torch.bfloat16)
        want = check.reference_answers(ids, nb, specs, inputs.target)
        for name, value in check.compare(got, want, specs).items():
            gaps[name] = max(gaps[name], value)
        gaps["count_gap"] = max(gaps["count_gap"], check.gap(
            plain.h_rows(ids, nb, rows, torch.bfloat16),
            plain.h_rows(ids, nb, rows)))
        del ids, got, want
    return gaps


def readings(cell, program_seeds, control_seeds, seconds, device) -> dict:
    import torch

    from portbench import check, generate, harness

    program, control = [], []
    for seed in program_seeds:
        t = time.perf_counter()
        rec = harness.run_cell(cell, seed, seconds, False, device=device)
        program.append({"seed": seed, "correct": rec["correct"],
                        "requests": rec["attempted"],
                        "plan": rec["window"]["plan"],
                        "seconds": time.perf_counter() - t,
                        **{k: v["value"] for k, v in rec["checks"].items()}})
        print(json.dumps(program[-1]), flush=True)
        del rec
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    for seed in control_seeds:
        t = time.perf_counter()
        control.append({"seed": seed, **control_gaps(cell, seed, device),
                        "seconds": time.perf_counter() - t})
        print(json.dumps(control[-1]), flush=True)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    names = check.numbers_for(generate.make_queries(cell.config,
                                                    cell.traffic, 0))
    return {"workload": cell.name, "program": program, "control": control,
            "lower": {k: max(p[k] for p in program) for k in names}
            if program else {},
            "upper": {k: min(c[k] for c in control) for k in names}
            if control else {}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("control.py needs the card", file=sys.stderr)
        return 3
    cell = harness.load_cell(harness.load_manifest(), args.workload)
    seeds = [int(s) for s in args.program_seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    out = readings(cell, seeds, cseeds, args.seconds, "cuda")
    out["device"] = torch.cuda.get_device_name(0)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    print(json.dumps({"workload": args.workload, "lower": out["lower"],
                      "upper": out["upper"]}, default=str))
    return 0 if all(math.isfinite(v) for v in out["lower"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())

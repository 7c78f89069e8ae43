#!/usr/bin/env python3
"""Time K1 (WF-TiS), K2 (fused rows), K5 (SSD scan) and K5-bwd (its
gradients) of any tree of the repo on one GPU.

    python3 scripts/kernel_times.py [--src DIR] [--label NAME] [--json PATH]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so that another tree, such as a parent commit unpacked with ``git
archive``, is timed at the shapes ``chip_smoke.py`` times its own at:
K1 at ``chip_smoke.K1_SHAPES``, K2 at ``chip_smoke.K2_SHAPES``, K5 and
K5-bwd at ``chip_smoke.K5_SHAPE`` (K5-bwd as a training step calls it:
h0 = None, no gradient of h_last), with chip_smoke's inputs, timer
(``time_ms``), byte bounds and profiler count (``device_kernels``: K2's
and K5-bwd's CUDA launches and device µs a call).  Only the wrappers
``wf_tis_cuda``, ``fused_rows_cuda``, ``ssd_scan_cuda`` and
``ssd_scan_bwd_cuda`` and their plain versions are called, which every
tree of the port since K5-bwd has.  Run parent, change, change, parent on
one machine to compare two trees.  Each result is held against its plain
version (K1 and K2 bit for bit, K5 within chip_smoke's K5_ATOL /
K5_RTOL, K5-bwd's gradients within K5BWD_RTOL of their largest
magnitude).  Prints one JSON line as its last, and writes it to
``--json`` when given.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (stdlib-only at import)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--json", help="also write the JSON line to this file")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    torch.backends.cuda.matmul.allow_tf32 = False
    wf = importlib.import_module("repro_torch.kernels.wf_tis")
    fr = importlib.import_module("repro_torch.kernels.fused_rows")
    ssd = importlib.import_module("repro_torch.kernels.ssd_scan")
    dev = torch.device("cuda")
    result = {"label": args.label, "src": args.src,
              "card": smoke.card_line(), "k1": {}}
    for label, ((n, h, w, bins, with_carry), _) in smoke.K1_SHAPES.items():
        ids, carry = smoke.k1_inputs(torch, dev, n, h, w, bins, with_carry)
        if not torch.equal(wf.wf_tis_cuda(ids, bins, carry=carry),
                           wf.wf_tis_plain(ids, bins, carry)):
            print(f"kernel_times: K1 != plain at {label}", file=sys.stderr)
            return 1
        ms = smoke.time_ms(lambda: wf.wf_tis_cuda(ids, bins, carry=carry))
        bound = smoke.k1_bytes(ids, bins, carry) / smoke.HBM_BYTES_PER_S * 1e3
        result["k1"][label] = {"ms": ms, "bound_ms": bound}
        print(f"K1 {label} {n}x{h}x{w}x{bins}"
              f"{' + carry' if with_carry else ''}: {ms:.4f} ms | bound "
              f"{bound:.4f} ms ({bound / ms:.1%})", flush=True)
        del ids, carry
        torch.cuda.empty_cache()

    result["k2"] = {}
    for label, ((n, h, w, bins, rows), _) in smoke.K2_SHAPES.items():
        ids, _ = smoke.k1_inputs(torch, dev, n, h, w, bins, False)

        def call():
            return fr.fused_rows_cuda(ids, bins, rows)

        if not torch.equal(call(), fr.fused_rows_plain(ids, bins, rows)):
            print(f"kernel_times: K2 != plain at {label}", file=sys.stderr)
            return 1
        ms = smoke.time_ms(call)
        per_call, kernel_us = smoke.device_kernels(torch, call)
        bound = smoke.k2_bytes(ids, bins, rows, None) / smoke.HBM_BYTES_PER_S \
            * 1e3
        result["k2"][label] = {
            "ms": ms, "bound_ms": bound, "cuda_launches_per_call": per_call,
            "device_us": kernel_us}
        print(f"K2 {label} {n}x{h}x{w}x{bins}, {len(rows)} rows: {ms:.4f} ms "
              f"| bound {bound:.4f} ms ({bound / ms:.1%}) | profiled: "
              f"{per_call} CUDA launch(es) a call, device µs a call "
              + ", ".join(f"{k[:48]} {v:.2f}" for k, v in kernel_us.items()),
              flush=True)
        del ids
        torch.cuda.empty_cache()

    x, dt, A, Bm, Cm, _ = smoke.ssd_inputs(torch, dev, 9)
    chunk = smoke.K5_SHAPE[-1]
    got = ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk)
    want = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
    ok = all(torch.allclose(g, w_, atol=smoke.K5_ATOL, rtol=smoke.K5_RTOL)
             for g, w_ in zip(got, want))
    ms = smoke.time_ms(lambda: ssd.ssd_scan_cuda(x, dt, A, Bm, Cm,
                                                 chunk=chunk))
    result["k5"] = {"ms": ms, "max_abs_err": err, "within_gate": ok}
    print(f"K5 {'x'.join(map(str, smoke.K5_SHAPE[:4]))}, N="
          f"{smoke.K5_SHAPE[4]}: {ms:.4f} ms | max abs err {err:.3e} | "
          f"within atol {smoke.K5_ATOL} + rtol {smoke.K5_RTOL}: {ok} | card "
          f"{result['card']}", flush=True)

    gy = torch.as_tensor(np.random.default_rng(12).standard_normal(
        tuple(x.shape)), dtype=torch.float32, device=dev)
    _, _, states = ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk,
                                     return_states=True)

    def bwd():
        return ssd.ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, gy, states=states,
                                     chunk=chunk)

    want = ssd.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, gy,
                                  chunk=ssd.KERNEL_CHUNK)
    rel = max(float((g - w_).abs().max()) / float(w_.abs().max())
              for g, w_ in zip(bwd()[:5], want[:5]))
    ok_bwd = rel <= smoke.K5BWD_RTOL
    ms = smoke.time_ms(bwd)
    per_call, kernel_us = smoke.device_kernels(torch, bwd)
    result["k5_bwd"] = {"ms": ms, "max_rel_err": rel, "within_gate": ok_bwd,
                        "cuda_launches_per_call": per_call,
                        "device_us": kernel_us}
    print(f"K5-bwd {'x'.join(map(str, smoke.K5_SHAPE[:4]))}, N="
          f"{smoke.K5_SHAPE[4]}: {ms:.4f} ms | largest error over largest "
          f"magnitude {rel:.3e}, within {smoke.K5BWD_RTOL}: {ok_bwd} | "
          f"profiled: {per_call} CUDA launch(es) a call, device µs a call "
          + ", ".join(f"{k[:48]} {v:.2f}" for k, v in kernel_us.items()),
          flush=True)
    line = json.dumps(result)
    if args.json:
        pathlib.Path(args.json).write_text(line + "\n")
    print(line)
    return 0 if ok and ok_bwd else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""K2 variants on one GPU, at chip_smoke.py's K2_SHAPES.

    python3 scripts/k2_variants.py [--json PATH]

Times the port's two-pass K2 (``kernels/fused_rows.py::launch``) against:
copies of ``csrc/fused_rows.cu`` with one constant changed (``VARIANTS``:
pass-A CTAs an SM must hold, which caps its registers), built here with
the port's nvcc flags, each at bin blocks 8 and 4; and a one-pass variant
whose chunk sums are chained by decoupled look-back
(``scripts/k2_one_pass.cu``).  The port's kernel is timed first
and last.  Every variant is held against ``fused_rows_plain`` bit for
bit.  Times by chip_smoke's ``time_ms`` (CUDA events), device µs a call by
its ``device_kernels`` (torch.profiler).  The one-pass variant gets its
chunk plan on the card once, before it is timed; the others copy theirs
with every call, as the port does.  Prints one JSON line as its last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402  (stdlib-only at import)

# name -> (constant in csrc/fused_rows.cu, its value in the variant)
VARIANTS = {
    "regs128": ("kMinCtas", 1),
}
BIN_BLOCKS = (8, 4)


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Compile each name -> CUDA source text, all at once, into the
    port's (git-ignored) build directory; print each pass-A kernel's
    registers and spills from ptxas."""
    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = _build.BUILD_DIR / f"k2_{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(src.with_suffix(".so")), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        kernels = re.findall(
            r"Compiling entry function '\S*?((?:chunk|sum|one_pass)_kernel)"
            r"IL[ib](\d+)E\S*'.*?(\d+) bytes spill stores.*?"
            r"Used (\d+) registers", log, re.S)
        print(f"{name}: " + ", ".join(
            f"{k[0]}<{k[1]}> {k[3]} registers"
            f"{f', {k[2]} bytes spilled' if k[2] != '0' else ''}"
            for k in kernels), flush=True)
        libs[name] = ctypes.CDLL(str(_build.BUILD_DIR / f"k2_{name}.so"))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="also write the JSON line to this file")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_rows as fr

    base = (_build.CSRC / "fused_rows.cu").read_text()
    sources = {"port": base,
               "one_pass": (ROOT / "scripts" / "k2_one_pass.cu").read_text()}
    for name, (const, value) in VARIANTS.items():
        old = next(line for line in base.splitlines()
                   if line.startswith(f"constexpr int {const} ="))
        sources[name] = base.replace(
            old, f"constexpr int {const} = {value};")
    libs = build(sources)
    libs.pop("port")                 # built for its ptxas report only
    one_pass_fn = libs.pop("one_pass").k2_one_pass_launch
    one_pass_fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    one_pass_fn.restype = ctypes.c_int
    port_loader = fr._lib
    port_lib = port_loader()
    variant_fns = {}
    for name, lib in libs.items():
        fn = lib.fused_rows_launch
        fn.argtypes, fn.restype = port_lib.argtypes, port_lib.restype
        variant_fns[name] = fn

    dev = torch.device("cuda")
    result = {"card": smoke.card_line(), "shapes": {}}
    for label, ((n, h, w, bins, rows), _) in smoke.K2_SHAPES.items():
        ids, _ = smoke.k1_inputs(torch, dev, n, h, w, bins, False)
        rows = np.asarray(rows, np.int64)
        want = fr.fused_rows_plain(ids, bins, rows)
        shape = fr.chunk_shape(w, bins, n, rows.size, int(rows[-1]) + 1)
        first, slot = fr.chunk_plan(rows, shape.chunk_rows)
        chunks = first.size
        plan = torch.as_tensor(np.concatenate((first, slot)), device=dev)
        blocks = -(-bins // shape.bin_block)

        def one_pass():
            out = torch.empty((n, bins, rows.size, w), device=dev)
            agg = torch.empty((n, bins, chunks, w), device=dev)
            incl = out if chunks == rows.size else torch.empty_like(agg)
            flags = torch.empty(n * blocks * chunks + 1, dtype=torch.int32,
                                device=dev)
            err = one_pass_fn(ids.data_ptr(), plan.data_ptr(), None,
                              agg.data_ptr(), incl.data_ptr(), out.data_ptr(),
                              flags.data_ptr(), n, h, int(rows[-1]) + 1, w,
                              bins, chunks, rows.size, shape.bin_block,
                              shape.threads,
                              torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"k2_one_pass: CUDA error {err}")
            return out

        def two_pass(lib_fn=port_lib, bin_block=shape.bin_block):
            fr._lib = lambda: lib_fn
            try:
                return fr.launch(ids, bins, rows,
                                 shape._replace(bin_block=bin_block))
            finally:
                fr._lib = port_loader

        candidates = {"port": two_pass, "one_pass": one_pass}
        for name, fn in {"port": port_lib, **variant_fns}.items():
            for bb in BIN_BLOCKS:
                candidates[f"{name} bb{bb}"] = (
                    lambda fn=fn, bb=bb: two_pass(lib_fn=fn, bin_block=bb))
        candidates["port again"] = two_pass
        rec = {"chunks": chunks, "bound_ms": smoke.k2_bytes(
            ids, bins, rows, None) / smoke.HBM_BYTES_PER_S * 1e3}
        for name, fn in candidates.items():
            if not torch.equal(fn(), want):
                print(f"k2_variants: {name} != plain at {label}",
                      file=sys.stderr)
                return 1
            _, us = smoke.device_kernels(torch, fn)
            rec[name] = {"ms": smoke.time_ms(fn), "device_us": us}
        result["shapes"][label] = rec
        print(f"{label} {n}x{h}x{w}x{bins}, {rows.size} rows, {chunks} chunks"
              f" | bound {rec['bound_ms']:.4f} ms | " + "; ".join(
                  f"{name} {rec[name]['ms']:.4f} ms (" + ", ".join(
                      f"{k[:34]} {v:.2f}"
                      for k, v in rec[name]["device_us"].items()) + ")"
                  for name in candidates), flush=True)
        del ids, want
        torch.cuda.empty_cache()
    print(f"card {result['card']}")
    line = json.dumps(result)
    if args.json:
        pathlib.Path(args.json).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

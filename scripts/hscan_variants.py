#!/usr/bin/env python3
"""K4's hscan variants on one GPU, at the clip and chip_smoke's WIDE_SHAPE.

    python3 scripts/hscan_variants.py [--json PATH]

Times the port's hscan (``csrc/cw_tis.cu``, called through its C entry
point so that the warps a CTA can be set) at bin blocks 1, 2, 4 and 8
and at 4, 8 and 16 warps a CTA, against:

  * ``late_load``: a copy of the source whose next chunk of ids is loaded
    after this chunk's stores, not before (no register double buffer);
  * ``stream_stores``: a copy whose ``hh`` stores are ``__stcs``
    (evict-first) instead of plain stores;
  * ``tma``: ``scripts/hscan_tma.cu``, the ids fed through a shared ring
    of 2 or 4 stages a warp by ``cp.async.bulk`` and an ``mbarrier``;
  * ``contig``: ``scripts/hscan_contig.cu``, the port's walk with 16
    contiguous columns a lane (512-column chunks), the layout of the
    earlier hscan and of K1 at 16 columns a thread, at bin blocks 8 and 2.

Every variant is built here with the port's nvcc flags, all compilers at
once, and each hscan instantiation's registers and spills are printed
from ptxas.  Every result is held against ``cw_tis_hscan_plain`` bit for
bit before it is timed.  Times by chip_smoke's ``time_ms`` (CUDA events,
median of 11 runs of 10 calls); the port at its defaults is timed first
and last.  Prints one JSON line as its last, and writes it to ``--json``
when given.
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

#: name -> (text in csrc/cw_tis.cu, its replacement in the variant)
EDITS = {
    "late_load": [
        ("    const int4 next = load_ids<VEC>(row, c + kChunk, w);\n", ""),
        ("    ids = next;\n",
         "    ids = load_ids<VEC>(row, c + kChunk, w);\n"),
    ],
    "stream_stores": [
        ("*reinterpret_cast<float4*>(orow + c) = o;",
         "__stcs(reinterpret_cast<float4*>(orow + c), o);"),
    ],
}
#: the C entry point of each variant built from a source of its own
ENTRY = {"tma": "hscan_tma_launch", "contig": "hscan_contig_launch"}
SHAPES = {"small": (1, 3, 384, 8), "clip": (16, 480, 640, 32),
          "wide": smoke.WIDE_SHAPE}


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Compile each name -> CUDA source text at once into the port's
    (git-ignored) build directory; print each hscan instantiation's
    registers and spills."""
    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = _build.BUILD_DIR / f"hscan_{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(src.with_suffix(".so")), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"hscan_variants: nvcc failed on {name}:\n{log}",
                  file=sys.stderr, flush=True)
            continue
        kernels = re.findall(
            r"Compiling entry function '\S*?\d(hscan(?:_tma|_contig)?_kernel)"
            r"IL[ib](\d+)E"
            r"(?:L[ib](\d+)E)?\S*'.*?(\d+) bytes spill stores.*?"
            r"Used (\d+) registers", log, re.S)
        print(f"{name}: " + ", ".join(
            f"{k[0]}<{', '.join(a for a in k[1:3] if a)}> {k[4]} registers"
            f"{f', {k[3]} bytes spilled' if k[3] != '0' else ''}"
            for k in kernels), flush=True)
        libs[name] = ctypes.CDLL(str(_build.BUILD_DIR / f"hscan_{name}.so"))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="also write the JSON line to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("hscan_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, cw_tis

    base = (_build.CSRC / "cw_tis.cu").read_text()
    sources = {"port": base,
               "tma": (ROOT / "scripts" / "hscan_tma.cu").read_text(),
               "contig": (ROOT / "scripts" / "hscan_contig.cu").read_text()}
    for name, edits in EDITS.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in cw_tis.cu")
            text = text.replace(old, new)
        sources[name] = text
    libs = build(sources)
    fns = {}
    for name, lib in libs.items():
        fn = getattr(lib, ENTRY.get(name, "cw_tis_hscan_launch"))
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * (
            7 if name == "tma" else 6) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    dev = torch.device("cuda")
    result = {"card": smoke.card_line(), "shapes": {}, "failed": []}
    for label, (n, h, w, bins) in SHAPES.items():
        ids, _ = smoke.k1_inputs(torch, dev, n, h, w, bins, False, seed=27)
        want = cw_tis.cw_tis_hscan_plain(ids, bins)
        out = torch.empty_like(want)
        bb0, warps0 = cw_tis.hscan_shape(bins)

        def call(name, bb=bb0, warps=warps0, *extra):
            def run():
                err = fns[name](ids.data_ptr(), out.data_ptr(), n, h, w,
                                bins, bb, warps, *extra,
                                torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
                return out
            return run

        candidates = {"port": call("port")}
        for bb in (1, 2, 4, 8):
            candidates[f"port bb{bb}"] = call("port", bb)
        for warps in (4, 16):
            candidates[f"port {warps} warps"] = call("port", bb0, warps)
        for name in EDITS:
            if name in fns:
                candidates[name] = call(name)
        if "tma" in fns:
            for stages in (2, 4):
                for warps in (4, 8):
                    candidates[f"tma {stages} stages {warps} warps"] = call(
                        "tma", bb0, warps, stages)
        if "contig" in fns:
            for bb in (8, 2):
                candidates[f"contig bb{bb}"] = call("contig", bb)
        candidates["port again"] = call("port")
        wk = cw_tis.cw_tis_hscan_work(n, h, w, bins)
        rec = {"shape": f"{n}x{h}x{w}x{bins}",
               "bound_ms": wk["bytes"] / smoke.HBM_BYTES_PER_S * 1e3}
        for name, fn in candidates.items():
            out.fill_(-1.0)
            try:
                fn()
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"{label} {name}: {e}", flush=True)
                result["failed"].append(f"{label} {name}: {e}")
                continue
            if not torch.equal(out, want):
                bad = (out != want).nonzero()
                first = tuple(int(v) for v in bad[0])
                msg = (f"{label} {name}: != plain at {bad.shape[0]} of "
                       f"{out.numel()} elements, first (f, b, r, c) {first}: "
                       f"{float(out[first])} for {float(want[first])}")
                print(msg, flush=True)
                result["failed"].append(msg)
                continue
            rec[name] = smoke.time_ms(fn)
        result["shapes"][label] = rec
        print(f"{label} {rec['shape']} | bound {rec['bound_ms']:.4f} ms | "
              + "; ".join(f"{k} {v:.4f} ({rec['bound_ms'] / v:.1%})"
                          for k, v in rec.items()
                          if k not in ("shape", "bound_ms")), flush=True)
        del ids, want, out
        torch.cuda.empty_cache()
    print(f"card {result['card']}")
    line = json.dumps(result)
    if args.json:
        pathlib.Path(args.json).write_text(line + "\n")
    print(line)
    return 1 if result["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the cell is looked up in
``BENCHMARK.json`` there and the port is imported from ``src/``.  With
``--trace 0`` the last line of standard output carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics (see
``harness.py``).  Exit codes: 0 with a result; 1 on an error; 3 without
the CUDA devices the cell needs; 4 when JAX or the JAX package got loaded;
5 when a traced run recorded nothing.  No result is printed unless 0.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Build and kernel caches of the program, and the bytecode of every module
# it imports, stay in the checkout at fixed paths, so only a checkout's
# first run builds and compiles.
CACHE = ROOT / "build" / "portbench_cache"
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}
# One process with few threads: the host work of a request is one
# thread's, and idle CPU thread pools only add noise between runs.
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(CACHE / sub)
    os.environ.update(THREADS)
    sys.pycache_prefix = str(CACHE / "pycache")
    sys.dont_write_bytecode = False
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness

    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())

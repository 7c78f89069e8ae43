"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``kernels/csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, all the compilers started
together.  The libraries go to ``kernels/build/`` (ignored by git) under a
name that carries a hash of every source and flag, so a fresh checkout
builds them on its first kernel call and an edited source never loads a
stale library.  ``ptxas -v`` (registers, shared memory, spills) is kept
beside each library as ``<name>.log``, and each compiler's wall seconds
in ``build_seconds``.

There is no fallback: without ``nvcc``, or when a build fails, this raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}    # source -> wall seconds of its nvcc


def _nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME (the toolkit's default prefix
    when unset)."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc")
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        f"nvcc not found on PATH or at {candidate}: the CUDA kernels of "
        "repro_torch are built at first use and need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_paths() -> dict[str, Path]:
    """Source name -> its library path for the current sources."""
    digest = _digest()
    return {
        src.name: BUILD_DIR / f"{src.stem}_{digest}.so"
        for src in sorted(CSRC.glob("*.cu"))
    }


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, in parallel.

    Returns the source -> library map.  Raises ``RuntimeError`` with the
    compiler's output when any build fails."""
    targets = library_paths()
    missing = {s: p for s, p in targets.items() if not p.exists()}
    if not missing:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()

    def compile_one(src: str, out: Path):
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        seconds = time.perf_counter() - t0
        out.with_suffix(".log").write_text(
            f"{proc.stdout}nvcc took {seconds:.1f} s\n")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            return seconds, f"--- {src} (exit {proc.returncode}) ---\n" \
                f"{proc.stdout}"
        os.replace(tmp, out)          # atomic: a reader never sees half a file
        return seconds, None

    with ThreadPoolExecutor(len(missing)) as pool:   # all compilers at once
        done = {src: pool.submit(compile_one, src, out)
                for src, out in missing.items()}
    failed = []
    for src, job in done.items():
        build_seconds[src], error = job.result()
        if error:
            failed.append(error)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def library(source: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<source>``, built if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[source]))
            _libs[source] = lib
        return lib

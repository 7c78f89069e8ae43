"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port.  Top-level module names are
compared whole, so ``repro_torch`` is not ``repro``."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from portbench import smallcells

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

_LOADED = """
import importlib, json, sys
for name in {modules!r}:
    importlib.import_module(name)
for path in {metrics!r}:
    from portbench import harness
    harness.load_reader(path)
for cell in {cells!r}:
    from portbench import harness, smallcells
    c = smallcells.small_cell(cell)
    rec = harness.run_cell(c, 3, 0.05, False, device="cpu")
    harness.metrics_of(c, rec["run"], False)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _modules():
    out = []
    for path in sorted(BENCH.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        if path.name.startswith("test_") or "metrics" in rel.parts:
            continue
        out.append(".".join(p for p in rel.parts if p != "__init__"))
    return out


def _top_level(modules, metrics=(), cells=()):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    env.pop("JAX_PLATFORMS", None)
    code = _LOADED.format(modules=list(modules), metrics=list(metrics),
                          cells=list(cells))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _static_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_the_benchmark_loads_is_jax_or_the_jax_package():
    metrics = [p.stem for p in (BENCH / "metrics").glob("*.py")
               if p.stem != "__init__"]
    cells = list(smallcells.SMALL)
    loaded = _top_level(_modules() + ["portbench.run"], metrics, cells)
    assert "repro_torch" in loaded        # the port itself ran
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_no_benchmark_source_names_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _static_imports(path) & FORBIDDEN, path


def test_the_reference_loads_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not _static_imports(path) & (FORBIDDEN | {"repro_torch",
                                                         "portbench"}), path
    loaded = _top_level(["portbench.reference.plain"])
    assert not loaded & (FORBIDDEN | {"repro_torch"})

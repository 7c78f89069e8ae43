"""The port's lint layer (repro_torch.analysis.lint/rules/__main__) held
against the reference's engine.

Each rule fixture of tests/test_analysis.py goes through both engines: the
reference on its own paths, the port on the same paths under
``src/repro_torch``; they must give the same (rule, line, suppressed)
findings.  The host-sync fixtures are rewritten with torch's syncs for the
port.  Then the port's own surface: pragmas, the baseline ratchet, the CLI
and its exit codes, the clean tree, and lint without torch imported.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import lint_source as ref_lint_source
from repro_torch.analysis import (
    RULES,
    gate,
    lint_paths,
    lint_source,
    load_baseline,
    stale_fingerprints,
    write_baseline,
)
from repro_torch.analysis.__main__ import main as analysis_main

ROOT = Path(__file__).resolve().parent.parent


def _found(engine, src: str, relpath: str):
    return [(f.rule, f.line, f.suppressed)
            for f in engine(textwrap.dedent(src), relpath)]


# ---------------------------------------------------------------------------
# rule parity: the reference's fixtures through both engines
# ---------------------------------------------------------------------------
LOCKED_CLASS = """\
import threading
class Svc:
    _LOCK_PROTECTED = ("_cache", "stats")
    _LOCK_PROTECTED_MUTATORS = ("observe",)
    def __init__(self):
        self._lock = threading.Lock()
        self._cache = {}     # __init__ is exempt
        self.stats = None
"""

#: (id, path under src/<pkg>/, source, expected rules) — one fixture each.
FIXTURES = [
    ("carry-one-arg", "core/x.py", """\
        from repro.core.runtime import FrameRuntime
        rt = FrameRuntime(lambda chunk: chunk)
    """, ["carry-contract"]),
    ("carry-no-pair", "core/x.py", """\
        from repro.core.runtime import FrameRuntime
        def step(chunk, carry):
            return chunk
        rt = FrameRuntime(step)
    """, ["carry-contract"]),
    ("carry-clean", "core/x.py", """\
        from repro.core.runtime import FrameRuntime
        def step(chunk, carry):
            return chunk * 2, carry
        rt = FrameRuntime(step)
        rt2 = FrameRuntime(lambda chunk, carry: (chunk, carry))
        rt3 = FrameRuntime(FrameRuntime.stateless(abs))
        rt4 = runtime_for(plan, step)
    """, []),
    ("carry-suppressed", "core/x.py", """\
        from repro.core.runtime import FrameRuntime
        # analysis: allow-carry-contract(adapter normalizes the signature downstream)
        rt = FrameRuntime(lambda chunk: chunk)
    """, ["carry-contract"]),
    ("shim-import", "core/x.py", """\
        from repro.core.region_query import banded_region_histogram
    """, ["no-shim-use"]),
    ("shim-attr", "core/x.py", """\
        from repro.core import region_query
        f = region_query.banded_likelihood_map
    """, ["no-shim-use"]),
    ("shim-defining-module", "core/region_query.py", """\
        def banded_region_histogram(bands, rects):
            return banded_region_histogram
    """, []),
    ("shim-suppressed", "core/x.py", """\
        from repro.core import region_query
        # analysis: allow-shim-use(public deprecated alias kept until 2.0)
        f = region_query.banded_region_histogram
    """, ["no-shim-use"]),
    ("overflow-no-bound", "core/bands.py", """\
        import numpy as np
        STORAGE_POLICIES = {"uint16": np.uint16}
    """, ["overflow-policy"]),
    ("overflow-dynamic-bound", "core/bands.py", """\
        import numpy as np
        def limit(): return 65535
        STORAGE_POLICIES = {"uint16": (np.uint16, limit())}
    """, ["overflow-policy"]),
    ("overflow-no-method", "core/bands.py", """\
        from repro.core.hsource import HSource
        class SpilledIH(HSource):
            storage: str
    """, ["overflow-policy"]),
    ("overflow-clean", "core/bands.py", """\
        import numpy as np
        BITS = 16
        STORAGE_POLICIES = {"uint16": (np.uint16, (1 << BITS) - 1)}
        from repro.core.hsource import HSource
        class SpilledIH(HSource):
            storage: str
            def exact_region_bound(self):
                return STORAGE_POLICIES[self.storage][1]
    """, []),
    ("lock-write", "serve/service.py", LOCKED_CLASS + """\
    def hit(self, k):
        self._cache[k] = 1
""", ["lock-discipline"]),
    ("lock-mutator", "serve/service.py", LOCKED_CLASS + """\
    def note(self, dt):
        self.stats.observe(dt)
""", ["lock-discipline"]),
    ("lock-clean-and-suppressed", "serve/service.py", LOCKED_CLASS + """\
    def hit(self, k):
        with self._lock:
            self._cache[k] = 1
            self.stats.observe(0.0)
        return self._cache.get(k)   # reads need no lock
    def setup(self, k):
        # analysis: allow-lock-discipline(single-threaded setup path)
        self._cache[k] = 1
""", ["lock-discipline"]),
    ("lock-order-cycle", "serve/service.py", """\
        import threading
        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self._cache_lock = threading.Lock()
            def a(self):
                with self._lock:
                    with self._cache_lock:
                        pass
            def b(self):
                with self._cache_lock:
                    with self._lock:
                        pass
    """, ["lock-order"]),
    ("lock-order-reacquire-via-call", "serve/service.py", """\
        import threading
        class S:
            def __init__(self):
                self._lock = threading.Lock()
            def close(self):
                with self._lock:
                    self.flush()
            def flush(self):
                with self._lock:
                    pass
    """, ["lock-order"]),
    ("lock-order-blocking", "serve/service.py", """\
        import threading
        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self._worker = threading.Thread()
                self._queue = None
            def close(self, fut):
                with self._lock:
                    self._worker.join()
                    fut.set_result(None)
                    self.take()
            def take(self):
                return self._queue.get(timeout=1)
    """, ["lock-order", "lock-order", "lock-order"]),
    ("lock-order-clean-and-suppressed", "serve/service.py", """\
        import threading
        class S:
            def __init__(self):
                self._lock = threading.RLock()
                self._queue = None
                self._worker = threading.Thread()
            def submit(self, p):
                self._queue.put(p, block=True)
                with self._lock:
                    self.flush()
            def flush(self):
                with self._lock:
                    # analysis: allow-lock-order(worker never takes this lock)
                    self._worker.join()
    """, ["lock-order", "lock-order"]),
    ("bad-pragmas", "core/x.py", """\
        x = 1  # analysis: allow-no-such-rule(whatever)
        # analysis: allow-shim-use()
        from repro.core.region_query import banded_region_histogram
    """, ["pragma", "pragma", "no-shim-use"]),
]


@pytest.mark.parametrize("case", FIXTURES, ids=[c[0] for c in FIXTURES])
def test_rule_findings_match_the_reference(case):
    _, path, src, rules = case
    want = _found(ref_lint_source, src, f"src/repro/{path}")
    got = _found(lint_source, src, f"src/repro_torch/{path}")
    assert got == want
    assert sorted(r for r, _, _ in got) == sorted(rules)


# host-sync: the same lines with jax's syncs for the reference and torch's
# for the port.
HOST_SYNC = [
    ("retire", """\
        import jax, numpy as np
        def retire(out):
            out = jax.block_until_ready(out)
            n = out.sum().item()
            return np.asarray(out), n
    """, """\
        import torch, numpy as np
        def retire(out):
            torch.cuda.synchronize()
            n = out.sum().item()
            return np.asarray(out), n
    """),
    ("readbacks", """\
        import jax
        def read(out):
            a = jax.device_get(out)
            b = out.block_until_ready()
            c = jax.device_get(b)
            return a, b, c
    """, """\
        import torch
        def read(out):
            a = out.cpu()
            b = out.numpy()
            c = out.tolist()
            return a, b, c
    """),
    ("suppressed", """\
        import jax
        def retire(out):
            # analysis: allow-host-sync(retire-time sync is the contract)
            return jax.block_until_ready(out)
    """, """\
        import torch
        def retire(ev):
            # analysis: allow-host-sync(retire-time sync is the contract)
            return ev.synchronize()
    """),
    ("clean", """\
        import jax
        def dispatch(fn, chunk):
            return fn(chunk)
    """, """\
        import torch
        def dispatch(fn, chunk):
            return fn(chunk)
    """),
]


@pytest.mark.parametrize("scope", ["core/runtime.py", "kernels/ops.py",
                                   "core/hsource.py"])
@pytest.mark.parametrize("case", HOST_SYNC, ids=[c[0] for c in HOST_SYNC])
def test_host_sync_matches_the_reference_with_torch_syncs(case, scope):
    _, ref_src, port_src = case
    want = [(r, line, s) for r, line, s in
            _found(ref_lint_source, ref_src, f"src/repro/{scope}")
            if r == "host-sync"]
    got = [(r, line, s) for r, line, s in
           _found(lint_source, port_src, f"src/repro_torch/{scope}")
           if r == "host-sync"]
    assert got == want
    if scope == "core/hsource.py":          # out of the rule's scope
        assert got == []


def test_rule_set_is_the_reference_less_sharded_concat():
    from repro.analysis import RULES as REF_RULES

    assert set(RULES) == set(REF_RULES) - {"sharded-concat"}
    for name, rule in RULES.items():
        assert rule.pragma == REF_RULES[name].pragma


# ---------------------------------------------------------------------------
# baseline, CLI
# ---------------------------------------------------------------------------
BAD = """\
import numpy as np
STORAGE_POLICIES = {"uint16": np.uint16}
"""


def _seed_repo(tmp_path) -> Path:
    pkg = tmp_path / "src" / "repro_torch" / "core"
    pkg.mkdir(parents=True)
    (pkg / "bands.py").write_text(BAD)
    return pkg / "bands.py"


def test_baseline_roundtrip_and_gate(tmp_path):
    findings = lint_source(BAD, "src/repro_torch/core/bands.py")
    assert len(findings) == 1
    path = tmp_path / "baseline.json"
    assert write_baseline(findings, path) == 1
    baseline = load_baseline(path)
    assert gate(findings, baseline) == []
    assert gate(findings, set()) == findings
    moved = lint_source("\n\n" + BAD, "src/repro_torch/core/bands.py")
    assert gate(moved, baseline) == []


def test_write_baseline_is_a_ratchet(tmp_path):
    old = lint_source(BAD, "src/repro_torch/core/bands.py")
    path = tmp_path / "baseline.json"
    assert write_baseline(old, path) == 1
    new = lint_source(BAD, "src/repro_torch/core/other.py")
    assert write_baseline(new, path) == 0       # old ∩ current = {}
    assert load_baseline(path) == set()
    assert gate(new, load_baseline(path)) == new
    live = {f.fingerprint for f in new}
    assert stale_fingerprints(new, live | {"x:y:z"}) == {"x:y:z"}


def test_cli_check_exit_codes_and_stale_baseline(tmp_path, capsys):
    bad_file = _seed_repo(tmp_path)
    root = str(tmp_path)
    assert analysis_main(["--check", "--root", root]) == 1
    assert analysis_main(["--write-baseline", "--root", root]) == 0
    assert (tmp_path / "analysis-baseline-torch.json").exists()
    assert analysis_main(["--check", "--root", root]) == 0
    bad_file.write_text("X = 1\n")              # the debt is fixed
    report = tmp_path / "report.json"
    assert analysis_main(["--check", "--root", root,
                          "--json", str(report)]) == 1
    assert "stale baseline entry" in capsys.readouterr().out
    assert json.loads(report.read_text())["counts"]["stale_baseline"] == 1
    assert analysis_main(["--write-baseline", "--root", root]) == 0
    assert analysis_main(["--check", "--root", root]) == 0
    capsys.readouterr()


def test_cli_usage_errors_exit_2(tmp_path, capsys):
    assert analysis_main(["--check", "--write-baseline"]) == 2
    assert analysis_main(["--list-rules", "--check"]) == 2
    assert analysis_main(["--check-kernels", "--check"]) == 2
    assert analysis_main(["--check-kernels", "src/repro_torch"]) == 2
    assert analysis_main(["--check", "--root", str(tmp_path)]) == 2
    assert analysis_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in RULES)


def test_cli_json_and_pragma_end_to_end(tmp_path, capsys):
    pkg = tmp_path / "src" / "repro_torch" / "core"
    pkg.mkdir(parents=True)
    (pkg / "runtime.py").write_text(textwrap.dedent("""\
        def retire(ev, out):
            # analysis: allow-host-sync(the window contract)
            ev.synchronize()
            return out.item()
    """))
    report = tmp_path / "report.json"
    assert analysis_main(["--root", str(tmp_path), "--json",
                          str(report)]) == 0
    data = json.loads(report.read_text())
    assert set(data["rules"]) == set(RULES)
    assert [(f["line"], f["suppressed"]) for f in data["findings"]] \
        == [(3, True), (4, False)]
    assert data["findings"][0]["suppression_reason"] == "the window contract"
    assert data["counts"] == {"total": 2, "suppressed": 1, "gating": 1,
                              "stale_baseline": 0}
    assert analysis_main(["--check", "--root", str(tmp_path)]) == 1
    capsys.readouterr()


def test_tree_is_clean_with_an_empty_baseline():
    """The port's tree lints clean, and its baseline lists nothing."""
    findings = lint_paths(["src/repro_torch"], root=ROOT)
    baseline = load_baseline(ROOT / "analysis-baseline-torch.json")
    assert baseline == set()
    gating = gate(findings, baseline)
    assert gating == [], "\n".join(f.render() for f in gating)
    # every suppression says why
    assert all(f.suppression_reason for f in findings if f.suppressed)


def test_lint_runs_without_torch_imported():
    code = (
        "import sys; import repro_torch.analysis; "
        "from repro_torch.analysis.__main__ import main; "
        "rc = main(['--check']); "
        "assert 'torch' not in sys.modules, 'lint layer imported torch'; "
        "sys.exit(rc)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=str(ROOT), env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"},
        timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

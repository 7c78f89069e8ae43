"""``python -m repro_torch.analysis`` — run the port's lint rules.

Port of ``repro/analysis/__main__.py``.  Exit codes: 0 clean (or
informational modes), 1 gating findings, 2 usage error.

Typical invocations (from the repo root):

    PYTHONPATH=src python -m repro_torch.analysis --check
    PYTHONPATH=src python -m repro_torch.analysis --check --json report.json
    PYTHONPATH=src python -m repro_torch.analysis --write-baseline
    PYTHONPATH=src python -m repro_torch.analysis --list-rules
    PYTHONPATH=src python -m repro_torch.analysis --check-kernels

``--check`` also fails on *stale* baseline entries (fingerprints whose
finding no longer exists): the committed baseline is a ratchet that may
only shrink, and ``--write-baseline`` prunes it.

``--check-kernels`` runs :mod:`repro_torch.analysis.kernelcheck`: the
proofs of the CUDA kernels' declared launch contracts (carry order,
output coverage, in-bounds operands, shared-memory fit).  It is a
separate mode because it imports torch (the kernel modules build the
specs) and needs no card; the lint modes run without torch.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.lint import (
    BASELINE_DEFAULT,
    RULES,
    gate,
    lint_paths,
    load_baseline,
    render_json,
    render_text,
    stale_fingerprints,
    write_baseline,
)

DEFAULT_PATHS = ("src/repro_torch",)


def find_root(start: Path) -> Path:
    """Nearest ancestor holding the repo markers (so the CLI works from
    subdirectories too); falls back to ``start``."""
    for p in (start, *start.parents):
        if (p / "src" / "repro_torch").is_dir():
            return p
    return start


def _run_check_kernels(args) -> int:
    """The ``--check-kernels`` mode: verify every registered KernelSpec,
    print the verdicts, optionally write the JSON report; exit 1 on any
    failed check."""
    import json

    try:
        from repro_torch.analysis import kernelcheck
    except ImportError as e:  # torch not installed: the lint-only env
        print(f"--check-kernels needs torch (kernel modules build the "
              f"specs): {e}", file=sys.stderr)
        return 2
    verdicts = kernelcheck.check_kernels()
    for v in verdicts:
        print(v.render())
    failed = [v for v in verdicts if not v.ok]
    print(f"{len(verdicts)} kernel verdict(s), {len(failed)} failed")
    if args.json:
        report = json.dumps({
            "version": 1,
            "verdicts": [v.to_json() for v in verdicts],
            "counts": {"total": len(verdicts), "failed": len(failed)},
        }, indent=2)
        if args.json == "-":
            print(report)
        else:
            Path(args.json).write_text(report + "\n")
    return 1 if failed else 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Lint the tree against the project invariant rules.",
    )
    parser.add_argument(
        "paths", nargs="*",
        help=f"files/dirs to lint (default: {' '.join(DEFAULT_PATHS)})",
    )
    parser.add_argument(
        "--root", default=None,
        help="repo root for relative paths and the baseline "
             "(default: auto-detected from cwd)",
    )
    parser.add_argument(
        "--check", action="store_true",
        help="exit 1 if any non-baselined, non-suppressed finding "
             "remains, or if the baseline holds stale fingerprints",
    )
    parser.add_argument(
        "--json", metavar="FILE", default=None,
        help="also write the full JSON report to FILE ('-' for stdout)",
    )
    parser.add_argument(
        "--baseline", metavar="FILE", default=None,
        help=f"baseline file (default: <root>/{BASELINE_DEFAULT})",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="seed the baseline (first write), or prune stale entries "
             "from it (the baseline only ever shrinks)",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the registered rules and exit",
    )
    parser.add_argument(
        "--check-kernels", action="store_true",
        help="verify the CUDA kernels' launch contracts (KernelSpec carry/"
             "coverage/bounds/smem proofs; needs torch, no card), exit 1 on "
             "any failure",
    )
    args = parser.parse_args(argv)

    modes = [args.check, args.write_baseline, args.list_rules,
             args.check_kernels]
    if sum(bool(m) for m in modes) > 1:
        print("--check, --write-baseline, --list-rules and "
              "--check-kernels are mutually exclusive modes",
              file=sys.stderr)
        return 2

    if args.list_rules:
        for name, rule in sorted(RULES.items()):
            print(f"{name:18s} allow-{rule.pragma:18s} {rule.description}")
        return 0

    if args.check_kernels:
        if args.paths:
            print("--check-kernels verifies the registered KernelSpecs; "
                  "it takes no paths", file=sys.stderr)
            return 2
        return _run_check_kernels(args)

    root = find_root(Path(args.root or ".").resolve())
    paths = args.paths or [p for p in DEFAULT_PATHS if (root / p).exists()]
    if not paths:
        print(f"no default paths exist under {root}", file=sys.stderr)
        return 2
    baseline_path = Path(args.baseline) if args.baseline \
        else root / BASELINE_DEFAULT

    findings = lint_paths(paths, root=root)

    if args.write_baseline:
        n = write_baseline(findings, baseline_path)
        print(f"wrote {n} fingerprint(s) to {baseline_path}")
        return 0

    baseline = load_baseline(baseline_path)
    gating = gate(findings, baseline)
    stale = stale_fingerprints(findings, baseline)

    print(render_text(findings, gating, baseline, stale))
    if args.json:
        report = render_json(findings, gating, baseline, stale)
        if args.json == "-":
            print(report)
        else:
            Path(args.json).write_text(report + "\n")

    if args.check and (gating or stale):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

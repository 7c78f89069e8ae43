"""Static analysis for the port's invariants.

Port of ``repro/analysis`` (the port's own copies; it imports nothing of
the reference package):

  * :mod:`repro_torch.analysis.lint` + :mod:`repro_torch.analysis.rules`
    — the AST lint engine and the port's rules (host-sync with torch's
    syncs, carry-contract, no-shim-use, overflow-policy, lock-discipline,
    lock-order).  Stdlib-only: ``python -m repro_torch.analysis --check``
    runs without importing torch.
  * :mod:`repro_torch.analysis.plancheck` — the static plan validator
    (abstract evaluation on meta tensors over an ``ExecutionPlan``);
    imported lazily because it needs torch.
    ``HistogramEngine.validate(plan)`` is the wired-in entry point, and
    every ``run``/``map_frames`` calls it with ``deep=True``.
  * :mod:`repro_torch.analysis.kernelcheck` — proofs of the CUDA kernels'
    declared :class:`~repro_torch.kernels.specs.KernelSpec` launch
    contracts (carry order within a CTA and across launches, output
    coverage, in-bounds operands, shared-memory fit); also lazy.
    ``python -m repro_torch.analysis --check-kernels`` is its CLI.
"""

from repro_torch.analysis import rules as rules    # registers the rule set
from repro_torch.analysis.lint import (
    BASELINE_DEFAULT,
    Finding,
    FileContext,
    Rule,
    RULES,
    gate,
    lint_paths,
    lint_source,
    load_baseline,
    render_json,
    render_text,
    stale_fingerprints,
    write_baseline,
)

__all__ = [
    "BASELINE_DEFAULT",
    "Finding",
    "FileContext",
    "Rule",
    "RULES",
    "gate",
    "lint_paths",
    "lint_source",
    "load_baseline",
    "render_json",
    "render_text",
    "stale_fingerprints",
    "write_baseline",
    "check_plan",
    "PlanVerdict",
    "PlanCheck",
    "check_kernels",
    "check_method",
    "KernelVerdict",
    "KernelCheck",
]

#: names resolved lazily (they need torch): attr -> providing submodule.
_LAZY = {
    "check_plan": "plancheck",
    "PlanVerdict": "plancheck",
    "PlanCheck": "plancheck",
    "plancheck": "plancheck",
    "check_kernels": "kernelcheck",
    "check_method": "kernelcheck",
    "KernelVerdict": "kernelcheck",
    "KernelCheck": "kernelcheck",
    "kernelcheck": "kernelcheck",
}


def __getattr__(name):
    modname = _LAZY.get(name)
    if modname is not None:
        import importlib

        mod = importlib.import_module(f"repro_torch.analysis.{modname}")
        return mod if name == modname else getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

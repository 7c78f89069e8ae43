"""The project lint engine: AST rules over the port's invariant set.

Port of ``repro/analysis/lint.py``, kept as the port's own copy (the port
imports nothing of the reference package).  The engine is
dependency-free (stdlib ``ast`` only), so ``python -m repro_torch.analysis
--check`` runs without importing torch.  It provides what every rule
shares:

  * **Rule registry** — rules register a ``name`` (finding id), a
    ``pragma`` (the ``allow-<pragma>`` suppression token) and a
    ``check(ctx)`` over the parsed file.
  * **Pragma suppressions** — ``# analysis: allow-<pragma>(reason)`` on
    the offending line, or on a comment-only line directly above it.
    The reason is mandatory: an empty ``allow-x()`` does not suppress
    and is itself reported (rule id ``pragma``), as is an ``allow-``
    token no registered rule owns.
  * **Baseline** — a committed JSON file of finding fingerprints
    (rule + path + a hash of the offending source line, so findings
    don't churn when unrelated lines move).  ``--check`` fails only on
    findings that are neither suppressed nor baselined.
  * **Output** — human text or a JSON report (the CI artifact).

``python -m repro_torch.analysis`` is the CLI (``__main__.py``); the
project rules themselves live in ``rules.py``.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import re
import tokenize
from pathlib import Path, PurePosixPath
from typing import Callable, Iterable

#: an analysis pragma comment, anywhere on a line.
_PRAGMA_COMMENT = re.compile(r"#\s*analysis:\s*(?P<body>.+?)\s*$")
#: one ``allow-<name>(<reason>)`` token inside the pragma body.
_ALLOW_TOKEN = re.compile(r"allow-(?P<name>[A-Za-z0-9_-]+)\((?P<reason>[^()]*)\)")

#: findings the engine itself emits about malformed pragmas — these are
#: not suppressible (a broken suppression must not hide itself).
PRAGMA_RULE = "pragma"

BASELINE_DEFAULT = "analysis-baseline-torch.json"


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str                    # root-relative, posix separators
    line: int                    # 1-indexed
    message: str
    snippet: str = ""            # the stripped offending source line
    suppressed: bool = False
    suppression_reason: str | None = None

    @property
    def fingerprint(self) -> str:
        """Baseline key: stable across unrelated line moves (hashes the
        offending line's text, not its number)."""
        digest = hashlib.sha1(self.snippet.encode()).hexdigest()[:12]
        return f"{self.rule}:{self.path}:{digest}"

    def render(self) -> str:
        tag = f" [suppressed: {self.suppression_reason}]" if self.suppressed else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{tag}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "snippet": self.snippet,
            "fingerprint": self.fingerprint,
            "suppressed": self.suppressed,
            "suppression_reason": self.suppression_reason,
        }


# ---------------------------------------------------------------------------
# per-file context
# ---------------------------------------------------------------------------
class FileContext:
    """Everything a rule sees for one file: source, AST, pragma map."""

    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        # line -> {pragma-name: reason}; filled by _collect_pragmas.
        self.pragmas: dict[int, dict[str, str]] = {}
        self.pragma_findings: list[Finding] = []
        self._collect_pragmas()

    # -- pragmas -------------------------------------------------------------
    def _iter_comments(self):
        """(lineno, comment_text, comment_only_line) for real COMMENT
        tokens — docstrings quoting the pragma syntax don't count."""
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.source).readline)
            for tok in tokens:
                if tok.type == tokenize.COMMENT:
                    lineno = tok.start[0]
                    prefix = self.lines[lineno - 1][: tok.start[1]]
                    yield lineno, tok.string, not prefix.strip()
        except tokenize.TokenizeError:
            return

    def _collect_pragmas(self) -> None:
        known = {r.pragma for r in RULES.values()}
        for lineno, text, comment_only in self._iter_comments():
            m = _PRAGMA_COMMENT.search(text)
            if m is None:
                continue
            body = m.group("body")
            tokens = list(_ALLOW_TOKEN.finditer(body))
            if not tokens:
                self.pragma_findings.append(Finding(
                    rule=PRAGMA_RULE, path=self.relpath, line=lineno,
                    message=f"unparseable analysis pragma {body!r} "
                            "(want allow-<rule>(reason))",
                    snippet=self.snippet_at(lineno),
                ))
                continue
            # A comment-only pragma line covers the next line; an inline
            # pragma covers its own line.
            target = lineno + 1 if comment_only else lineno
            for tok in tokens:
                name, reason = tok.group("name"), tok.group("reason").strip()
                if name not in known:
                    self.pragma_findings.append(Finding(
                        rule=PRAGMA_RULE, path=self.relpath, line=lineno,
                        message=f"pragma allow-{name} matches no registered "
                                f"rule (known: {sorted(known)})",
                        snippet=self.snippet_at(lineno),
                    ))
                    continue
                if not reason:
                    self.pragma_findings.append(Finding(
                        rule=PRAGMA_RULE, path=self.relpath, line=lineno,
                        message=f"pragma allow-{name} has no reason — a "
                                "suppression must say why it is safe",
                        snippet=self.snippet_at(lineno),
                    ))
                    continue
                self.pragmas.setdefault(target, {})[name] = reason

    def suppression_for(self, pragma: str, line: int) -> str | None:
        return self.pragmas.get(line, {}).get(pragma)

    # -- helpers rules share -------------------------------------------------
    def snippet_at(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    @property
    def parts(self) -> tuple:
        return PurePosixPath(self.relpath).parts

    @property
    def filename(self) -> str:
        return PurePosixPath(self.relpath).name


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------
class Rule:
    """Base class: subclass, set the class attributes, implement check().

    ``check`` yields ``(line, message)`` pairs; the engine turns them
    into :class:`Finding` objects and applies pragma suppression.
    """

    name: str = ""
    pragma: str = ""             # suppression token: allow-<pragma>(reason)
    description: str = ""

    def applies_to(self, ctx: FileContext) -> bool:
        return True

    def check(self, ctx: FileContext) -> Iterable[tuple[int, str]]:
        raise NotImplementedError


#: global registry (name -> rule instance), filled by ``register``.
RULES: dict[str, Rule] = {}


def register(rule_cls: type[Rule]) -> type[Rule]:
    """Class decorator: instantiate and register a rule."""
    rule = rule_cls()
    if not rule.name or not rule.pragma:
        raise ValueError(f"rule {rule_cls.__name__} needs name and pragma")
    if rule.name in RULES:
        raise ValueError(f"duplicate rule name {rule.name!r}")
    RULES[rule.name] = rule
    return rule_cls


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
def lint_source(
    source: str, relpath: str, rules: Iterable[Rule] | None = None
) -> list[Finding]:
    """Lint one file's source; returns every finding (suppressed ones
    included, marked)."""
    if rules is None:
        rules = list(RULES.values())
    try:
        ctx = FileContext(relpath, source)
    except SyntaxError as e:
        return [Finding(
            rule=PRAGMA_RULE, path=relpath, line=e.lineno or 1,
            message=f"file does not parse: {e.msg}", snippet="",
        )]
    findings = list(ctx.pragma_findings)
    for rule in rules:
        if not rule.applies_to(ctx):
            continue
        for line, message in rule.check(ctx):
            reason = ctx.suppression_for(rule.pragma, line)
            findings.append(Finding(
                rule=rule.name, path=relpath, line=line, message=message,
                snippet=ctx.snippet_at(line),
                suppressed=reason is not None,
                suppression_reason=reason,
            ))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def iter_python_files(paths: Iterable[str | Path], root: Path) -> Iterable[Path]:
    for p in paths:
        p = (root / p) if not Path(p).is_absolute() else Path(p)
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def lint_paths(
    paths: Iterable[str | Path],
    *,
    root: str | Path | None = None,
    rules: Iterable[Rule] | None = None,
) -> list[Finding]:
    """Lint every ``*.py`` under ``paths`` (files or directories)."""
    root = Path(root) if root is not None else Path.cwd()
    findings: list[Finding] = []
    for path in iter_python_files(paths, root):
        try:
            rel = path.resolve().relative_to(root.resolve())
        except ValueError:
            rel = path
        relpath = PurePosixPath(rel).as_posix()
        findings.extend(
            lint_source(path.read_text(), relpath, rules=rules)
        )
    return findings


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------
def load_baseline(path: str | Path) -> set[str]:
    path = Path(path)
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return set(data.get("fingerprints", []))


def write_baseline(findings: Iterable[Finding], path: str | Path) -> int:
    """Persist the baseline; returns how many fingerprints it now holds.

    The baseline is a RATCHET: once a file exists, rewriting it can only
    *shrink* it (new = old ∩ current unsuppressed findings — fixed debt
    is pruned, new debt is refused, so ``--write-baseline`` can never
    launder a fresh violation).  Only when no baseline file exists yet
    does this seed it with the full current set.  Regenerate with
    ``python -m repro_torch.analysis --write-baseline`` after fixing baselined
    debt, and commit the file."""
    path = Path(path)
    current = {f.fingerprint for f in findings if not f.suppressed}
    if path.exists():
        fps = sorted(load_baseline(path) & current)
    else:
        fps = sorted(current)
    path.write_text(json.dumps(
        {"version": 1, "fingerprints": fps}, indent=2,
    ) + "\n")
    return len(fps)


def stale_fingerprints(
    findings: Iterable[Finding], baseline: set[str]
) -> set[str]:
    """Baseline entries no current unsuppressed finding matches — fixed
    (or vanished) debt still recorded.  ``--check`` fails on these so
    the committed baseline only ever shrinks (run ``--write-baseline``
    to prune them)."""
    current = {f.fingerprint for f in findings if not f.suppressed}
    return baseline - current


def gate(findings: Iterable[Finding], baseline: set[str]) -> list[Finding]:
    """The findings ``--check`` fails on: unsuppressed and not baselined."""
    return [
        f for f in findings
        if not f.suppressed and f.fingerprint not in baseline
    ]


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------
def render_text(
    findings: list[Finding], gating: list[Finding], baseline: set[str],
    stale: Iterable[str] = (),
) -> str:
    lines = [f.render() for f in findings if not f.suppressed]
    for fp in sorted(stale):
        lines.append(
            f"stale baseline entry {fp} — the finding is gone; prune "
            "with --write-baseline")
    n_sup = sum(f.suppressed for f in findings)
    n_base = sum(
        1 for f in findings
        if not f.suppressed and f.fingerprint in baseline
    )
    lines.append(
        f"{len(gating)} finding(s) ({n_sup} suppressed by pragma, "
        f"{n_base} baselined)"
    )
    return "\n".join(lines)


def render_json(
    findings: list[Finding], gating: list[Finding], baseline: set[str],
    stale: Iterable[str] = (),
) -> str:
    return json.dumps({
        "version": 1,
        "rules": {
            name: {"pragma": f"allow-{r.pragma}",
                   "description": r.description}
            for name, r in sorted(RULES.items())
        },
        "findings": [f.to_json() for f in findings],
        "gating": [f.fingerprint for f in gating],
        "baselined": sorted(
            f.fingerprint for f in findings
            if not f.suppressed and f.fingerprint in baseline
        ),
        "stale_baseline": sorted(stale),
        "counts": {
            "total": len(findings),
            "suppressed": sum(f.suppressed for f in findings),
            "gating": len(gating),
            "stale_baseline": len(set(stale)),
        },
    }, indent=2)


# helpers for rules -----------------------------------------------------------
def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_int(node: ast.AST, env: dict[str, int]) -> int | None:
    """Constant-fold an int expression over module-level int bindings."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = const_int(node.operand, env)
        return None if v is None else -v
    if isinstance(node, ast.BinOp):
        left = const_int(node.left, env)
        right = const_int(node.right, env)
        if left is None or right is None:
            return None
        ops: dict[type, Callable[[int, int], int]] = {
            ast.Add: lambda a, b: a + b,
            ast.Sub: lambda a, b: a - b,
            ast.Mult: lambda a, b: a * b,
            ast.FloorDiv: lambda a, b: a // b,
            ast.LShift: lambda a, b: a << b,
            ast.RShift: lambda a, b: a >> b,
            ast.Pow: lambda a, b: a ** b,
        }
        fn = ops.get(type(node.op))
        return None if fn is None else fn(left, right)
    return None


def module_int_env(tree: ast.AST) -> dict[str, int]:
    """Module-level ``NAME = <int expr>`` bindings, const-folded in order."""
    env: dict[str, int] = {}
    for stmt in getattr(tree, "body", []):
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            v = const_int(stmt.value, env)
            if v is not None:
                env[stmt.targets[0].id] = v
    return env

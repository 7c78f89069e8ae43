"""The port's invariant rules.

Port of ``repro/analysis/rules.py`` (the port's own copy).  Each rule
encodes one contract the engine rests on:

  * ``host-sync``        — a host sync (``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``.synchronize()``,
    ``torch.cuda.synchronize``, ``np.asarray``) inside ``FrameRuntime``
    dispatch or a kernel wrapper waits for the card and serializes the
    §4.4 double-buffering overlap.  Sanctioned sync points, and host-only
    arrays, carry a pragma.
  * ``carry-contract``   — any function passed as a runtime ``step``
    must be ``step(chunk, carry) -> (out, carry)``.
  * ``no-shim-use``      — internal code must not call the deprecated
    ``banded_*`` shims; the unified HSource entry points replace them.
  * ``overflow-policy``  — every storage policy must declare a
    statically-known validity bound (the §4.6 uint16/fp32 regime), and
    a storage-policy HSource must expose ``exact_region_bound``.
  * ``lock-discipline``  — attributes a class declares in
    ``_LOCK_PROTECTED`` may only be mutated under ``with self._lock:``
    (the close()/drain race class).
  * ``lock-order``       — per class, the lock-acquisition graph
    (nested ``with self.<lock>:`` blocks plus ``self.method()`` calls
    made while holding a lock, followed into the callee) must be
    acyclic, non-reentrant locks must not be re-acquired, and no
    blocking call (``.join()``, ``.result()``, blocking queue
    get/put, ``time.sleep``, or future completion — inline done
    callbacks) may run under a held lock.

The reference's ``sharded-concat`` rule is not ported: it guards a jax
0.4.37 bug (a device-side concatenate of row-sharded bands mis-assembles)
that torch does not have, and the port assembles shards on the card by
design.

Suppress a deliberate exception with
``# analysis: allow-<rule>(reason)`` on (or directly above) the line.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from repro_torch.analysis.lint import (
    FileContext,
    Rule,
    const_int,
    dotted_name,
    module_int_env,
    register,
)

# deprecated shims defined (and allowed) only in core/region_query.py
SHIM_NAMES = frozenset({
    "banded_region_histogram",
    "banded_sliding_window_histograms",
    "banded_likelihood_map",
})

# calls that wait for the card (np.asarray of a tensor copies it to the
# host), and tensor methods that do
_SYNC_CALLS = frozenset({
    "np.asarray", "numpy.asarray", "torch.cuda.synchronize",
})
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})

# container mutators always treated as writes on a protected attribute
_MUTATORS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "setdefault", "move_to_end", "add", "discard", "appendleft",
})


def _walk_calls(tree: ast.AST) -> Iterator[ast.Call]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


@register
class HostSyncRule(Rule):
    name = "host-sync"
    pragma = "host-sync"
    description = (
        "no .item() / .tolist() / .cpu() / .numpy() / .synchronize() / "
        "torch.cuda.synchronize / np.asarray in FrameRuntime dispatch or "
        "kernel wrappers — a host sync there serializes the double-buffered "
        "overlap; sanctioned sync points need "
        "`# analysis: allow-host-sync(reason)`"
    )

    def applies_to(self, ctx: FileContext) -> bool:
        return (
            ctx.relpath.endswith("core/runtime.py")
            or "kernels" in ctx.parts
        )

    def check(self, ctx: FileContext) -> Iterable[tuple[int, str]]:
        for call in _walk_calls(ctx.tree):
            dn = dotted_name(call.func)
            if dn in _SYNC_CALLS:
                yield call.lineno, (
                    f"{dn} is a host sync in a hot path — it stalls the "
                    "dispatch pipeline until the device catches up"
                )
                continue
            if isinstance(call.func, ast.Attribute) and \
                    call.func.attr in _SYNC_METHODS:
                yield call.lineno, (
                    f".{call.func.attr}() is a host sync in a hot "
                    "path — it stalls the dispatch pipeline"
                )


@register
class CarryContractRule(Rule):
    name = "carry-contract"
    pragma = "carry-contract"
    description = (
        "a function passed as a runtime `step` must satisfy "
        "step(chunk, carry) -> (out, carry): take exactly two arguments "
        "and return a two-tuple on every path"
    )

    def check(self, ctx: FileContext) -> Iterable[tuple[int, str]]:
        # local function definitions, for resolving `step` by name
        defs: dict[str, ast.FunctionDef] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs[node.name] = node

        for call in _walk_calls(ctx.tree):
            dn = dotted_name(call.func)
            if dn is None:
                continue
            leaf = dn.split(".")[-1]
            if leaf == "FrameRuntime":
                step = call.args[0] if call.args else next(
                    (kw.value for kw in call.keywords if kw.arg == "step"),
                    None,
                )
            elif leaf == "runtime_for":
                step = call.args[1] if len(call.args) > 1 else next(
                    (kw.value for kw in call.keywords if kw.arg == "step"),
                    None,
                )
            else:
                continue
            if step is None:
                continue
            yield from self._check_step(step, defs)

    def _check_step(self, step: ast.AST, defs: dict) -> Iterator[tuple[int, str]]:
        # FrameRuntime.stateless(fn) lifts fn into the contract — fine.
        if isinstance(step, ast.Call):
            dn = dotted_name(step.func)
            if dn is not None and dn.split(".")[-1] == "stateless":
                return
            return  # other call results are unresolvable — skip
        if isinstance(step, ast.Lambda):
            sig = list(self._check_signature(step, step.args, "lambda"))
            if sig:
                yield from sig     # wrong arity subsumes the return check
                return
            params = {a.arg for a in step.args.args}
            if not self._returns_pair(step.body, params):
                yield step.lineno, (
                    "step lambda must return a two-tuple (out, carry)"
                )
            return
        if isinstance(step, ast.Name) and step.id in defs:
            fn = defs[step.id]
            sig = list(self._check_signature(fn, fn.args, f"def {fn.name}"))
            if sig:
                yield from sig     # wrong arity subsumes the return check
                return
            params = {a.arg for a in fn.args.args}
            returns = [
                n for n in ast.walk(fn)
                if isinstance(n, ast.Return) and n.value is not None
            ]
            for ret in returns:
                if not self._returns_pair(ret.value, params):
                    yield ret.lineno, (
                        f"step `{fn.name}` must return a two-tuple "
                        "(out, carry) on every path"
                    )
        # anything else (parameter, attribute, comprehension) — skip

    @staticmethod
    def _check_signature(node, args: ast.arguments, label: str):
        n_pos = len(args.args) + len(args.posonlyargs)
        if n_pos != 2 or args.vararg or args.kwonlyargs:
            yield node.lineno, (
                f"step {label} must take exactly (chunk, carry), "
                f"got {n_pos} positional arg(s)"
            )

    @staticmethod
    def _returns_pair(expr: ast.AST, params: set) -> bool:
        if isinstance(expr, ast.Tuple):
            return len(expr.elts) == 2
        if isinstance(expr, ast.Name):
            # returning a bare parameter is the classic carry-drop bug;
            # other names (locals built as tuples) are unresolvable
            return expr.id not in params
        # non-literal returns (calls, attributes) are unresolvable — trust
        return not isinstance(expr, (ast.Constant, ast.List, ast.Dict))


@register
class NoShimUseRule(Rule):
    name = "no-shim-use"
    pragma = "shim-use"
    description = (
        "internal code must not import or call the deprecated banded_* "
        "shims (banded_region_histogram & co.) — the unified HSource "
        "entry points in core/region_query.py accept a BandedH directly"
    )

    def applies_to(self, ctx: FileContext) -> bool:
        # the defining module keeps the shims until their removal release
        return ctx.filename != "region_query.py"

    def check(self, ctx: FileContext) -> Iterable[tuple[int, str]]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    if alias.name in SHIM_NAMES:
                        yield node.lineno, (
                            f"imports deprecated shim `{alias.name}` — "
                            "use the unified entry point on an HSource"
                        )
            elif isinstance(node, ast.Attribute) and node.attr in SHIM_NAMES:
                yield node.lineno, (
                    f"references deprecated shim `{node.attr}` — use the "
                    "unified entry point on an HSource"
                )
            elif isinstance(node, ast.Name) and node.id in SHIM_NAMES \
                    and isinstance(node.ctx, ast.Load):
                yield node.lineno, (
                    f"uses deprecated shim `{node.id}` — use the unified "
                    "entry point on an HSource"
                )


@register
class OverflowPolicyRule(Rule):
    name = "overflow-policy"
    pragma = "overflow-policy"
    description = (
        "every STORAGE_POLICIES entry must be (dtype, bound) with a "
        "statically-known integer validity bound (§4.6 exact-count "
        "regime), and any HSource carrying a `storage` policy field "
        "must expose exact_region_bound()"
    )

    def check(self, ctx: FileContext) -> Iterable[tuple[int, str]]:
        env = module_int_env(ctx.tree)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and \
                            tgt.id == "STORAGE_POLICIES":
                        yield from self._check_policies(node.value, env)
            elif isinstance(node, ast.ClassDef):
                yield from self._check_storage_class(node)

    @staticmethod
    def _check_policies(value: ast.AST, env: dict) -> Iterator[tuple[int, str]]:
        if not isinstance(value, ast.Dict):
            yield value.lineno, (
                "STORAGE_POLICIES must be a literal dict so the bounds "
                "are statically checkable"
            )
            return
        for key, val in zip(value.keys, value.values):
            name = ast.unparse(key) if key is not None else "?"
            if not (isinstance(val, ast.Tuple) and len(val.elts) == 2):
                yield val.lineno, (
                    f"storage policy {name} must be a (dtype, bound) "
                    "pair declaring its validity bound"
                )
                continue
            bound = const_int(val.elts[1], env)
            if bound is None:
                yield val.lineno, (
                    f"storage policy {name}: validity bound must fold to "
                    "a compile-time integer (plancheck depends on it)"
                )
            elif bound <= 0:
                yield val.lineno, (
                    f"storage policy {name}: validity bound {bound} "
                    "must be positive"
                )

    @staticmethod
    def _check_storage_class(cls: ast.ClassDef) -> Iterator[tuple[int, str]]:
        # only HSource subclasses answer queries; plan/spec dataclasses
        # carry `storage` as metadata and are validated by plancheck.
        is_hsource = any(
            (dotted_name(base) or "").split(".")[-1] == "HSource"
            for base in cls.bases
        )
        has_storage = any(
            isinstance(stmt, ast.AnnAssign)
            and isinstance(stmt.target, ast.Name)
            and stmt.target.id == "storage"
            for stmt in cls.body
        )
        if not (is_hsource and has_storage):
            return
        has_bound = any(
            isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
            and stmt.name == "exact_region_bound"
            for stmt in cls.body
        )
        if not has_bound:
            yield cls.lineno, (
                f"class {cls.name} carries a `storage` policy field but "
                "does not define exact_region_bound() — queries cannot "
                "enforce the policy's validity bound"
            )


@register
class LockDisciplineRule(Rule):
    name = "lock-discipline"
    pragma = "lock-discipline"
    description = (
        "attributes a class lists in _LOCK_PROTECTED may only be "
        "mutated inside `with self._lock:` (outside __init__) — "
        "declared mutator methods (_LOCK_PROTECTED_MUTATORS) and "
        "container mutators count as mutations"
    )

    def check(self, ctx: FileContext) -> Iterable[tuple[int, str]]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(node)

    def _check_class(self, cls: ast.ClassDef) -> Iterator[tuple[int, str]]:
        protected = self._declared(cls, "_LOCK_PROTECTED")
        if not protected:
            return
        mutators = _MUTATORS | self._declared(cls, "_LOCK_PROTECTED_MUTATORS")
        for stmt in cls.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if stmt.name == "__init__":   # construction precedes sharing
                continue
            yield from self._scan(stmt.body, protected, mutators, False)

    @staticmethod
    def _declared(cls: ast.ClassDef, name: str) -> frozenset:
        for stmt in cls.body:
            targets = []
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets = [stmt.target]
            for tgt in targets:
                if isinstance(tgt, ast.Name) and tgt.id == name:
                    try:
                        value = ast.literal_eval(stmt.value)
                    except (ValueError, TypeError):
                        return frozenset()
                    return frozenset(
                        v for v in value if isinstance(v, str)
                    )
        return frozenset()

    def _scan(self, body, protected, mutators, locked) -> Iterator:
        for node in body:
            if isinstance(node, ast.With):
                inner = locked or any(
                    self._is_self_lock(item.context_expr)
                    for item in node.items
                )
                yield from self._scan(node.body, protected, mutators, inner)
                continue
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue            # nested callables judged on their own
            if not locked:
                yield from self._check_stmt(node, protected, mutators)
            # recurse into compound statements preserving lock state
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(node, field, None)
                if sub:
                    yield from self._scan(sub, protected, mutators, locked)
            for handler in getattr(node, "handlers", []) or []:
                yield from self._scan(handler.body, protected, mutators,
                                      locked)

    def _check_stmt(self, node, protected, mutators) -> Iterator:
        # only inspect this statement's own expressions, not nested blocks
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                attr = self._protected_base(tgt, protected)
                if attr is not None:
                    yield node.lineno, (
                        f"`self.{attr}` is declared lock-protected but is "
                        "written outside `with self._lock:`"
                    )
        exprs = []
        if isinstance(node, ast.Expr):
            exprs = [node.value]
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)) \
                and node.value is not None:
            exprs = [node.value]
        elif isinstance(node, (ast.If, ast.While)):
            exprs = [node.test]
        elif isinstance(node, ast.Return) and node.value is not None:
            exprs = [node.value]
        for expr in exprs:
            for call in _walk_calls(expr):
                if not isinstance(call.func, ast.Attribute):
                    continue
                if call.func.attr not in mutators:
                    continue
                attr = self._protected_base(call.func.value, protected)
                if attr is not None:
                    yield call.lineno, (
                        f"`self.{attr}.{call.func.attr}(...)` mutates a "
                        "lock-protected attribute outside "
                        "`with self._lock:`"
                    )

    @staticmethod
    def _protected_base(node: ast.AST, protected) -> str | None:
        """The protected attr name if `node` roots at self.<protected>."""
        while isinstance(node, (ast.Attribute, ast.Subscript)):
            base = node.value
            if isinstance(node, ast.Attribute) and \
                    isinstance(base, ast.Name) and base.id == "self" and \
                    node.attr in protected:
                return node.attr
            node = base
        return None

    @staticmethod
    def _is_self_lock(expr: ast.AST) -> bool:
        dn = dotted_name(expr)
        return dn is not None and dn.endswith("self._lock")


# lock-constructor callables recognized by the lock-order rule; RLock is
# reentrant (re-acquisition is legal), the rest are not.
_LOCK_FACTORIES = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "condition",
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
}

# attribute calls that block the calling thread outright
_BLOCKING_ATTRS = frozenset({"join", "result"})
# completing a future runs its done-callbacks inline on this thread —
# arbitrary foreign code under a held lock
_FUTURE_COMPLETERS = frozenset({"set_result", "set_exception"})
# queue methods that can block (get_nowait/put_nowait cannot)
_QUEUE_BLOCKERS = frozenset({"get", "put"})


@register
class LockOrderRule(Rule):
    name = "lock-order"
    pragma = "lock-order"
    description = (
        "per class: the lock-acquisition graph (nested `with self.X:` "
        "plus self.method() calls made while holding a lock, followed "
        "into the callee) must be acyclic; non-reentrant locks must not "
        "be re-acquired; no blocking call (.join/.result/blocking queue "
        "get/put/time.sleep/future completion) under a held lock"
    )

    def check(self, ctx: FileContext) -> Iterable[tuple[int, str]]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(node)

    # -- per-class analysis --------------------------------------------------
    def _check_class(self, cls: ast.ClassDef) -> Iterator[tuple[int, str]]:
        locks = self._lock_attrs(cls)
        if not locks:
            return
        methods = {
            stmt.name: stmt for stmt in cls.body
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        info = {
            name: self._scan_method(fn, locks)
            for name, fn in methods.items()
        }

        # Fixpoint closures: every lock a method may acquire and every
        # blocking call it may make, following self.method() calls.
        acq = {m: {a for a, _, _ in info[m]["acquires"]} for m in info}
        blk = {m: {d for d, _, _ in info[m]["blocks"]} for m in info}
        changed = True
        while changed:
            changed = False
            for m in info:
                for callee, _, _ in info[m]["calls"]:
                    if callee not in info:
                        continue
                    if not acq[callee] <= acq[m]:
                        acq[m] |= acq[callee]
                        changed = True
                    if not blk[callee] <= blk[m]:
                        blk[m] |= blk[callee]
                        changed = True

        # edge (a, b): b acquired while a held; remember one witness site
        edges: dict[tuple[str, str], tuple[int, str]] = {}
        for m in info:
            for lock, line, held in info[m]["acquires"]:
                for h in held:
                    if h == lock:
                        if locks[lock] != "rlock":
                            yield line, (
                                f"`{m}` re-acquires non-reentrant "
                                f"`self.{lock}` it already holds — "
                                "threading.Lock self-deadlocks"
                            )
                    else:
                        edges.setdefault((h, lock), (line, m))
            for callee, line, held in info[m]["calls"]:
                if not held or callee not in info:
                    continue
                for lock in acq[callee]:
                    for h in held:
                        if h == lock:
                            if locks[lock] != "rlock":
                                yield line, (
                                    f"`{m}` holds `self.{lock}` and calls "
                                    f"`self.{callee}()`, which acquires it "
                                    "again — threading.Lock self-deadlocks"
                                )
                        else:
                            edges.setdefault((h, lock), (line, m))
                for desc in blk[callee]:
                    yield line, (
                        f"`{m}` holds {self._held_str(held)} and calls "
                        f"`self.{callee}()`, which blocks ({desc}) — the "
                        "lock is held across the wait"
                    )
            for desc, line, held in info[m]["blocks"]:
                if held:
                    yield line, (
                        f"`{m}` blocks ({desc}) while holding "
                        f"{self._held_str(held)} — every other thread "
                        "needing the lock stalls behind the wait"
                    )

        yield from self._cycles(edges)

    @staticmethod
    def _held_str(held) -> str:
        return " + ".join(f"`self.{h}`" for h in held)

    def _cycles(self, edges) -> Iterator[tuple[int, str]]:
        graph: dict[str, list[str]] = {}
        for a, b in edges:
            graph.setdefault(a, []).append(b)
        reported: set[frozenset] = set()
        for start in sorted(graph):
            path: list[str] = []

            def dfs(node):
                if node in path:
                    cycle = path[path.index(node):] + [node]
                    key = frozenset(cycle)
                    if key not in reported:
                        reported.add(key)
                        line, meth = edges[(cycle[0], cycle[1])]
                        yield line, (
                            "lock-order cycle "
                            + " -> ".join(f"self.{c}" for c in cycle)
                            + f" (one edge acquired in `{meth}`) — two "
                            "threads taking the locks in opposite order "
                            "deadlock"
                        )
                    return
                path.append(node)
                for nxt in graph.get(node, ()):
                    yield from dfs(nxt)
                path.pop()

            yield from dfs(start)

    # -- method scan ---------------------------------------------------------
    @staticmethod
    def _lock_attrs(cls: ast.ClassDef) -> dict[str, str]:
        """``self.<attr>`` assignments whose value is a lock constructor
        call, anywhere in the class body: attr -> kind."""
        locks: dict[str, str] = {}
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign):
                continue
            if not isinstance(node.value, ast.Call):
                continue
            kind = _LOCK_FACTORIES.get(dotted_name(node.value.func) or "")
            if kind is None:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self":
                    locks[tgt.attr] = kind
        return locks

    def _scan_method(self, fn, locks) -> dict:
        out: dict = {"acquires": [], "calls": [], "blocks": []}
        self._scan_body(fn.body, locks, (), out)
        return out

    def _scan_body(self, body, locks, held, out) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue            # nested callables judged on their own
            if isinstance(node, ast.With):
                new_held = held
                for item in node.items:
                    attr = self._self_lock_attr(item.context_expr, locks)
                    if attr is not None:
                        out["acquires"].append((attr, node.lineno, new_held))
                        new_held = new_held + (attr,)
                    else:
                        self._scan_exprs([item.context_expr], locks,
                                         held, out)
                self._scan_body(node.body, locks, new_held, out)
                continue
            # this statement's own expressions (not nested blocks)
            self._scan_exprs(self._stmt_exprs(node), locks, held, out)
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(node, field, None)
                if sub:
                    self._scan_body(sub, locks, held, out)
            for handler in getattr(node, "handlers", []) or []:
                self._scan_body(handler.body, locks, held, out)

    @staticmethod
    def _stmt_exprs(node) -> list:
        exprs = []
        for field, value in ast.iter_fields(node):
            if field in ("body", "orelse", "finalbody", "handlers"):
                continue
            if isinstance(value, ast.expr):
                exprs.append(value)
            elif isinstance(value, list):
                exprs.extend(v for v in value if isinstance(v, ast.expr))
        return exprs

    def _scan_exprs(self, exprs, locks, held, out) -> None:
        for expr in exprs:
            for call in _walk_calls(expr):
                if not isinstance(call.func, ast.Attribute):
                    if dotted_name(call.func) == "time.sleep":
                        out["blocks"].append(
                            ("time.sleep(...)", call.lineno, held))
                    continue
                attr = call.func.attr
                base = dotted_name(call.func.value) or ""
                if base == "self" and attr not in locks:
                    out["calls"].append((attr, call.lineno, held))
                    continue
                if dotted_name(call.func) == "time.sleep":
                    out["blocks"].append(
                        ("time.sleep(...)", call.lineno, held))
                elif attr in _BLOCKING_ATTRS:
                    out["blocks"].append(
                        (f"{base or '...'}.{attr}()", call.lineno, held))
                elif attr in _FUTURE_COMPLETERS:
                    out["blocks"].append(
                        (f"{base or '...'}.{attr}() runs done-callbacks "
                         "inline", call.lineno, held))
                elif attr in _QUEUE_BLOCKERS and self._queue_like(base):
                    out["blocks"].append(
                        (f"{base}.{attr}() can block on the queue",
                         call.lineno, held))

    @staticmethod
    def _queue_like(base: str) -> bool:
        leaf = base.split(".")[-1].lower()
        return "queue" in leaf or leaf.endswith("_q")

    @staticmethod
    def _self_lock_attr(expr: ast.AST, locks) -> str | None:
        """`self.<lock attr>` in a with-item, else None."""
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self" and expr.attr in locks:
            return expr.attr
        return None

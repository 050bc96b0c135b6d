"""Concurrency lint — lock-discipline rules over the threaded fleet.

Counterpart of ``chainermn_tpu/analysis/concurrency.py``: the same rules,
fingerprints, lock graph and creation-site table, and on JAX sources the
same findings.  ``blocking-call-under-lock``'s compiled-program call gains
its torch counterpart in a module that imports torch: a call that blocks
the host on the card (``torch.cuda.synchronize()``, ``Event.synchronize()``
/ ``Stream.synchronize()``, ``.item()``) while a lock is held.

The serving/observability/health planes are a thread-and-lock system
(submit threads, supervisor ticks, role drivers, heartbeat side
threads; 17 modules hold ``threading.Lock``\\ s), and the review
rounds hand-found ~25 real races in exactly four shapes.  This
engine makes those shapes mechanical (docs/ANALYSIS.md has the real
historical bug behind each rule):

==========================  ========  =====================================
rule                        severity  fires on
==========================  ========  =====================================
lock-order-inversion        error     a cycle in the per-class lock-
                                      acquisition graph (lock B taken
                                      while A held in one path, A while B
                                      held in another), including re-
                                      acquisition of a NON-reentrant lock
                                      through an intra-class call chain
unguarded-shared-write      warning   a field written under ``self._lock``
                                      in one method but written bare in
                                      another — the seq-mint and     
                                      ``sent_since_lease`` lost-update
                                      class
blocking-call-under-lock    warning   ``lane_call``/lane-store get/put/
                                      ``sleep``/``join``/``wait``/
                                      subprocess/compiled-program calls
                                      while a lock is held — every other
                                      thread needing the lock stalls for
                                      the full I/O (the `_supervise`
                                      lease-poll shape)
callback-under-lock-contract warning  a user-supplied callback (``on_*``/
                                      ``*_hook``/``*_cb``) invoked while a
                                      lock is held without a
                                      ``# holds-lock: <lock>`` declaration
                                      on the call line (or the line
                                      above), OR a declaration that no
                                      longer matches reality — the two-
                                      sided PrefixCache hook      
                                      contract
==========================  ========  =====================================

Pure stdlib ``ast`` like ``ast_engine.py`` — no jax import, runs on any
box.  Findings ride the same fingerprint/suppression machinery
(``# spmd-lint: disable=<rule>`` works here too); the checked-in
baseline is ``.concurrency-baseline.json``.

What "held" means statically: ``with self._lock:`` blocks (and
``with``-stacked multiples), linear ``.acquire()``/``.release()``
pairs, and whole-body holds via a ``@_locked``-style decorator (any
decorator whose name contains ``locked`` is assumed to wrap the body in
``with self._lock``).  A nested ``def`` does NOT inherit the
enclosing ``with`` — its body runs later, on whatever thread calls it.

The per-class lock graph and the creation-site table are exported
(:func:`lock_graph`, :func:`lock_sites`) for the opt-in
``CHAINERMN_TPU_TORCH_LOCK_ASSERT=1`` runtime cross-check
(``analysis/lockassert.py``): dynamic acquisition orders the AST cannot
see are recorded at test time and the UNION of both graphs must stay
acyclic.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .findings import Finding, Suppressions

#: rule id -> (severity, one-line summary) — the catalog.
CONCURRENCY_RULES: Dict[str, Tuple[str, str]] = {
    "lock-order-inversion": (
        "error", "cycle in the per-class lock-acquisition graph"),
    "unguarded-shared-write": (
        "warning", "field written both under a lock and bare"),
    "blocking-call-under-lock": (
        "warning", "blocking call while a lock is held"),
    "callback-under-lock-contract": (
        "warning", "callback under a lock without (or with a stale) "
                   "# holds-lock: declaration"),
}

CONCURRENCY_BASELINE_FILENAME = ".concurrency-baseline.json"

_LOCK_FACTORIES = frozenset({"Lock", "RLock", "Condition"})
_REENTRANT_KINDS = frozenset({"RLock", "Condition"})  # Condition wraps RLock

_HOLDS_RE = re.compile(r"#\s*holds-lock:\s*([A-Za-z0-9_.,\s]+)")

#: attribute names treated as user-supplied callbacks when invoked.
_CALLBACK_ATTR_RE = re.compile(
    r"^(on_|_on_)|(_hook|_hooks|_cb|_callback|_callbacks)$|callback")

#: containers whose elements are callbacks (``for h in self._hooks:``).
_CALLBACK_CONTAINER_RE = re.compile(
    r"(_hooks|_callbacks|_cbs|_listeners|_sinks)$")

#: lane/store receivers whose get/put/send family blocks on I/O.
_LANE_BASES = frozenset({"store", "sender", "receiver", "outbox", "inbox",
                         "mailbox", "lane", "lanes"})
_LANE_TAILS = frozenset({"send", "recv", "put", "get", "delete", "drain",
                         "tags"})
_SUBPROCESS_TAILS = frozenset({"run", "call", "check_call", "check_output",
                               "Popen", "communicate"})
#: torch calls that block the host until the card has caught up (read
#: only in modules that import torch: ``.item()`` is numpy's too).
_CARD_SYNC_TAILS = frozenset({"synchronize", "item"})


def _imports_torch(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import) and any(
                a.name == "torch" or a.name.startswith("torch.")
                for a in node.names):
            return True
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module == "torch" or node.module.startswith("torch.")):
            return True
    return False


def _name_of(expr: ast.AST) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _dotted(expr: ast.AST) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        base = _dotted(expr.value)
        return f"{base}.{expr.attr}" if base is not None else None
    return None


def _terminates(stmts: Sequence[ast.stmt]) -> bool:
    """Whether a suite unconditionally leaves the enclosing block."""
    return any(isinstance(s, (ast.Return, ast.Raise, ast.Break,
                              ast.Continue))
               for s in stmts)


def _is_jit_expr(expr: ast.AST) -> bool:
    if _name_of(expr) == "jit":
        return True
    if isinstance(expr, ast.Call):
        fn = _name_of(expr.func)
        if fn == "jit":
            return True
        if fn == "partial" and expr.args and _is_jit_expr(expr.args[0]):
            return True
    return False


@dataclass(frozen=True)
class LockInfo:
    """One lock object the analyzer tracks."""
    lock_id: str     # "ClassQual.attr" or "<module>.NAME"
    attr: str        # the bare attr/name the source uses
    kind: str        # Lock | RLock | Condition
    line: int        # creation line (the lockassert site key)


@dataclass
class _Edge:
    src: str
    dst: str
    line: int
    context: str


@dataclass
class _Write:
    attr: str
    line: int
    method: str      # method qualname tail ("submit", "start.loop", ...)
    guarded: bool
    locks: Tuple[str, ...]


@dataclass
class _ClassFacts:
    qual: str
    locks: Dict[str, LockInfo] = field(default_factory=dict)  # attr -> info
    edges: List[_Edge] = field(default_factory=list)
    writes: List[_Write] = field(default_factory=list)
    # method name -> {lock attr -> first acquisition line}
    acquires: Dict[str, Dict[str, int]] = field(default_factory=dict)
    # (caller method, callee method, held attrs tuple, line)
    self_calls: List[Tuple[str, str, Tuple[str, ...], int]] = \
        field(default_factory=list)
    # def-level `# holds-lock:` contracts: method -> declared lock attrs
    contracts: Dict[str, Set[str]] = field(default_factory=dict)


class _HoldsDecls:
    """``# holds-lock: a, b`` comment table, parsed once per file from
    REAL comment tokens (``tokenize``) — the marker inside a docstring
    or string literal is prose, not a declaration."""

    def __init__(self, source: str):
        import io
        import tokenize

        self.by_line: Dict[int, Set[str]] = {}
        try:
            toks = tokenize.generate_tokens(
                io.StringIO(source).readline)
            comments = [(t.start[0], t.string) for t in toks
                        if t.type == tokenize.COMMENT]
        except (tokenize.TokenError, SyntaxError,
                IndentationError):   # pragma: no cover - parse-error path
            comments = []
        for i, text in comments:
            m = _HOLDS_RE.search(text)
            if not m:
                continue
            names = {t.strip() for t in m.group(1).split(",")
                     if t.strip()}
            names = {t[5:] if t.startswith("self.") else t
                     for t in names}
            if names:
                self.by_line[i] = names

    def for_def(self, def_line: int,
                first_stmt_line: int) -> Tuple[Set[str], List[int]]:
        """A def-level contract: a declaration on the ``def`` line or
        on a comment line between it and the first statement means
        "callers hold these locks" — the body is analyzed as if they
        were held, and every intra-class call site is checked against
        the contract."""
        out: Set[str] = set()
        used: List[int] = []
        for ln in range(def_line, max(first_stmt_line, def_line + 1)):
            names = self.by_line.get(ln)
            if names:
                out |= names
                used.append(ln)
        return out, used

    def for_call(self, line: int) -> Tuple[Set[str], List[int]]:
        """Declared locks covering a call at ``line`` (own line or the
        line above), plus the declaration lines consumed."""
        out: Set[str] = set()
        used: List[int] = []
        for ln in (line, line - 1):
            toks = self.by_line.get(ln)
            if toks:
                out |= toks
                used.append(ln)
        return out, used


class _FileAnalyzer:
    def __init__(self, source: str, path: str):
        self.source = source
        self.path = path
        self.lines = source.splitlines()
        self.findings: List[Finding] = []
        self.decls = _HoldsDecls(source)
        #: callback-call line -> held lock attr names at that call
        self.callback_calls: Dict[int, Set[str]] = {}
        #: declaration lines consumed by a matching callback call
        self.consumed_decls: Set[int] = set()
        self.module_locks: Dict[str, LockInfo] = {}
        self.classes: List[_ClassFacts] = []
        #: the module-scope pseudo-class (module functions + module
        #: locks) — kept so lock_graph() exports its edges too
        self.mod_facts: Optional[_ClassFacts] = None
        self.jitted_names: Set[str] = set()     # module/local callables
        self.jitted_attrs: Set[str] = set()     # self.X = jit(...)
        self.torch = False   # the module imports torch

    # ---- entry ----
    def run(self) -> List[Finding]:
        try:
            tree = ast.parse(self.source, filename=self.path)
        except SyntaxError as e:
            return [Finding(rule="parse-error", severity="error",
                            path=self.path, line=e.lineno or 0,
                            message=f"file does not parse: {e.msg}")]
        self._collect_module_facts(tree)
        self.torch = _imports_torch(tree)

        # module-level functions run under module locks only
        mod_facts = _ClassFacts(qual="<module>")
        mod_facts.locks = dict(self.module_locks)
        self.mod_facts = mod_facts
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk_method(mod_facts, node, node.name, held=[])
        self._emit_graph_findings(mod_facts)

        for cls, qual in self._iter_classes(tree):
            facts = self._class_facts(cls, qual)
            self.classes.append(facts)
            self._emit_graph_findings(facts)
            self._emit_unguarded_writes(facts)

        self._emit_stale_decls()
        return self.findings

    # ---- collection ----
    def _collect_module_facts(self, tree: ast.Module) -> None:
        for node in tree.body:
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                kind = self._lock_kind(node.value)
                if kind:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self.module_locks[t.id] = LockInfo(
                                f"<module>.{t.id}", t.id, kind,
                                node.lineno)
                # (jit-assign detection happens in the full-tree walk
                # below, which also visits these module-level nodes)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(_is_jit_expr(d) for d in node.decorator_list):
                    self.jitted_names.add(node.name)
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                if _is_jit_expr(node.value.func) or \
                        _is_jit_expr(node.value):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self.jitted_names.add(t.id)
                        elif isinstance(t, ast.Attribute) and \
                                _name_of(t.value) == "self":
                            self.jitted_attrs.add(t.attr)

    @staticmethod
    def _lock_kind(call: ast.Call) -> Optional[str]:
        name = _name_of(call.func)
        if name in _LOCK_FACTORIES:
            # threading.Lock() / Lock() / threading.Condition()
            return name
        return None

    def _iter_classes(self, tree: ast.Module):
        def rec(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    q = f"{prefix}.{child.name}" if prefix else child.name
                    yield child, q
                    yield from rec(child, q)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    yield from rec(child, prefix)
        yield from rec(tree, "")

    def _class_facts(self, cls: ast.ClassDef, qual: str) -> _ClassFacts:
        facts = _ClassFacts(qual=qual)
        # pre-pass: every `self.X = threading.Lock()` in any method
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                kind = self._lock_kind(node.value)
                if not kind:
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            _name_of(t.value) == "self":
                        facts.locks[t.attr] = LockInfo(
                            f"{qual}.{t.attr}", t.attr, kind,
                            node.lineno)
        for meth in cls.body:
            if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                held: List[LockInfo] = []
                if self._locked_decorator(meth) and \
                        "_lock" in facts.locks:
                    held = [facts.locks["_lock"]]
                    facts.acquires.setdefault(meth.name, {}).setdefault(
                        "_lock", meth.lineno)
                held.extend(self._def_contract(facts, meth))
                self._walk_method(facts, meth, meth.name, held=held)
        self._emit_contract_violations(facts)
        return facts

    def _def_contract(self, facts: _ClassFacts, meth) -> List[LockInfo]:
        """Seed the held set from a def-level ``# holds-lock:``
        contract ("callers hold these") and record it for call-site
        verification."""
        first = meth.body[0].lineno if meth.body else meth.lineno + 1
        declared, used = self.decls.for_def(meth.lineno, first)
        if not declared:
            return []
        self.consumed_decls.update(used)
        facts.contracts[meth.name] = declared
        out: List[LockInfo] = []
        for attr in sorted(declared):
            info = facts.locks.get(attr) or self.module_locks.get(attr)
            if info is not None:
                out.append(info)
        return out

    def _emit_contract_violations(self, facts: _ClassFacts) -> None:
        """The stale/violated side of a def-level contract: every
        intra-class call of a contract method must hold the declared
        locks (the caller half of the hook discipline)."""
        for caller, callee, held_attrs, line in facts.self_calls:
            declared = facts.contracts.get(callee)
            if not declared:
                continue
            missing = declared - set(held_attrs)
            if missing:
                self.findings.append(Finding(
                    rule="callback-under-lock-contract",
                    severity=CONCURRENCY_RULES[
                        "callback-under-lock-contract"][0],
                    path="", line=line,
                    context=f"{facts.qual}.{caller}",
                    message=(
                        f"`self.{callee}` declares `# holds-lock: "
                        f"{', '.join(sorted(declared))}` but is called "
                        f"here without {sorted(missing)} — the "
                        "contract says callers serialize; take the "
                        "lock at this call site or drop the "
                        "declaration")))

    @staticmethod
    def _locked_decorator(meth) -> bool:
        for dec in meth.decorator_list:
            nm = _name_of(dec if not isinstance(dec, ast.Call)
                          else dec.func)
            if nm and "locked" in nm:
                return True
        return False

    # ---- the statement walk (one method or module function) ----
    def _lock_of_expr(self, facts: _ClassFacts,
                      expr: ast.AST) -> Optional[LockInfo]:
        """Resolve ``self._lock`` / module ``NAME`` to a tracked lock."""
        if isinstance(expr, ast.Attribute) and \
                _name_of(expr.value) == "self":
            return facts.locks.get(expr.attr)
        if isinstance(expr, ast.Name):
            return self.module_locks.get(expr.id)
        return None

    def _walk_method(self, facts: _ClassFacts, fn, method: str,
                     held: List[LockInfo]) -> None:
        # `cb = self.on_evict` rebindings tracked per method scope
        self._cb_names: Set[str] = set()
        self._walk_block(facts, fn.body, method, held)

    def _walk_block(self, facts: _ClassFacts, stmts: Sequence[ast.stmt],
                    method: str, held: List[LockInfo]) -> None:
        for st in stmts:
            self._statement(facts, st, method, held)

    def _statement(self, facts: _ClassFacts, st: ast.stmt, method: str,
                   held: List[LockInfo]) -> None:
        if isinstance(st, ast.ClassDef):
            return
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def's body does NOT run under the enclosing
            # lock — it runs when (and where) someone calls it; walk it
            # with a clean held set so its own `with` blocks count
            saved = self._cb_names
            self._walk_method(facts, st, f"{method}.{st.name}", held=[])
            self._cb_names = saved
            return

        # expression-level checks on this statement's own expressions
        for call in self._own_calls(st):
            self._check_call(facts, call, method, held, st)

        # writes to self.<attr> (class scopes only)
        if facts.qual != "<module>":
            self._record_writes(facts, st, method, held)

        # callback-name rebinding: cb = self.on_evict
        if isinstance(st, ast.Assign) and \
                isinstance(st.value, ast.Attribute) and \
                _CALLBACK_ATTR_RE.search(st.value.attr or ""):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    self._cb_names.add(t.id)

        # linear acquire()/release() tracking
        if isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
            call = st.value
            fname = _name_of(call.func)
            if fname in ("acquire", "release") and \
                    isinstance(call.func, ast.Attribute):
                info = self._lock_of_expr(facts, call.func.value)
                if info is not None:
                    if fname == "acquire":
                        self._note_acquire(facts, info, method,
                                           call.lineno, held)
                        held.append(info)
                    else:
                        for i in range(len(held) - 1, -1, -1):
                            if held[i].lock_id == info.lock_id:
                                del held[i]
                                break

        # control flow
        if isinstance(st, (ast.With, ast.AsyncWith)):
            entered: List[LockInfo] = []
            for item in st.items:
                info = self._lock_of_expr(facts, item.context_expr)
                if info is not None:
                    self._note_acquire(facts, info, method,
                                       st.lineno, held + entered)
                    entered.append(info)
            held.extend(entered)
            # `for h in self._hooks:` loop vars inside a with-block are
            # still visible to the block walk below
            self._walk_block(facts, st.body, method, held)
            for _ in entered:
                held.pop()
        elif isinstance(st, ast.If):
            # the linear acquire()/release() state is BRANCH-SCOPED: an
            # acquire inside the if-body must not read as held while the
            # mutually exclusive else-body is walked (0-FP requirement).
            # After the If, keep the surviving branch's state when the
            # other terminates, else the intersection (a lock released
            # on only one path is conservatively treated as released)
            snap = list(held)
            self._walk_block(facts, st.body, method, held)
            after_body = list(held)
            held[:] = snap
            self._walk_block(facts, st.orelse, method, held)
            after_else = list(held)
            if _terminates(st.body):
                held[:] = after_else
            elif _terminates(st.orelse):
                held[:] = after_body
            else:
                else_ids = {h.lock_id for h in after_else}
                held[:] = [h for h in after_body
                           if h.lock_id in else_ids]
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            # callback containers: for h in self._hooks: h(...)
            if isinstance(st.iter, ast.Attribute) and \
                    _CALLBACK_CONTAINER_RE.search(st.iter.attr or "") \
                    or (isinstance(st.iter, ast.Call)
                        and isinstance(st.iter.func, ast.Name)
                        and st.iter.func.id == "list"
                        and st.iter.args
                        and isinstance(st.iter.args[0], ast.Attribute)
                        and _CALLBACK_CONTAINER_RE.search(
                            st.iter.args[0].attr or "")):
                if isinstance(st.target, ast.Name):
                    self._cb_names.add(st.target.id)
            snap = list(held)
            self._walk_block(facts, st.body, method, held)
            held[:] = snap   # zero-iteration loops: state is branch-scoped
            self._walk_block(facts, st.orelse, method, held)
            held[:] = snap
        elif isinstance(st, ast.While):
            snap = list(held)
            self._walk_block(facts, st.body, method, held)
            held[:] = snap
            self._walk_block(facts, st.orelse, method, held)
            held[:] = snap
        elif isinstance(st, ast.Try):
            self._walk_block(facts, st.body, method, held)
            for h in st.handlers:
                self._walk_block(facts, h.body, method, held)
            self._walk_block(facts, st.orelse, method, held)
            self._walk_block(facts, st.finalbody, method, held)

    def _note_acquire(self, facts: _ClassFacts, info: LockInfo,
                      method: str, line: int,
                      held: Sequence[LockInfo]) -> None:
        facts.acquires.setdefault(method, {}).setdefault(info.attr, line)
        for h in held:
            facts.edges.append(_Edge(h.lock_id, info.lock_id, line,
                                     f"{facts.qual}.{method}"))

    def _own_calls(self, st: ast.stmt) -> Iterable[ast.Call]:
        """Call expressions of THIS statement (headers for compound
        statements), not of nested blocks or nested defs."""
        if isinstance(st, (ast.If, ast.While)):
            roots: List[ast.AST] = [st.test]
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            roots = [st.iter]
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            roots = [item.context_expr for item in st.items]
        elif isinstance(st, ast.Try):
            return
        else:
            roots = [st]
        stack: List[ast.AST] = list(roots)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(n, ast.Call):
                yield n
            stack.extend(ast.iter_child_nodes(n))

    # ---- per-call rules ----
    def _check_call(self, facts: _ClassFacts, call: ast.Call,
                    method: str, held: Sequence[LockInfo],
                    st: ast.stmt) -> None:
        ctx = f"{facts.qual}.{method}"
        # intra-class call: self.m(...) — the lock-order closure input
        if isinstance(call.func, ast.Attribute) and \
                _name_of(call.func.value) == "self" and \
                facts.qual != "<module>":
            facts.self_calls.append(
                (method, call.func.attr,
                 tuple(h.attr for h in held), call.lineno))
        elif isinstance(call.func, ast.Name) and \
                facts.qual == "<module>":
            facts.self_calls.append(
                (method, call.func.id,
                 tuple(h.attr for h in held), call.lineno))

        if not held:
            return
        held_attrs = {h.attr for h in held}

        blocked = self._blocking_reason(facts, call, held)
        if blocked:
            self.findings.append(Finding(
                rule="blocking-call-under-lock",
                severity=CONCURRENCY_RULES[
                    "blocking-call-under-lock"][0],
                path="", line=call.lineno, context=ctx,
                message=(
                    f"{blocked} while holding "
                    f"{sorted(held_attrs)} — every thread contending "
                    "for the lock stalls for the full call (and a "
                    "blocking call that re-enters this class can "
                    "deadlock); move the call outside the critical "
                    "section or snapshot under the lock and do the "
                    "I/O after")))

        if self._is_callback_call(call):
            self.callback_calls.setdefault(
                call.lineno, set()).update(held_attrs)
            declared, used = self.decls.for_call(call.lineno)
            self.consumed_decls.update(used)
            missing = held_attrs - declared
            if missing:
                cb = _dotted(call.func) or _name_of(call.func) or "?"
                self.findings.append(Finding(
                    rule="callback-under-lock-contract",
                    severity=CONCURRENCY_RULES[
                        "callback-under-lock-contract"][0],
                    path="", line=call.lineno, context=ctx,
                    message=(
                        f"callback `{cb}` invoked while holding "
                        f"{sorted(missing)} with no `# holds-lock: "
                        f"{', '.join(sorted(missing))}` declaration — "
                        "a hook that takes any lock orderable against "
                        "this one deadlocks (the PrefixCache "
                        "hook contract); declare the hold on the call "
                        "line so hook authors can see it, or move the "
                        "invocation outside the lock")))

    def _is_callback_call(self, call: ast.Call) -> bool:
        if isinstance(call.func, ast.Attribute):
            return bool(_CALLBACK_ATTR_RE.search(call.func.attr or ""))
        if isinstance(call.func, ast.Name):
            return call.func.id in self._cb_names
        return False

    def _blocking_reason(self, facts: _ClassFacts, call: ast.Call,
                         held: Sequence[LockInfo]) -> Optional[str]:
        fname = _name_of(call.func)
        dotted = _dotted(call.func) or (fname or "")

        if fname == "sleep":
            return f"`{dotted}` sleeps"
        if fname in ("lane_call", "lane_try_get"):
            return f"`{fname}` does retrying lane I/O"
        if fname == "wait":
            if isinstance(call.func, ast.Attribute):
                recv = self._lock_of_expr(facts, call.func.value)
                if recv is not None and any(
                        h.lock_id == recv.lock_id for h in held):
                    return None   # cv.wait() RELEASES the held lock
            return f"`{dotted}` blocks on an event/thread/process"
        if fname == "join":
            # str.join / os.path.join take an iterable/str args;
            # Thread.join()/Popen.join(timeout) take nothing or a number
            numeric = (len(call.args) == 1
                       and isinstance(call.args[0], ast.Constant)
                       and isinstance(call.args[0].value, (int, float)))
            kw_ok = all(kw.arg == "timeout" for kw in call.keywords)
            if (not call.args or numeric) and kw_ok and \
                    isinstance(call.func, ast.Attribute):
                return f"`{dotted}` joins a thread/process"
            return None
        if fname in _SUBPROCESS_TAILS and isinstance(
                call.func, ast.Attribute) and \
                _name_of(call.func.value) == "subprocess":
            return f"`{dotted}` spawns/waits on a subprocess"
        if fname == "communicate":
            return f"`{dotted}` waits on a subprocess"
        if isinstance(call.func, ast.Attribute) and \
                fname in _LANE_TAILS:
            base = _dotted(call.func.value) or ""
            segs = set(base.split("."))
            if segs & _LANE_BASES:
                return f"`{dotted}` is lane/store I/O"
        # compiled-program calls: self._tick(...) assigned from jit, or
        # a module/local name assigned from jit / a jit-decorated def
        if isinstance(call.func, ast.Attribute) and \
                _name_of(call.func.value) == "self" and \
                call.func.attr in self.jitted_attrs:
            return f"`{dotted}` runs a compiled program"
        if isinstance(call.func, ast.Name) and \
                call.func.id in self.jitted_names:
            return f"`{dotted}` runs a compiled program"
        # the torch counterpart: a call that waits for the card
        if self.torch and isinstance(call.func, ast.Attribute) and \
                fname in _CARD_SYNC_TAILS and (
                    fname == "synchronize" or not call.args):
            return f"`{dotted}` waits for the card"
        return None

    # ---- writes ----
    def _record_writes(self, facts: _ClassFacts, st: ast.stmt,
                       method: str, held: Sequence[LockInfo]) -> None:
        targets: List[ast.AST] = []
        if isinstance(st, ast.Assign):
            targets = list(st.targets)
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            targets = [st.target]
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                targets.extend(t.elts)
                continue
            base = t
            while isinstance(base, ast.Subscript):
                base = base.value
            if isinstance(base, ast.Attribute) and \
                    _name_of(base.value) == "self":
                if base.attr in facts.locks:
                    continue   # creating/rebinding the lock itself
                facts.writes.append(_Write(
                    attr=base.attr, line=st.lineno, method=method,
                    guarded=bool(held),
                    locks=tuple(sorted(h.attr for h in held))))

    # ---- emission ----
    def _emit_graph_findings(self, facts: _ClassFacts) -> None:
        if not facts.locks and facts.qual != "<module>":
            return
        # transitive acquisition closure per method (intra-class calls)
        closure: Dict[str, Dict[str, int]] = {}

        def close(m: str, stack: Set[str]) -> Dict[str, int]:
            if m in closure:
                return closure[m]
            if m in stack:
                return {}
            stack.add(m)
            out = dict(facts.acquires.get(m, {}))
            for caller, callee, _held, line in facts.self_calls:
                if caller != m:
                    continue
                for attr in close(callee, stack):
                    out.setdefault(attr, line)
            stack.discard(m)
            closure[m] = out
            return out

        methods = set(facts.acquires) | \
            {c[0] for c in facts.self_calls} | \
            {c[1] for c in facts.self_calls}
        for m in methods:
            close(m, set())

        edges: List[_Edge] = list(facts.edges)
        for caller, callee, held_attrs, line in facts.self_calls:
            if not held_attrs:
                continue
            for attr in close(callee, set()):
                info = facts.locks.get(attr) or \
                    self.module_locks.get(attr)
                if info is None:
                    continue
                for h in held_attrs:
                    hinfo = facts.locks.get(h) or \
                        self.module_locks.get(h)
                    if hinfo is None:
                        continue
                    edges.append(_Edge(hinfo.lock_id, info.lock_id,
                                       line,
                                       f"{facts.qual}.{caller}"))

        # persist the closure edges: lock_graph() (the lockassert union
        # check) must see call-chain orders too, not just direct
        # with-nesting — else a dynamic B->A against a static
        # call-chain A->B would pass the acyclicity assert
        facts.edges = edges
        self._emit_cycles(facts, edges)

    def _emit_cycles(self, facts: _ClassFacts,
                     edges: List[_Edge]) -> None:
        by_id = {i.lock_id: i for i in facts.locks.values()}
        by_id.update({i.lock_id: i for i in self.module_locks.values()})
        graph: Dict[str, Dict[str, _Edge]] = {}
        emitted: Set[Tuple[str, ...]] = set()
        for e in edges:
            if e.src == e.dst:
                info = by_id.get(e.src)
                if info is not None and info.kind in _REENTRANT_KINDS:
                    continue   # RLock/Condition re-entry is legal
                key = (e.src,)
                if key in emitted:
                    continue
                emitted.add(key)
                self.findings.append(Finding(
                    rule="lock-order-inversion",
                    severity=CONCURRENCY_RULES[
                        "lock-order-inversion"][0],
                    path="", line=e.line, context=e.context,
                    message=(
                        f"non-reentrant lock `{e.src}` re-acquired "
                        "while already held (through an intra-class "
                        "call chain) — the thread deadlocks against "
                        "itself; use an RLock, or split the locked "
                        "face from the unlocked `_impl`")))
                continue
            graph.setdefault(e.src, {}).setdefault(e.dst, e)

        # cycle detection (DFS, canonicalized rotation for dedup)
        def find_cycle(start: str) -> Optional[List[str]]:
            stack = [(start, [start])]
            seen: Set[str] = set()
            while stack:
                node, path = stack.pop()
                for nxt in graph.get(node, {}):
                    if nxt == start:
                        return path
                    if nxt in seen:
                        continue
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
            return None

        for start in sorted(graph):
            cyc = find_cycle(start)
            if not cyc:
                continue
            canon = tuple(sorted(cyc))
            if canon in emitted:
                continue
            emitted.add(canon)
            first = graph[cyc[0]][cyc[1] if len(cyc) > 1 else cyc[0]] \
                if len(cyc) > 1 else None
            ring = " -> ".join(cyc + [cyc[0]])
            e = first or next(iter(graph[cyc[0]].values()))
            self.findings.append(Finding(
                rule="lock-order-inversion",
                severity=CONCURRENCY_RULES["lock-order-inversion"][0],
                path="", line=e.line, context=e.context,
                message=(
                    f"lock acquisition cycle {ring}: two threads "
                    "entering from opposite ends deadlock; impose one "
                    "global order (acquire in a fixed sequence) or "
                    "collapse to a single lock")))

    def _emit_unguarded_writes(self, facts: _ClassFacts) -> None:
        if not facts.locks:
            return
        by_attr: Dict[str, List[_Write]] = {}
        for w in facts.writes:
            by_attr.setdefault(w.attr, []).append(w)
        for attr, ws in sorted(by_attr.items()):
            guarded = [w for w in ws if w.guarded]
            if not guarded:
                continue
            bare = [w for w in ws
                    if not w.guarded
                    and w.method.split(".")[0] not in
                    ("__init__", "__new__")]
            if not bare:
                continue
            glock = sorted({lk for w in guarded for lk in w.locks})
            gsites = sorted({f"{w.method} (line {w.line})"
                             for w in guarded})[:2]
            for w in bare:
                self.findings.append(Finding(
                    rule="unguarded-shared-write",
                    severity=CONCURRENCY_RULES[
                        "unguarded-shared-write"][0],
                    path="", line=w.line,
                    context=f"{facts.qual}.{w.method}",
                    message=(
                        f"`self.{attr}` is written under {glock} in "
                        f"{', '.join(gsites)} but written BARE here — "
                        "a concurrent locked read-modify-write loses "
                        "one of the updates (the seq-mint / "
                        "sent_since_lease class); take the same lock "
                        "here, or move the field out of the shared "
                        "plane")))

    def _emit_stale_decls(self) -> None:
        for line, toks in sorted(self.decls.by_line.items()):
            calls = self.callback_calls.get(line) or \
                self.callback_calls.get(line + 1)
            if calls is None:
                if line in self.consumed_decls or \
                        (line + 1) in self.callback_calls:
                    continue
                self.findings.append(Finding(
                    rule="callback-under-lock-contract",
                    severity=CONCURRENCY_RULES[
                        "callback-under-lock-contract"][0],
                    path="", line=line, context="",
                    message=(
                        f"stale `# holds-lock: "
                        f"{', '.join(sorted(toks))}` — no callback is "
                        "invoked under a lock on this line (or the "
                        "next): the declaration no longer matches the "
                        "code; delete it (the two-sided contract, like "
                        "shardflow's stale-replication-annotation)")))
                continue
            stale = toks - calls
            if stale:
                self.findings.append(Finding(
                    rule="callback-under-lock-contract",
                    severity=CONCURRENCY_RULES[
                        "callback-under-lock-contract"][0],
                    path="", line=line, context="",
                    message=(
                        f"stale `# holds-lock:` tokens "
                        f"{sorted(stale)} — the callback here runs "
                        f"under {sorted(calls) or '(no lock)'}; "
                        "declarations must name exactly the held "
                        "locks (delete the stale tokens)")))


# --------------------------------------------------------------------------
# public faces
# --------------------------------------------------------------------------

def analyze_source(source: str, path: str,
                   rules: Optional[Sequence[str]] = None
                   ) -> List[Finding]:
    findings = _FileAnalyzer(source, path).run()
    sup = Suppressions(source)
    lines = source.splitlines()
    wanted = set(rules) if rules else None
    out: List[Finding] = []
    for f in findings:
        if wanted is not None and f.rule not in wanted \
                and f.rule != "parse-error":
            continue
        if sup.suppressed(f.rule, f.line):
            continue
        f.path = path
        if 1 <= f.line <= len(lines):
            f.snippet = lines[f.line - 1].strip()
        out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def analyze_file(path: str,
                 rules: Optional[Sequence[str]] = None) -> List[Finding]:
    with open(path) as fh:
        return analyze_source(fh.read(), path, rules=rules)


_DEFAULT_EXCLUDES = ("__pycache__", ".git", "build", "dist", ".eggs")


def _iter_files(paths: Sequence[str],
                exclude: Sequence[str] = _DEFAULT_EXCLUDES) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames if d not in exclude]
            files.extend(os.path.join(dirpath, f)
                         for f in sorted(filenames) if f.endswith(".py"))
    return sorted(set(files))


def analyze_paths(paths: Sequence[str],
                  rules: Optional[Sequence[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for f in _iter_files(paths):
        findings.extend(analyze_file(f, rules=rules))
    return findings


def analyze_lock_surface(paths: Sequence[str]
                         ) -> Tuple[Dict[Tuple[str, int],
                                         Tuple[str, str]],
                                    Set[Tuple[str, str]]]:
    """ONE analysis pass over ``paths`` yielding both halves the
    runtime lock-assert needs: the creation-site table ``(abs path,
    line) -> (owner qualname, attr)`` and the static lock-order edge
    set ``(held lock id, acquired lock id)`` — intra-class call-chain
    closure and module-function edges included."""
    sites: Dict[Tuple[str, int], Tuple[str, str]] = {}
    edges: Set[Tuple[str, str]] = set()
    for fpath in _iter_files(paths):
        with open(fpath) as fh:
            source = fh.read()
        an = _FileAnalyzer(source, fpath)
        try:
            an.run()
        except RecursionError:   # pragma: no cover - absurd nesting
            continue
        ap = os.path.abspath(fpath)
        for info in an.module_locks.values():
            sites[(ap, info.line)] = ("<module>", info.attr)
        all_facts = list(an.classes)
        if an.mod_facts is not None:
            all_facts.append(an.mod_facts)
        kinds = {i.lock_id: i.kind for i in an.module_locks.values()}
        for facts in all_facts:
            kinds.update({i.lock_id: i.kind
                          for i in facts.locks.values()})
        for facts in all_facts:
            for info in facts.locks.values():
                sites[(ap, info.line)] = (facts.qual, info.attr)
            for e in facts.edges:
                if e.src == e.dst and \
                        kinds.get(e.src) in _REENTRANT_KINDS:
                    continue   # legal RLock/Condition re-entry (the
                    # PrefixCache insert->evict shape) is not an order
                edges.add((e.src, e.dst))
    return sites, edges


def lock_sites(paths: Sequence[str]
               ) -> Dict[Tuple[str, int], Tuple[str, str]]:
    """(abs path, creation line) -> (owner qualname, attr) for every
    tracked lock — the key the runtime lock-assert recorder uses to name
    the locks it observes (``analysis/lockassert.py``)."""
    return analyze_lock_surface(paths)[0]


def lock_graph(paths: Sequence[str]) -> Set[Tuple[str, str]]:
    """The static lock-order edge set over ``paths``: (held lock id,
    acquired lock id) pairs, intra-class call-chain closure and
    module-level-function edges included."""
    return analyze_lock_surface(paths)[1]


# --------------------------------------------------------------------------
# runner: python -m chainermn_tpu_torch.analysis.concurrency
# --------------------------------------------------------------------------

def find_concurrency_baseline(start: Optional[str] = None
                              ) -> Optional[str]:
    from .findings import find_baseline

    d = start or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return find_baseline(d, filename=CONCURRENCY_BASELINE_FILENAME)


def main(argv: Optional[List[str]] = None) -> int:
    """Concurrency-lint runner (default: the port's package directory).  Exit contract: 0 = clean modulo
    baseline, 1 = findings, 2 = unusable inputs (the
    ``check_perf_regression.py`` / ``lint_spmd.py`` contract)."""
    import argparse
    import json
    import sys

    from .baseline import BaselineGate

    p = argparse.ArgumentParser(
        prog="python -m chainermn_tpu_torch.analysis.concurrency",
        description="Lock-discipline lint: lock-order cycles, unguarded "
                    "shared writes, blocking calls and undeclared "
                    "callbacks under locks (docs/ANALYSIS.md)")
    p.add_argument("paths", nargs="*", default=None)
    p.add_argument("--json", action="store_true")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule subset")
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("--baseline", default=None)
    p.add_argument("--no-baseline", action="store_true")
    p.add_argument("--fix-baseline", action="store_true")
    args = p.parse_args(argv)

    if args.list_rules:
        for rule, (sev, desc) in sorted(CONCURRENCY_RULES.items()):
            print(f"{rule:28s} {sev:8s} {desc}")
        return 0

    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = args.paths or [pkg_dir]
    missing = [q for q in paths if not os.path.exists(q)]
    if missing:
        print(f"error: no such path(s): {', '.join(missing)}",
              file=sys.stderr)
        return 2
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    if rules:
        unknown = set(rules) - set(CONCURRENCY_RULES)
        if unknown:
            print(f"error: unknown rule(s): "
                  f"{', '.join(sorted(unknown))}", file=sys.stderr)
            return 2

    findings = analyze_paths(paths, rules=rules)

    gate = BaselineGate.resolve(
        args.baseline, paths[0],
        CONCURRENCY_BASELINE_FILENAME, enabled=not args.no_baseline)
    # repo-relative paths for location-independent fingerprints (the
    # cli.py normalization, anchored at the baseline's directory)
    abs_paths = [os.path.abspath(q) for q in paths]
    common = os.path.commonpath(abs_paths)
    if os.path.isfile(common):
        common = os.path.dirname(common)
    root = common
    if gate.path:
        bl_dir = os.path.dirname(os.path.abspath(gate.path))
        if os.path.commonpath([bl_dir, common]) == bl_dir:
            root = bl_dir
    for f in findings:
        if f.path:
            f.path = os.path.relpath(os.path.abspath(f.path), root)

    err = gate.load()
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 2

    if args.fix_baseline:
        def in_scope(entry) -> bool:
            if rules is not None and entry["rule"] not in rules \
                    and entry["rule"] != "parse-error":
                return False
            ap = os.path.normpath(os.path.join(root, entry["path"]))
            return any(ap == sp or ap.startswith(sp + os.sep)
                       for sp in abs_paths)

        gate.fix(findings, in_scope=in_scope,
                 default_target=os.path.join(
                     root, CONCURRENCY_BASELINE_FILENAME))
        return 0

    findings, accepted = gate.filter(findings)

    if args.json:
        print(json.dumps({
            "schema": "chainermn_tpu.concurrency_lint.v1",
            "baseline": (os.path.relpath(gate.path, root)
                         if gate.baseline is not None else None),
            "n_accepted_by_baseline": len(accepted),
            "findings": [f.to_dict() for f in findings],
        }, indent=2))
    else:
        for f in findings:
            print(f.render())
        sev: Dict[str, int] = {}
        for f in findings:
            sev[f.severity] = sev.get(f.severity, 0) + 1
        tally = ", ".join(f"{n} {s}" for s, n in sorted(sev.items())) \
            or "no findings"
        extra = (f" ({len(accepted)} accepted by baseline)"
                 if accepted else "")
        print(f"concurrency-lint: {tally}{extra} over "
              f"{len(paths)} path(s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":   # pragma: no cover - python -m face
    import sys

    sys.exit(main())

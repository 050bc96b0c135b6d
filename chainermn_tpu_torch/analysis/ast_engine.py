"""AST rule engine — pure stdlib, imports neither torch nor jax.

Counterpart of ``chainermn_tpu/analysis/ast_engine.py``: the same catalog
(:data:`AST_RULES`), the same fingerprints, and on JAX sources the same
findings, line for line.  Every rule here encodes a bug class this repo
has actually shipped or that the reference's MPI heritage makes
structural (see docs/ANALYSIS.md for a real-bug example per rule):

================  ========  ====================================================
rule              severity  fires on
================  ========  ====================================================
collective-       error     a registry collective called under rank-dependent
deadlock                    control flow (branch, loop bound, or after a
                            rank-guarded early return) — some ranks enter the
                            collective, others don't: the gang deadlocks
prng-constant-    warning   ``jax.random.PRNGKey(<literal>)`` / ``key(<lit>)``
key                         — process-constant randomness (the rng trap)        
prng-key-reuse    warning   the same key consumed by two sampling calls with no
                            ``split``/``fold_in`` between — identical draws
host-alias-race   warning   in-place mutation of a buffer that also flows
                            through ``asarray`` — zero-copy device aliasing +
                            async dispatch races the mutation (pos-vector bug)
traced-control-   error     Python ``if``/``while`` on a traced parameter inside
flow                        a jitted function — TracerBoolConversionError at
                            best, silent trace-time specialization at worst
inplace-jit-      warning   in-place mutation of a name that is also passed to
mutation                    a jitted callable in the same scope
mismatched-       error     shard_map whose body reduces over a literal axis
shard-specs                 the same-scope mesh doesn't bind, or whose
                            out_specs shard an axis the returned collective
                            just reduced over
donated-buffer-   warning   a name passed at a ``donate_argnums`` position of
reuse                       a jitted call and READ afterwards — the buffer may
                            alias the output (the serving cache-pool hazard)
================  ========  ====================================================

The linear-flow rules (key reuse, deadlock-after-return) process loop
bodies TWICE — a cheap fixed-point that makes "reused every iteration"
emerge without real dataflow analysis; findings are deduped by line.

The port's idiom, which the rules also read:

* **collective-deadlock:** ``torch.distributed``'s collectives called
  through the module (``dist.all_reduce``, ``dist.barrier``, ...) are
  collectives, and ``dist.get_rank()`` is rank taint (the registry's
  torch vocabulary);
* **host-alias-race:** ``torch.from_numpy(buf)`` / ``torch.as_tensor(buf)``
  (zero-copy on the host) alias ``buf``; mutating it in place while a
  ``non_blocking=True`` copy in the same scope may still be reading the
  bytes is the torch shape of the pos-vector race ``asarray`` catches;
* **prng-constant-key / prng-key-reuse:** the port's ``prng.PRNGKey`` /
  ``fold_in`` / ``uniform`` / ``gumbel`` (threefry keys as JAX's), and a
  ``torch.manual_seed`` / ``Generator.manual_seed`` given a literal.

Four rules stay for JAX sources and find nothing in torch code, by
construction: **traced-control-flow** and **inplace-jit-mutation** read
``jax.jit`` bodies and callables (eager torch traces nothing: a Python
branch on a tensor is a host read, not a trace-time specialization);
**mismatched-shard-specs** reads ``shard_map`` specs (the port's ranks are
processes whose collectives name their axis at run time, which the trace
engine's unbound-axis check holds); **donated-buffer-reuse** reads
``donate_argnums`` (torch donates no buffer: its in-place writes are
explicit).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .findings import Finding, Suppressions
from .registry import CollectiveRegistry, default_registry

#: rule id -> (severity, one-line summary) — the catalog.
AST_RULES: Dict[str, Tuple[str, str]] = {
    "collective-deadlock": (
        "error", "collective under rank-dependent control flow"),
    "prng-constant-key": (
        "warning", "PRNGKey built from a literal constant"),
    "prng-key-reuse": (
        "warning", "PRNG key consumed twice without split/fold_in"),
    "host-alias-race": (
        "warning", "in-place mutation of an asarray-aliased buffer"),
    "traced-control-flow": (
        "error", "Python branch on a traced value inside jit"),
    "inplace-jit-mutation": (
        "warning", "in-place mutation of an argument of a jitted call"),
    "mismatched-shard-specs": (
        "error", "shard_map specs inconsistent with the axis the body "
                 "reduces over"),
    "donated-buffer-reuse": (
        "warning", "donate_argnums'd buffer read after the jitted call"),
}

_PRNG_CONSUMERS = frozenset({
    "normal", "uniform", "randint", "bernoulli", "categorical", "gumbel",
    "choice", "permutation", "shuffle", "truncated_normal", "exponential",
    "gamma", "beta", "dirichlet", "laplace", "poisson", "rademacher",
    "maxwell", "ball", "orthogonal", "t", "loggamma", "binomial",
})
_PRNG_DERIVERS = frozenset({"split", "fold_in", "clone"})
#: attribute bases that name a PRNG namespace: JAX's ``jax.random`` (and
#: its usual aliases) and the port's threefry module ``prng``
_PRNG_NAMESPACES = ("random", "jrandom", "jr", "prng")
#: host-to-host zero-copy tensor constructors (torch), the counterpart of
#: ``asarray``'s aliasing
_TORCH_ALIASING = frozenset({"from_numpy", "as_tensor"})
_STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "size", "aval",
                           "sharding", "weak_type"})
_JIT_NAMES = frozenset({"jit"})  # matched as name or attribute tail


def _name_of(expr: ast.AST) -> Optional[str]:
    """Final identifier of a Name or dotted Attribute chain."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _dotted_name(expr: ast.AST) -> Optional[str]:
    """Full dotted path of a Name/Attribute chain (``pool.caches``), or
    None when the base is computed (``f().x``, ``a[i].x``)."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        base = _dotted_name(expr.value)
        return f"{base}.{expr.attr}" if base is not None else None
    return None


def _is_jit_expr(expr: ast.AST) -> bool:
    """``jax.jit`` / ``jit`` / ``partial(jax.jit, ...)`` /
    ``jax.jit(...)`` (call form) / ``functools.partial(jit, ...)``."""
    if _name_of(expr) in _JIT_NAMES:
        return True
    if isinstance(expr, ast.Call):
        fn = _name_of(expr.func)
        if fn in _JIT_NAMES:
            return True
        if fn == "partial" and expr.args and _is_jit_expr(expr.args[0]):
            return True
    return False


def _is_shard_map_expr(expr: ast.AST) -> bool:
    if _name_of(expr) in ("shard_map", "pmap"):
        return True
    if isinstance(expr, ast.Call):
        return _name_of(expr.func) in ("shard_map", "pmap")
    return False


def _terminates(stmts: Sequence[ast.stmt]) -> bool:
    """Whether a suite unconditionally leaves the enclosing block."""
    return any(isinstance(s, (ast.Return, ast.Raise, ast.Break, ast.Continue))
               for s in stmts)


def _donate_positions(call: ast.Call) -> Tuple[int, ...]:
    """Literal ``donate_argnums`` positions of a jit call, or ()."""
    for kw in call.keywords:
        if kw.arg == "donate_argnums":
            try:
                v = ast.literal_eval(kw.value)
            except ValueError:
                continue
            if isinstance(v, int):
                return (v,)
            if isinstance(v, (tuple, list)):
                return tuple(int(i) for i in v if isinstance(i, int))
    return ()


@dataclass
class _Ctx:
    """Module-wide facts collected in one pre-pass."""
    registry: CollectiveRegistry
    jitted_value_names: Set[str]   # x = jax.jit(f) / partial(jax.jit, ...)
    jitted_def_names: Set[str]     # defs decorated with / passed to jit
    static_params: Dict[str, Set[str]]  # def name -> static_argnames
    donated_callables: Dict[str, Tuple[int, ...]]  # name -> donate_argnums


def _collect_ctx(tree: ast.Module, registry: CollectiveRegistry) -> _Ctx:
    jitted_values: Set[str] = set()
    jitted_defs: Set[str] = set()
    static_params: Dict[str, Set[str]] = {}
    donated: Dict[str, Tuple[int, ...]] = {}

    def static_names_from_call(call: ast.Call) -> Set[str]:
        out: Set[str] = set()
        for kw in call.keywords:
            if kw.arg == "static_argnames":
                try:
                    v = ast.literal_eval(kw.value)
                except ValueError:
                    continue
                out.update([v] if isinstance(v, str) else list(v))
        return out

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            statics: Set[str] = set()
            jitted = False
            for dec in node.decorator_list:
                if _is_jit_expr(dec) or _is_shard_map_expr(dec):
                    jitted = True
                    if isinstance(dec, ast.Call):
                        statics |= static_names_from_call(dec)
                        pos = _donate_positions(dec)
                        if pos:
                            donated[node.name] = pos
            if jitted:
                jitted_defs.add(node.name)
                static_params[node.name] = statics
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            # x = jax.jit(f)   |   x = partial(jax.jit, ...)(f)
            if _is_jit_expr(node.value.func) or _is_jit_expr(node.value):
                pos = _donate_positions(node.value)
                if not pos and isinstance(node.value.func, ast.Call):
                    # partial(jax.jit, donate_argnums=...)(f): the
                    # kwarg lives on the INNER partial call
                    pos = _donate_positions(node.value.func)
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        jitted_values.add(t.id)
                        if pos:
                            donated[t.id] = pos
        if isinstance(node, ast.Call) and (
                _is_jit_expr(node.func) or _is_shard_map_expr(node.func)):
            # jax.jit(step) / shard_map(body, mesh=...) — the named def
            # becomes a traced body even without a decorator.
            statics = static_names_from_call(node)
            for a in node.args[:1]:
                nm = _name_of(a)
                if nm:
                    jitted_defs.add(nm)
                    static_params.setdefault(nm, set()).update(statics)

    return _Ctx(registry=registry, jitted_value_names=jitted_values,
                jitted_def_names=jitted_defs, static_params=static_params,
                donated_callables=donated)


# --------------------------------------------------------------------------
# per-scope analysis
# --------------------------------------------------------------------------

class _Scope:
    """Analysis of ONE function body (or the module top level).

    Nested defs get their own _Scope; statement-linear rules do not
    descend into them (a nested def does not execute where it is
    defined), but expression-level rules scanning the current statement
    skip nested-def subtrees explicitly.
    """

    def __init__(self, ctx: _Ctx, node, qualname: str,
                 findings: List[Finding]):
        self.ctx = ctx
        self.node = node
        self.qualname = qualname
        self.findings = findings
        self.rank_tainted: Set[str] = set()
        self.key_state: Dict[str, str] = {}      # key name -> fresh|used
        self.aliased: Set[str] = set()           # asarray sources/results
        # torch.from_numpy / as_tensor sources/results, and whether this
        # scope starts a non_blocking copy (the async reader)
        self.torch_aliased: Set[str] = set()
        self.non_blocking_line: Optional[int] = None
        self.jit_args: Set[str] = set()          # names passed to jitted calls
        self.local_jitted: Set[str] = set(ctx.jitted_value_names)
        self.mutations: List[Tuple[str, int]] = []  # (name, line)
        self._emitted: Set[Tuple[str, int]] = set()
        # donate_argnums tracking: callable name -> donated positions,
        # live buffer name -> line of the donating call
        self.donating: Dict[str, Tuple[int, ...]] = dict(
            ctx.donated_callables)
        self.donated_bufs: Dict[str, int] = {}

    # ---- helpers ----
    def emit(self, rule: str, line: int, message: str) -> None:
        if (rule, line) in self._emitted:
            return
        self._emitted.add((rule, line))
        sev = AST_RULES[rule][0]
        self.findings.append(Finding(
            rule=rule, severity=sev, path="", line=line, message=message,
            context=self.qualname))

    def _exprs(self, node: ast.AST) -> Iterable[ast.AST]:
        """Walk an expression/statement subtree WITHOUT entering nested
        function/class definitions."""
        stack = [node]
        while stack:
            n = stack.pop()
            yield n
            for child in ast.iter_child_nodes(n):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef, ast.Lambda)):
                    continue
                stack.append(child)

    def _is_rank_expr(self, expr: ast.AST) -> bool:
        reg = self.ctx.registry
        for n in self._exprs(expr):
            if isinstance(n, ast.Attribute) and n.attr in reg.rank_attrs:
                return True
            if isinstance(n, ast.Call) and reg.is_rank_call(n):
                return True
            if isinstance(n, ast.Name) and n.id in self.rank_tainted:
                return True
        return False

    # ---- the linear walk ----
    def run(self) -> None:
        body = self.node.body
        self._walk_block(body, rank_guarded=None)

    def _walk_block(self, stmts: Sequence[ast.stmt],
                    rank_guarded: Optional[str]) -> None:
        """``rank_guarded`` carries the description of the innermost
        rank-dependent control context, or None when symmetric."""
        divergent: Optional[str] = None  # set after a rank-guarded early exit
        for st in stmts:
            guard = rank_guarded or divergent
            self._statement(st, guard)

            if isinstance(st, ast.If) and self._is_rank_expr(st.test):
                if _terminates(st.body) or _terminates(st.orelse):
                    divergent = divergent or (
                        f"after rank-dependent early exit at line {st.lineno}")

    def _statement(self, st: ast.stmt, guard: Optional[str]) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return  # nested defs are their own scopes (and don't run here)

        # -- rule: donated-buffer-reuse (reads BEFORE this statement's
        # own donations register, so the donating call's own args and a
        # rebinding `x = step(x, ...)` stay clean; names are full dotted
        # paths, so `pool.caches` — the serving cache-pool shape — is
        # tracked like a local) --
        if self.donated_bufs:
            for n in self._iter_own_exprs(st):
                if not (isinstance(n, (ast.Name, ast.Attribute))
                        and isinstance(n.ctx, ast.Load)):
                    continue
                dn = _dotted_name(n)
                if dn is None or dn not in self.donated_bufs:
                    continue
                don_line = self.donated_bufs.pop(dn)
                self.emit(
                    "donated-buffer-reuse", n.lineno,
                    f"`{dn}` was DONATED to the jitted call on line "
                    f"{don_line} (donate_argnums) and is read again — "
                    "the buffer may already be aliased to the output "
                    "(garbage on TPU, use-after-free semantics); "
                    "rebind the result (`x = step(x, ...)`) or pass a "
                    "copy (the serving cache-pool hazard class)")

        # -- rule: collective-deadlock (call sites) --
        if guard is not None:
            for call in self._iter_own_exprs(st):
                if isinstance(call, ast.Call) and \
                        self.ctx.registry.is_collective_call(call):
                    name = _name_of(call.func)
                    self.emit(
                        "collective-deadlock", call.lineno,
                        f"collective `{name}` executed {guard}: ranks that "
                        "skip it leave the gang waiting forever — hoist the "
                        "collective out of the rank-dependent path (guard "
                        "only the host-side work, e.g. printing/IO)")

        # expression-level rules on this statement (not nested blocks)
        for expr in self._iter_own_exprs(st):
            self._expression(expr, st)

        # track taints/aliases introduced by this statement
        self._track(st)

        # recurse into control-flow blocks — the incoming `guard` MUST
        # survive the descent: a collective wrapped in a plain loop/with/
        # try INSIDE a rank-guarded branch is still rank-guarded
        if isinstance(st, ast.If):
            g = (f"under the rank-dependent branch at line {st.lineno}"
                 if self._is_rank_expr(st.test) else guard)
            # donation state is branch-scoped: a call donating in one
            # branch must not flag a read in the mutually-exclusive
            # other branch; after the If, a donation from EITHER branch
            # stays live (either may have executed) — UNLESS that branch
            # terminates (return/raise/break/continue), in which case
            # control past the If can only have come through the other
            # path and the terminated branch's donations are unreachable
            snap = dict(self.donated_bufs)
            self._walk_block(st.body, g)
            after_body = self.donated_bufs
            self.donated_bufs = dict(snap)
            self._walk_block(st.orelse, g)
            after_else = self.donated_bufs
            if _terminates(st.body):
                merged = after_else
            elif _terminates(st.orelse):
                merged = after_body
            else:
                merged = dict(after_else)
                merged.update(after_body)
            self.donated_bufs = merged
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            g = guard
            if self._is_rank_expr(st.iter):
                g = (f"inside a loop with rank-dependent trip count "
                     f"(line {st.lineno})")
            # loop bodies run twice: key reuse across iterations surfaces
            self._walk_block(st.body, g)
            self._walk_block(st.body, g)
            self._walk_block(st.orelse, guard)
        elif isinstance(st, ast.While):
            g = guard
            if self._is_rank_expr(st.test):
                g = (f"inside a while-loop with rank-dependent condition "
                     f"(line {st.lineno})")
            self._walk_block(st.body, g)
            self._walk_block(st.body, g)
            self._walk_block(st.orelse, guard)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            self._walk_block(st.body, guard)
        elif isinstance(st, ast.Try):
            self._walk_block(st.body, guard)
            for h in st.handlers:
                self._walk_block(h.body, guard)
            self._walk_block(st.orelse, guard)
            self._walk_block(st.finalbody, guard)

    def _iter_own_exprs(self, st: ast.stmt) -> Iterable[ast.AST]:
        """Expressions belonging to THIS statement only — for compound
        statements, the header (test/iter/targets), not the body."""
        if isinstance(st, ast.If) or isinstance(st, ast.While):
            yield from self._exprs(st.test)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            yield from self._exprs(st.iter)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                yield from self._exprs(item.context_expr)
        elif isinstance(st, ast.Try):
            return
        else:
            yield from self._exprs(st)

    # ---- expression-level rules ----
    def _expression(self, n: ast.AST, st: ast.stmt) -> None:
        if not isinstance(n, ast.Call):
            return
        fname = _name_of(n.func)

        # -- rule: prng-constant-key --
        if fname == "PRNGKey" or (
                fname == "key" and isinstance(n.func, ast.Attribute)
                and _name_of(n.func.value) == "random"):
            if n.args and isinstance(n.args[0], ast.Constant) and \
                    isinstance(n.args[0].value, (int, bool)):
                self.emit(
                    "prng-constant-key", n.lineno,
                    f"`{fname}({n.args[0].value!r})` builds a process-"
                    "constant key: every run (and every rank) draws the "
                    "SAME randomness — derive the seed from a CLI "
                    "flag/config, and fold in the step/rank for per-call "
                    "freshness (the serving sampling trap)")
        # torch.manual_seed(0) / torch.cuda.manual_seed(0) /
        # torch.Generator().manual_seed(0): the same trap in torch
        if fname == "manual_seed":
            seed = n.args[0] if n.args else next(
                (kw.value for kw in n.keywords if kw.arg == "seed"), None)
            if isinstance(seed, ast.Constant) and \
                    isinstance(seed.value, (int, bool)):
                self.emit(
                    "prng-constant-key", n.lineno,
                    f"`manual_seed({seed.value!r})` seeds a process-"
                    "constant generator: every run (and every rank) draws "
                    "the SAME randomness — derive the seed from a CLI "
                    "flag/config")

        # -- rule: prng-key-reuse --
        if fname in _PRNG_CONSUMERS and self._in_random_ns(n.func):
            if n.args and isinstance(n.args[0], ast.Name):
                key = n.args[0].id
                state = self.key_state.get(key)
                if state == "used":
                    self.emit(
                        "prng-key-reuse", n.lineno,
                        f"key `{key}` already consumed by an earlier "
                        "sampling call in this scope — both calls draw "
                        "IDENTICAL values; `split` (or `fold_in`) the "
                        "key between uses")
                else:
                    self.key_state[key] = "used"

    @staticmethod
    def _in_random_ns(func: ast.AST) -> bool:
        """``jax.random.normal`` / ``random.normal`` / ``prng.uniform`` /
        bare ``normal`` (assume a from-import when the name is that
        distinctive)."""
        if isinstance(func, ast.Attribute):
            return _name_of(func.value) in _PRNG_NAMESPACES
        return True

    # ---- state tracking ----
    def _track(self, st: ast.stmt) -> None:
        reg = self.ctx.registry

        def taint_targets(targets, value):
            names = [t.id for t in targets if isinstance(t, ast.Name)]
            if not names:
                return
            if self._is_rank_expr(value):
                self.rank_tainted.update(names)
            else:
                self.rank_tainted.difference_update(names)

        if isinstance(st, ast.Assign):
            taint_targets(st.targets, st.value)
            self._track_assign_value(st.targets, st.value)
        elif isinstance(st, ast.AnnAssign) and st.value is not None:
            taint_targets([st.target], st.value)
            self._track_assign_value([st.target], st.value)
        elif isinstance(st, ast.AugAssign):
            self._record_mutation(st.target, st)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            if self._is_rank_expr(st.iter) and isinstance(st.target, ast.Name):
                self.rank_tainted.add(st.target.id)

        # subscript stores: buf[i] = v
        if isinstance(st, ast.Assign):
            for t in st.targets:
                if isinstance(t, ast.Subscript):
                    self._record_mutation(t, st)

        # scan every expression of this statement for alias/jit-arg facts
        for n in self._iter_own_exprs(st):
            if not isinstance(n, ast.Call):
                continue
            fname = _name_of(n.func)
            if fname == "asarray":
                for a in n.args[:1]:
                    if isinstance(a, ast.Name):
                        self.aliased.add(a.id)
            if fname in _TORCH_ALIASING and not any(
                    kw.arg == "device" for kw in n.keywords):
                for a in n.args[:1]:
                    if isinstance(a, ast.Name):
                        self.torch_aliased.add(a.id)
            if any(kw.arg == "non_blocking"
                   and isinstance(kw.value, ast.Constant)
                   and kw.value.value is True for kw in n.keywords):
                if self.non_blocking_line is None:
                    self.non_blocking_line = n.lineno
            callee = _name_of(n.func)
            if callee and (callee in self.local_jitted
                           or callee in self.ctx.jitted_def_names):
                for a in list(n.args) + [kw.value for kw in n.keywords]:
                    if isinstance(a, ast.Name):
                        self.jit_args.add(a.id)

        # donate_argnums bookkeeping — donations from this statement's
        # calls register FIRST, then assignment targets clear, so the
        # canonical `params, opt = step(params, opt, b)` rebinding
        # consumes its own donation within one statement
        for n in self._iter_own_exprs(st):
            if isinstance(n, ast.Call):
                callee = _name_of(n.func)
                pos = self.donating.get(callee) if callee else None
                if pos:
                    for i in pos:
                        if i >= len(n.args):
                            continue
                        dn = _dotted_name(n.args[i])
                        if dn is not None:
                            self.donated_bufs[dn] = st.lineno
        rebind_targets: List[ast.AST] = []
        if isinstance(st, ast.Assign):
            rebind_targets = list(st.targets)
        elif isinstance(st, (ast.AnnAssign, ast.AugAssign)):
            rebind_targets = [st.target]
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            rebind_targets = [st.target]
        for t in rebind_targets:
            els = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
            for el in els:
                dn = _dotted_name(el)
                if dn is None:
                    continue
                # rebinding clears the path AND everything under it —
                # `pool = fresh_pool()` revives `pool.caches` too
                for k in [k for k in self.donated_bufs
                          if k == dn or k.startswith(dn + ".")]:
                    self.donated_bufs.pop(k, None)

        self._check_mutations()

    def _track_assign_value(self, targets, value) -> None:
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        # y = np.asarray(x): y may be a VIEW of x — mutating y mutates x
        if isinstance(value, ast.Call) and _name_of(value.func) == "asarray":
            self.aliased.update(names)
        # t = torch.from_numpy(buf): t shares buf's memory
        if isinstance(value, ast.Call) and \
                _name_of(value.func) in _TORCH_ALIASING and not any(
                    kw.arg == "device" for kw in value.keywords):
            self.torch_aliased.update(names)
        # k = jax.random.split(key) / fold_in: fresh keys
        if isinstance(value, ast.Call) and \
                _name_of(value.func) in _PRNG_DERIVERS:
            for nm in names:
                self.key_state[nm] = "fresh"
            # tuple-unpack targets too: k1, k2 = split(key)
            for t in targets:
                if isinstance(t, (ast.Tuple, ast.List)):
                    for el in t.elts:
                        if isinstance(el, ast.Name):
                            self.key_state[el.id] = "fresh"
        elif names:
            for nm in names:
                self.key_state[nm] = "fresh"
        # x = jax.jit(f) inside a function scope
        if isinstance(value, ast.Call) and (_is_jit_expr(value.func)
                                            or _is_jit_expr(value)):
            self.local_jitted.update(names)

    def _record_mutation(self, target: ast.AST, st: ast.stmt) -> None:
        base = target
        while isinstance(base, ast.Subscript):
            base = base.value
        nm = _name_of(base)
        if nm:
            self.mutations.append((nm, st.lineno))

    def _check_mutations(self) -> None:
        """Scope-wide (order-insensitive — loops interleave the two sides):
        a name that is both asarray-aliased and mutated, or both passed to
        a jitted call and mutated, is a race."""
        for nm, line in self.mutations:
            if nm in self.aliased:
                self.emit(
                    "host-alias-race", line,
                    f"`{nm}` flows through `asarray` (zero-copy on CPU: the "
                    "device array may ALIAS this buffer) and is mutated in "
                    "place — async dispatch can read the mutated bytes "
                    "(the serving pos-vector race); mutate a `.copy()` "
                    "or re-materialize the device array after the write")
            if nm in self.torch_aliased and \
                    self.non_blocking_line is not None:
                self.emit(
                    "host-alias-race", line,
                    f"`{nm}` flows through `torch.from_numpy`/`as_tensor` "
                    "(zero-copy: the tensor SHARES this buffer) and is "
                    "mutated in place while the `non_blocking=True` copy "
                    f"on line {self.non_blocking_line} may still be "
                    "reading it (the serving pos-vector race); copy at "
                    "the boundary (`torch.tensor(buf)`) or synchronize "
                    "before the write")
            if nm in self.jit_args:
                self.emit(
                    "inplace-jit-mutation", line,
                    f"`{nm}` is passed to a jitted callable and mutated in "
                    "place in the same scope — with donation or zero-copy "
                    "the compiled program may still alias the buffer when "
                    "the mutation lands; pass a copy or make the update "
                    "functional")


# --------------------------------------------------------------------------
# traced-control-flow (per jitted def, separate small pass)
# --------------------------------------------------------------------------

def _check_traced_control_flow(ctx: _Ctx, fn_node, qualname: str,
                               findings: List[Finding]) -> None:
    name = fn_node.name
    if name not in ctx.jitted_def_names:
        return
    statics = ctx.static_params.get(name, set())
    params = {a.arg for a in (fn_node.args.posonlyargs + fn_node.args.args
                              + fn_node.args.kwonlyargs)} - statics - {"self"}
    if not params:
        return

    def dynamic_refs(test: ast.AST) -> List[ast.Name]:
        static_bases: Set[int] = set()
        for n in ast.walk(test):
            if isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
                for sub in ast.walk(n.value):
                    static_bases.add(id(sub))
            elif isinstance(n, ast.Call) and \
                    _name_of(n.func) in ("len", "isinstance", "getattr",
                                         "hasattr", "type"):
                for a in n.args:
                    for sub in ast.walk(a):
                        static_bases.add(id(sub))
            elif isinstance(n, ast.Compare) and any(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops):
                for sub in ast.walk(n):
                    static_bases.add(id(sub))
        return [n for n in ast.walk(test)
                if isinstance(n, ast.Name) and n.id in params
                and id(n) not in static_bases]

    for node in ast.walk(fn_node):
        if isinstance(node, (ast.If, ast.While)) or \
                isinstance(node, ast.IfExp):
            refs = dynamic_refs(node.test)
            if refs:
                kind = "while" if isinstance(node, ast.While) else "if"
                sev_names = ", ".join(sorted({r.id for r in refs}))
                findings.append(Finding(
                    rule="traced-control-flow",
                    severity=AST_RULES["traced-control-flow"][0],
                    path="", line=node.test.lineno,
                    message=(
                        f"Python `{kind}` on traced value(s) `{sev_names}` "
                        f"inside jitted `{name}` — the branch is taken at "
                        "TRACE time (TracerBoolConversionError, or silent "
                        "specialization); use `lax.cond`/`lax.select`/"
                        "`lax.while_loop`, or declare the argument in "
                        "`static_argnames`"),
                    context=qualname))


# --------------------------------------------------------------------------
# mismatched-shard-specs (per scope, separate small pass)
# --------------------------------------------------------------------------

#: ops whose result is reduced/replicated over the named axis — an
#: out_spec that SHARDS the result over that same axis contradicts the
#: body (shard_map's replication checker rejects it at run time; this
#: catches it at lint time, jax-free).
_REDUCING_OPS = frozenset({
    "psum", "pmean", "pmax", "pmin", "pmean_if_bound", "all_gather",
    "bcast", "quantized_ring_pmean", "hierarchical_pmean",
})


def _mesh_literal_axes(call: ast.Call) -> Optional[Set[str]]:
    """Axis names of a mesh-constructing call, when they are literals:
    ``make_nd_mesh(("a", "b"), ...)``, ``make_mesh(axis_name="x")``,
    ``Mesh(devs, ("a",))``.  None = not resolvable (stay silent)."""
    fname = _name_of(call.func)

    def str_literals(expr) -> Optional[Set[str]]:
        try:
            v = ast.literal_eval(expr)
        except (ValueError, SyntaxError):
            return None
        if isinstance(v, str):
            return {v}
        if isinstance(v, (tuple, list)) and all(
                isinstance(x, str) for x in v):
            return set(v)
        return None

    if fname == "make_nd_mesh" and call.args:
        return str_literals(call.args[0])
    if fname == "make_mesh":
        for kw in call.keywords:
            if kw.arg == "axis_name":
                return str_literals(kw.value)
        return None
    if fname == "Mesh":
        if len(call.args) >= 2:
            return str_literals(call.args[1])
        for kw in call.keywords:
            if kw.arg == "axis_names":
                return str_literals(kw.value)
    return None


def _pspec_axes(expr: ast.AST) -> Set[str]:
    """Axis-name string literals inside any ``P(...)``/``PartitionSpec``
    call of an (in|out)_specs expression."""
    out: Set[str] = set()
    for n in ast.walk(expr):
        if isinstance(n, ast.Call) and _name_of(n.func) in (
                "P", "PartitionSpec"):
            for a in n.args:
                for sub in ast.walk(a):
                    if isinstance(sub, ast.Constant) and \
                            isinstance(sub.value, str):
                        out.add(sub.value)
    return out


def _collective_axis_literals_of_call(call: ast.Call) -> Set[str]:
    """Literal axis names ONE collective call names: the ``axis_name=``
    (or hierarchical ``chip_axis=``/``slice_axis=``) keyword, or any
    positional string literal (``psum(x, "mn")``).  Non-literal axes
    resolve to nothing — the rule only argues from positive evidence."""
    axes: Set[str] = set()
    for kw in call.keywords:
        if kw.arg in ("axis_name", "chip_axis", "slice_axis") and \
                isinstance(kw.value, ast.Constant) and \
                isinstance(kw.value.value, str):
            axes.add(kw.value.value)
    for a in call.args:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            axes.add(a.value)
    return axes


def _collective_axis_literals(fn_node, registry: CollectiveRegistry
                              ) -> Set[str]:
    """Union of :func:`_collective_axis_literals_of_call` over every
    collective call in a body function."""
    axes: Set[str] = set()
    for n in ast.walk(fn_node):
        if isinstance(n, ast.Call) and registry.is_collective_call(n):
            axes |= _collective_axis_literals_of_call(n)
    return axes


def _check_shard_specs(ctx: _Ctx, scope_node, qualname: str,
                       findings: List[Finding]) -> None:
    """Two inconsistency shapes at a ``shard_map(...)`` call site, argued
    only from same-scope literals (no cross-module resolution — silence
    over speculation):

    * the body's collectives name a LITERAL axis absent from the mesh
      whose axis names are resolvable in this scope — the compiled gang
      would raise (or bind the wrong axis) at run time;
    * the body RETURNS a reducing collective over axis ``a`` (result
      replicated over ``a``) while ``out_specs`` shards over ``a`` —
      shard_map's replication checker rejects exactly this, but only
      once jax runs.
    """
    body = getattr(scope_node, "body", [])
    local_defs: Dict[str, ast.AST] = {}
    mesh_axes_of: Dict[str, Set[str]] = {}
    for st in body:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            local_defs[st.name] = st
        if isinstance(st, ast.Assign) and isinstance(st.value, ast.Call):
            ax = _mesh_literal_axes(st.value)
            if ax:
                for t in st.targets:
                    if isinstance(t, ast.Name):
                        mesh_axes_of[t.id] = ax

    # shard_map calls belonging to THIS scope (not nested defs)
    stack: List[ast.AST] = list(body)
    calls: List[ast.Call] = []
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        if isinstance(n, ast.Call) and _is_shard_map_expr(n.func):
            calls.append(n)
        stack.extend(ast.iter_child_nodes(n))

    for call in calls:
        if not call.args:
            continue
        # resolve the body: a same-scope def, possibly through
        # partial(fn, axis_name="x")
        first = call.args[0]
        partial_axes: Set[str] = set()
        if isinstance(first, ast.Call) and _name_of(first.func) == "partial":
            for kw in first.keywords:
                if kw.arg == "axis_name" and \
                        isinstance(kw.value, ast.Constant) and \
                        isinstance(kw.value.value, str):
                    partial_axes.add(kw.value.value)
            first = first.args[0] if first.args else first
        body_def = local_defs.get(_name_of(first) or "")

        mesh_axes: Optional[Set[str]] = None
        out_specs_expr = None
        for kw in call.keywords:
            if kw.arg == "mesh":
                if isinstance(kw.value, ast.Name):
                    mesh_axes = mesh_axes_of.get(kw.value.id)
                elif isinstance(kw.value, ast.Call):
                    mesh_axes = _mesh_literal_axes(kw.value)
            elif kw.arg == "out_specs":
                out_specs_expr = kw.value

        body_axes: Set[str] = set(partial_axes)
        if body_def is not None:
            body_axes |= _collective_axis_literals(body_def, ctx.registry)

        if mesh_axes and body_axes:
            stray = sorted(body_axes - mesh_axes)
            if stray:
                findings.append(Finding(
                    rule="mismatched-shard-specs",
                    severity=AST_RULES["mismatched-shard-specs"][0],
                    path="", line=call.lineno,
                    message=(
                        f"shard_map body reduces over axis "
                        f"{stray} but the mesh built in this scope only "
                        f"binds {sorted(mesh_axes)} — the collective "
                        "would hit an unbound (or wrong) axis at run "
                        "time; make the body's axis_name and the mesh "
                        "agree"),
                    context=qualname))

        if body_def is not None and out_specs_expr is not None:
            out_axes = _pspec_axes(out_specs_expr)
            if out_axes:
                for ret in ast.walk(body_def):
                    if not (isinstance(ret, ast.Return)
                            and isinstance(ret.value, ast.Call)):
                        continue
                    rcall = ret.value
                    rname = _name_of(rcall.func)
                    if rname not in _REDUCING_OPS:
                        continue
                    raxes = _collective_axis_literals_of_call(rcall)
                    clash = sorted(raxes & out_axes)
                    if clash:
                        findings.append(Finding(
                            rule="mismatched-shard-specs",
                            severity=AST_RULES["mismatched-shard-specs"][0],
                            path="", line=call.lineno,
                            message=(
                                f"the body returns `{rname}` over axis "
                                f"{clash} — a value REPLICATED over that "
                                "axis — but out_specs shards the output "
                                f"over {clash}: each rank would keep only "
                                "a slice of an identical value (and the "
                                "replication checker rejects it); use "
                                "P() for reduced outputs, or drop the "
                                "reduction"),
                            context=qualname))


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def _iter_scopes(tree: ast.Module):
    """Yield (node, qualname) for the module and every def, tracking the
    enclosing chain."""
    yield tree, "<module>"

    def rec(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}.{child.name}" if prefix else child.name
                yield child, q
                yield from rec(child, q)
            elif isinstance(child, ast.ClassDef):
                q = f"{prefix}.{child.name}" if prefix else child.name
                yield from rec(child, q)
            else:
                yield from rec(child, prefix)

    yield from rec(tree, "")


def analyze_source(source: str, path: str,
                   registry: Optional[CollectiveRegistry] = None,
                   rules: Optional[Sequence[str]] = None) -> List[Finding]:
    registry = registry or default_registry()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rule="parse-error", severity="error", path=path,
                        line=e.lineno or 0,
                        message=f"file does not parse: {e.msg}")]
    ctx = _collect_ctx(tree, registry)
    findings: List[Finding] = []
    for node, qualname in _iter_scopes(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _Scope(ctx, node, qualname, findings).run()
            _check_traced_control_flow(ctx, node, qualname, findings)
        else:
            _Scope(ctx, node, qualname, findings).run()
        _check_shard_specs(ctx, node, qualname, findings)

    lines = source.splitlines()
    sup = Suppressions(source)
    out = []
    wanted = set(rules) if rules else None
    for f in findings:
        # parse-error bypasses the rule filter: "this file could not be
        # analyzed at all" must never read as "clean under rule X"
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
                 registry: Optional[CollectiveRegistry] = None,
                 rules: Optional[Sequence[str]] = None) -> List[Finding]:
    with open(path) as fh:
        source = fh.read()
    return analyze_source(source, path, registry=registry, rules=rules)


_DEFAULT_EXCLUDES = ("__pycache__", ".git", "build", "dist", ".eggs")


def analyze_paths(paths: Sequence[str],
                  registry: Optional[CollectiveRegistry] = None,
                  rules: Optional[Sequence[str]] = None,
                  exclude: Sequence[str] = _DEFAULT_EXCLUDES
                  ) -> List[Finding]:
    registry = registry or default_registry()
    files: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames if d not in exclude]
            files.extend(os.path.join(dirpath, f)
                         for f in sorted(filenames) if f.endswith(".py"))
    findings: List[Finding] = []
    for f in sorted(set(files)):
        findings.extend(analyze_file(f, registry=registry, rules=rules))
    return findings

"""Exhaustive-interleaving model checker for the fleet's protocols.

The static lint (``concurrency.py``) argues about lock *shapes*; this
module argues about protocol *state spaces*.  Each load-bearing
concurrent machine in the serving/health plane is modeled as a small
explicit-state transition system — every nondeterministic scheduling
choice (a thread interleaving, a message delay, a SIGKILL) is a
transition — and the checker walks EVERY reachable state (BFS, so a
violation comes back with a minimal counterexample trace).  Exhaustive
exploration up to the model's bounded parameters replaces "we reviewed
the interleavings by hand", which is how the ~25 PR 10-13 races
shipped in the first place.

Three models, three invariants (docs/ANALYSIS.md has the table):

* :func:`make_done_xor_shed_model` — request ownership across submit
  threads, worker death, supervisor failover, and the shed path
  (``FleetRouter``).  Invariant: every accepted request reaches
  EXACTLY one terminal outcome (done XOR shed), never both, never
  neither (no forever-hang) — over every interleaving of dispatch,
  death, detection, redispatch, and late result delivery.
* :func:`make_lease_fence_model` — lease/epoch zombie fencing under
  SIGSTOP/SIGKILL/readmission schedules (``EpochFence`` +
  supervisor).  Invariant: a fenced writer's artifact NEVER lands —
  any write produced after the fence and before a fresh-epoch hello is
  refused on every delivery schedule.
* :func:`make_slot_model` — the ``SlotAllocator``
  free→reserved→busy→cached(rc)→free lifecycle.  Invariant: the slot
  partition is exact (free ∪ busy ∪ cached ∪ reserved = all slots,
  pairwise disjoint — no leak, no alias) after every legal operation
  sequence.

A copy of ``chainermn_tpu/analysis/protocol.py``: the port's runtime
conformance monitor (``observability/conform.py``) replays the port's
journals through these models, and ``tests/test_torch_conform.py``
holds its reports to the JAX package's on the same journals, mutated
models included.

Pure stdlib; states are hashable namedtuples, transitions are pure
functions.  ``python -m chainermn_tpu_torch.analysis.protocol`` runs all
three models and exits 0/1/2 (the lint contract).
"""

from __future__ import annotations

from collections import deque, namedtuple
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Transition", "Model", "CheckResult", "check", "reachable_graph",
    "path_to", "make_done_xor_shed_model", "make_lease_fence_model",
    "make_slot_model", "ALL_MODELS", "main",
]


@dataclass(frozen=True)
class Transition:
    """One atomic step of one actor: enabled when ``guard(state)`` and
    rewriting the state via the pure ``apply(state)``."""
    name: str
    guard: Callable
    apply: Callable


@dataclass
class Model:
    name: str
    initial: tuple
    transitions: List[Transition]
    #: state predicate: None = holds, else a violation description.
    invariant: Callable[[tuple], Optional[str]]
    #: checked on states with NO enabled transition (complete
    #: schedules); None = nothing to assert at quiescence.
    terminal_invariant: Optional[Callable[[tuple],
                                          Optional[str]]] = None

    def replace(self, name: str, *, guard=None,
                apply=None) -> "Model":
        """A copy with one transition's guard/apply swapped — the
        mutation-injection hook (tests break a transition and assert
        the checker notices)."""
        out: List[Transition] = []
        hit = False
        for t in self.transitions:
            if t.name == name:
                hit = True
                out.append(Transition(
                    t.name, guard or t.guard, apply or t.apply))
            else:
                out.append(t)
        if not hit:
            raise KeyError(f"no transition named {name!r} in "
                           f"{self.name}; have "
                           f"{[t.name for t in self.transitions]}")
        return Model(self.name, self.initial, out, self.invariant,
                     self.terminal_invariant)


@dataclass
class CheckResult:
    ok: bool
    model: str
    n_states: int = 0
    n_edges: int = 0
    n_terminal: int = 0
    #: every reachable state expanded within the bounds (False = the
    #: depth/state cap truncated the walk: "counterexample-free" then
    #: only means "up to the bound")
    complete: bool = True
    violation: Optional[str] = None
    #: minimal trace to the violating state: [(transition name, state)]
    counterexample: List[Tuple[str, tuple]] = field(
        default_factory=list)

    def render(self) -> str:
        head = (f"{self.model}: "
                + ("OK" if self.ok else f"VIOLATION: {self.violation}")
                + f" ({self.n_states} states, {self.n_edges} edges, "
                  f"{self.n_terminal} terminal"
                + ("" if self.complete else ", TRUNCATED") + ")")
        if self.ok:
            return head
        lines = [head, "  counterexample (minimal):"]
        for i, (t, s) in enumerate(self.counterexample, 1):
            lines.append(f"    {i:2d}. {t:36s} -> {s}")
        return "\n".join(lines)


def path_to(parents: Dict[tuple, Optional[Tuple[tuple, str]]],
            state: tuple) -> List[Tuple[str, tuple]]:
    out: List[Tuple[str, tuple]] = []
    while parents[state] is not None:
        prev, tname = parents[state]
        out.append((tname, state))
        state = prev
    out.reverse()
    return out


def check(model: Model, max_depth: int = 10 ** 9,
          max_states: int = 500_000) -> CheckResult:
    """BFS over every reachable state.  BFS (not DFS) so the first
    invariant violation found is at minimal depth — the counterexample
    is a shortest trace, which is what a human debugging the protocol
    wants to read."""
    parents: Dict[tuple, Optional[Tuple[tuple, str]]] = {
        model.initial: None}
    depth = {model.initial: 0}
    q = deque([model.initial])
    n_edges = 0
    n_terminal = 0
    complete = True

    v = model.invariant(model.initial)
    if v:
        return CheckResult(False, model.name, 1, 0, 0, True,
                           f"initial state: {v}", [])

    n_states = 0
    while q:
        s = q.popleft()
        n_states += 1
        enabled = [t for t in model.transitions if t.guard(s)]
        if not enabled:
            n_terminal += 1
            if model.terminal_invariant is not None:
                v = model.terminal_invariant(s)
                if v:
                    return CheckResult(
                        False, model.name, n_states, n_edges,
                        n_terminal, complete,
                        f"terminal state: {v}",
                        path_to(parents, s))
            continue
        if depth[s] >= max_depth:
            complete = False
            continue
        for t in enabled:
            ns = t.apply(s)
            n_edges += 1
            if ns in parents:
                continue
            parents[ns] = (s, t.name)
            depth[ns] = depth[s] + 1
            v = model.invariant(ns)
            if v:
                return CheckResult(
                    False, model.name, n_states, n_edges, n_terminal,
                    complete, v, path_to(parents, ns))
            if len(parents) > max_states:
                return CheckResult(
                    True, model.name, n_states, n_edges, n_terminal,
                    False, None, [])
            q.append(ns)
    return CheckResult(True, model.name, n_states, n_edges, n_terminal,
                       complete, None, [])


def reachable_graph(model: Model, max_states: int = 500_000
                    ) -> Dict[tuple, List[Tuple[str, tuple]]]:
    """state -> [(transition name, next state)] over the reachable
    space, plus (via :func:`path_to`-style BFS parents baked into the
    insertion order) — the conformance tests walk this to replay every
    reachable edge through the real implementation."""
    graph: Dict[tuple, List[Tuple[str, tuple]]] = {}
    q = deque([model.initial])
    graph[model.initial] = []
    order = [model.initial]
    while q:
        s = q.popleft()
        for t in model.transitions:
            if not t.guard(s):
                continue
            ns = t.apply(s)
            graph[s].append((t.name, ns))
            if ns not in graph:
                graph[ns] = []
                order.append(ns)
                if len(graph) > max_states:
                    raise RuntimeError("state space exceeds max_states")
                q.append(ns)
    return graph


def bfs_paths(model: Model) -> Dict[tuple, List[Tuple[str, tuple]]]:
    """state -> one minimal trace reaching it (transition/state pairs
    from the initial state)."""
    parents: Dict[tuple, Optional[Tuple[tuple, str]]] = {
        model.initial: None}
    q = deque([model.initial])
    while q:
        s = q.popleft()
        for t in model.transitions:
            if t.guard(s):
                ns = t.apply(s)
                if ns not in parents:
                    parents[ns] = (s, t.name)
                    q.append(ns)
    return {s: path_to(parents, s) for s in parents}


# ==========================================================================
# model 1: done-XOR-shed request ownership (FleetRouter)
# ==========================================================================

#: has_req[i] is the dispatch ATTEMPT number sitting in worker i's
#: queue (None = nothing): a result message carries the attempt it was
#: produced under, and the router accepts a result only from the
#: CURRENT owner at the CURRENT attempt — the orphan-drop rule that
#: closes the late-result/failover TOCTOU (PR 10 review round).
DxsState = namedtuple("DxsState", [
    "registered",   # submit registered the entry
    "owner",        # current owning worker index (or None)
    "attempts",     # dispatch attempts so far
    "alive",        # tuple[bool] — process truly alive
    "detected",     # tuple[bool] — supervisor marked it dead
    "has_req",      # tuple[Optional[int]] — queued dispatch attempt
    "results",      # frozenset[(worker, attempt)] — in-flight results
    "done",         # terminal done count (must stay <= 1)
    "shed",         # terminal shed count (must stay <= 1)
    "returned",     # a LIVE owner gave the request back (queue_full)
])


def make_done_xor_shed_model(n_workers: int = 2,
                             max_attempts: int = 2) -> Model:
    """Submit vs worker death vs supervisor failover vs shed.

    Nondeterminism modeled: submit's liveness snapshot is STALE (it may
    dispatch to a dead-but-undetected worker — the submit/_mark_dead
    TOCTOU), workers die at any point, results survive their producer
    (the lane store persists a published result), detection and
    failover interleave with delivery.
    """
    W = range(n_workers)

    def st(**kw):
        base = dict(
            registered=False, owner=None, attempts=0,
            alive=tuple(True for _ in W),
            detected=tuple(False for _ in W),
            has_req=tuple(None for _ in W),
            results=frozenset(), done=0, shed=0, returned=False)
        base.update(kw)
        return DxsState(**base)

    def tup_set(t, i, v):
        lst = list(t)
        lst[i] = v
        return tuple(lst)

    ts: List[Transition] = []

    # submit: dispatch to ANY not-yet-detected worker (stale snapshot:
    # an undetected corpse is a legal target — the TOCTOU under test)
    for w in W:
        ts.append(Transition(
            f"submit(->w{w})",
            lambda s, w=w: not s.registered and not s.detected[w],
            lambda s, w=w: s._replace(
                registered=True, owner=w, attempts=1,
                has_req=tup_set(s.has_req, w, 1))))
    ts.append(Transition(
        "submit(reject:no_live_worker)",
        lambda s: not s.registered and all(s.detected),
        lambda s: s._replace(registered=True, shed=s.shed + 1)))

    for w in W:
        ts.append(Transition(
            f"worker{w}.produce_result",
            lambda s, w=w: s.alive[w] and s.has_req[w] is not None,
            lambda s, w=w: s._replace(
                has_req=tup_set(s.has_req, w, None),
                results=s.results | {(w, s.has_req[w])})))
        ts.append(Transition(
            f"worker{w}.dies",
            lambda s, w=w: s.alive[w],
            lambda s, w=w: s._replace(alive=tup_set(s.alive, w, False))))
        ts.append(Transition(
            f"supervisor.detect(w{w})",
            lambda s, w=w: not s.alive[w] and not s.detected[w],
            lambda s, w=w: s._replace(
                detected=tup_set(s.detected, w, True))))
        # give-back: a LIVE owner sheds the dispatched request back to
        # the router (worker-side queue_full backpressure) — ownership
        # returns WITHOUT a death, and the router may then re-dispatch
        # or shed (the scenario plane's burst workloads drive this)
        ts.append(Transition(
            f"worker{w}.give_back",
            lambda s, w=w: (
                s.registered and s.done + s.shed == 0
                and s.alive[w] and s.owner == w
                and s.has_req[w] is not None),
            lambda s, w=w: s._replace(
                has_req=tup_set(s.has_req, w, None), returned=True)))

    # failover: the supervisor owns re-dispatch (mark_dead loop + the
    # orphan sweep both funnel here) — enabled whenever the current
    # owner is detected dead OR gave the request back, and the entry
    # has no outcome yet
    for w in W:
        for v in W:
            if v == w:
                continue
            ts.append(Transition(
                f"supervisor.failover(w{w}->w{v})",
                lambda s, w=w, v=v: (
                    s.registered and s.done + s.shed == 0
                    and s.owner == w
                    and (s.detected[w] or s.returned)
                    and s.attempts < max_attempts
                    and not s.detected[v]),
                lambda s, w=w, v=v: s._replace(
                    owner=v, attempts=s.attempts + 1, returned=False,
                    has_req=tup_set(s.has_req, v, s.attempts + 1))))
        ts.append(Transition(
            f"supervisor.shed(w{w})",
            lambda s, w=w: (
                s.registered and s.done + s.shed == 0
                and s.owner == w
                and (s.detected[w] or s.returned)
                and (s.attempts >= max_attempts
                     or all(s.detected[v] for v in W if v != w))),
            lambda s, w=w: s._replace(shed=s.shed + 1)))

    for w in W:
        for att in range(1, max_attempts + 1):
            ts.append(Transition(
                f"router.deliver_result(w{w},att{att})",
                lambda s, w=w, att=att: (w, att) in s.results,
                lambda s, w=w, att=att: s._replace(
                    results=s.results - {(w, att)},
                    done=(s.done + 1
                          if (s.done + s.shed == 0 and s.owner == w
                              and s.attempts == att)
                          else s.done))))

    def invariant(s: DxsState) -> Optional[str]:
        if s.done > 1:
            return f"request completed TWICE (done={s.done})"
        if s.shed > 1:
            return f"request shed TWICE (shed={s.shed})"
        if s.done + s.shed > 1:
            return ("request both done AND shed "
                    f"(done={s.done}, shed={s.shed})")
        return None

    def terminal_invariant(s: DxsState) -> Optional[str]:
        if s.registered and s.done + s.shed != 1:
            return ("accepted request reached quiescence with NO "
                    "terminal outcome (forever-hang): "
                    f"done={s.done}, shed={s.shed}, owner=w{s.owner}")
        return None

    return Model("done_xor_shed", st(), ts, invariant,
                 terminal_invariant)


# ==========================================================================
# model 2: lease/epoch zombie fencing (EpochFence + supervisor)
# ==========================================================================

LeaseState = namedtuple("LeaseState", [
    "worker_epoch",    # the epoch the worker stamps writes with
    "current_epoch",   # the fence's current epoch for this worker
    "fenced",          # fence flag on current_epoch
    "running",         # False = SIGSTOP'd
    "view",            # supervisor's view: "live" | "dead"
    "hello_pending",   # readmission hello not yet processed
    "zombie",          # worker fenced at some point, no hello since
    "pending",         # tuple[(epoch, was_zombie)] in-flight writes
    "landed",          # tuple[(epoch, was_zombie)] admitted writes
    "refused",         # refusal count
    "writes_left",     # bound
    "readmits_left",   # bound
])


def make_lease_fence_model(max_writes: int = 3,
                           max_readmits: int = 2,
                           max_pending: int = 2) -> Model:
    """SIGSTOP/SIGCONT/death-detection/readmission schedules against
    the epoch fence.  ``zombie`` is the INTRINSIC truth the invariant
    uses: the worker was fenced (rightly or wrongly — the model
    includes false-positive detection of a live worker) and has not yet
    re-joined through a fresh-epoch hello; nothing such a worker
    publishes may ever land."""

    init = LeaseState(
        worker_epoch=1, current_epoch=1, fenced=False, running=True,
        view="live", hello_pending=False, zombie=False,
        pending=(), landed=(), refused=0,
        writes_left=max_writes, readmits_left=max_readmits)

    ts = [
        Transition(
            "worker.write",
            lambda s: (s.running and s.writes_left > 0
                       and len(s.pending) < max_pending),
            lambda s: s._replace(
                pending=s.pending + ((s.worker_epoch, s.zombie),),
                writes_left=s.writes_left - 1)),
        Transition(
            "worker.sigstop",
            lambda s: s.running,
            lambda s: s._replace(running=False)),
        Transition(
            "worker.sigcont",
            lambda s: not s.running,
            lambda s: s._replace(running=True)),
        Transition(
            # lease aged out — ALSO enabled while the worker is alive
            # and beating slowly: the false-positive-detection case a
            # fence must survive
            "supervisor.fence",
            lambda s: s.view == "live",
            lambda s: s._replace(fenced=True, view="dead",
                                 zombie=True)),
        Transition(
            "fence.deliver_write",
            lambda s: bool(s.pending),
            lambda s: (lambda e, z: s._replace(
                pending=s.pending[1:],
                landed=(s.landed + ((e, z),)
                        if e == s.current_epoch and not s.fenced
                        else s.landed),
                refused=(s.refused
                         if e == s.current_epoch and not s.fenced
                         else s.refused + 1)))(*s.pending[0])),
        Transition(
            # a NEW stale-seq beat from a fenced worker is the breaker's
            # re-admission evidence; the supervisor mints a FRESH epoch
            # and sends hello — the worker keeps stamping its old epoch
            # until it processes the hello
            "supervisor.readmit",
            lambda s: (s.view == "dead" and s.running
                       and s.readmits_left > 0),
            lambda s: s._replace(
                current_epoch=s.current_epoch + 1, fenced=False,
                view="live", hello_pending=True,
                readmits_left=s.readmits_left - 1)),
        Transition(
            "worker.process_hello",
            lambda s: s.hello_pending and s.running,
            lambda s: s._replace(
                worker_epoch=s.current_epoch, hello_pending=False,
                zombie=False)),
    ]

    def invariant(s: LeaseState) -> Optional[str]:
        for e, z in s.landed:
            if z:
                return (f"FENCED WRITER LANDED: a write stamped "
                        f"epoch {e}, produced after the fence and "
                        "before a fresh-epoch hello, was admitted")
        return None

    return Model("lease_fence", init, ts, invariant, None)


# ==========================================================================
# model 3: SlotAllocator free -> reserved -> busy -> cached(rc) -> free
# ==========================================================================

SlotState = namedtuple("SlotState", [
    "free",       # tuple[int] sorted — the free list
    "busy",       # frozenset[int]
    "cached",     # tuple[(slot, rc)] sorted
    "reserved",   # frozenset[int]
])


def make_slot_model(n_slots: int = 2, max_rc: int = 2) -> Model:
    """The allocator lifecycle with guards mirroring the real class's
    hard errors (an illegal transition is DISABLED here and RAISES
    there — the conformance test checks that equivalence edge by
    edge).  The state deliberately mirrors the real internal sets so a
    mutated transition can produce the real failure modes: a slot in
    two sets (alias) or in none (leak)."""
    ALL = frozenset(range(n_slots))

    init = SlotState(free=tuple(range(n_slots)), busy=frozenset(),
                     cached=(), reserved=frozenset())

    def cached_dict(s):
        return dict(s.cached)

    def with_cached(s, d):
        return s._replace(cached=tuple(sorted(d.items())))

    ts: List[Transition] = [
        Transition(
            "acquire",
            lambda s: bool(s.free),
            lambda s: s._replace(free=s.free[1:],
                                 busy=s.busy | {s.free[0]})),
        Transition(
            "reserve",
            lambda s: bool(s.free),
            lambda s: s._replace(free=s.free[1:],
                                 reserved=s.reserved | {s.free[0]})),
    ]
    for i in range(n_slots):
        ts.extend([
            Transition(
                f"release({i})",
                lambda s, i=i: i in s.busy,
                lambda s, i=i: s._replace(
                    busy=s.busy - {i},
                    free=tuple(sorted(s.free + (i,))))),
            Transition(
                f"commit_reservation({i})",
                lambda s, i=i: i in s.reserved,
                lambda s, i=i: s._replace(reserved=s.reserved - {i},
                                          busy=s.busy | {i})),
            Transition(
                f"cancel_reservation({i})",
                lambda s, i=i: i in s.reserved,
                lambda s, i=i: s._replace(
                    reserved=s.reserved - {i},
                    free=tuple(sorted(s.free + (i,))))),
            Transition(
                f"cache({i})",
                lambda s, i=i: i in s.busy,
                lambda s, i=i: with_cached(
                    s._replace(busy=s.busy - {i}),
                    {**cached_dict(s), i: 0})),
            Transition(
                f"retain({i})",
                lambda s, i=i: cached_dict(s).get(i, max_rc) < max_rc,
                lambda s, i=i: with_cached(
                    s, {**cached_dict(s),
                        i: cached_dict(s)[i] + 1})),
            Transition(
                f"unretain({i})",
                lambda s, i=i: cached_dict(s).get(i, 0) > 0,
                lambda s, i=i: with_cached(
                    s, {**cached_dict(s),
                        i: cached_dict(s)[i] - 1})),
            Transition(
                f"uncache({i})",
                lambda s, i=i: cached_dict(s).get(i) == 0,
                lambda s, i=i: with_cached(
                    s._replace(free=tuple(sorted(s.free + (i,)))),
                    {k: v for k, v in cached_dict(s).items()
                     if k != i})),
        ])

    def invariant(s: SlotState) -> Optional[str]:
        free = frozenset(s.free)
        cached = frozenset(dict(s.cached))
        if len(s.free) != len(free):
            return f"free list holds a DUPLICATE: {s.free}"
        groups = [("free", free), ("busy", s.busy),
                  ("cached", cached), ("reserved", s.reserved)]
        for i, (na, a) in enumerate(groups):
            for nb, b in groups[i + 1:]:
                both = a & b
                if both:
                    return (f"slot(s) {sorted(both)} ALIASED: in "
                            f"{na} and {nb} simultaneously")
        union = free | s.busy | cached | s.reserved
        if union != ALL:
            return (f"slot(s) {sorted(ALL - union)} LEAKED: in no "
                    "state set — capacity silently lost")
        for slot, rc in s.cached:
            if rc < 0:
                return f"slot {slot} refcount underflow ({rc})"
        return None

    return Model("slot_lifecycle", init, ts, invariant, None)


ALL_MODELS: Dict[str, Callable[[], Model]] = {
    "done_xor_shed": make_done_xor_shed_model,
    "lease_fence": make_lease_fence_model,
    "slot_lifecycle": make_slot_model,
}


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run every model; exit 0 when all spaces are counterexample-free
    AND fully explored, 1 on a violation, 2 on unusable arguments."""
    import argparse
    import json as _json
    import sys

    p = argparse.ArgumentParser(
        prog="python -m chainermn_tpu_torch.analysis.protocol",
        description="Exhaustive protocol model checker: done-XOR-shed "
                    "ownership, lease/epoch fencing, slot lifecycle "
                    "(docs/ANALYSIS.md)")
    p.add_argument("--model", action="append", default=None,
                   help="run one model (repeatable; default: all)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    names = args.model or sorted(ALL_MODELS)
    unknown = set(names) - set(ALL_MODELS)
    if unknown:
        print(f"error: unknown model(s) {sorted(unknown)}; have "
              f"{sorted(ALL_MODELS)}", file=sys.stderr)
        return 2

    results = [check(ALL_MODELS[n]()) for n in names]
    if args.json:
        print(_json.dumps({
            "schema": "chainermn_tpu.protocol_check.v1",
            "results": [{
                "model": r.model, "ok": r.ok,
                "n_states": r.n_states, "n_edges": r.n_edges,
                "n_terminal": r.n_terminal, "complete": r.complete,
                "violation": r.violation,
                "counterexample": [
                    {"transition": t, "state": list(s)}
                    for t, s in r.counterexample],
            } for r in results]}, indent=2))
    else:
        for r in results:
            print(r.render())
    bad = [r for r in results if not r.ok or not r.complete]
    return 1 if bad else 0


if __name__ == "__main__":   # pragma: no cover - python -m face
    import sys

    sys.exit(main())

"""Runtime protocol conformance: replay REAL runs through the models.

PR 15's model checker (``analysis/protocol.py``) proves the fleet's
three load-bearing protocols correct over EVERY interleaving of a small
bounded model; this module closes the other half of the loop — it maps
a REAL run's causal journal (``journal.py``) onto those models' action
alphabets and replays it, so every chaos test, every bench chaos
section, and any production run with ``--journal`` is continuously
model-checked:

* ``done_xor_shed`` — every request's fleet lifecycle (``submitted`` /
  ``redispatched`` / ``finished`` / ``shed`` plus the interleaved
  ``worker_lost``/``drained`` deaths) replays per trace id.  A second
  terminal outcome, a result from a worker that was never dispatched
  the current attempt, or a failover that contradicts ownership is a
  violation.
* ``lease_fence`` — per worker, ``beat`` events are the model's writes
  and ``lease_judged`` events are the deliveries: at each judged beat
  the model's land/refuse prediction is compared against what the real
  :class:`~..serving.health.EpochFence` actually decided, and the
  model's own invariant (a fenced writer's artifact never lands) runs
  over the replay — which is how a mutation-injected run (an un-fenced
  zombie write via :meth:`~..analysis.protocol.Model.replace`) is
  caught with the exact ``beat → lease_judged`` HLC edge named.
* ``slot_lifecycle`` — per allocator, ``slot`` events replay the
  free→reserved→busy→cached(rc)→free lifecycle; the model's
  exact-partition invariant (no leak, no alias) runs after every op.

Violations are rendered as minimal causal chains: the journal events
(HLC-stamped, :func:`~.journal.format_event` lines) that force the bad
step, plus the explicit happens-before edge where one exists ("this
shed happened-after that done", with the HLC path).  Requests that
simply have no terminal event yet (a journal captured mid-run) are
reported as ``incomplete``, never as violations.

``mutate`` maps a model name to a ``Model -> Model`` function applied
before replay — the acceptance hook proving the monitor catches what
the checker catches (tests mutate ``fence.deliver_write`` to land
everything and assert the zombie write is named).

A copy of ``chainermn_tpu/observability/conform.py`` over the port's
journals (``journal.py``) and its copy of the models
(``analysis/protocol.py``); pure stdlib.  ``tests/test_torch_conform.py``
holds :func:`check_dir` to the JAX package's on the same journals.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from ..analysis.protocol import (Model, make_done_xor_shed_model,
                                 make_lease_fence_model, make_slot_model)
from .journal import format_event

#: Schema of the conformance report document.
CONFORMANCE_SCHEMA = "chainermn_tpu.conformance.v1"

#: Cap on the causal-chain length attached to one violation (the chain
#: is MINIMAL context for a human, not a full dump — the merged journal
#: has the rest).
_CHAIN_CAP = 12

Mutators = Optional[Dict[str, Callable[[Model], Model]]]


class _Replay:
    """One protocol model stepped through journal-mapped actions."""

    def __init__(self, model: Model):
        self.model = model
        self.state = model.initial
        self.transitions = {t.name: t for t in model.transitions}
        #: journal events that produced applied steps (causal context)
        self.trail: List[Dict[str, Any]] = []

    def step(self, action: str, ev: Dict[str, Any]) -> Optional[str]:
        """Apply ``action``; returns a violation description when the
        action is disabled in the current model state or the invariant
        breaks after it, else None."""
        t = self.transitions.get(action)
        if t is None:
            return (f"journal demands action {action!r} which model "
                    f"{self.model.name!r} does not have")
        if not t.guard(self.state):
            return (f"{action} is DISABLED in model state "
                    f"{self.state}")
        self.state = t.apply(self.state)
        self.trail.append(ev)
        return self.model.invariant(self.state)

    def try_step(self, action: str, ev: Dict[str, Any]
                 ) -> Optional[str]:
        """Apply ``action`` if enabled, silently skip otherwise (for
        events that are legitimately idempotent/duplicated on the real
        side, e.g. a second death report of one worker).  Returns an
        invariant violation if the APPLIED step breaks it."""
        t = self.transitions.get(action)
        if t is None or not t.guard(self.state):
            return None
        self.state = t.apply(self.state)
        self.trail.append(ev)
        return self.model.invariant(self.state)

    def force(self, **fields) -> None:
        """Overwrite model-state fields with wire truth (epoch numbers
        ride the real messages; the model need not re-derive them)."""
        self.state = self.state._replace(**fields)

    def chain(self, ev: Dict[str, Any]) -> List[Dict[str, Any]]:
        evs = self.trail[-(_CHAIN_CAP - 1):] + [ev]
        seen = set()
        out = []
        for e in evs:
            key = (e.get("proc"), e.get("seq"))
            if key not in seen:
                seen.add(key)
                out.append(e)
        return out


def _violation(model: str, subject: str, action: str, reason: str,
               events: List[Dict[str, Any]],
               edge: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    return {"model": model, "subject": subject, "action": action,
            "reason": reason,
            "chain": [format_event(e) for e in events],
            "events": [e.get("idx") for e in events],
            "edge": edge}


def _hb_edge(kind: str, src: Dict[str, Any],
             dst: Dict[str, Any]) -> Dict[str, Any]:
    return {"kind": kind, "src": src.get("idx"), "dst": dst.get("idx"),
            "src_hlc": src.get("hlc"), "dst_hlc": dst.get("hlc")}


# ==========================================================================
# done_xor_shed: per-request fleet lifecycle
# ==========================================================================

def _mutated(factory, mutator, **kw) -> Model:
    m = factory(**kw)
    return mutator(m) if mutator is not None else m


def replay_done_xor_shed(merged: Dict[str, Any],
                         mutator=None) -> Tuple[List[Dict[str, Any]],
                                                int, List[str]]:
    """Replay every request's fleet lifecycle; returns
    ``(violations, n_traces_checked, incomplete_trace_ids)``."""
    fleet = [e for e in merged["events"] if e.get("kind") == "fleet"]

    # incarnation bookkeeping: a readmitted worker NAME is a NEW model
    # worker (the old incarnation's epoch is fenced forever) — the
    # incarnation index is the count of prior readmissions of the name
    inc: Dict[str, int] = {}
    per_trace: Dict[str, List[Tuple[int, Dict[str, Any], Any]]] = {}
    deaths: List[Tuple[int, Tuple[str, int], Dict[str, Any]]] = []
    for pos, ev in enumerate(fleet):
        event = ev.get("event")
        w = ev.get("worker")
        tid = ev.get("trace_id")
        if event == "readmitted":
            inc[w] = inc.get(w, 0) + 1
            continue
        if event in ("worker_lost", "drained"):
            deaths.append((pos, (str(w), inc.get(w, 0)), ev))
            continue
        if tid is None:
            continue
        if event == "submitted":
            per_trace.setdefault(tid, []).append(
                (pos, ev, ("submit", (str(w), inc.get(w, 0)))))
        elif event == "redispatched":
            to = ev.get("to")
            # a re-dispatch caused by a LIVE worker's shed-back
            # (queue_full backpressure) is a give-back + failover, not
            # a death failover — the why names the worker-side shed
            op = ("giveback_failover" if "shed:" in str(ev.get("why"))
                  else "failover")
            per_trace.setdefault(tid, []).append(
                (pos, ev, (op, (str(to), inc.get(to, 0)))))
        elif event == "finished":
            per_trace.setdefault(tid, []).append(
                (pos, ev, ("finished", (str(w), inc.get(w, 0)))))
        elif event == "shed":
            detail = str((ev.get("payload") or {}).get("detail"))
            op = ("giveback_shed"
                  if detail.startswith("worker") and "shed:" in detail
                  else "shed")
            per_trace.setdefault(tid, []).append(
                (pos, ev, (op, None)))

    violations: List[Dict[str, Any]] = []
    incomplete: List[str] = []
    for tid, items in per_trace.items():
        # the per-trace worker universe: every incarnation the router
        # dispatched this request to, in first-dispatch order
        universe: List[Tuple[str, int]] = []
        for _, _, (op, who) in items:
            if who is not None and who not in universe:
                universe.append(who)
        if not universe:
            continue   # nothing dispatch-shaped journaled (torn head)
        n_failovers = sum(1 for _, _, (op, _) in items
                          if op in ("failover", "giveback_failover"))
        model = _mutated(make_done_xor_shed_model, mutator,
                         n_workers=len(universe),
                         max_attempts=1 + n_failovers)
        r = _Replay(model)
        submit_pos = items[0][0]
        # deaths interleave in ROUTER program order (every fleet event
        # is router-emitted, so fleet order IS program order); deaths
        # before this trace's submit are irrelevant to it
        timeline = sorted(
            [(pos, ev, tag) for pos, ev, tag in items]
            + [(pos, ev, ("death", who)) for pos, who, ev in deaths
               if who in universe and pos > submit_pos],
            key=lambda x: x[0])

        def idx(who) -> Optional[int]:
            return universe.index(who) if who in universe else None

        bad = None
        for pos, ev, (op, who) in timeline:
            if op == "submit":
                bad = r.step(f"submit(->w{idx(who)})", ev)
            elif op == "death":
                i = idx(who)
                bad = (r.try_step(f"worker{i}.dies", ev)
                       or r.try_step(f"supervisor.detect(w{i})", ev))
            elif op in ("failover", "giveback_failover"):
                cur = r.state.owner
                if cur is None:
                    bad = "failover of a request with no owner"
                else:
                    if op == "giveback_failover":
                        # the live owner returned the request first
                        # (no-op if the model already saw it die)
                        r.try_step(f"worker{cur}.give_back", ev)
                    bad = r.step(
                        f"supervisor.failover(w{cur}->w{idx(who)})", ev)
            elif op == "finished":
                i = idx(who)
                if i is None:
                    bad = (f"result accepted from {who} which this "
                           f"request was never dispatched to")
                else:
                    att = r.state.has_req[i]
                    if att is None:
                        bad = (f"result accepted from w{i} ({who[0]}) "
                               "with no dispatched attempt in flight")
                    else:
                        bad = (r.step(f"worker{i}.produce_result", ev)
                               or r.step(
                                   f"router.deliver_result(w{i},"
                                   f"att{att})", ev))
            elif op in ("shed", "giveback_shed"):
                cur = r.state.owner
                if cur is None:
                    bad = r.try_step("submit(reject:no_live_worker)",
                                     ev) or None
                else:
                    if op == "giveback_shed":
                        r.try_step(f"worker{cur}.give_back", ev)
                    bad = r.step(f"supervisor.shed(w{cur})", ev)
            if bad:
                violations.append(_violation(
                    "done_xor_shed", tid, f"{op}", bad, r.chain(ev)))
                break
        if bad:
            continue
        if r.state.registered and r.state.done + r.state.shed == 0:
            incomplete.append(tid)
    return violations, len(per_trace), incomplete


# ==========================================================================
# lease_fence: per-worker zombie fencing
# ==========================================================================

def replay_lease_fence(merged: Dict[str, Any],
                       mutator=None) -> Tuple[List[Dict[str, Any]], int]:
    """Replay each worker's beat/fence/judge stream; returns
    ``(violations, n_workers_checked)``."""
    per_worker: Dict[str, List[Dict[str, Any]]] = {}
    for ev in merged["events"]:
        kind = ev.get("kind")
        if kind in ("beat", "lease_judged", "fence", "hello_processed"):
            per_worker.setdefault(str(ev.get("worker")), []).append(ev)
        elif kind == "fleet" and ev.get("event") == "readmitted":
            per_worker.setdefault(str(ev.get("worker")), []).append(ev)

    violations: List[Dict[str, Any]] = []
    for worker, evs in per_worker.items():
        e0 = next((int(e["epoch"]) for e in evs
                   if e.get("epoch") is not None), 1)
        model = _mutated(make_lease_fence_model, mutator,
                         max_writes=1 << 60, max_readmits=1 << 60,
                         max_pending=1 << 60)
        model = Model(model.name,
                      model.initial._replace(worker_epoch=e0,
                                             current_epoch=e0),
                      model.transitions, model.invariant,
                      model.terminal_invariant)
        r = _Replay(model)
        pending: List[Tuple[int, Dict[str, Any]]] = []  # (lseq, beat ev)
        last_fence: Optional[Dict[str, Any]] = None

        def deliver(judged_ev, compare: bool) -> Optional[str]:
            lseq, beat_ev = pending.pop(0)
            before = len(r.state.landed)
            bad = r.step("fence.deliver_write", judged_ev)
            if bad:
                return bad
            if compare:
                model_admit = len(r.state.landed) > before
                real_admit = bool(judged_ev.get("admitted"))
                if model_admit != real_admit:
                    return (f"epoch fence diverges from model at lseq "
                            f"{lseq}: model says "
                            f"{'land' if model_admit else 'refuse'}, "
                            f"real fence "
                            f"{'admitted' if real_admit else 'refused'}")
            return None

        for ev in evs:
            kind = ev.get("kind")
            bad = None
            beat_ev = None
            if kind == "beat":
                # the wire epoch is the worker's truth — force it so
                # merged-order jitter around hello cannot desync it
                r.force(worker_epoch=int(ev.get("epoch", e0)))
                bad = r.step("worker.write", ev)
                if not bad:
                    pending.append((int(ev.get("lseq", -1)), ev))
            elif kind == "lease_judged":
                lseq = int(ev.get("lseq", -1))
                # beats superseded before the router read them were
                # never judged: deliver them uncompared to keep the
                # model's FIFO aligned with the real lease table
                while pending and pending[0][0] < lseq and not bad:
                    bad = deliver(ev, compare=False)
                if not bad and pending and pending[0][0] == lseq:
                    beat_ev = pending[0][1]
                    bad = deliver(ev, compare=True)
            elif kind == "fence":
                last_fence = ev
                bad = r.try_step("supervisor.fence", ev)
            elif kind == "fleet":   # readmitted
                bad = r.try_step("supervisor.readmit", ev)
                if ev.get("epoch") is not None:
                    r.force(current_epoch=int(ev["epoch"]))
            elif kind == "hello_processed":
                r.try_step("worker.process_hello", ev)
                # wire truth again: adopt the epoch the hello carried,
                # and the zombie window closes exactly here
                r.force(worker_epoch=int(ev.get("epoch", e0)),
                        zombie=False, hello_pending=False)
            if bad:
                chain = [e for e in (last_fence, beat_ev) if e]
                chain = [e for e in chain
                         if e not in r.trail[-(_CHAIN_CAP - 1):]]
                edge = (_hb_edge("lease", beat_ev, ev)
                        if beat_ev is not None else None)
                violations.append(_violation(
                    "lease_fence", worker, kind, bad,
                    chain + r.chain(ev), edge))
                break
    return violations, len(per_worker)


# ==========================================================================
# slot_lifecycle: per-allocator slot partition
# ==========================================================================

def replay_slot_lifecycle(merged: Dict[str, Any],
                          mutator=None) -> Tuple[List[Dict[str, Any]],
                                                 int]:
    """Replay each allocator's op stream; returns
    ``(violations, n_allocators_checked)``."""
    streams: Dict[Tuple[str, Any], Optional[_Replay]] = {}
    violations: List[Dict[str, Any]] = []
    for ev in merged["events"]:
        if ev.get("kind") != "slot":
            continue
        key = (str(ev.get("proc")), ev.get("alloc"))
        op = ev.get("op")
        if op == "init":
            streams[key] = _Replay(_mutated(
                make_slot_model, mutator,
                n_slots=int(ev.get("n_slots", 1)), max_rc=1 << 30))
            continue
        r = streams.get(key)
        if r is None:
            # allocator born before journaling started (or its replay
            # already failed): nothing sound to check against
            continue
        subject = f"{key[0]}/alloc{key[1]}"
        bad = None
        if op in ("acquire", "reserve"):
            expect = r.state.free[0] if r.state.free else None
            real = ev.get("slot")
            if expect is None:
                bad = (f"{op} returned slot {real} but the model free "
                       "list is empty (slot materialized from nowhere)")
            elif int(real) != int(expect):
                bad = (f"{op} returned slot {real}; lowest-free "
                       f"discipline demands {expect} "
                       f"(free={list(r.state.free)})")
            else:
                bad = r.step(op, ev)
        else:
            bad = r.step(f"{op}({ev.get('slot')})", ev)
        if bad:
            violations.append(_violation(
                "slot_lifecycle", subject, str(op), bad, r.chain(ev)))
            streams[key] = None   # stop cascading from one bad step
    checked = sum(1 for _ in streams)
    return violations, checked


# ==========================================================================
# the monitor: one merged journal -> one conformance report
# ==========================================================================

def check_conformance(merged: Dict[str, Any],
                      mutate: Mutators = None) -> Dict[str, Any]:
    """Replay one merged journal (:func:`~.journal.merge_journals`
    output) through all three protocol models.

    Returns ``{"schema", "ok", "violations", "checked", "incomplete"}``
    — ``checked`` counts replayed subjects per model (traces, workers,
    allocators), ``incomplete`` lists trace ids with no terminal
    outcome in the journal window (mid-run capture, not a violation).
    """
    mutate = mutate or {}
    dxs_v, n_traces, incomplete = replay_done_xor_shed(
        merged, mutate.get("done_xor_shed"))
    lf_v, n_workers = replay_lease_fence(merged,
                                         mutate.get("lease_fence"))
    slot_v, n_allocs = replay_slot_lifecycle(
        merged, mutate.get("slot_lifecycle"))
    violations = dxs_v + lf_v + slot_v
    return {
        "schema": CONFORMANCE_SCHEMA,
        "ok": not violations,
        "violations": violations,
        "checked": {"done_xor_shed": n_traces,
                    "lease_fence": n_workers,
                    "slot_lifecycle": n_allocs},
        "incomplete": incomplete,
    }


def check_dir(journal_dir: str, mutate: Mutators = None
              ) -> Dict[str, Any]:
    """Merge a journal directory and run the monitor over it."""
    from .journal import merge_journals
    return check_conformance(merge_journals(journal_dir), mutate)


def render_report(report: Dict[str, Any]) -> str:
    """Human rendering: verdict line, per-model counts, and each
    violation as its minimal causal chain."""
    checked = report.get("checked", {})
    lines = [
        ("conformance: "
         + ("OK" if report.get("ok") else
            f"{len(report['violations'])} VIOLATION(S)")
         + " ("
         + ", ".join(f"{k}: {v} checked"
                     for k, v in sorted(checked.items()))
         + (f", {len(report['incomplete'])} incomplete"
            if report.get("incomplete") else "")
         + ")")]
    for v in report.get("violations", []):
        lines.append(f"  [{v['model']}] {v['subject']}: {v['reason']}")
        lines.append("    causal chain (HLC order):")
        for c in v.get("chain", []):
            lines.append(f"      {c}")
        e = v.get("edge")
        if e:
            lines.append(
                f"    offending happens-before edge: {e['kind']} "
                f"hlc={tuple(e.get('src_hlc') or ())} -> "
                f"hlc={tuple(e.get('dst_hlc') or ())} "
                f"(events {e.get('src')} -> {e.get('dst')})")
    return "\n".join(lines)

"""Trace-driven workload engine: seeded, replayable serving scenarios.

Counterpart of ``chainermn_tpu/serving/scenarios.py``, a copy (it is pure
host Python).  The workload is a first-class artifact:

* **Generators**, seeded: diurnal curves, flash crowds,
  prefix-sniping / long-prompt adversarial tenants, mixed deadline
  classes, and composed chaos (worker kill + burst + SIGSTOP zombie in
  one stream).  Same seed => byte-identical event stream
  (:func:`stream_digest` is the proof, equal to JAX's for every family).
* **Event stream**, schema ``chainermn_tpu.scenario.v1``: one record per
  arrival (virtual time, tenant, priority, prompt SPEC, deadline) or
  fault injection.  Prompts ride as specs (seed + length + prefix group):
  :func:`materialize_prompt` derives the exact tokens deterministically.
* **Driver**: :func:`run_scenario` replays a stream in scaled wall-clock
  against a live fleet (:class:`~chainermn_tpu_torch.serving.fleet
  .FleetRouter` with its autoscale / tenancy / chaos planes), applies the
  fault events to the live workers, and returns the per-scenario SLO /
  shed / autoscale / degradation-rung matrix row.

The stream is deterministic; the replay is wall-clock.  Fault events name
workers by INDEX into the driver's runtime list: ``kill`` is the SIGKILL
face (:meth:`~chainermn_tpu_torch.serving.worker.WorkerRuntime.kill`),
``pause`` / ``resume`` the SIGSTOP / SIGCONT zombie.  Process fleets get
the same actions as real signals.
"""

from __future__ import annotations

import hashlib
import json
import random
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

#: Event-stream schema tag; every record carries it (receivers refuse
#: foreign streams the same way the worker lanes refuse foreign
#: mailboxes).
SCENARIO_SCHEMA = "chainermn_tpu.scenario.v1"

EVENT_KINDS = ("request", "fault")

#: Fault vocabulary: ``kill`` = SIGKILL (permanent silence), ``pause``/
#: ``resume`` = SIGSTOP/SIGCONT (the zombie drill: silence, then stale
#: writes under a fenced epoch).
FAULT_ACTIONS = ("kill", "pause", "resume")

#: The default diurnal curve (night → morning → PEAK+BURST → evening →
#: night): (phase name, requests, interarrival seconds).
DIURNAL_PHASES: Tuple[Tuple[str, int, float], ...] = (
    ("night", 3, 0.05), ("morning", 10, 0.005),
    ("peak_burst", 20, 0.0), ("evening", 6, 0.02),
    ("night2", 3, 0.05))


def _stable_seed(*parts) -> int:
    """Deterministic 64-bit seed from arbitrary parts — NEVER Python's
    ``hash`` (randomized per process, which would break the same-seed ⇒
    same-stream contract across runs)."""
    h = hashlib.sha256("\x1f".join(str(p) for p in parts).encode())
    return int.from_bytes(h.digest()[:8], "big")


# ---------------------------------------------------------------------------
# events: construction + validation + canonical bytes
# ---------------------------------------------------------------------------

def request_event(t: float, *, tenant: Optional[str] = None,
                  priority: Optional[str] = None,
                  prompt_seed: int = 0, prompt_len: int = 8,
                  prefix_group: Optional[str] = None,
                  prefix_len: int = 0,
                  max_new_tokens: int = 8,
                  deadline_s: Optional[float] = None,
                  phase: Optional[str] = None) -> Dict[str, Any]:
    """One arrival record (``seq`` is assigned by :func:`finalize`)."""
    ev: Dict[str, Any] = {
        "schema": SCENARIO_SCHEMA, "kind": "request",
        "t": round(float(t), 9),
        "tenant": tenant, "priority": priority,
        "prompt": {"seed": int(prompt_seed), "len": int(prompt_len),
                   "prefix_group": prefix_group,
                   "prefix_len": int(prefix_len)},
        "max_new_tokens": int(max_new_tokens),
        "deadline_s": (None if deadline_s is None else float(deadline_s)),
    }
    if phase is not None:
        ev["phase"] = str(phase)
    return ev


def fault_event(t: float, action: str, target: int) -> Dict[str, Any]:
    """One fault-injection record: ``target`` indexes the driver's
    worker list (NOT a name — the stream must replay against any fleet
    of sufficient size)."""
    if action not in FAULT_ACTIONS:
        raise ValueError(f"fault action must be one of {FAULT_ACTIONS}, "
                         f"got {action!r}")
    return {"schema": SCENARIO_SCHEMA, "kind": "fault",
            "t": round(float(t), 9),
            "fault": {"action": str(action), "target": int(target)}}


def validate_event(ev: Dict[str, Any]) -> None:
    """Schema check one record; raises ``ValueError`` with the exact
    field that is wrong (the refuse-don't-guess lane discipline)."""
    if not isinstance(ev, dict):
        raise ValueError(f"event must be a dict, got {type(ev).__name__}")
    if ev.get("schema") != SCENARIO_SCHEMA:
        raise ValueError(f"refusing scenario event: schema "
                         f"{ev.get('schema')!r} != {SCENARIO_SCHEMA!r}")
    kind = ev.get("kind")
    if kind not in EVENT_KINDS:
        raise ValueError(f"event kind must be one of {EVENT_KINDS}, "
                         f"got {kind!r}")
    if not isinstance(ev.get("t"), (int, float)) or ev["t"] < 0:
        raise ValueError(f"event t must be a non-negative number, "
                         f"got {ev.get('t')!r}")
    if "seq" in ev and not isinstance(ev["seq"], int):
        raise ValueError(f"event seq must be an int, got {ev['seq']!r}")
    if kind == "request":
        spec = ev.get("prompt")
        if not isinstance(spec, dict):
            raise ValueError("request event needs a prompt spec dict")
        if int(spec.get("len", 0)) < 1:
            raise ValueError(f"prompt len must be >= 1, got "
                             f"{spec.get('len')!r}")
        if int(spec.get("prefix_len", 0)) < 0:
            raise ValueError("prompt prefix_len must be >= 0")
        if int(ev.get("max_new_tokens", 0)) < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{ev.get('max_new_tokens')!r}")
        dl = ev.get("deadline_s")
        if dl is not None and (not isinstance(dl, (int, float))
                               or dl <= 0):
            raise ValueError(f"deadline_s must be positive or None, "
                             f"got {dl!r}")
    else:
        fault = ev.get("fault")
        if not isinstance(fault, dict) \
                or fault.get("action") not in FAULT_ACTIONS \
                or not isinstance(fault.get("target"), int):
            raise ValueError(f"fault event needs "
                             f"{{action ∈ {FAULT_ACTIONS}, target: int}}, "
                             f"got {fault!r}")


def finalize(events: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Order a raw event list into a valid stream: stable sort by
    arrival time (ties keep construction order — the determinism the
    composed-chaos interleave test pins), assign ``seq``, validate
    every record."""
    out = sorted((dict(ev) for ev in events), key=lambda e: e["t"])
    for i, ev in enumerate(out):
        ev["seq"] = i
        validate_event(ev)
    return out


def merge(*streams: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Deterministic interleave of finalized streams: sort by
    ``(t, stream index, position)`` — byte-stable however the inputs
    overlap — and re-assign ``seq`` over the union."""
    tagged = []
    for k, stream in enumerate(streams):
        for i, ev in enumerate(stream):
            tagged.append((float(ev["t"]), k, i, ev))
    tagged.sort(key=lambda row: row[:3])
    return finalize([ev for _, _, _, ev in tagged])


def check_stream(events: Sequence[Dict[str, Any]]) -> int:
    """Validate a whole stream (schema per record, ``seq`` dense and
    ordered, ``t`` non-decreasing); returns the event count."""
    last_t = 0.0
    for i, ev in enumerate(events):
        validate_event(ev)
        if ev.get("seq") != i:
            raise ValueError(f"stream seq must be dense 0..N-1: "
                             f"position {i} carries seq {ev.get('seq')!r}")
        if ev["t"] < last_t:
            raise ValueError(f"stream t must be non-decreasing: "
                             f"event {i} at t={ev['t']} after t={last_t}")
        last_t = ev["t"]
    return len(events)


def canonical_bytes(ev: Dict[str, Any]) -> bytes:
    """One record's canonical JSON line (sorted keys, minimal
    separators) — what :func:`stream_digest` hashes and what the
    byte-identical determinism acceptance means literally."""
    return json.dumps(ev, sort_keys=True,
                      separators=(",", ":")).encode()


def stream_digest(events: Sequence[Dict[str, Any]]) -> str:
    """SHA-256 over the stream's canonical bytes: two generator runs
    with the same seed must produce the SAME digest."""
    h = hashlib.sha256()
    for ev in events:
        h.update(canonical_bytes(ev))
        h.update(b"\n")
    return h.hexdigest()


def materialize_prompt(spec: Dict[str, Any], vocab: int) -> List[int]:
    """Deterministic token list for a prompt spec: ``prefix_len``
    tokens drawn from the ``prefix_group``'s own stable stream (every
    request in a group shares them EXACTLY — the prefix-cache /
    prefix-sniping surface), then a tail from the spec's ``seed``."""
    n = int(spec["len"])
    plen = min(int(spec.get("prefix_len") or 0), n)
    toks: List[int] = []
    if plen > 0 and spec.get("prefix_group") is not None:
        rng = random.Random(_stable_seed("prefix", spec["prefix_group"]))
        toks = [rng.randrange(int(vocab)) for _ in range(plen)]
    rng = random.Random(_stable_seed("tail", int(spec["seed"])))
    toks += [rng.randrange(int(vocab)) for _ in range(n - len(toks))]
    return toks


# ---------------------------------------------------------------------------
# generators (each: same seed ⇒ byte-identical stream)
# ---------------------------------------------------------------------------

def staggered(n: int, interarrival: float, *, seed: int = 0,
              tenant: Optional[str] = None,
              priority: Optional[str] = None,
              prompt_len: int = 8, max_new_tokens: int = 8,
              deadline_s: Optional[float] = None,
              prefix_group: Optional[str] = None, prefix_len: int = 0,
              t0: float = 0.0, phase: Optional[str] = None
              ) -> List[Dict[str, Any]]:
    """The primitive arrival source: ``n`` requests, one every
    ``interarrival`` virtual units.  The unit is the REPLAYER's choice
    — wall seconds under :func:`run_scenario`, engine steps under a
    step-driven loop."""
    rng = random.Random(_stable_seed("staggered", seed))
    return finalize([
        request_event(
            t0 + i * float(interarrival), tenant=tenant,
            priority=priority, prompt_seed=rng.getrandbits(32),
            prompt_len=prompt_len, prefix_group=prefix_group,
            prefix_len=prefix_len, max_new_tokens=max_new_tokens,
            deadline_s=deadline_s, phase=phase)
        for i in range(int(n))])


def diurnal(seed: int = 0, *,
            phases: Sequence[Tuple[str, int, float]] = DIURNAL_PHASES,
            tenants: Sequence[str] = ("gold", "free"),
            prompt_len: int = 16, max_new_tokens: int = 12,
            deadline_s: Optional[float] = None,
            jitter_frac: float = 0.0) -> List[Dict[str, Any]]:
    """Diurnal offered-load curve: ``phases`` of (name, requests,
    interarrival seconds), tenants alternating deterministically per
    arrival, optional ±``jitter_frac`` seeded jitter on each gap: a
    scale-up on the peak, a no-flap scale-down on the nights."""
    rng = random.Random(_stable_seed("diurnal", seed))
    events, t, k = [], 0.0, 0
    for name, n_req, gap in phases:
        for _ in range(int(n_req)):
            events.append(request_event(
                t, tenant=tenants[k % len(tenants)],
                prompt_seed=rng.getrandbits(32), prompt_len=prompt_len,
                max_new_tokens=max_new_tokens, deadline_s=deadline_s,
                phase=name))
            k += 1
            g = float(gap)
            if jitter_frac:
                g *= 1.0 + jitter_frac * (2.0 * rng.random() - 1.0)
            t += max(g, 0.0)
    return finalize(events)


def flash_crowd(seed: int = 0, *, n_background: int = 8,
                background_gap: float = 0.03, crowd_at: float = 0.1,
                crowd_n: int = 16, crowd_gap: float = 0.0,
                crowd_prefix_len: int = 12, prompt_len: int = 16,
                max_new_tokens: int = 8,
                deadline_s: Optional[float] = None
                ) -> List[Dict[str, Any]]:
    """Flash crowd: steady background traffic plus a sudden burst of
    ``crowd_n`` near-simultaneous arrivals all sharing one long prefix
    (the crowd is asking the same question) — the prefix cache and the
    autoscaler's scale-up band are both on the measured path."""
    background = staggered(
        n_background, background_gap, seed=_stable_seed("bg", seed),
        tenant="steady", prompt_len=prompt_len,
        max_new_tokens=max_new_tokens, deadline_s=deadline_s,
        phase="background")
    crowd = staggered(
        crowd_n, crowd_gap, seed=_stable_seed("crowd", seed),
        tenant="crowd", prompt_len=prompt_len,
        max_new_tokens=max_new_tokens, deadline_s=deadline_s,
        prefix_group=f"crowd-{seed}", prefix_len=crowd_prefix_len,
        t0=crowd_at, phase="crowd")
    return merge(background, crowd)


def adversarial(seed: int = 0, *, n_paid: int = 8,
                paid_gap: float = 0.02, paid_deadline_s: float = 30.0,
                n_snipe: int = 10, snipe_gap: float = 0.004,
                n_long: int = 4, long_prompt_len: int = 48,
                prompt_len: int = 16, max_new_tokens: int = 8
                ) -> List[Dict[str, Any]]:
    """Adversarial tenants against a paid one: ``sniper`` (best-effort)
    floods cheap requests that SHARE the paid tenant's prefix group —
    prefix-sniping: riding and churning the cache the paid tenant
    earned — while ``hog`` (best-effort) submits near-capacity long
    prompts.  The acceptance is QoS isolation: the paid tenant stays
    un-degraded (no rung ever clamps it) while best-effort absorbs the
    ladder."""
    group = f"paid-{seed}"
    paid = staggered(
        n_paid, paid_gap, seed=_stable_seed("paid", seed),
        tenant="gold", priority="paid", prompt_len=prompt_len,
        prefix_group=group, prefix_len=max(prompt_len // 2, 1),
        max_new_tokens=max_new_tokens, deadline_s=paid_deadline_s,
        phase="paid")
    snipe = staggered(
        n_snipe, snipe_gap, seed=_stable_seed("snipe", seed),
        tenant="sniper", priority="best_effort",
        prompt_len=prompt_len, prefix_group=group,
        prefix_len=max(prompt_len // 2, 1),
        max_new_tokens=max_new_tokens, phase="snipe")
    hog = staggered(
        n_long, snipe_gap * 3, seed=_stable_seed("hog", seed),
        tenant="hog", priority="best_effort",
        prompt_len=long_prompt_len, max_new_tokens=max_new_tokens,
        t0=0.01, phase="hog")
    return merge(paid, snipe, hog)


def mixed_deadlines(seed: int = 0, *, n: int = 16, gap: float = 0.01,
                    prompt_len: int = 16, max_new_tokens: int = 8,
                    classes: Sequence[Tuple[Optional[float], float]] = (
                        (0.5, 0.25), (5.0, 0.25), (None, 0.5))
                    ) -> List[Dict[str, Any]]:
    """Mixed deadline classes: each arrival draws its deadline from
    ``classes`` (deadline seconds or None, weight) via the seeded rng —
    the deadline-aware scheduling surface (tight deadlines evict, slack
    ones queue) under one reproducible stream."""
    rng = random.Random(_stable_seed("deadlines", seed))
    deadlines = [c for c, _ in classes]
    weights = [w for _, w in classes]
    return finalize([
        request_event(
            i * float(gap), tenant="mixed",
            prompt_seed=rng.getrandbits(32), prompt_len=prompt_len,
            max_new_tokens=max_new_tokens,
            deadline_s=rng.choices(deadlines, weights=weights)[0])
        for i in range(int(n))])


def composed_chaos(seed: int = 0, *, kill_at: float = 0.08,
                   kill_target: int = 0, pause_at: float = 0.12,
                   pause_target: int = 1, resume_at: float = 0.3,
                   **crowd_kwargs) -> List[Dict[str, Any]]:
    """Composed chaos: a flash crowd UNDER a worker kill and a
    SIGSTOP/SIGCONT zombie in one stream — detection, failover, the
    zombie fence, and the breaker all fire while the burst is live.
    The interleave is deterministic (:func:`merge`'s stable order), so
    two replays inject the same faults between the same arrivals."""
    load = flash_crowd(_stable_seed("chaos-load", seed), **crowd_kwargs)
    faults = finalize([
        fault_event(kill_at, "kill", kill_target),
        fault_event(pause_at, "pause", pause_target),
        fault_event(resume_at, "resume", pause_target)])
    return merge(load, faults)


#: Named scenario registry: name → zero-config builder(seed).
SCENARIOS: Dict[str, Callable[..., List[Dict[str, Any]]]] = {
    "diurnal": diurnal,
    "flash_crowd": flash_crowd,
    "adversarial": adversarial,
    "mixed_deadlines": mixed_deadlines,
    "composed_chaos": composed_chaos,
}


def build_scenario(name: str, seed: int = 0,
                   **overrides) -> List[Dict[str, Any]]:
    """Build a registry scenario by name (machine-readable refusal on
    an unknown one)."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; known: "
                         f"{sorted(SCENARIOS)}")
    return SCENARIOS[name](seed=seed, **overrides)


# ---------------------------------------------------------------------------
# replay driver
# ---------------------------------------------------------------------------

def apply_fault(ev: Dict[str, Any], runtimes: Sequence[Any]) -> str:
    """Apply one fault event to a worker list.  In-process
    :class:`~.worker.WorkerRuntime` targets use the chaos face
    (``kill()`` silences everything incl. heartbeats; ``pause`` is the
    same silence, ``resume`` re-opens it — the SIGSTOP zombie: stale
    beats under a fenced epoch).  Popen-bearing targets get the real
    signals.  Returns the applied action for the trace."""
    fault = ev["fault"]
    action = fault["action"]
    if not runtimes:
        return "skipped"
    rt = runtimes[int(fault["target"]) % len(runtimes)]
    proc = getattr(rt, "proc", None)
    if proc is not None:          # a real worker process: real signals
        import signal
        sig = {"kill": signal.SIGKILL, "pause": signal.SIGSTOP,
               "resume": signal.SIGCONT}[action]
        proc.send_signal(sig)
        return action
    if action == "kill":
        rt.kill()
    elif action == "pause":
        rt.killed = True          # kill()'s mechanism, reversibly held
    elif action == "resume":
        rt.killed = False
    return action


def run_scenario(events: Sequence[Dict[str, Any]], router, *,
                 vocab: int, time_scale: float = 1.0,
                 runtimes: Sequence[Any] = (),
                 tenancy=None, model_id: Optional[str] = None,
                 max_attempts: int = 2,
                 settle_timeout_s: float = 60.0,
                 sleep: Callable[[float], None] = time.sleep
                 ) -> Dict[str, Any]:
    """Replay a finalized stream against a live fleet in scaled
    wall-clock; returns the per-scenario matrix row.

    Each request event materializes its prompt, submits through
    :func:`~.fleet.submit_with_retry` (tenant/priority/deadline ride
    the event), and counts machine-readable sheds; each fault event
    lands on ``runtimes``.  ``time_scale`` compresses or stretches the
    stream's virtual clock (0 replays as fast as admission allows).
    The caller owns warm-up and ``router.reset_stats()`` — this
    function measures, it does not prepare.

    Matrix keys: ``shed_rate`` / ``slo_burn`` / ``max_rung`` / ``flap``
    / ``drain_shed`` / ``*_degraded`` lower-is-better, ``terminal_frac``
    higher.
    """
    from .fleet import submit_with_retry
    from .scheduler import AdmissionError

    check_stream(events)
    jitter_rng = random.Random(_stable_seed("retry-jitter",
                                            stream_digest(events)))
    handles: List[Tuple[Dict[str, Any], Any, float]] = []
    shed_by_tenant: Dict[str, int] = {}
    shed_with_deadline = 0
    fault_log: List[Dict[str, Any]] = []
    worker_trace: List[Dict[str, Any]] = []
    n_requests = n_faults = 0

    def live_count() -> int:
        return sum(1 for w in list(router.workers.values())
                   if w.state in ("starting", "live"))

    def sample(phase: Optional[str]) -> None:
        row = {"phase": phase, "t": round(t_virtual, 4),
               "live_workers": live_count()}
        if not worker_trace or worker_trace[-1]["phase"] != phase \
                or worker_trace[-1]["live_workers"] != row["live_workers"]:
            worker_trace.append(row)

    t0 = time.monotonic()
    t_virtual = 0.0
    for ev in events:
        t_virtual = float(ev["t"])
        due = t0 + t_virtual * float(time_scale)
        delay = due - time.monotonic()
        if delay > 0:
            sleep(delay)
        if ev["kind"] == "fault":
            n_faults += 1
            applied = apply_fault(ev, runtimes)
            fault_log.append({"t": t_virtual, "action": applied,
                              "target": ev["fault"]["target"]})
            sample(f"fault:{applied}")
            continue
        n_requests += 1
        tenant = ev.get("tenant")
        prompt = materialize_prompt(ev["prompt"], vocab)
        kwargs: Dict[str, Any] = {
            "tenant": tenant, "priority": ev.get("priority"),
            "deadline_s": ev.get("deadline_s")}
        if model_id is not None:
            kwargs["model_id"] = model_id
        try:
            h = submit_with_retry(
                router.submit, prompt, ev["max_new_tokens"],
                max_attempts=max_attempts, jitter_rng=jitter_rng,
                **kwargs)
        except AdmissionError:
            shed_by_tenant[str(tenant)] = \
                shed_by_tenant.get(str(tenant), 0) + 1
            if ev.get("deadline_s") is not None:
                shed_with_deadline += 1
        else:
            handles.append((ev, h, time.monotonic()))
        sample(ev.get("phase"))

    # settle: every accepted request reaches exactly one outcome
    deadline = time.monotonic() + float(settle_timeout_s)
    while (any(h.status not in ("done", "evicted")
               for _, h, _ in handles)
           and time.monotonic() < deadline):
        sleep(0.005)
    sample("settled")

    # SLO burn: of the deadline-carrying requests, the fraction that
    # missed (deadline eviction, wall overrun, or shed before start)
    with_deadline = [row for row in handles
                     if row[0].get("deadline_s") is not None]
    missed = 0
    for ev, h, t_sub in with_deadline:
        took = time.monotonic() - t_sub
        if h.status not in ("done", "evicted"):
            missed += 1
        elif h.finish_reason in ("deadline", "shed"):
            missed += 1
        elif took > float(ev["deadline_s"]) \
                and h.finish_reason != "eos" and not h.tokens:
            missed += 1
    n_with_deadline = len(with_deadline) + shed_with_deadline
    slo_burn = ((missed + shed_with_deadline) / n_with_deadline
                if n_with_deadline else 0.0)

    m = router.metrics()
    terminal = sum(h.status in ("done", "evicted") for _, h, _ in handles)
    out: Dict[str, Any] = {
        "digest": stream_digest(events),
        "n_events": len(events),
        "n_requests": n_requests,
        "n_faults": n_faults,
        "offered_shed": int(sum(shed_by_tenant.values())),
        "shed_rate": round(float(m.get("fleet/shed_rate", 0.0)), 4),
        "slo_burn": round(float(slo_burn), 4),
        "terminal_frac": round(terminal / max(len(handles), 1), 4),
        "drain_shed": int(m.get("fleet/shed_inflight_total", 0)),
        "worker_lost_detections": int(m.get("fleet/dead_workers", 0)),
        "fenced_refusals": int(sum(
            v for k, v in m.items()
            if k.startswith("fleet/fenced_refusals/"))),
        "peak_workers": max((r["live_workers"] for r in worker_trace),
                            default=0),
        "final_workers": (worker_trace[-1]["live_workers"]
                          if worker_trace else 0),
        "worker_trace": worker_trace,
        "fault_log": fault_log,
        "shed_by_tenant": dict(sorted(shed_by_tenant.items())),
    }
    autoscaler = getattr(router, "autoscaler", None)
    if autoscaler is not None:
        out["flap"] = int(sum(p.flap_count()
                              for p in autoscaler.policies.values()))
    tenancy = tenancy if tenancy is not None else router.tenancy
    if tenancy is not None:
        tm = tenancy.metrics()
        out["max_rung"] = max(
            (i for i, name in enumerate(tenancy.ladder.RUNGS)
             if tenancy.ladder.state()["rung_entries"].get(name)),
            default=0)
        for tname in sorted({str(ev.get("tenant")) for ev in events
                             if ev["kind"] == "request"
                             and ev.get("tenant") is not None}):
            out[f"tenant_{tname}_shed"] = int(
                tm.get(f"tenant/{tname}/shed_total", 0))
            out[f"tenant_{tname}_degraded"] = int(
                tm.get(f"tenant/{tname}/degraded_total", 0))
            ttft = tm.get(f"tenant/{tname}/ttft_p99_ms")
            if ttft is not None:
                out[f"tenant_{tname}_ttft_p99_ms"] = round(
                    float(ttft), 2)
    return out

"""Load-driven elastic autoscaling for the serving fleet.

Counterpart of ``chainermn_tpu/serving/autoscale.py``, a copy (host
Python over the fleet's leases and counters):

* :class:`AutoscalePolicy`, the decision function, deliberately PURE:
  ``decide(signals, now)`` reads a plain signal dict and an explicit
  receiver time (no sleeps, no wall-clock reads), so the hysteresis proof
  is a unit test over a synthetic signal trace.  Scale-up fires on any
  overload trigger (backlog tokens per worker, shed rate, SLO burn,
  tick-gap p99, queue depth); scale-down only after EVERY signal sat
  below the (strictly lower) relax thresholds continuously for
  ``down_stable_s``.  Both directions honor cooldowns and a bounded step.

  **Why it does not flap**: (1) every up threshold is validated strictly
  above its down counterpart, so no single signal value satisfies both
  directions; (2) after an up decision at ``t``, a down is refused until
  ``t + down_cooldown_s`` AND the low-dwell clock restarts at the
  decision; (3) after a down at ``t``, an up is refused until ``t +
  up_cooldown_s``.  :meth:`AutoscalePolicy.flap_count` re-derives the
  invariant from the recorded decision history.

* :class:`FleetAutoscaler` binds one policy PER ROLE to a live
  :class:`~chainermn_tpu_torch.serving.fleet.FleetRouter`: signals come
  from the leases the workers publish (queue depth, backlog tokens,
  free / busy slots, ``last_step_age_s``, ``tick_gap_p99_ms``) plus the
  router's SLO tracker and shed counters; scale-up spawns a worker
  through the caller's ``spawn(name, role)`` factory and registers it via
  ``add_worker`` (a fresh epoch); scale-down ALWAYS goes through
  ``drain()``, never a kill, so a shrinking fleet sheds nothing.  Every
  decision is recorded as a machine-readable ``autoscale_decision``
  flight event naming the triggering signal, its value and threshold,
  and the worker count before and after.

* :func:`derive_retry_after_ms`, the drain-aware back-off hint:
  ``retry_after_ms`` = tokens queued / recent tokens-per-second, clamped
  and jittered.

:func:`proc_spawn_factory` spawns worker processes on the card by default
(``device="cuda"``; the worker initialises it and loads the serving
kernels before its first lease), or on ``device="cpu"`` when asked.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..observability import flight as _flight

#: The module's names not ported yet: name -> ROADMAP.md queue A item
#: (empty: every name of JAX's module is here).
NOT_PORTED: Dict[str, str] = {}

#: Signal names a decision's ``reason`` may carry (the triggering
#: signal), in evaluation order.
UP_SIGNALS = ("below_min", "backlog_tokens_per_worker", "shed_rate",
              "burn_rate_short", "tick_gap_p99_ms",
              "queue_depth_per_worker")


def derive_retry_after_ms(backlog_tokens: float, tokens_per_sec: float, *,
                          default_token_latency_ms: float = 20.0,
                          floor_ms: float = 1.0,
                          cap_ms: float = 30_000.0,
                          jitter_frac: float = 0.1,
                          rng: Optional[random.Random] = None) -> float:
    """Back-off hint from the MEASURED backlog drain rate.

    ``backlog_tokens / tokens_per_sec`` is the wall the queue needs to
    drain at the recent throughput — the honest "come back when
    capacity plausibly exists" signal.  Edge cases, each clamped into
    ``[floor_ms, cap_ms]``:

    * ``backlog_tokens <= 0`` → ``floor_ms`` (no congestion: retry
      immediately-ish; the floor keeps the hint truthy).
    * ``tokens_per_sec <= 0`` with backlog (cold start, or a wedged
      fleet emitting nothing) → price the backlog at
      ``default_token_latency_ms`` per token instead of dividing by
      zero; the cap bounds the hint when the backlog is huge.

    ``jitter_frac`` spreads retries ±uniformly so a shed burst does not
    re-arrive as a synchronized herd (same rationale as
    ``submit_with_retry``); pass ``rng`` (or ``jitter_frac=0``) for
    deterministic tests.  The jittered value is re-clamped, so the
    bounds hold unconditionally.
    """
    backlog = max(float(backlog_tokens), 0.0)
    tps = float(tokens_per_sec)
    if backlog <= 0.0:
        est = float(floor_ms)
    elif tps > 1e-9:
        est = backlog / tps * 1e3
    else:
        est = backlog * float(default_token_latency_ms)
    est = min(max(est, float(floor_ms)), float(cap_ms))
    if jitter_frac > 0.0:
        u = (rng or random).random()
        est *= 1.0 + float(jitter_frac) * (2.0 * u - 1.0)
        est = min(max(est, float(floor_ms)), float(cap_ms))
    return est


class AutoscalePolicy:
    """Hysteretic worker-count policy — pure ``decide(signals, now)``.

    ``signals`` is a plain dict; missing/None entries disable their
    trigger.  Recognized keys: ``live_workers`` (required),
    ``backlog_tokens``, ``queue_depth``, ``shed_rate`` (fraction of
    recently offered), ``burn_rate_short``, ``tick_gap_p99_ms``,
    ``occupancy_frac``.

    Thresholds come in (up, down) pairs validated ``up > down`` —
    see the module docstring for the no-flap argument.
    """

    def __init__(self, *, role: str = "engine",
                 min_workers: int = 1, max_workers: int = 4,
                 up_backlog_tokens_per_worker: float = 64.0,
                 down_backlog_tokens_per_worker: float = 8.0,
                 up_queue_depth_per_worker: float = 4.0,
                 down_queue_depth_per_worker: float = 0.5,
                 up_shed_rate: float = 0.02,
                 up_burn_rate: float = 1.0,
                 up_tick_gap_p99_ms: Optional[float] = None,
                 down_occupancy_frac: float = 0.5,
                 up_cooldown_s: float = 1.0,
                 down_cooldown_s: float = 2.0,
                 down_stable_s: float = 2.0,
                 max_step: int = 1,
                 history: int = 256):
        if not 1 <= int(min_workers) <= int(max_workers):
            raise ValueError(f"need 1 <= min_workers <= max_workers, got "
                             f"{min_workers}..{max_workers}")
        for up, down, what in (
                (up_backlog_tokens_per_worker,
                 down_backlog_tokens_per_worker, "backlog"),
                (up_queue_depth_per_worker,
                 down_queue_depth_per_worker, "queue_depth")):
            if up <= down:
                raise ValueError(
                    f"{what}: up threshold ({up}) must sit strictly "
                    f"above the down threshold ({down}) — equal or "
                    f"inverted bands flap on a noisy signal")
        if down_cooldown_s <= 0 or up_cooldown_s <= 0:
            raise ValueError("cooldowns must be > 0")
        self.role = str(role)
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.up_backlog = float(up_backlog_tokens_per_worker)
        self.down_backlog = float(down_backlog_tokens_per_worker)
        self.up_queue = float(up_queue_depth_per_worker)
        self.down_queue = float(down_queue_depth_per_worker)
        self.up_shed_rate = float(up_shed_rate)
        self.up_burn = float(up_burn_rate)
        self.up_tick_gap_ms = (None if up_tick_gap_p99_ms is None
                               else float(up_tick_gap_p99_ms))
        self.down_occupancy = float(down_occupancy_frac)
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.down_stable_s = float(down_stable_s)
        self.max_step = max(int(max_step), 1)
        # hysteresis state
        self._last_up_t: Optional[float] = None
        self._last_down_t: Optional[float] = None
        self._low_since: Optional[float] = None
        self.ups = 0
        self.downs = 0
        self.decisions: deque = deque(maxlen=int(history))

    # ---- trigger evaluation ----
    def _up_trigger(self, sig: Dict[str, Any],
                    live: int) -> Optional[Dict[str, Any]]:
        def per(v):
            return float(v) / max(live, 1)

        checks = (
            ("backlog_tokens_per_worker",
             per(sig.get("backlog_tokens") or 0), self.up_backlog),
            ("shed_rate", float(sig.get("shed_rate") or 0.0),
             self.up_shed_rate),
            ("burn_rate_short", sig.get("burn_rate_short"), self.up_burn),
            ("tick_gap_p99_ms", sig.get("tick_gap_p99_ms"),
             self.up_tick_gap_ms),
            ("queue_depth_per_worker",
             per(sig.get("queue_depth") or 0), self.up_queue),
        )
        for name, value, thr in checks:
            if value is None or thr is None:
                continue
            if float(value) > thr:
                return {"reason": name, "signal": round(float(value), 4),
                        "threshold": thr}
        return None

    def _is_low(self, sig: Dict[str, Any], live: int) -> bool:
        def per(v):
            return float(v) / max(live, 1)

        if per(sig.get("backlog_tokens") or 0) > self.down_backlog:
            return False
        if per(sig.get("queue_depth") or 0) > self.down_queue:
            return False
        if float(sig.get("shed_rate") or 0.0) > 0.0:
            return False
        burn = sig.get("burn_rate_short")
        if burn is not None and float(burn) > self.up_burn / 2.0:
            return False
        occ = sig.get("occupancy_frac")
        if occ is not None and float(occ) > self.down_occupancy:
            return False
        return True

    # ---- the decision function ----
    def decide(self, signals: Dict[str, Any],
               now: float) -> Optional[Dict[str, Any]]:
        """One policy evaluation; returns a decision dict (also
        appended to :attr:`decisions`) or None.  Deterministic: the
        same (signals, now) trace always yields the same decisions."""
        live = int(signals["live_workers"])
        decision = None
        if live < self.min_workers:
            # both cooldowns apply here too: a permanently failing
            # spawn must retry at the cooldown cadence (not every
            # tick), and an up right after a down — even a legitimate
            # below-min recovery — would read as a flap in the
            # recorded history (invariant 3)
            if self._cooled(self._last_up_t, self.up_cooldown_s, now) \
                    and self._cooled(self._last_down_t,
                                     self.up_cooldown_s, now):
                decision = self._mk(
                    "up", live,
                    min(self.min_workers - live, self.max_step),
                    {"reason": "below_min", "signal": live,
                     "threshold": self.min_workers}, now)
        else:
            trig = self._up_trigger(signals, live)
            if trig is not None:
                self._low_since = None
                if (live < self.max_workers
                        and self._cooled(self._last_up_t,
                                         self.up_cooldown_s, now)
                        and self._cooled(self._last_down_t,
                                         self.up_cooldown_s, now)):
                    decision = self._mk(
                        "up", live, min(self.max_step,
                                        self.max_workers - live),
                        trig, now)
            elif self._is_low(signals, live):
                if self._low_since is None:
                    self._low_since = now
                if (now - self._low_since >= self.down_stable_s
                        and live > self.min_workers
                        and self._cooled(self._last_up_t,
                                         self.down_cooldown_s, now)
                        and self._cooled(self._last_down_t,
                                         self.down_cooldown_s, now)):
                    decision = self._mk(
                        "down", live, min(self.max_step,
                                          live - self.min_workers),
                        {"reason": "sustained_low_load",
                         "signal": round(now - self._low_since, 4),
                         "threshold": self.down_stable_s}, now)
            else:
                self._low_since = None
        return decision

    @staticmethod
    def _cooled(last_t: Optional[float], cooldown_s: float,
                now: float) -> bool:
        return last_t is None or now - last_t >= cooldown_s

    def _mk(self, direction: str, live: int, delta: int,
            trig: Dict[str, Any], now: float) -> Dict[str, Any]:
        if direction == "up":
            self._last_up_t = now
            self._low_since = None   # calm must RE-accumulate after it
            self.ups += 1
            target = live + delta
        else:
            self._last_down_t = now
            self._low_since = None
            self.downs += 1
            target = live - delta
        dec = {"event": "autoscale_decision", "role": self.role,
               "direction": direction, "delta": int(delta),
               "before": int(live), "target": int(target),
               "t": round(now, 4), **trig}
        self.decisions.append(dec)
        return dec

    def flap_count(self) -> int:
        """Opposite-direction decision pairs closer than the relevant
        cooldown, re-derived from the RECORDED history (the acceptance:
        must be 0 — the refusal logic above makes it so,
        this measures rather than trusts)."""
        flaps = 0
        prev = None
        for dec in self.decisions:
            if prev is not None and dec["direction"] != prev["direction"]:
                window = (self.down_cooldown_s
                          if dec["direction"] == "down"
                          else self.up_cooldown_s)
                if dec["t"] - prev["t"] < window:
                    flaps += 1
            prev = dec
        return flaps

    def state(self) -> Dict[str, Any]:
        return {
            "role": self.role,
            "min_workers": self.min_workers,
            "max_workers": self.max_workers,
            "ups": self.ups,
            "downs": self.downs,
            "flaps": self.flap_count(),
            "last_decision": (self.decisions[-1] if self.decisions
                              else None),
            "cooldowns_s": {"up": self.up_cooldown_s,
                            "down": self.down_cooldown_s,
                            "down_stable": self.down_stable_s},
        }


class FleetAutoscaler:
    """Bind :class:`AutoscalePolicy` instances to a live FleetRouter.

    ``spawn(name, role) -> WorkerClient`` is the caller's worker
    factory (:func:`local_spawn_factory` for in-process runtimes,
    :func:`proc_spawn_factory` for real processes); the autoscaler
    registers the returned client via ``router.add_worker`` — the
    rolling-restart admission path, fresh epoch included.  Scale-down
    picks the live worker of the role with the least in-flight work
    and calls ``router.drain`` — NEVER kill — so every shrink finishes
    its in-flight requests and exits 0.

    Drive: ``router.step()`` calls :meth:`maybe_tick` when an
    autoscaler is attached (throttled to ``interval_s``), so the
    router's supervisor thread IS the control loop; :meth:`tick` is
    the deterministic face tests drive directly.
    """

    def __init__(self, router, spawn: Callable[[str, str], Any], *,
                 policies: Optional[List[AutoscalePolicy]] = None,
                 interval_s: float = 0.1,
                 signal_window_s: float = 2.0,
                 metrics_writer=None,
                 clock: Callable[[], float] = time.monotonic):
        from ..observability.slo import RateMeter

        self.router = router
        self.spawn = spawn
        roles = sorted({w.role for w in router.workers.values()})
        self.policies: Dict[str, AutoscalePolicy] = {
            p.role: p for p in (policies
                                or [AutoscalePolicy(role=r)
                                    for r in roles])}
        unknown = set(self.policies) - set(roles)
        if unknown:
            raise ValueError(f"policies for roles not in the fleet: "
                             f"{sorted(unknown)} (fleet has {roles})")
        self.interval_s = float(interval_s)
        self.metrics_writer = metrics_writer
        self._clock = clock
        self._t_last_tick: Optional[float] = None
        self._counter = 0
        self._spawn_failures = 0
        self._drains_requested = 0
        self._shed_meter = RateMeter(signal_window_s, clock=clock)
        self._offered_meter = RateMeter(signal_window_s, clock=clock)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        #: latched by stop(): a fleet being deliberately drained to
        #: zero (shutdown, rolling restart) must not fight a control
        #: loop that would re-spawn workers below min_workers
        self._disabled = False
        router.autoscaler = self   # the /statusz fleet_health view

    # ---- signals ----
    def collect(self, role: str) -> Dict[str, Any]:
        """One role's signal snapshot, built from what the fleet
        already exports: worker leases, the router's rejection/dispatch
        counters (windowed into a recent shed RATE), and the shared SLO
        tracker's short-window burn."""
        r = self.router
        now = self._clock()
        live = [w for w in r.workers.values()
                if w.state in ("starting", "live") and w.role == role]
        backlog = queue_depth = busy = free = 0
        gap_p99 = None
        step_age = 0.0
        for w in live:
            lease = w.last_lease or {}
            queue_depth += (int(lease.get("queue_depth", 0))
                            + w.sent_since_lease)
            backlog += int(lease.get("backlog_tokens", 0))
            busy += int(lease.get("busy_slots", 0))
            free += int(lease.get("free_slots", 0))
            step_age = max(step_age,
                           float(lease.get("last_step_age_s", 0.0)))
            g = lease.get("tick_gap_p99_ms")
            if g is not None:
                gap_p99 = max(gap_p99 or 0.0, float(g))
        with r._lock:
            # CAPACITY sheds only: queue_full/shed_slo are fixed by
            # more workers; shed_tenant_budget and too_long are not —
            # a budget-capped tenant hammering submit_with_retry must
            # neither drive a spurious scale-up nor (via the is-low
            # check) pin the fleet at max forever
            rejected = sum(n for reason, n in r._rejected.items()
                           if reason in ("queue_full", "shed_slo"))
            dispatched = r._dispatched
        self._shed_meter.observe(rejected, now=now)
        self._offered_meter.observe(rejected + dispatched, now=now)
        offered_rate = self._offered_meter.rate(now=now)
        shed_rate = (self._shed_meter.rate(now=now) / offered_rate
                     if offered_rate > 0 else 0.0)
        burn = (r.slo.short_window_burn() if r.slo is not None
                else None)
        return {
            "live_workers": len(live),
            "queue_depth": queue_depth,
            "backlog_tokens": backlog,
            "shed_rate": round(shed_rate, 4),
            "burn_rate_short": burn,
            "tick_gap_p99_ms": gap_p99,
            "occupancy_frac": busy / max(busy + free, 1),
            "last_step_age_s": round(step_age, 4),
        }

    # ---- drive ----
    def maybe_tick(self) -> List[Dict[str, Any]]:
        now = self._clock()
        if self._disabled or (
                self._t_last_tick is not None
                and now - self._t_last_tick < self.interval_s):
            return []
        return self.tick(now=now)

    def tick(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One control-loop round: collect → decide → actuate, per
        role.  Returns the decisions applied (possibly empty)."""
        if self._disabled:
            return []
        now = self._clock() if now is None else float(now)
        with self._lock:
            self._t_last_tick = now
            applied = []
            for role, policy in self.policies.items():
                signals = self.collect(role)
                dec = policy.decide(signals, now)
                if dec is None:
                    continue
                dec["signals"] = signals
                self._apply(dec)
                applied.append(dec)
            return applied

    def _apply(self, dec: Dict[str, Any]) -> None:
        role, delta = dec["role"], dec["delta"]
        if dec["direction"] == "up":
            spawned = []
            for _ in range(delta):
                self._counter += 1
                name = f"{role}-as{self._counter}"
                try:
                    wc = self.spawn(name, role)
                    self.router.add_worker(wc)
                except Exception as e:  # noqa: BLE001 — a failed spawn
                    # must not kill the control loop; the gap re-fires
                    # the trigger next tick
                    self._spawn_failures += 1
                    _flight.note("autoscale", event="spawn_failed",
                                 worker=name, role=role, error=repr(e))
                    continue
                spawned.append(name)
            dec["spawned"] = spawned
        else:
            # scale-down is ALWAYS a drain (never kill): pick the live
            # workers with the least in-flight work, let them finish,
            # collect exit 0 — drain_shed stays 0 by construction
            with self.router._lock:
                inflight: Dict[str, int] = {}
                for e in self.router._inflight.values():
                    inflight[e["worker"]] = \
                        inflight.get(e["worker"], 0) + 1
            live = [w for w in self.router.workers.values()
                    if w.state in ("starting", "live")
                    and w.role == role]
            victims = sorted(
                live, key=lambda w: (
                    inflight.get(w.name, 0),
                    int((w.last_lease or {}).get("queue_depth", 0))
                    + w.sent_since_lease))[:delta]
            for w in victims:
                self.router.drain(w.name)
                self._drains_requested += 1
            dec["drained"] = [w.name for w in victims]
        # "t" is the POLICY clock (monotonic decision time, used by
        # flap_count); the ring stamps its own wall-clock "t" — don't
        # shadow it
        _flight.note("autoscale_decision",
                     **{k: v for k, v in dec.items()
                        if k not in ("event", "t")})
        if self.metrics_writer is not None:
            self.metrics_writer.write(
                {k: v for k, v in dec.items()
                 if isinstance(v, (int, float)) and k != "t"},
                kind="autoscale_decision")

    def start(self) -> None:
        """Standalone supervisor thread (when the router is driven by
        something that never calls ``step()``)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.maybe_tick()
                except Exception as e:  # noqa: BLE001 — the control
                    # loop must outlive one bad tick; note and continue
                    _flight.note("autoscale", event="tick_failed",
                                 error=repr(e))
                self._stop.wait(self.interval_s / 2.0)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-autoscaler")
        self._thread.start()

    def stop(self) -> None:
        """Latch the control loop OFF (both the standalone thread and
        the router-step drive): call before deliberately draining the
        fleet, or the below-min rule would re-spawn what shutdown just
        drained."""
        self._disabled = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # ---- read-out ----
    # every reader takes the same lock tick() holds while appending
    # decisions / registering workers: a /statusz scrape or a
    # metrics() call iterating the decision deque mid-append would
    # otherwise raise RuntimeError
    def target_sizes(self) -> Dict[str, int]:
        with self._lock:
            return self._target_sizes_locked()

    def _target_sizes_locked(self) -> Dict[str, int]:
        out = {}
        for role, p in self.policies.items():
            last = p.decisions[-1] if p.decisions else None
            out[role] = (int(last["target"]) if last is not None
                         else sum(1 for w in
                                  list(self.router.workers.values())
                                  if w.role == role
                                  and w.state in ("starting", "live")))
        return out

    def state(self) -> Dict[str, Any]:
        """The fleet_health provider's autoscaler view (/statusz and
        the flight bundle agree on why the fleet is its current size)."""
        with self._lock:
            return {
                "target_sizes": self._target_sizes_locked(),
                "policies": {role: p.state()
                             for role, p in self.policies.items()},
                "spawn_failures": self._spawn_failures,
                "drains_requested": self._drains_requested,
                "interval_s": self.interval_s,
            }

    def metrics(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = {
                "autoscale/spawn_failures": float(self._spawn_failures),
                "autoscale/drains_requested": float(
                    self._drains_requested),
            }
            for role, p in self.policies.items():
                out[f"autoscale/{role}/ups"] = float(p.ups)
                out[f"autoscale/{role}/downs"] = float(p.downs)
                out[f"autoscale/{role}/flap"] = float(p.flap_count())
            return out


# ---------------------------------------------------------------------------
# spawn factories (the actuator's supply side)
# ---------------------------------------------------------------------------

def local_spawn_factory(params, router, *, head_dim: int,
                        beat_interval_s: float = 0.02,
                        worker_kwargs: Optional[Dict[str, Any]] = None,
                        runtimes: Optional[List[Any]] = None):
    """``spawn(name, role)`` for in-process fleets: builds a
    :class:`~chainermn_tpu_torch.serving.worker.WorkerRuntime` on the
    router's store, drives it on a daemon thread (``rt.run`` — the
    same loop a process runs, exit 0 on drain), and returns the
    :class:`~chainermn_tpu_torch.serving.fleet.WorkerClient` to register.
    Appends each runtime to ``runtimes`` so the caller can tear them
    down."""
    from .fleet import WorkerClient
    from .worker import WorkerRuntime

    def spawn(name: str, role: str):
        rt = WorkerRuntime(name, role, params, router.store,
                           head_dim=head_dim, epoch=1,
                           beat_interval_s=beat_interval_s,
                           **(worker_kwargs or {}))
        if runtimes is not None:
            runtimes.append(rt)
        threading.Thread(target=rt.run, daemon=True,
                         name=f"worker-{name}").start()
        return WorkerClient(name, role, router.store, epoch=1)

    return spawn


def proc_spawn_factory(lane_dir: str, params_file: str, *,
                       beat_interval_s: float = 0.05,
                       bundle_dir: Optional[str] = None,
                       journal_dir: Optional[str] = None,
                       env: Optional[Dict[str, str]] = None,
                       device: str = "cuda",
                       worker_cmd: Optional[List[str]] = None,
                       tp: int = 1):
    """``spawn(name, role)`` for cross-process fleets: execs a real
    worker process over the file lanes (the ``build_proc_fleet``
    spawner) on ``device`` and returns its :class:`WorkerClient`.
    ``worker_cmd``: the worker entry's argv prefix; ``tp > 1``: the
    worker is a group of ``tp`` processes, its leader the spawned one
    (see
    :func:`~chainermn_tpu_torch.serving.fleet.spawn_worker`).  A
    scale-down drains the group through its leader."""
    from .fleet import WorkerClient, spawn_worker
    from .lanes import FileLaneStore

    store = FileLaneStore(lane_dir)

    def spawn(name: str, role: str):
        proc = spawn_worker(lane_dir, params_file, name, role, epoch=1,
                            beat_interval_s=beat_interval_s,
                            bundle_dir=bundle_dir,
                            journal_dir=journal_dir, device=device,
                            env=env, worker_cmd=worker_cmd, tp=tp)
        return WorkerClient(name, role, store, epoch=1, proc=proc)

    return spawn

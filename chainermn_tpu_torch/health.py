"""Transport-agnostic health plane: leases, epochs, breakers, consensus.

Counterpart of ``chainermn_tpu/health.py``: the supervision primitives
the training gang runs per rank (``extensions/gang.py``) and the serving
fleet shares.  Everything here is fuzzable standalone:

* **Leases** (:class:`HeartbeatPublisher` / :class:`LeaseTable`) — each
  member publishes a heartbeat lease (role, epoch, seq, free-form
  state) under its OWN lane tag, overwritten every beat.  That is the
  ``allgather_obj_eventual`` pattern applied to liveness: a bounded
  per-publisher side channel, deliberately NOT a gang collective — a
  dead member is simply ABSENT (its lease stops refreshing), it can
  never wedge the readers.
* **Detection-window math** (:func:`detection_window_s`) — the reader
  clocks a lease by when IT saw a new sequence number (receiver-side
  monotonic time, so publisher clock skew is irrelevant).  A member
  beating every ``beat_interval_s`` that misses ``miss_beats``
  consecutive beats is declared dead after at most ``beat_interval_s *
  (miss_beats + 1)`` seconds — the ``+1`` covers the worst-case phase
  offset between the last accepted beat and the first missed one
  (the JAX package's docs/ROBUSTNESS.md).
* **Epoch fencing** (:class:`EpochFence`) — every admission mints a
  monotonic epoch; marking a member dead FENCES its epoch, and every
  lease, token, result, or slab stamped with a fenced epoch is refused
  and counted.  A paused-then-resumed zombie can therefore never land
  anything: its writes carry the old epoch, and re-admission always
  mints a new one.
* **Circuit breaker** (:class:`CircuitBreaker`) — re-admission of a
  flapping member is governed by a retry budget + exponential backoff;
  past the budget the circuit opens permanently.
* **Membership consensus** (:class:`MembershipConsensus`) — the
  training gang's checkpoint-free live-shrink agreement: a pure,
  message-driven state machine (no clocks, no sleeps) every survivor
  drives over the lease side channel.  Either all survivors land on the
  IDENTICAL new gang, or the disagreeing member raises loudly
  (:class:`GangFencedError` / :class:`GangConsensusError`) — never a
  silent hang, never a split brain.
* **Collective watchdog** (:class:`CollectiveGuard`) — a bounded-timeout
  guard on every eager collective (:func:`guarded` wraps the
  communicator methods, the in-step collectives of ``ops.collective``
  and the gradient bucket's all-reduce): when a collective exceeds the
  window, the guard consults the lease table (``lost_ranks_fn``), dumps a
  ``rank_lost`` flight bundle naming the missing rank(s), and aborts
  loudly, before the process group's own timeout kills the job
  anonymously.

NCCL returns from a collective call once the work is enqueued, so
bracketing the Python call alone bounds nothing on the card.  While a
guard is installed, :func:`guarded` therefore synchronises the current
stream before it leaves the bracket whenever the call returned a CUDA
tensor: the window bounds the collective's completion, at the price of
one stream synchronisation per guarded call (nothing without a guard).
Under gloo the call blocks until done and no synchronisation is needed.

The JAX package also writes leases, fences and epochs into its causal
journal; the journal is ROADMAP.md's A12.
"""

from __future__ import annotations

import functools
import os
import pickle
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

#: Wire schema of one published lease.
LEASE_SCHEMA = "chainermn_tpu.lease.v1"

#: Wire schema of one membership-consensus proposal.
CONSENSUS_SCHEMA = "chainermn_tpu.gang_consensus.v1"


def detection_window_s(beat_interval_s: float, miss_beats: int) -> float:
    """Worst-case seconds from death to detection: ``miss_beats``
    missed beats plus one interval of phase offset (the member may die
    immediately after a beat the reader just accepted)."""
    return float(beat_interval_s) * (int(miss_beats) + 1)


def make_lease(worker: str, role: str, epoch: int, seq: int,
               **state) -> Dict[str, Any]:
    """One heartbeat lease payload (plain dict: the wire shape)."""
    lease = {
        "schema": LEASE_SCHEMA,
        "worker": str(worker),
        "role": str(role),
        "epoch": int(epoch),
        "seq": int(seq),
        "pid": os.getpid(),
        "t_wall": time.time(),
    }
    lease.update(state)
    return lease


class HeartbeatPublisher:
    """Publisher half: publish this member's lease on the lane store
    every ``beat_interval_s`` (callers invoke :meth:`maybe_beat` from
    their loop — a wedged loop then misses leases, which is exactly the
    liveness semantics the reader wants to observe).

    Thread-safe: a member may beat from both its step loop and a side
    heartbeat thread, so seq minting + the put serialize under a lock
    (concurrent unlocked beats could publish duplicate/out-of-order
    seqs and regress lease contents).  :meth:`release` latches the
    publisher closed under the same lock, so a racing beat can never
    resurrect the lease of a member that just drained.  ``epoch`` is a
    plain attribute read at beat time: a gang reconfiguration re-mints
    it in place and the next beat carries the new stamp."""

    def __init__(self, store, worker: str, role: str, epoch: int,
                 beat_interval_s: float = 0.05, lane_config=None):
        self.store = store
        self.worker = str(worker)
        self.role = str(role)
        self.epoch = int(epoch)
        self.beat_interval_s = float(beat_interval_s)
        self.lane_config = lane_config
        self.seq = 0
        self._last_beat = 0.0
        self._lock = threading.Lock()
        self._released = False

    def beat(self, **state) -> Optional[Dict[str, Any]]:
        """Publish one lease; returns it (None once released)."""
        from .communicators.base import lane_call

        with self._lock:
            if self._released:
                return None
            self.seq += 1
            lease = make_lease(self.worker, self.role, self.epoch,
                               self.seq, **state)
            payload = pickle.dumps(lease,
                                   protocol=pickle.HIGHEST_PROTOCOL)
            lane_call(f"health/{self.worker}/beat",
                      lambda: self.store.put(f"lease/{self.worker}",
                                             payload),
                      self.lane_config)
            self._last_beat = time.monotonic()
            return lease

    def maybe_beat(self, **state) -> Optional[Dict[str, Any]]:
        """Publish iff a beat interval elapsed since the last one."""
        if time.monotonic() - self._last_beat >= self.beat_interval_s:
            return self.beat(**state)
        return None

    def release(self) -> None:
        """Graceful exit (drain): delete this member's lease so the
        reader sees an explicit departure, not a missed window.
        Latches the publisher: later beats are refused."""
        from .communicators.base import lane_call

        with self._lock:
            self._released = True
            lane_call(f"health/{self.worker}/release",
                      lambda: self.store.delete(f"lease/{self.worker}"),
                      self.lane_config)


class LeaseTable:
    """Reader half: read leases and clock them by RECEIVER monotonic
    time — ``age_s`` is seconds since this process last saw a NEW
    sequence number, immune to cross-process clock skew."""

    def __init__(self, store, lane_config=None):
        self.store = store
        self.lane_config = lane_config
        # worker -> (last seen lease dict, t_seen of last NEW seq)
        self._seen: Dict[str, Any] = {}

    def read(self, worker: str) -> Optional[Dict[str, Any]]:
        """Latest lease for ``worker`` (schema-checked), or None when
        the worker never published / released its lease."""
        from .serving.lanes import lane_try_get

        payload = lane_try_get(self.store, f"health/{worker}/read",
                               f"lease/{worker}", self.lane_config)
        if payload is None:
            return None
        lease = pickle.loads(payload)
        if lease.get("schema") != LEASE_SCHEMA:
            raise ValueError(
                f"refusing lease with schema {lease.get('schema')!r} "
                f"for worker {worker!r} (this reader speaks "
                f"{LEASE_SCHEMA})")
        prev = self._seen.get(worker)
        if prev is None or lease["seq"] != prev[0]["seq"]:
            self._seen[worker] = (lease, time.monotonic())
        return self._seen[worker][0]

    def age_s(self, worker: str) -> Optional[float]:
        """Seconds since the last NEW lease seq from ``worker`` was
        observed, or None before any lease arrived."""
        self.read(worker)
        return self.age_of_seen(worker)

    def age_of_seen(self, worker: str) -> Optional[float]:
        """The age from the ALREADY-OBSERVED state (no store read) —
        for callers that just called :meth:`read` and must not pay a
        second lane round trip per poll."""
        prev = self._seen.get(worker)
        if prev is None:
            return None
        return time.monotonic() - prev[1]

    def last_seq(self, worker: str) -> Optional[int]:
        """The last lease seq observed from ``worker`` (no store read),
        or None — the fence's baseline so only writes AFTER a member was
        fenced count as zombie refusals."""
        prev = self._seen.get(worker)
        return None if prev is None else int(prev[0]["seq"])

    def forget(self, worker: str) -> None:
        self._seen.pop(worker, None)


class EpochFence:
    """Monotonic per-member epochs + the fence refusing stale writes.

    The supervisor mints ``new_epoch(worker)`` at every (re-)admission
    and ``fence(worker)`` on death.  Receivers gate every inbound
    artifact with :meth:`admit` — a stale-epoch lease/token/result/slab
    is refused AND counted per kind, which is the zombie-fencing
    evidence."""

    def __init__(self):
        self._lock = threading.Lock()
        self._epoch: Dict[str, int] = {}     # worker -> current epoch
        self._fenced: Dict[str, bool] = {}
        self.refusals: Dict[str, int] = {}   # kind -> refused count

    def new_epoch(self, worker: str) -> int:
        with self._lock:
            e = self._epoch.get(worker, 0) + 1
            self._epoch[worker] = e
            self._fenced[worker] = False
        return e

    def set_epoch(self, worker: str, epoch: int) -> int:
        """Install an externally agreed epoch (the gang's consensus mints
        ONE epoch for the whole membership rather than per-member
        counters); refuses to move backwards."""
        with self._lock:
            cur = self._epoch.get(worker, 0)
            if int(epoch) < cur:
                raise ValueError(
                    f"epoch for {worker!r} may not regress "
                    f"({cur} -> {epoch})")
            self._epoch[worker] = int(epoch)
            self._fenced[worker] = False
            return int(epoch)

    def fence(self, worker: str) -> None:
        with self._lock:
            self._fenced[worker] = True

    def current(self, worker: str) -> Optional[int]:
        with self._lock:
            return self._epoch.get(worker)

    def is_fenced(self, worker: str) -> bool:
        with self._lock:
            return bool(self._fenced.get(worker, False))

    def admit(self, worker: str, epoch, kind: str) -> bool:
        """Whether an artifact stamped ``epoch`` from ``worker`` may
        land.  Refusals (stale epoch, or the worker's current epoch is
        fenced) are counted under ``kind``."""
        with self._lock:
            cur = self._epoch.get(worker)
            ok = (cur is not None and int(epoch) == cur
                  and not self._fenced.get(worker, False))
            if not ok:
                self.refusals[kind] = self.refusals.get(kind, 0) + 1
            return ok

    def refusal_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.refusals)


class CircuitBreaker:
    """Per-member re-admission governor: retry budget + exponential
    backoff.  ``record_failure`` opens the circuit for ``backoff_base_s
    * 2^(failures-1)`` (capped at ``backoff_max_s``); :meth:`allow`
    half-opens it after the hold-off; ``record_success`` closes it and
    refunds the budget.  Past ``max_failures`` consecutive failures the
    circuit opens PERMANENTLY — a serial flapper is removed rather than
    re-admitted forever."""

    def __init__(self, max_failures: int = 4, backoff_base_s: float = 0.5,
                 backoff_max_s: float = 30.0,
                 clock=time.monotonic):
        self.max_failures = int(max_failures)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self._clock = clock
        self.failures = 0
        self._open_until: Optional[float] = None
        self.permanently_open = False

    def record_failure(self) -> None:
        self.failures += 1
        if self.failures >= self.max_failures:
            self.permanently_open = True
            self._open_until = None
            return
        delay = min(self.backoff_base_s * (2 ** (self.failures - 1)),
                    self.backoff_max_s)
        self._open_until = self._clock() + delay

    def record_success(self) -> None:
        self.failures = 0
        self._open_until = None
        self.permanently_open = False

    def allow(self) -> bool:
        """May the member be re-admitted now?"""
        if self.permanently_open:
            return False
        if self._open_until is None:
            return True
        return self._clock() >= self._open_until

    def state(self) -> Dict[str, Any]:
        return {
            "failures": self.failures,
            "permanently_open": self.permanently_open,
            "open_for_s": (None if self._open_until is None
                           else max(self._open_until - self._clock(), 0.0)),
        }


# ---------------------------------------------------------------------------
# training-gang failure vocabulary
# ---------------------------------------------------------------------------

class RankLostError(RuntimeError):
    """A collective could not complete because named rank(s) fell out of
    their lease window mid-operation.  Raised by the gang's watchdog-
    guarded collectives instead of the anonymous lane timeout the same
    death used to surface as — the message, the ``rank_lost`` flight
    bundle, and the attributes all NAME the missing ranks, so the
    survivor can run the live-shrink protocol (``SelfHealingGang
    .heal``) or die with an actionable postmortem."""

    def __init__(self, ranks: Sequence[int], op: Optional[str] = None,
                 lease_age_s: Optional[Dict[int, Optional[float]]] = None,
                 window_s: Optional[float] = None,
                 epoch: Optional[int] = None):
        self.ranks = sorted(int(r) for r in ranks)
        self.op = op
        self.lease_age_s = lease_age_s or {}
        self.window_s = window_s
        self.epoch = epoch
        ages = {r: (None if a is None else round(a, 3))
                for r, a in self.lease_age_s.items()}
        super().__init__(
            f"rank(s) {self.ranks} lost during collective "
            f"{op!r} (epoch {epoch}): lease age(s) {ages} exceeded the "
            f"{window_s}s detection window")


class GangFencedError(RuntimeError):
    """THIS member was fenced out of the gang: a live peer's lease or
    proposal carries a newer epoch, or a consensus proposal excludes us.
    The only correct move is a loud death — continuing would split the
    brain (the survivors already agreed on a gang without us)."""


class GangConsensusError(RuntimeError):
    """Membership consensus could not complete inside its deadline (or
    proposals permanently disagree).  Loud death; the scheduler
    restarts the job from the last checkpoint — a checkpoint restart,
    never a silent hang."""


class GangStateLossError(RuntimeError):
    """The side-channel state redundancy is incomplete: a surviving OLD
    member's shard lease is missing (a rank died before its first
    publish, or the lane write was lost) or the shard iterations
    diverge beyond the documented one-step skew — a live shrink would
    silently corrupt the re-partitioned state, so it is refused loudly
    and the caller falls back to the checkpoint restart."""


class GangBelowFloorError(RuntimeError):
    """The surviving membership fell below the configured minimum world
    size — live shrink is refused and the caller must fall back to the
    checkpoint restart (the shrink-vs-restart decision table of the JAX
    package's docs/ROBUSTNESS.md)."""

    def __init__(self, survivors: Sequence[int], min_world: int):
        self.survivors = sorted(int(r) for r in survivors)
        self.min_world = int(min_world)
        super().__init__(
            f"only {len(self.survivors)} survivor(s) {self.survivors} "
            f"remain, below the min-world floor {min_world}: refusing "
            f"live shrink — fall back to checkpoint restart")


class MembershipConsensus:
    """Deterministic membership agreement for checkpoint-free shrink.

    A pure message-driven state machine (no clocks, no I/O — fuzzable):
    each survivor feeds its lease-table view in via :meth:`observe`,
    publishes :meth:`proposal` messages over the side channel, delivers
    peers' proposals via :meth:`deliver` (stale-epoch messages refused
    and counted, duplicates deduped by ``seq`` — latest wins), and polls
    :meth:`decide`:

    * ``decide()`` returns the agreed membership exactly when every
      member of MY observed-alive set has a live proposal whose alive
      set EQUALS mine — unanimity over the candidate set.  Until then
      it returns None (keep re-observing/re-publishing).
    * A proposal from a member of my alive set that EXCLUDES me raises
      :class:`GangFencedError`: a live peer considers me dead, so I may
      be the zombie — dying loudly beats splitting the gang.
    * Messages from members outside my alive set (a zombie proposing
      its stale world) are ignored and counted, never adopted.

    ``SelfHealingGang._run_consensus`` bounds the loop
    with a deadline and raises :class:`GangConsensusError` on expiry —
    disagreement degrades to a loud death, never a hang."""

    def __init__(self, member: int, members: Sequence[int], epoch: int):
        self.member = int(member)
        self.members = sorted(int(m) for m in members)
        if self.member not in self.members:
            raise ValueError(
                f"member {member} not in gang {self.members}")
        self.epoch = int(epoch)
        self._alive = {self.member}
        self._seq = 0
        self._proposals: Dict[int, Any] = {}  # member -> (seq, alive tuple)
        self.stale_refused = 0
        self.duplicate_dropped = 0
        self.foreign_ignored = 0

    def observe(self, alive: Sequence[int]) -> None:
        """Install my current lease-table view (I am always alive)."""
        self._alive = {int(r) for r in alive} | {self.member}

    def proposal(self) -> Dict[str, Any]:
        """Mint my next proposal message (seq-stamped, epoch-scoped)."""
        self._seq += 1
        return {"schema": CONSENSUS_SCHEMA, "kind": "gang_propose",
                "epoch": self.epoch, "member": self.member,
                "seq": self._seq, "alive": sorted(self._alive)}

    def deliver(self, msg: Any) -> bool:
        """Feed one (possibly delayed/duplicated/stale) message; returns
        True when it updated the proposal table.  A malformed message or
        a same-epoch proposal from OUTSIDE my alive set (a zombie voting
        for its stale world) is dropped and counted under
        ``foreign_ignored`` — a refused vote can never resurrect its
        sender; the consensus loop re-reads peers every iteration, so a
        proposal that arrives before its sender is observed alive is
        simply re-delivered later."""
        if (not isinstance(msg, dict)
                or msg.get("schema") != CONSENSUS_SCHEMA
                or msg.get("kind") != "gang_propose"):
            self.foreign_ignored += 1
            return False
        if int(msg.get("epoch", -1)) != self.epoch:
            self.stale_refused += 1
            return False
        try:
            m = int(msg["member"])
            seq = int(msg["seq"])
            alive = tuple(int(r) for r in msg["alive"])
        except (KeyError, TypeError, ValueError):
            # schema-stamped but truncated/corrupt: malformed, per the
            # contract — counted and dropped, never a raise out of the
            # consensus loop
            self.foreign_ignored += 1
            return False
        if m == self.member:
            return False  # my own echo off the store
        if m not in self._alive:
            self.foreign_ignored += 1
            return False
        prev = self._proposals.get(m)
        if prev is not None and seq <= prev[0]:
            self.duplicate_dropped += 1
            return False
        self._proposals[m] = (seq, alive)
        return True

    def decide(self) -> Optional[List[int]]:
        """The agreed new membership, None while pending; raises
        :class:`GangFencedError` when a live peer has voted me out."""
        want = tuple(sorted(self._alive))
        for m in want:
            if m == self.member:
                continue
            p = self._proposals.get(m)
            if p is None:
                return None
            if self.member not in p[1]:
                raise GangFencedError(
                    f"member {m} proposes gang {sorted(p[1])} at epoch "
                    f"{self.epoch}, excluding member {self.member}: this "
                    f"member was presumed dead — dying loudly instead of "
                    f"splitting the gang")
            if p[1] != want:
                return None
        return list(want)

    def stats(self) -> Dict[str, int]:
        return {"stale_refused": self.stale_refused,
                "duplicate_dropped": self.duplicate_dropped,
                "foreign_ignored": self.foreign_ignored,
                "proposals_seen": len(self._proposals),
                "seq": self._seq}


# ---------------------------------------------------------------------------
# the collective watchdog (threaded through every eager collective)
# ---------------------------------------------------------------------------

def _default_guard_action(op: str, gap_s: float, missing) -> None:
    import sys
    print(f"[chainermn_tpu_torch health] collective '{op}' exceeded its "
          f"{gap_s:.1f}s guard window"
          + (f"; lease table names rank(s) {missing} as lost"
             if missing else "; lease table names no missing rank")
          + " — aborting the gang loudly (exit 44)",
          file=sys.stderr, flush=True)
    from .topology import abort_process_group
    abort_process_group(timeout_s=5.0)
    os._exit(44)


class CollectiveGuard:
    """Bounded-timeout watchdog over eager collective calls.

    :func:`guarded` brackets every eager collective (the communicator
    methods wrapped by ``CommunicatorBase.__init_subclass__``, the
    in-step collectives of ``ops.collective`` and the gradient bucket's
    all-reduce) with :meth:`enter`/:meth:`exit` when a guard is installed
    via :func:`set_collective_guard`.  A watcher thread fires when any
    active call outlives ``timeout_s``:

    1. ``lost_ranks_fn()`` (typically ``SelfHealingGang.stale_members``)
       is consulted so the abort NAMES the missing rank(s) instead of
       surfacing as an anonymous stall;
    2. a ``rank_lost`` flight bundle is dumped (when ``dump_dir`` set);
    3. ``action(op, gap_s, missing)`` runs — default: print + a bounded
       process-group teardown + ``os._exit(44)`` (exit 43 is the step
       watchdog; 44 is the collective guard), because a thread cannot
       raise into a caller blocked inside a collective.

    The guard fires at most once per active call and disarms cleanly on
    :meth:`stop`.  With no guard installed a guarded call pays one
    module-global read.
    """

    def __init__(self, timeout_s: float,
                 lost_ranks_fn: Optional[Callable[[], Sequence[int]]] = None,
                 action: Optional[Callable] = None,
                 poll_s: Optional[float] = None,
                 dump_dir: Optional[str] = None,
                 rank: Optional[int] = None,
                 clock=time.monotonic):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.lost_ranks_fn = lost_ranks_fn
        self.action = action or _default_guard_action
        self.poll_s = poll_s or max(self.timeout_s / 4, 0.02)
        self.dump_dir = dump_dir
        self.rank = rank
        self._clock = clock
        self._lock = threading.Lock()
        self._active: Dict[int, Any] = {}   # token -> (op, t0, fired)
        self._next_token = 0
        self.fired = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the hooks guarded() calls --
    def enter(self, op: str) -> int:
        with self._lock:
            self._next_token += 1
            tok = self._next_token
            self._active[tok] = [str(op), self._clock(), False]
        return tok

    def exit(self, token: int) -> None:
        with self._lock:
            self._active.pop(token, None)

    def active_ops(self) -> List[str]:
        with self._lock:
            return [op for op, _, _ in self._active.values()]

    # -- lifecycle --
    def start(self) -> "CollectiveGuard":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._watch, name="chainermn-tpu-torch-collective-guard",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def check(self) -> int:
        """One synchronous sweep (the watcher's body; also the test
        seam): fires expiry for every overdue active call, returns how
        many fired."""
        now = self._clock()
        expired = []
        with self._lock:
            for tok, rec in self._active.items():
                op, t0, fired = rec
                if not fired and now - t0 > self.timeout_s:
                    rec[2] = True
                    expired.append((op, now - t0))
        for op, gap in expired:
            self._expire(op, gap)
        return len(expired)

    def _expire(self, op: str, gap_s: float) -> None:
        self.fired += 1
        missing: Optional[List[int]] = None
        if self.lost_ranks_fn is not None:
            try:
                missing = sorted(int(r) for r in self.lost_ranks_fn())
            except Exception:
                missing = None
        from .observability import flight as _flight
        _flight.note("rank_lost", op=op, gap_s=round(gap_s, 3),
                     timeout_s=self.timeout_s, missing=missing,
                     source="collective_guard")
        if self.dump_dir:
            _flight.dump_bundle(
                self.dump_dir, "rank_lost", rank=self.rank,
                extra={"rank_lost": {
                    "missing": missing, "op": op,
                    "gap_s": round(gap_s, 3),
                    "detection_window_s": self.timeout_s,
                    "source": "collective_guard"}})
        self.action(op, gap_s, missing)

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.check()


#: The process-wide guard the guarded collectives consult.  None (the
#: default) costs one module-global read per eager collective.
_COLLECTIVE_GUARD: Optional[CollectiveGuard] = None


def set_collective_guard(guard: Optional[CollectiveGuard]
                         ) -> Optional[CollectiveGuard]:
    """Install (or clear, with None) the process-wide collective guard."""
    global _COLLECTIVE_GUARD
    _COLLECTIVE_GUARD = guard
    return guard


def collective_guard() -> Optional[CollectiveGuard]:
    return _COLLECTIVE_GUARD


#: Nesting depth of guarded calls on this thread: only the outermost one
#: enters the guard (``multi_node_mean_grad`` -> ``allreduce`` is one).
_EAGER_DEPTH = threading.local()


def _sync_if_cuda(out) -> None:
    """Synchronise the current stream when ``out`` holds a CUDA tensor
    (the completion of an NCCL collective, which returned on enqueue)."""
    import torch

    from ._tree import leaves

    for x in leaves(out):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.current_stream(x.device).synchronize()
            return


def guarded(op: str):
    """Decorator bracketing an eager collective with the installed
    :class:`CollectiveGuard` (outermost call only).  On a CUDA result the
    stream is synchronised inside the bracket, so the guard bounds the
    collective's completion, not its launch."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            guard = _COLLECTIVE_GUARD
            if guard is None or getattr(_EAGER_DEPTH, "d", 0):
                return fn(*args, **kwargs)
            tok = guard.enter(op)
            _EAGER_DEPTH.d = 1
            try:
                out = fn(*args, **kwargs)
                _sync_if_cuda(out)
                return out
            finally:
                _EAGER_DEPTH.d = 0
                guard.exit(tok)
        wrapper._guard_wrapped = True
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# store adapter: the communicator KV side channel as a lease store
# ---------------------------------------------------------------------------

class KvLeaseStore:
    """Adapt a communicator's ``kv_lane_transport()`` (tag-addressed
    put/get/delete over the process group's ``torch.distributed`` store,
    or the in-process loopback) into the store face the health plane
    polls.

    The one impedance mismatch: the health plane's non-blocking reads
    (``lane_try_get``) expect an ABSENT tag to surface as
    ``TimeoutError``/``KeyError`` (the ``FileLaneStore`` contract), but a
    c10d store raises its own error types (``DistStoreError`` or a
    ``RuntimeError``, saying "wait timeout") whose text would classify as
    a lane fault.  This adapter maps absence back onto ``TimeoutError``
    (text matching the transient fingerprints, like every other store)
    and lets real faults propagate for ``lane_call`` to classify."""

    _ABSENT_FINGERPRINTS = ("deadline", "timed out", "timeout",
                            "not found", "does not exist")

    def __init__(self, transport):
        self.transport = transport

    def put(self, tag: str, payload: bytes) -> None:
        self.transport.put(tag, payload)

    def get(self, tag: str, timeout_s: float = 10.0) -> bytes:
        try:
            return self.transport.get(tag, timeout_s)
        except (TimeoutError, KeyError):
            raise
        except Exception as e:
            msg = str(e).lower()
            if any(p in msg for p in self._ABSENT_FINGERPRINTS):
                raise TimeoutError(
                    f"lane tag {tag!r} not published within {timeout_s}s "
                    f"(deadline exceeded)") from e
            raise

    def delete(self, tag: str) -> None:
        try:
            self.transport.delete(tag)
        except KeyError:
            pass
        except Exception as e:
            # absent-tag deletes are a no-op everywhere else; real
            # faults propagate for lane_call to classify
            if not any(p in str(e).lower()
                       for p in self._ABSENT_FINGERPRINTS):
                raise

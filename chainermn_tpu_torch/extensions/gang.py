"""Self-healing training gang: rank health plane + checkpoint-free shrink.

Counterpart of ``chainermn_tpu/extensions/gang.py``.  ChainerMN
inherited MPI's failure semantics: one dead rank wedges every collective
and the only recovery is killing the gang and restarting from a
checkpoint (elastic since the v2 manifest, but still a full gang teardown
and a disk round trip).  :class:`SelfHealingGang` closes the gap in three
layers:

1. **Rank health plane** — every rank runs a
   :class:`~chainermn_tpu_torch.health.HeartbeatPublisher` on a side
   thread over the hardened side channel (a ``FileLaneStore`` for
   elastic gangs, or ``comm.gang_lease_store()`` over the process group's
   ``torch.distributed`` store), the ``allgather_obj_eventual`` pattern
   applied to liveness: a dead rank is ABSENT, never a wedge.  Detection
   is receiver-clocked
   (:class:`~chainermn_tpu_torch.health.LeaseTable`) and epoch-fenced
   (:class:`~chainermn_tpu_torch.health.EpochFence`): a SIGSTOPped
   zombie's late lease/collective writes are refused and counted.

2. **Collective watchdog** — the gang's object collectives
   (:meth:`allgather` / :meth:`allreduce`) poll with a bounded window;
   on expiry they consult the lease table and raise
   :class:`~chainermn_tpu_torch.health.RankLostError` NAMING the missing
   rank(s), plus a ``rank_lost`` flight bundle.
   :meth:`install_collective_guard` extends the same bound to the
   communicator and in-step collectives (the guard of
   :mod:`chainermn_tpu_torch.health`).

3. **Checkpoint-free live shrink** — :meth:`heal` runs the
   deterministic :class:`~chainermn_tpu_torch.health.MembershipConsensus`
   over the lease side channel (all survivors agree on the same new
   gang or die loudly), mints a fresh epoch fencing the dead ranks,
   collects every member's **shard lease** (the per-rank non-replicated
   state block each rank re-publishes at every completed optimizer step
   via :meth:`publish_shard` — in-window state redundancy on the side
   channel, NOT a disk checkpoint), and returns a
   :class:`GangReconfig` the caller re-partitions with
   ``parallel.reshard_host`` before continuing from the last completed
   step.  Below the ``min_world`` floor, :meth:`heal` raises
   :class:`~chainermn_tpu_torch.health.GangBelowFloorError` and the
   caller falls back to the checkpoint restart.

The hand-rolled-loop shape (the :class:`~.preemption.PreemptionHandler`
convention)::

    gang = SelfHealingGang(store, rank=i, world=n, min_world=2,
                           dump_dir=out)
    gang.start()
    it = 0
    while it < steps:
        try:
            grad = gang.allreduce(local_grad, label=f"grad{it}")
            state = update(state, grad)
            gang.publish_shard(it, {"m": state["m_block"]})
            it += 1
        except RankLostError:
            rc = gang.heal()            # GangBelowFloorError -> ckpt restart
            state = repartition(state, rc)   # reshard_host over rc.shards
            # `it` unchanged: re-run the failed step on the new gang
    gang.stop()
"""

from __future__ import annotations

import pickle
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..health import (CollectiveGuard, EpochFence, GangBelowFloorError,
                      GangConsensusError, GangFencedError,
                      GangStateLossError, LeaseTable, HeartbeatPublisher,
                      MembershipConsensus, RankLostError,
                      collective_guard, detection_window_s,
                      set_collective_guard)
from ..observability import flight as _flight

#: Wire schema of one gang collective / shard-lease payload.
GANG_SCHEMA = "chainermn_tpu.gang.v1"


class GangReconfig:
    """The outcome of one live shrink: who died, the agreed new gang,
    this member's new coordinates, and the shard leases the caller
    re-partitions (``reshard_host``) to continue checkpoint-free."""

    def __init__(self, *, old_members: List[int], members: List[int],
                 old_epoch: int, epoch: int, member_id: int,
                 shards: Dict[int, Dict[str, Any]],
                 detection_ms: Optional[float],
                 consensus_wall_ms: float):
        self.old_members = list(old_members)
        self.members = list(members)
        self.dead = [m for m in old_members if m not in members]
        self.old_world = len(old_members)
        self.new_world = len(members)
        self.old_epoch = int(old_epoch)
        self.epoch = int(epoch)
        self.member_id = int(member_id)
        self.old_rank = self.old_members.index(member_id)
        self.new_rank = self.members.index(member_id)
        #: member_id -> {"iteration": int, "payload": Any} — the shard
        #: leases at the last completed step, OLD-member order preserved
        #: in ``old_members``.
        self.shards = shards
        self.detection_ms = detection_ms
        self.consensus_wall_ms = consensus_wall_ms
        self.reshard_wall_ms: Optional[float] = None
        self.repartitioned: Any = None

    def resume_iteration(self) -> Optional[int]:
        """The common last-completed step across shard leases, or None
        when no member published one (nothing non-replicated to carry).
        A disagreement means some member completed a step the others did
        not — the caller must roll back to the MINIMUM (keeping a
        one-step shadow of its own state), so the minimum is returned
        and per-member iterations stay readable on ``shards``."""
        its = [v["iteration"] for v in self.shards.values()
               if v.get("iteration") is not None]
        return min(its) if its else None

    def summary(self) -> Dict[str, Any]:
        return {
            "old_world": self.old_world, "new_world": self.new_world,
            "old_members": self.old_members, "members": self.members,
            "dead": self.dead, "old_epoch": self.old_epoch,
            "epoch": self.epoch, "member": self.member_id,
            "old_rank": self.old_rank, "new_rank": self.new_rank,
            "resume_iteration": self.resume_iteration(),
            "shard_iterations": {m: v.get("iteration")
                                 for m, v in self.shards.items()},
            "detection_ms": self.detection_ms,
            "consensus_wall_ms": self.consensus_wall_ms,
            "reshard_wall_ms": self.reshard_wall_ms,
            "decision": "live_shrink",
        }


class SelfHealingGang:
    """One training rank's half of the self-healing plane.

    Parameters
    ----------
    store:
        A lane store (``serving.lanes.FileLaneStore`` for elastic gangs
        of unrelated processes, ``comm.gang_lease_store()`` over the
        process group's store for gangs sharing one, or the in-process
        loopback).  Every operation rides
        :func:`~chainermn_tpu_torch.communicators.base.lane_call`.
    rank / world:
        This member's ORIGINAL rank and the launch world size.  Member
        ids are stable identities; after a shrink the data-parallel rank
        is the index into the surviving membership (:attr:`rank`).
    beat_interval_s / miss_beats:
        The detection-window knobs (see
        :func:`~chainermn_tpu_torch.health.detection_window_s`).
    min_world:
        The live-shrink floor: :meth:`heal` refuses to shrink below it
        (``GangBelowFloorError`` — fall back to checkpoint restart).
    op_timeout_s:
        Hard cap on any one collective (default ``max(4 × window, 5 s)``)
        — a peer that is neither fresh nor absent (wedged store, lost
        message) still produces a bounded, named ``RankLostError``.
    """

    def __init__(self, store, rank: int, world: int, *,
                 name: str = "gang", epoch: int = 1,
                 beat_interval_s: float = 0.05, miss_beats: int = 4,
                 op_timeout_s: Optional[float] = None,
                 consensus_timeout_s: Optional[float] = None,
                 min_world: int = 1,
                 dump_dir: Optional[str] = None,
                 lane_config=None,
                 register_provider: bool = True,
                 clock=time.monotonic):
        if world < 1 or not 0 <= int(rank) < int(world):
            raise ValueError(f"bad rank/world {rank}/{world}")
        self.store = store
        self.name = str(name)
        self.member_id = int(rank)
        self.members: List[int] = list(range(int(world)))
        self.epoch = int(epoch)
        self.beat_interval_s = float(beat_interval_s)
        self.miss_beats = int(miss_beats)
        self.window_s = detection_window_s(beat_interval_s, miss_beats)
        self.op_timeout_s = float(op_timeout_s if op_timeout_s is not None
                                  else max(4 * self.window_s, 5.0))
        self.consensus_timeout_s = float(
            consensus_timeout_s if consensus_timeout_s is not None
            else max(10 * self.window_s, 5.0))
        self.min_world = int(min_world)
        self.dump_dir = dump_dir
        self.lane_config = lane_config
        self.register_provider = register_provider
        self._clock = clock
        self.poll_s = max(self.beat_interval_s / 4, 0.002)

        self._publisher = HeartbeatPublisher(
            store, self._tag(self.member_id), role="trainer",
            epoch=self.epoch, beat_interval_s=beat_interval_s,
            lane_config=lane_config)
        self._leases = LeaseTable(store, lane_config=lane_config)
        self._fence = EpochFence()
        for m in self.members:
            self._fence.set_epoch(self._tag(m), self.epoch)
        self._fenced: List[int] = []          # dead member ids, fenced
        self._fenced_seq: Dict[int, int] = {}  # last counted lease seq
        self._suspects: Dict[int, Optional[float]] = {}  # id -> lease age
        self._seq = 0
        self._my_keys: deque = deque()        # my published x-keys (GC)
        self._last_step: Optional[int] = None
        self._last_consensus: Optional[Dict[str, int]] = None
        self._last_rank_lost: Optional[Dict[str, Any]] = None
        self._last_reconfig: Optional[Dict[str, Any]] = None
        self.rank_lost_events = 0
        self.reconfigs = 0
        self._guard: Optional[CollectiveGuard] = None
        self._stop = threading.Event()
        self._beat_thread: Optional[threading.Thread] = None
        self._start_t: Optional[float] = None

    # ---- identities & keys ----
    def _tag(self, member: int) -> str:
        return f"{self.name}-r{int(member)}"

    def _xkey(self, epoch: int, seq: int, member: int) -> str:
        return f"gangx/{self.name}/{int(epoch)}/{int(seq)}/{int(member)}"

    def _ckey(self, epoch: int, member: int) -> str:
        return f"gangc/{self.name}/{int(epoch)}/{int(member)}"

    def _skey(self, member: int) -> str:
        return f"gangs/{self.name}/{int(member)}"

    @property
    def world(self) -> int:
        return len(self.members)

    @property
    def rank(self) -> int:
        """Current data-parallel rank: index into the live membership."""
        return self.members.index(self.member_id)

    # ---- lifecycle ----
    def start(self) -> "SelfHealingGang":
        """Publish the first lease and start the side heartbeat thread
        (a long device call must not read as death; SIGKILL/SIGSTOP take
        the thread with the process, so real death still silences the
        lease within one beat)."""
        if self._beat_thread is not None:
            return self
        self._start_t = self._clock()
        self._publisher.beat(step=self._last_step, world=self.world,
                             members=list(self.members))
        self._stop.clear()
        self._beat_thread = threading.Thread(
            target=self._beat_loop, name=f"chainermn-tpu-torch-gang-beat-"
            f"{self.name}-r{self.member_id}", daemon=True)
        self._beat_thread.start()
        if self.register_provider:
            _flight.register_provider("gang_health", self.stats)
        return self

    def stop(self, release: bool = True) -> None:
        self._stop.set()
        if self._beat_thread is not None:
            self._beat_thread.join(timeout=5)
            self._beat_thread = None
        if self._guard is not None:
            self._guard.stop()
            # clear the process-global slot only if it is still OURS —
            # another gang may have installed its own guard since
            if collective_guard() is self._guard:
                set_collective_guard(None)
            self._guard = None
        if self.register_provider:
            _flight.unregister_provider("gang_health")
        if release:
            try:
                self._publisher.release()
            except Exception:
                pass  # a dying store must not mask the caller's exit path

    def _beat_loop(self) -> None:
        while not self._stop.wait(self.beat_interval_s / 2):
            try:
                self._publisher.maybe_beat(step=self._last_step,
                                           world=self.world,
                                           members=list(self.members))
            except BaseException as e:  # noqa: BLE001 — fail toward death
                # a permanently faulted lease lane means THIS member will
                # read as dead to its peers — the correct direction; say
                # why and stop beating rather than spinning on the fault
                import sys
                print(f"[chainermn_tpu_torch gang] heartbeat lane failed for "
                      f"{self._tag(self.member_id)}: {e!r} — lease will "
                      f"go stale", file=sys.stderr, flush=True)
                return

    def wait_for_members(self, timeout_s: float = 30.0) -> None:
        """Join barrier: block until every member's lease is fresh (the
        gang processes may boot with arbitrary skew — a peer that has
        not STARTED yet must not read as a death).  Raises a named
        :class:`RankLostError` when a member never shows up inside
        ``timeout_s``; on success, the absence clock re-arms from the
        join point."""
        deadline = self._clock() + float(timeout_s)
        pending = {m for m in self.members if m != self.member_id}
        while pending:
            for m in list(pending):
                try:
                    lease, age = self._read_lease(m)
                except GangFencedError:
                    raise
                except Exception:
                    continue
                if (lease is not None and age is not None
                        and age <= self.window_s):
                    pending.discard(m)
            if not pending:
                break
            if self._clock() > deadline:
                self._raise_rank_lost(sorted(pending), f"{self.name}/join",
                                      float(timeout_s))
            time.sleep(self.poll_s)
        self._start_t = self._clock()

    def install_collective_guard(self, timeout_s: Optional[float] = None,
                                 action=None) -> CollectiveGuard:
        """Extend the bounded-timeout watchdog to the communicator /
        device hot path: every eager collective (the comm ledger's
        wrappers, :mod:`chainermn_tpu_torch.observability.comm`) is
        bounded; on
        expiry the guard names this gang's stale members and aborts loudly
        (exit 44)."""
        if self._guard is not None:
            self._guard.stop()  # re-install must not leak a watcher
        guard = CollectiveGuard(
            timeout_s if timeout_s is not None else self.op_timeout_s,
            lost_ranks_fn=self.stale_members, action=action,
            dump_dir=self.dump_dir, rank=self.member_id).start()
        set_collective_guard(guard)
        self._guard = guard
        return guard

    # ---- lease reading ----
    def _read_lease(self, member: int):
        """(lease dict or None, age_s or None) for ``member``, with the
        epoch gate applied.  Reconfigurations are not atomic across the
        gang, so the comparison must distinguish three cases:

        * ``lease.epoch > ours`` and WE are in the lease's ``members``
          — the peer merely finished the reconfig ahead of us (we are
          mid-heal); its lease is live evidence, not a fence.
        * ``lease.epoch > ours`` and we are EXCLUDED — the gang agreed
          on a membership without us: raise :class:`GangFencedError`
          (we may be the zombie; dying loudly beats splitting).
        * ``lease.epoch == ours`` but the lease's ``members`` EXCLUDE us
          — two partitions independently reconfigured onto the same
          epoch number (divergent decisions): equally a fence, raised
          loudly so a split brain cannot persist behind an equal epoch.
        * ``lease.epoch < ours`` from a FENCED member — a zombie's late
          write: refused + counted (once per new seq), reads as absent.
          From a live member it just means the peer has not finished
          the reconfig yet — still live evidence.
        """
        tag = self._tag(member)
        lease = self._leases.read(tag)
        if lease is None:
            return None, None
        ep = int(lease["epoch"])
        if ep >= self.epoch:
            mem = lease.get("members")
            if mem is not None and self.member_id not in mem:
                raise GangFencedError(
                    f"member {member}'s lease carries epoch {ep} "
                    f"{'>' if ep > self.epoch else '=='} our epoch "
                    f"{self.epoch} with membership {mem} excluding "
                    f"member {self.member_id}: the gang "
                    f"{'reconfigured without us' if ep > self.epoch else 'split into divergent memberships'}"
                    f" — dying loudly (gang {self.name!r})")
            if ep > self.epoch:
                return lease, self._leases.age_of_seen(tag)
        if ep < self.epoch and self._fence.is_fenced(tag):
            # count once per NEW stale seq, not per poll
            if self._fenced_seq.get(member) != lease["seq"]:
                self._fenced_seq[member] = lease["seq"]
                self._fence.admit(tag, ep, "lease")
                _flight.note("gang", event="fenced_refusal",
                             what="lease", member=member, epoch=ep,
                             current_epoch=self.epoch)
            return None, None
        return lease, self._leases.age_of_seen(tag)

    def _lease_stale(self, member: int) -> bool:
        lease, age = self._read_lease(member)
        if lease is None:
            # never beat (or fenced): stale once the gang is old enough
            # that a live member MUST have published
            return (self._start_t is not None
                    and self._clock() - self._start_t > 2 * self.window_s)
        return age is not None and age > self.window_s

    def _seen_stale(self, member: int) -> bool:
        """Staleness from the ALREADY-OBSERVED lease state (no store
        read) — the hot poll loop's face: the warm lease poll refreshes
        the receiver clock at beat/2 cadence, so re-reading the store
        per poll iteration would only add lane I/O, not information."""
        age = self._leases.age_of_seen(self._tag(member))
        if age is None:
            return (self._start_t is not None
                    and self._clock() - self._start_t > 2 * self.window_s)
        return age > self.window_s

    def _poll_fenced(self) -> None:
        """Poll fenced (dead) members' lease keys so a resumed zombie's
        late writes are refused and COUNTED (the acceptance evidence)."""
        for m in list(self._fenced):
            try:
                self._read_lease(m)
            except GangFencedError:
                raise
            except Exception:
                pass  # a torn zombie write is not our failure

    def fenced_refusals(self) -> Dict[str, int]:
        return self._fence.refusal_counts()

    def await_fenced_refusals(self, min_count: int = 1,
                              timeout_s: float = 10.0) -> int:
        """Linger until ≥ ``min_count`` stale-epoch writes were refused
        (bounded) — the chaos test's zombie-evidence wait."""
        deadline = self._clock() + float(timeout_s)
        while self._clock() < deadline:
            self._poll_fenced()
            n = sum(self._fence.refusal_counts().values())
            if n >= min_count:
                return n
            time.sleep(self.poll_s)
        return sum(self._fence.refusal_counts().values())

    def stale_members(self) -> List[int]:
        """Members whose lease fell out of the window right now — the
        collective guard's ``lost_ranks_fn``."""
        out = []
        for m in self.members:
            if m == self.member_id:
                continue
            try:
                if self._lease_stale(m):
                    out.append(m)
            except GangFencedError:
                raise
            except Exception:
                out.append(m)
        return out

    # ---- the watchdog-guarded collectives ----
    def allgather(self, obj: Any, label: Optional[str] = None
                  ) -> Dict[int, Any]:
        """Epoch-scoped object allgather over the live membership.

        Publishes my payload under a (epoch, seq, member) key, polls
        peers' keys, and consults the lease table while waiting: a peer
        absent past the detection window raises
        :class:`RankLostError` NAMING it (plus a ``rank_lost`` flight
        bundle); the hard ``op_timeout_s`` cap bounds even a
        neither-fresh-nor-stale pathology.  Stale-epoch payloads are
        refused and counted, never adopted.  Returns ``{member: obj}``
        over the CURRENT membership."""
        from ..communicators.base import lane_call
        from ..serving.lanes import lane_try_get

        self._seq += 1
        seq = self._seq
        op = f"{self.name}/{label or f'op{seq}'}"
        payload = pickle.dumps(
            {"schema": GANG_SCHEMA, "epoch": self.epoch,
             "member": self.member_id, "seq": seq, "obj": obj},
            protocol=pickle.HIGHEST_PROTOCOL)
        key = self._xkey(self.epoch, seq, self.member_id)
        lane_call(f"gang/{self.name}/x/{label or seq}/put",
                  lambda: self.store.put(key, payload), self.lane_config)
        # loop-progress beat from the MAIN thread (the serving workers'
        # maybe_beat contract): a wedged step loop then misses leases
        # even while the side thread breathes, and a resumed zombie
        # provably writes ≥1 post-fence lease BEFORE it discovers the
        # fence below — the write the survivors refuse and count.
        self._publisher.maybe_beat(step=self._last_step, world=self.world,
                                   members=list(self.members))
        self._my_keys.append(key)
        # GC my own key two collectives back: by the time any peer reads
        # seq s, every peer finished reading s-2 (it published s-1, which
        # required completing s-2) — the lockstep-GC argument of
        # ``_kv_exchange_obj``, applied to the gang lane.
        while len(self._my_keys) > 2:
            old = self._my_keys.popleft()
            lane_call(f"gang/{self.name}/x/gc",
                      lambda o=old: self.store.delete(o), self.lane_config)

        out = {self.member_id: obj}
        pending = [m for m in self.members if m != self.member_id]
        t0 = self._clock()
        last_lease_poll = 0.0
        while pending:
            # keep the receiver clock WARM: observe peers' lease seqs at
            # beat cadence even while payloads flow, so a death's age
            # counts from its last beat — not from the first post-window
            # read (which would double the effective detection window)
            if self._clock() - last_lease_poll >= self.beat_interval_s / 2:
                last_lease_poll = self._clock()
                for m in pending:
                    try:
                        self._read_lease(m)
                    except GangFencedError:
                        raise
                    except Exception:
                        pass
                # zombie-refusal evidence rides the same throttle: one
                # lane read per fenced member per beat/2, not per poll
                self._poll_fenced()
            for m in list(pending):
                data = lane_try_get(
                    self.store, f"gang/{self.name}/x/{label or seq}/get",
                    self._xkey(self.epoch, seq, m), self.lane_config)
                if data is None:
                    continue
                msg = pickle.loads(data)
                if (msg.get("schema") != GANG_SCHEMA
                        or int(msg.get("epoch", -1)) != self.epoch):
                    self._fence.admit(self._tag(m),
                                      msg.get("epoch", -1), "collective")
                    _flight.note("gang", event="fenced_refusal",
                                 what="collective", member=m,
                                 epoch=msg.get("epoch"),
                                 current_epoch=self.epoch)
                    continue
                out[m] = msg["obj"]
                pending.remove(m)
            if not pending:
                break
            elapsed = self._clock() - t0
            if elapsed > self.window_s:
                stale = [m for m in pending if self._seen_stale(m)]
                if stale:
                    self._raise_rank_lost(stale, op, elapsed,
                                          sticky=True)
                if elapsed > self.op_timeout_s:
                    # neither fresh nor stale is still BOUNDED: name the
                    # pending peers — but a fresh-leased peer (alive,
                    # merely slow/wedged) must NOT become a sticky
                    # suspect: evicting it would secede a live member.
                    # heal()'s consensus will observe it alive, miss its
                    # proposal, and die loudly (GangConsensusError)
                    # instead of splitting the gang.
                    self._raise_rank_lost(list(pending), op, elapsed,
                                          sticky=False)
            time.sleep(self.poll_s)
        return out

    def _raise_rank_lost(self, lost: Sequence[int], op: str,
                         elapsed: float, sticky: bool = True) -> None:
        """``sticky=True`` (the stale-lease path) records the ranks as
        suspects so a mid-consensus lease revival cannot re-admit them;
        the hard op-timeout path passes ``sticky=False`` — a peer whose
        lease is FRESH is alive, and suspecting it would let a slow step
        secede a live member."""
        ages = {}
        for m in lost:
            try:
                _, ages[m] = self._read_lease(m)
            except Exception:
                ages[m] = None
        if sticky:
            for m in lost:
                self._suspects[m] = ages.get(m)
        self.rank_lost_events += 1
        info = {
            "missing": sorted(int(m) for m in lost),
            "op": op, "epoch": self.epoch,
            "elapsed_s": round(elapsed, 3),
            "lease_age_s": {m: (None if a is None else round(a, 3))
                            for m, a in ages.items()},
            "detection_window_s": self.window_s,
            "step": self._last_step,
            "world": self.world,
        }
        self._last_rank_lost = info
        _flight.note("rank_lost", source="gang", **info)
        if self.dump_dir:
            _flight.dump_bundle(self.dump_dir, "rank_lost",
                                rank=self.member_id,
                                extra={"rank_lost": info})
        raise RankLostError(lost, op=op, lease_age_s=ages,
                            window_s=self.window_s, epoch=self.epoch)

    def allreduce(self, value: Any, op: Optional[Callable] = None,
                  label: Optional[str] = None) -> Any:
        """Object allreduce: allgather + a deterministic member-ordered
        fold (default ``+``) — every member computes the identical
        result."""
        got = self.allgather(value, label=label)
        vals = [got[m] for m in sorted(got)]
        out = vals[0]
        for v in vals[1:]:
            out = op(out, v) if op is not None else out + v
        return out

    def step_completed(self, iteration: int) -> None:
        """Stamp loop progress (rides the lease and the gang's stats)."""
        self._last_step = int(iteration)

    # ---- shard leases: in-window state redundancy on the side channel --
    def publish_shard(self, iteration: int, payload: Any) -> None:
        """Publish this member's NON-REPLICATED state block as of the
        just-completed ``iteration`` (one overwritten key per member —
        the lease pattern applied to state).  This is what makes the
        shrink checkpoint-free: when a member dies, the survivors
        recover its block from here instead of a disk generation."""
        from ..communicators.base import lane_call

        data = pickle.dumps(
            {"schema": GANG_SCHEMA, "epoch": self.epoch,
             "member": self.member_id, "iteration": int(iteration),
             "payload": payload},
            protocol=pickle.HIGHEST_PROTOCOL)
        lane_call(f"gang/{self.name}/shard/put",
                  lambda: self.store.put(self._skey(self.member_id), data),
                  self.lane_config)
        self._last_step = int(iteration)

    def _collect_shards(self, members: Sequence[int]
                        ) -> Dict[int, Dict[str, Any]]:
        from ..serving.lanes import lane_try_get

        out: Dict[int, Dict[str, Any]] = {}
        for m in members:
            data = lane_try_get(self.store, f"gang/{self.name}/shard/get",
                                self._skey(m), self.lane_config)
            if data is None:
                continue
            msg = pickle.loads(data)
            if msg.get("schema") != GANG_SCHEMA:
                continue
            out[int(msg["member"])] = {"iteration": msg.get("iteration"),
                                       "payload": msg.get("payload")}
        return out

    # ---- the live shrink ----
    def heal(self, repartition: Optional[Callable[["GangReconfig"], Any]]
             = None) -> GangReconfig:
        """Membership consensus → fence the dead → fresh epoch → shard
        collection; returns the :class:`GangReconfig` to continue from.

        ``repartition(rc)`` (optional) runs between consensus and the
        ``gang_reconfig`` bundle dump, its wall time recorded as
        ``reshard_wall_ms`` and its return stored at
        ``rc.repartitioned`` — pass the ``reshard_host`` closure so the
        bundle prices the whole reconfiguration.

        Raises :class:`GangBelowFloorError` when the survivors would
        fall below ``min_world`` (fall back to checkpoint restart),
        :class:`GangFencedError` when the gang reconfigured without us,
        :class:`GangConsensusError` when agreement cannot be reached
        inside ``consensus_timeout_s`` — all loud, never a hang."""
        detection_ms = None
        if self._last_rank_lost is not None:
            ages = [a for a in
                    self._last_rank_lost["lease_age_s"].values()
                    if a is not None]
            if ages:
                detection_ms = round(max(ages) * 1e3, 1)
        t0 = self._clock()
        old_members = list(self.members)
        old_epoch = self.epoch
        decision = self._run_consensus()
        consensus_wall_ms = round((self._clock() - t0) * 1e3, 1)
        if len(decision) < self.min_world:
            info = {"old_world": len(old_members),
                    "survivors": decision, "min_world": self.min_world,
                    "old_epoch": old_epoch,
                    "decision": "checkpoint_restart"}
            _flight.note("gang_reconfig", source="gang", **info)
            if self.dump_dir:
                _flight.dump_bundle(self.dump_dir, "gang_reconfig",
                                    rank=self.member_id,
                                    extra={"gang_reconfig": info})
            raise GangBelowFloorError(decision, self.min_world)

        dead = [m for m in old_members if m not in decision]
        shards = self._collect_shards(old_members)
        # NO shard leases at all means nothing non-replicated to carry
        # (a replicated-state gang) — fine.  PARTIAL coverage, or
        # iterations diverging beyond the documented one-step skew,
        # means the side-channel redundancy cannot rebuild the logical
        # state: refuse the shrink LOUDLY rather than hand the caller a
        # silently incomplete rc.shards to corrupt the optimizer with.
        if shards:
            missing = [m for m in old_members if m not in shards]
            its = sorted({int(v["iteration"]) for v in shards.values()
                          if v.get("iteration") is not None})
            skew = (its[-1] - its[0]) if its else 0
            if missing or skew > 1:
                info = {"old_world": len(old_members),
                        "old_epoch": old_epoch,
                        "survivors": decision,
                        "missing_shards": missing,
                        "shard_iterations": {m: v.get("iteration")
                                             for m, v in shards.items()},
                        "decision": "checkpoint_restart"}
                _flight.note("gang_reconfig", source="gang", **info)
                if self.dump_dir:
                    _flight.dump_bundle(self.dump_dir, "gang_reconfig",
                                        rank=self.member_id,
                                        extra={"gang_reconfig": info})
                raise GangStateLossError(
                    f"live shrink refused: shard leases are incomplete "
                    f"(missing from members {missing}) or diverge "
                    f"{skew} steps across {its} — fall back to "
                    f"checkpoint restart (gang {self.name!r}, epoch "
                    f"{old_epoch})")
        # install the agreed gang under a fresh epoch; fence the dead
        self.epoch = old_epoch + 1
        self.members = list(decision)
        self._publisher.epoch = self.epoch
        for m in decision:
            self._fence.set_epoch(self._tag(m), self.epoch)
        for d in dead:
            tag = self._tag(d)
            self._fence.fence(tag)
            if d not in self._fenced:
                self._fenced.append(d)
                # baseline the corpse's LAST seen seq: only leases the
                # zombie writes AFTER the fence count as refusals — its
                # pre-death lease file is evidence of life, not a write
                try:
                    self._leases.read(tag)
                except Exception:
                    pass
                self._fenced_seq[d] = self._leases.last_seq(tag)
        self._suspects.clear()
        self._publisher.beat(step=self._last_step, world=self.world,
                             members=list(self.members))

        rc = GangReconfig(
            old_members=old_members, members=list(decision),
            old_epoch=old_epoch, epoch=self.epoch,
            member_id=self.member_id, shards=shards,
            detection_ms=detection_ms,
            consensus_wall_ms=consensus_wall_ms)
        if repartition is not None:
            tr0 = self._clock()
            rc.repartitioned = repartition(rc)
            rc.reshard_wall_ms = round((self._clock() - tr0) * 1e3, 1)
        self.reconfigs += 1
        info = rc.summary()
        self._last_reconfig = info
        _flight.note("gang_reconfig", source="gang", **info)
        if self.dump_dir:
            _flight.dump_bundle(self.dump_dir, "gang_reconfig",
                                rank=self.member_id,
                                extra={"gang_reconfig": info})
        return rc

    def _run_consensus(self) -> List[int]:
        """Drive :class:`MembershipConsensus` over the lease side
        channel until every survivor proves unanimity (or die loudly).

        Suspicion is STICKY: members named by the triggering
        ``RankLostError`` stay excluded even if their lease revives
        mid-consensus (a rank absent in-window during a collective has
        lost its step-lockstep regardless; a revived zombie is fenced by
        the fresh epoch and dies loudly on its next op)."""
        from ..communicators.base import lane_call
        from ..serving.lanes import lane_try_get

        cons = MembershipConsensus(self.member_id, self.members,
                                   self.epoch)
        deadline = self._clock() + self.consensus_timeout_s
        while True:
            alive = {self.member_id}
            for m in self.members:
                if m == self.member_id or m in self._suspects:
                    continue
                try:
                    if not self._lease_stale(m):
                        alive.add(m)
                except GangFencedError:
                    raise
                except Exception:
                    pass
            cons.observe(alive)
            msg = cons.proposal()
            payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
            lane_call(f"gang/{self.name}/consensus/put",
                      lambda: self.store.put(
                          self._ckey(self.epoch, self.member_id), payload),
                      self.lane_config)
            for m in self.members:
                if m == self.member_id:
                    continue
                data = lane_try_get(
                    self.store, f"gang/{self.name}/consensus/get",
                    self._ckey(self.epoch, m), self.lane_config)
                if data is not None:
                    cons.deliver(pickle.loads(data))
            decision = cons.decide()   # may raise GangFencedError
            self._last_consensus = cons.stats()
            if decision is not None:
                return decision
            if self._clock() > deadline:
                raise GangConsensusError(
                    f"membership consensus for gang {self.name!r} epoch "
                    f"{self.epoch} did not converge within "
                    f"{self.consensus_timeout_s}s: my view {sorted(alive)}, "
                    f"proposals {cons.stats()} — dying loudly")
            time.sleep(self.poll_s)

    # ---- observability ----
    def stats(self) -> Dict[str, Any]:
        """The ``gang_health`` provider: every flight bundle carries this
        block."""
        return {
            "name": self.name,
            "member": self.member_id,
            "rank": self.rank,
            "epoch": self.epoch,
            "members": list(self.members),
            "world": self.world,
            "min_world": self.min_world,
            "beat_interval_s": self.beat_interval_s,
            "miss_beats": self.miss_beats,
            "detection_window_s": self.window_s,
            "op_timeout_s": self.op_timeout_s,
            "last_step": self._last_step,
            "suspects": sorted(self._suspects),
            "fenced_members": list(self._fenced),
            "fenced_refusals": self._fence.refusal_counts(),
            "rank_lost_events": self.rank_lost_events,
            "reconfigs": self.reconfigs,
            "last_rank_lost": self._last_rank_lost,
            "last_reconfig": self._last_reconfig,
            "consensus": self._last_consensus,
        }

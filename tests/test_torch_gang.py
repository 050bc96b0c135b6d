"""The port's health plane and self-healing gang against the JAX package's.

* JAX's ``tests/test_gang.py`` cases on the port (``chainermn_tpu_torch
  .health`` and ``extensions/gang.py``): the epoch fence, the collective
  guard (and its outermost-only bracket on the communicators, the in-step
  collectives and the gradient bucket), membership consensus, and the
  threaded in-process gang (lockstep collectives, death detection naming
  the rank, live shrink, the min-world floor, zombie fencing);
* the consensus fuzz, 300 seeded trials of delayed / duplicated /
  reordered / stale / forged schedules, each trial's outcome (the decided
  gang, the rounds, every survivor's counters) equal to JAX's
  ``MembershipConsensus`` on the same schedule;
* ``KvLeaseStore`` over the process group's store (``HashStore``,
  ``FileStore``) maps absence to ``TimeoutError``;
* the guard at world 2 over gloo (``tests/_torch_robustness_worker.py
  guard``, in subprocesses): a peer that stops publishing is named and the
  survivor exits 44.
"""

import datetime
import pickle
import random
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from chainermn_tpu.health import MembershipConsensus as JaxConsensus
from chainermn_tpu_torch.extensions.gang import GANG_SCHEMA, SelfHealingGang
from chainermn_tpu_torch.health import (CONSENSUS_SCHEMA, CollectiveGuard,
                                        EpochFence, GangBelowFloorError,
                                        GangConsensusError, GangFencedError,
                                        KvLeaseStore, MembershipConsensus,
                                        RankLostError, collective_guard,
                                        detection_window_s,
                                        set_collective_guard)
from chainermn_tpu_torch.serving.lanes import lane_try_get
from chainermn_tpu_torch.serving.transfer import InProcessLaneStore

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import _torch_robustness_worker as worker  # noqa: E402


def test_detection_window_and_schemas_equal_jax():
    import chainermn_tpu.extensions.gang as jgang
    import chainermn_tpu.health as jhealth

    assert detection_window_s(0.05, 4) == pytest.approx(0.25)
    assert CONSENSUS_SCHEMA == jhealth.CONSENSUS_SCHEMA
    assert GANG_SCHEMA == jgang.GANG_SCHEMA
    from chainermn_tpu_torch.health import LEASE_SCHEMA
    assert LEASE_SCHEMA == jhealth.LEASE_SCHEMA


def test_kv_lease_store_maps_absence_to_timeout():
    class _Storeish:
        """A transport whose absent-tag error is backend-flavored."""

        def __init__(self):
            self.d = {}

        def put(self, tag, payload):
            self.d[tag] = payload

        def get(self, tag, timeout_s=10.0):
            if tag not in self.d:
                raise RuntimeError(
                    "DEADLINE_EXCEEDED: Deadline Exceeded (14s)")
            return self.d[tag]

        def delete(self, tag):
            if tag not in self.d:
                raise RuntimeError("NOT_FOUND: key does not exist")
            del self.d[tag]

    store = KvLeaseStore(_Storeish())
    assert lane_try_get(store, "health/t/read", "lease/t") is None
    store.put("lease/t", b"x")
    assert store.get("lease/t") == b"x"
    store.delete("lease/t")
    store.delete("lease/t")


class _RawC10dLane:
    """A c10d store used as a lane with no mapping of its own: a missing
    key raises the store's error (``DistStoreError`` / "Wait timeout")."""

    def __init__(self, store):
        self.store = store

    def put(self, tag, payload):
        self.store.set(tag, payload)

    def get(self, tag, timeout_s=10.0):
        self.store.wait([tag], datetime.timedelta(
            milliseconds=max(int(timeout_s * 1000), 1)))
        return self.store.get(tag)

    def delete(self, tag):
        self.store.delete_key(tag)


@pytest.mark.parametrize("kind", ["hash", "file", "prefix"])
def test_kv_lease_store_over_c10d_stores(tmp_path, kind):
    """Every store type the port's process groups use: absence is
    ``TimeoutError`` (so ``lane_try_get`` reads None, no retry storm), a
    present tag reads back, a delete removes it."""
    base = {"hash": lambda: dist.HashStore(),
            "file": lambda: dist.FileStore(str(tmp_path / "fs"), 1),
            "prefix": lambda: dist.PrefixStore("p/", dist.HashStore())}[kind]
    store = KvLeaseStore(_RawC10dLane(base()))
    with pytest.raises(TimeoutError, match="deadline exceeded"):
        store.get("lease/t", timeout_s=0.01)
    t0 = time.monotonic()
    assert lane_try_get(store, "health/t/read", "lease/t") is None
    # one read, no retries (a FileStore's wait lasts ~1 s at the least;
    # five attempts and their backoff would take over 4 s)
    assert time.monotonic() - t0 < 3.0
    store.put("lease/t", b"x")
    assert store.get("lease/t", timeout_s=0.01) == b"x"
    store.delete("lease/t")
    assert lane_try_get(store, "health/t/read", "lease/t") is None


def test_gang_lease_store_of_a_one_rank_group():
    """``comm.gang_lease_store()`` of the one-rank group (``HashStore``)."""
    from chainermn_tpu_torch.communicators import create_communicator

    comm = create_communicator("xla", device="cpu")
    try:
        store = comm.gang_lease_store()
        assert lane_try_get(store, "health/t/read", "lease/t") is None
        store.put("lease/t", b"y")
        assert lane_try_get(store, "health/t/read", "lease/t") == b"y"
        store.delete("lease/t")
        assert lane_try_get(store, "health/t/read", "lease/t") is None
        g = SelfHealingGang(store, rank=0, world=1, name="solo",
                            register_provider=False).start()
        assert g.allreduce(3, label="x") == 3
        g.stop()
    finally:
        dist.destroy_process_group()


class TestCollectiveGuard:
    def test_fires_once_naming_ranks(self):
        fired = []
        g = CollectiveGuard(0.04, lost_ranks_fn=lambda: [3, 1],
                            action=lambda op, gap, missing:
                            fired.append((op, missing)))
        tok = g.enter("allreduce")
        time.sleep(0.06)
        assert g.check() == 1
        assert fired == [("allreduce", [1, 3])]
        assert g.check() == 0          # at most once per active call
        g.exit(tok)
        tok2 = g.enter("bcast")
        g.exit(tok2)
        time.sleep(0.06)
        assert g.check() == 0          # exited calls never fire

    def test_accounted_face_brackets_eager_collectives(self):
        from chainermn_tpu_torch.communicators.naive import NaiveCommunicator

        entered = []
        g = CollectiveGuard(60.0, action=lambda *a: None)
        orig_enter = g.enter
        g.enter = lambda op: (entered.append(op), orig_enter(op))[1]
        set_collective_guard(g)
        try:
            comm = NaiveCommunicator(size=2)
            comm.allreduce(comm.stack([np.ones(3), np.ones(3)]))
            assert entered == ["allreduce"]
            assert g.active_ops() == []  # exited on return
            # a delegating helper enters the guard ONCE
            entered.clear()
            comm.multi_node_mean_grad(
                {"w": comm.stack([np.ones(2), np.ones(2)])})
            assert entered == ["multi_node_mean_grad"]
            assert g.active_ops() == []
        finally:
            set_collective_guard(None)
        assert collective_guard() is None


def test_guard_brackets_the_in_step_collectives_once():
    """``ops.collective``, the gradient bucket (booked and guarded as the
    ``pmean`` it is) and the process-group communicator enter the guard
    once per outermost call."""
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.ops import collective as col
    from chainermn_tpu_torch.optimizers import compressed_mean

    comm = create_communicator("xla", device="cpu")
    entered = []
    g = CollectiveGuard(60.0, action=lambda *a: None)
    orig_enter = g.enter
    g.enter = lambda op: (entered.append(op), orig_enter(op))[1]
    set_collective_guard(g)
    try:
        col.psum(torch.ones(2), comm.mesh)
        col.all_gather(torch.ones(2), comm.mesh)
        compressed_mean([torch.ones(3)], comm)
        comm.allreduce(torch.ones(2))
        comm.multi_node_mean_grad([torch.ones(2)])
        assert entered == ["psum", "all_gather", "pmean",
                           "allreduce", "multi_node_mean_grad"]
        assert g.active_ops() == []
    finally:
        set_collective_guard(None)
        dist.destroy_process_group()


def _propose_msg(member, epoch, seq, alive):
    return {"schema": CONSENSUS_SCHEMA, "kind": "gang_propose",
            "epoch": epoch, "member": member, "seq": seq,
            "alive": sorted(alive)}


class TestMembershipConsensus:
    def test_unanimity_decides(self):
        c = MembershipConsensus(0, [0, 1, 2, 3], epoch=1)
        c.observe([0, 1, 3])
        assert c.decide() is None
        c.deliver(_propose_msg(1, 1, 1, [0, 1, 3]))
        assert c.decide() is None
        c.deliver(_propose_msg(3, 1, 1, [0, 1, 3]))
        assert c.decide() == [0, 1, 3]

    def test_stale_epoch_refused_and_counted(self):
        c = MembershipConsensus(0, [0, 1], epoch=2)
        c.observe([0, 1])
        assert not c.deliver(_propose_msg(1, 1, 9, [0, 1]))
        assert c.stale_refused == 1
        assert c.decide() is None     # the stale vote never counted

    def test_duplicates_deduped_latest_wins(self):
        c = MembershipConsensus(0, [0, 1], epoch=1)
        c.observe([0, 1])
        assert c.deliver(_propose_msg(1, 1, 2, [0, 1]))
        assert not c.deliver(_propose_msg(1, 1, 2, [0, 1]))   # dup
        assert not c.deliver(_propose_msg(1, 1, 1, [0]))      # older seq
        assert c.duplicate_dropped == 2
        assert c.decide() == [0, 1]

    def test_exclusion_is_a_loud_death(self):
        c = MembershipConsensus(2, [0, 1, 2], epoch=1)
        c.observe([0, 1, 2])
        c.deliver(_propose_msg(0, 1, 1, [0, 1]))   # 0 thinks I'm dead
        with pytest.raises(GangFencedError, match="excluding member 2"):
            c.decide()

    def test_truncated_proposal_counted_never_raises(self):
        """A schema-stamped but key-missing payload (torn write, buggy
        writer) is malformed per the contract: counted under
        foreign_ignored and dropped — never a KeyError out of the
        consensus loop."""
        c = MembershipConsensus(0, [0, 1], epoch=1)
        c.observe([0, 1])
        assert not c.deliver({"schema": CONSENSUS_SCHEMA,
                              "kind": "gang_propose", "epoch": 1})
        assert not c.deliver({"schema": CONSENSUS_SCHEMA,
                              "kind": "gang_propose", "epoch": 1,
                              "member": 1, "seq": "x", "alive": [0, 1]})
        assert c.foreign_ignored == 2
        assert c.decide() is None

    def test_forged_nonmember_proposal_ignored(self):
        c = MembershipConsensus(0, [0, 1, 2], epoch=1)
        c.observe([0, 1])                       # 2 is dead to me
        c.deliver(_propose_msg(1, 1, 1, [0, 1]))
        # the zombie claims everyone is alive — it is outside my alive
        # set, so its vote can never resurrect it
        c.deliver(_propose_msg(2, 1, 5, [0, 1, 2]))
        assert c.decide() == [0, 1]


def _fuzz_trial(rng: random.Random, Consensus) -> dict:
    """One randomized consensus round: adversarial DELIVERY (delays,
    duplicates, reorders, stale-epoch replays, forged proposals from the
    dead) over truthful detection (every survivor enters consensus
    already suspecting the true dead set — the implementation guarantees
    this by construction: heal() is only reached via a RankLostError
    whose suspects are sticky)."""
    world = rng.randint(2, 6)
    members = list(range(world))
    survivors = sorted(rng.sample(members, rng.randint(1, world - 1))) \
        if world > 1 else members
    epoch = rng.randint(1, 4)
    dead = [m for m in members if m not in survivors]

    cons = {m: Consensus(m, members, epoch) for m in survivors}
    inflight = []          # [due_round, recipient, message]
    decided = {}
    # exact adversity ledger: how many stale-epoch / forged-zombie
    # messages each survivor actually RECEIVED (delivery time), so the
    # refusal counters can be asserted exactly — not just >= 0
    expect_stale = {m: 0 for m in survivors}
    expect_foreign = {m: 0 for m in survivors}
    rounds = 0
    while len(decided) < len(survivors):
        rounds += 1
        assert rounds <= 50, "consensus fuzz hung (no silent hang allowed)"
        for m in survivors:
            if m in decided:
                continue
            c = cons[m]
            c.observe(survivors)
            msg = c.proposal()
            for r in survivors:
                if r == m:
                    continue
                inflight.append([rounds + rng.randint(0, 3), r, msg])
                if rng.random() < 0.4:                      # duplicate
                    inflight.append(
                        [rounds + rng.randint(0, 5), r, dict(msg)])
            if rng.random() < 0.4:                    # stale-epoch replay
                z = rng.choice(members)
                inflight.append([rounds + rng.randint(0, 2), m,
                                 _propose_msg(z, epoch - 1,
                                              rng.randint(1, 99),
                                              members)])
            if dead and rng.random() < 0.3:     # forged same-epoch zombie
                z = rng.choice(dead)
                inflight.append([rounds + rng.randint(0, 2), m,
                                 _propose_msg(z, epoch,
                                              rng.randint(1, 99),
                                              members)])
        due = [x for x in inflight if x[0] <= rounds]
        rng.shuffle(due)                                    # reorder
        for x in due:
            inflight.remove(x)
            r, msg = x[1], x[2]
            if r in decided:
                continue
            if msg["epoch"] != epoch:
                expect_stale[r] += 1
            elif msg["member"] in dead:
                expect_foreign[r] += 1
            cons[r].deliver(msg)
        for m in survivors:
            if m in decided:
                continue
            d = cons[m].decide()
            if d is not None:
                decided[m] = tuple(d)

    # THE property: every survivor landed on the identical new gang
    assert set(decided) == set(survivors)
    assert all(v == tuple(survivors) for v in decided.values()), decided
    # injected adversity was actually refused, EXACTLY: every delivered
    # stale-epoch replay counted, every delivered forged zombie vote
    # dropped (never stored, never able to resurrect its sender)
    for m in survivors:
        assert cons[m].stale_refused == expect_stale[m], (
            m, cons[m].stats(), expect_stale[m])
        assert cons[m].foreign_ignored == expect_foreign[m], (
            m, cons[m].stats(), expect_foreign[m])
    return {"decided": decided, "rounds": rounds,
            "stats": {m: cons[m].stats() for m in survivors}}

def test_membership_consensus_fuzz_equals_jax():
    """300 seeded trials: the port's and JAX's ``MembershipConsensus`` on
    the same schedule reach the same outcome, trial for trial."""
    for trial in range(300):
        want = _fuzz_trial(random.Random(trial), JaxConsensus)
        got = _fuzz_trial(random.Random(trial), MembershipConsensus)
        assert got == want, trial


def _make_gangs(store, n, tmp=None, **kw):
    kw.setdefault("beat_interval_s", 0.02)
    kw.setdefault("miss_beats", 3)
    kw.setdefault("min_world", 1)
    kw.setdefault("register_provider", False)
    return [SelfHealingGang(store, rank=i, world=n, name="t", **kw)
            for i in range(n)]


def _run_threads(fns, timeout=60):
    threads = [threading.Thread(target=fn) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert all(not t.is_alive() for t in threads), "gang test hung"


class TestSelfHealingGang:
    def test_lockstep_collectives_and_shard_leases(self):
        store = InProcessLaneStore()
        gangs = _make_gangs(store, 3)
        for g in gangs:
            g.start()
        res = {}

        def member(i):
            g = gangs[i]
            for it in range(3):
                res.setdefault(i, []).append(
                    g.allreduce(i + 1, label=f"s{it}"))
                g.publish_shard(it, np.full(2, float(i)))

        _run_threads([lambda i=i: member(i) for i in range(3)])
        assert res == {i: [6, 6, 6] for i in range(3)}
        shards = gangs[0]._collect_shards([0, 1, 2])
        assert sorted(shards) == [0, 1, 2]
        assert all(v["iteration"] == 2 for v in shards.values())
        for g in gangs:
            g.stop()

    def test_death_detection_names_rank_and_heals(self):
        store = InProcessLaneStore()
        gangs = _make_gangs(store, 3, min_world=2)
        for g in gangs:
            g.start()
        gangs[1].stop(release=False)   # "SIGKILL": lease goes stale
        res = {}

        def survivor(i):
            g = gangs[i]
            try:
                g.allreduce(1, label="doomed")
                res[i] = "NO-RAISE"
            except RankLostError as e:
                assert e.ranks == [1]
                assert e.window_s == pytest.approx(
                    detection_window_s(0.02, 3))
                rc = g.heal()
                res[i] = (rc.members, rc.epoch, rc.new_rank, rc.dead)

        _run_threads([lambda i=i: survivor(i) for i in (0, 2)])
        assert res[0] == ([0, 2], 2, 0, [1])
        assert res[2] == ([0, 2], 2, 1, [1])
        # the healed gang's collectives work at the new world
        def post(i):
            res[i] = gangs[i].allreduce(10, label="post")

        _run_threads([lambda i=i: post(i) for i in (0, 2)])
        assert res[0] == res[2] == 20
        st = gangs[0].stats()
        assert st["reconfigs"] == 1 and st["rank_lost_events"] == 1
        assert st["fenced_members"] == [1]
        for i in (0, 2):
            gangs[i].stop()

    def test_incomplete_shard_leases_refuse_live_shrink(self):
        """A dead member that never published a shard lease while the
        survivors did means the logical state CANNOT be rebuilt — the
        shrink must refuse loudly (checkpoint-restart fallback), never
        return a silently incomplete rc.shards."""
        from chainermn_tpu_torch.health import GangStateLossError

        store = InProcessLaneStore()
        gangs = _make_gangs(store, 3, min_world=1)
        for g in gangs:
            g.start()
        res = {}

        def member(i):
            g = gangs[i]
            g.allreduce(1, label="s0")
            if i != 1:                 # member 1 dies before publishing
                g.publish_shard(0, np.full(2, float(i)))

        _run_threads([lambda i=i: member(i) for i in range(3)])
        gangs[1].stop(release=False)

        def survivor(i):
            g = gangs[i]
            try:
                g.allreduce(1, label="doomed")
            except RankLostError:
                try:
                    g.heal()
                    res[i] = "HEALED"
                except GangStateLossError as e:
                    res[i] = str(e)

        _run_threads([lambda i=i: survivor(i) for i in (0, 2)])
        for i in (0, 2):
            assert "missing from members [1]" in res[i], res[i]
        for i in (0, 2):
            gangs[i].stop()

    def test_below_floor_falls_back_to_checkpoint_restart(self):
        store = InProcessLaneStore()
        gangs = _make_gangs(store, 2, min_world=2)
        for g in gangs:
            g.start()
        gangs[1].stop(release=False)
        with pytest.raises(RankLostError):
            gangs[0].allreduce(1, label="doomed")
        with pytest.raises(GangBelowFloorError) as ei:
            gangs[0].heal()
        assert ei.value.survivors == [0]
        assert ei.value.min_world == 2
        gangs[0].stop()

    def test_zombie_is_fenced_both_sides(self):
        """Survivor side: the zombie's post-fence lease writes are
        refused and counted.  Zombie side: its next collective dies
        loudly with GangFencedError (it is excluded from the new
        membership carried on the survivors' leases)."""
        store = InProcessLaneStore()
        gangs = _make_gangs(store, 3, min_world=2)
        for g in gangs:
            g.start()
        gangs[2].stop(release=False)   # SIGSTOP: silent but revivable
        res = {}

        def survivor(i):
            g = gangs[i]
            try:
                g.allreduce(1, label="doomed")
            except RankLostError:
                rc = g.heal()
                res[i] = rc.members

        _run_threads([lambda i=i: survivor(i) for i in (0, 1)])
        assert res[0] == res[1] == [0, 1]

        # the zombie wakes: its lease beats carry the OLD epoch
        zombie = gangs[2]
        zombie._publisher.beat(step=None, world=3, members=[0, 1, 2])
        assert gangs[0].await_fenced_refusals(1, timeout_s=5.0) >= 1
        assert gangs[0].fenced_refusals().get("lease", 0) >= 1
        # and its own next op discovers the fence and dies loudly
        with pytest.raises(GangFencedError, match="excluding member 2"):
            zombie.allgather(1, label="stale")
        for i in (0, 1):
            gangs[i].stop()

    def test_op_timeout_on_fresh_peer_is_loud_but_not_sticky(self):
        """A peer that is alive (fresh lease) but absent from a
        collective past the hard op cap raises a NAMED RankLostError —
        but must NOT become a sticky suspect: heal() then observes it
        alive, misses its proposal, and dies loudly with
        GangConsensusError instead of seceding a live member into a
        smaller gang (a slow step is not a death)."""
        store = InProcessLaneStore()
        gangs = _make_gangs(store, 2, op_timeout_s=0.3,
                            consensus_timeout_s=0.4)
        for g in gangs:
            g.start()
        # member 1 beats (alive) but never joins the collective
        with pytest.raises(RankLostError) as ei:
            gangs[0].allgather(1, label="slowpeer")
        assert ei.value.ranks == [1]
        assert ei.value.lease_age_s[1] is not None  # named, fresh
        assert gangs[0]._suspects == {}             # NOT suspected
        with pytest.raises(GangConsensusError):
            gangs[0].heal()                         # loud, no secession
        for g in gangs:
            g.stop()

    def test_same_epoch_divergent_membership_is_fenced(self):
        """Two partitions that independently reconfigure onto the SAME
        epoch number must still detect each other: a same-epoch lease
        whose membership excludes this member is a fence, not live
        evidence — a split brain may never persist behind an equal
        epoch."""
        from chainermn_tpu_torch.health import HeartbeatPublisher

        store = InProcessLaneStore()
        g = _make_gangs(store, 3)[2]
        g.start()
        # member 0's lease claims a same-epoch gang {0, 1} without us
        rogue = HeartbeatPublisher(store, "t-r0", role="trainer",
                                   epoch=1, beat_interval_s=0.02)
        rogue.beat(members=[0, 1])
        with pytest.raises(GangFencedError, match="divergent"):
            g._read_lease(0)
        g.stop()

    def test_consensus_timeout_is_loud(self):
        """A live peer that never participates in consensus produces a
        bounded GangConsensusError — disagreement degrades to a loud
        death, never a hang."""
        store = InProcessLaneStore()
        gangs = _make_gangs(store, 2, consensus_timeout_s=0.4)
        for g in gangs:
            g.start()
        # member 1 keeps beating but never runs heal()/consensus
        with pytest.raises(GangConsensusError, match="did not converge"):
            gangs[0]._run_consensus()
        for g in gangs:
            g.stop()

    def test_rank_lost_bundle_written(self, tmp_path):
        from chainermn_tpu_torch.observability.flight import read_bundle

        store = InProcessLaneStore()
        gangs = _make_gangs(store, 2, dump_dir=str(tmp_path))
        for g in gangs:
            g.start()
        gangs[1].stop(release=False)
        with pytest.raises(RankLostError) as raised:
            gangs[0].allreduce(1, label="doomed")
        ages = raised.value.lease_age_s
        age = ages.get(1, ages.get("1"))
        # the raised error carries the unrounded age: it really did
        # exceed the window
        assert age is None or age > 0.08
        bundles = [d for d in sorted((tmp_path).iterdir())
                   if d.name.startswith("bundle-")
                   and "rank_lost" in d.name]
        assert bundles, list(tmp_path.iterdir())
        b = read_bundle(str(bundles[0]))
        rl = b["manifest"]["extra"]["rank_lost"]
        assert rl["missing"] == [1]
        assert rl["detection_window_s"] == pytest.approx(0.08)
        # the bundle stores round(age, 3): rounding keeps ">=" (an age
        # of 0.0803 s reads 0.08), not ">"
        assert rl["lease_age_s"]["1"] is None or \
            rl["lease_age_s"]["1"] >= round(0.08, 3)
        gangs[0].stop()

    def test_wire_payloads_are_epoch_stamped(self):
        store = InProcessLaneStore()
        g = _make_gangs(store, 1)[0]
        g.start()
        g.allgather("x", label="solo")
        (tag,) = [t for t in store.tags() if t.startswith("gangx/")]
        msg = pickle.loads(store.get(tag))
        assert msg["schema"] == GANG_SCHEMA
        assert msg["epoch"] == 1 and msg["member"] == 0
        g.stop()


def test_epoch_fence_set_epoch_never_regresses():
    f = EpochFence()
    f.set_epoch("w", 3)
    assert f.admit("w", 3, "lease")
    with pytest.raises(ValueError, match="regress"):
        f.set_epoch("w", 2)
    f.fence("w")
    assert not f.admit("w", 3, "lease")
    assert f.refusal_counts() == {"lease": 1}


def test_circuit_breaker_backoff_and_budget():
    from chainermn_tpu.health import CircuitBreaker as JaxBreaker
    from chainermn_tpu_torch.health import CircuitBreaker

    clock = [0.0]
    for cls in (JaxBreaker, CircuitBreaker):
        clock[0] = 0.0
        b = cls(max_failures=3, backoff_base_s=1.0,
                clock=lambda: clock[0])
        seen = []
        for _ in range(3):
            b.record_failure()
            seen.append((b.allow(), b.state()))
            clock[0] += 1.5
            seen.append(b.allow())
        if cls is JaxBreaker:
            want = seen
    assert seen == want and not b.allow()


def test_guard_names_a_silent_peer_and_exits_44_at_world_2(tmp_path):
    from chainermn_tpu_torch.observability.flight import (find_bundles,
                                                          read_bundle)

    rcs, logs, _ = worker.launch("guard", tmp_path, timeout=90)
    assert rcs == [44, 0], "\n".join(logs)[-4000:]
    assert "guard armed" in logs[0]
    assert "lease table names rank(s) [1] as lost" in logs[0]
    assert "exit 44" in logs[0]
    assert "the guard did not fire" not in logs[0]
    (bundle,) = [b for b in find_bundles(str(tmp_path)) if "rank_lost" in b]
    info = read_bundle(bundle)["manifest"]["extra"]["rank_lost"]
    assert info["missing"] == [1] and info["op"] == "allreduce"
    assert info["source"] == "collective_guard"

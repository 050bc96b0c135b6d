"""The port's cross-process serving fleet vs the JAX package's.

The mailboxes over the lane stores, ``submit_with_retry``, the fleet cache
index, the KV economy's pull decision, the worker role loops and the
supervised ``FleetRouter`` (dispatch, leases, epoch fencing, the breaker,
failover, the orphan sweep, drain), the heterogeneous fleet and
``rolling_upgrade``, and the process fleet behind ``serve --fleet-procs``.
Held against JAX: the mailbox wire both ways, the back-off schedule, the
index under one seeded op stream, the pull plans, ``build_local_fleet``'s
tokens and dispatch choices (greedy and sampled: the sampling key rides the
wire as two uint32 words) on the same weights, every other fleet's tokens
against JAX's ``lm_generate``, the journal of a process fleet against JAX's
conformance monitor, and ``serve --fleet-procs 2`` against the JAX CLI's
(summary keys, metric keys, tokens).  The CPU only: width 16, 2 layers,
torch in one thread here and in every spawned worker.
"""

import json
import os
import pickle
import random
import re
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import chainermn_tpu as mn
from chainermn_tpu.communicators.base import \
    set_lane_fault_injector as jax_set_lane_fault_injector
from chainermn_tpu.parallel import init_tp_transformer_lm as jax_init
from chainermn_tpu.parallel import make_lm_generator
from chainermn_tpu.serving import fleet as jfleet
from chainermn_tpu.serving import fleet_cache as jfleet_cache
from chainermn_tpu.serving import lanes as jlanes
from chainermn_tpu.serving.scheduler import AdmissionError as JaxAdmissionError
from chainermn_tpu_torch.communicators.base import set_lane_fault_injector
from chainermn_tpu_torch.convert import from_jax, tree_map
from chainermn_tpu_torch.observability import journal as tjr
from chainermn_tpu_torch.serving import (AdmissionError, FileLaneStore,
                                         FleetCacheIndex, ModelRegistry,
                                         ModelVariant, build_local_fleet,
                                         build_proc_fleet, rolling_upgrade,
                                         submit_with_retry)
from chainermn_tpu_torch.serving import fleet as tfleet
from chainermn_tpu_torch.serving.lanes import (MSG_SCHEMA, MailboxReceiver,
                                               MailboxSender)
from chainermn_tpu_torch.serving.transfer import InProcessLaneStore

ROOT = os.path.join(os.path.dirname(__file__), "..")
VOCAB, D, HEADS, LAYERS = 32, 16, 4, 2
HEAD_DIM = D // HEADS
ORACLE_NEW = 8
MODEL_ARGV = ["--vocab", str(VOCAB), "--d-model", str(D), "--n-heads",
              str(HEADS), "--n-layers", str(LAYERS), "--pos-impl", "rope"]
WK = dict(n_slots=2, max_total=24, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch in one thread here and in the workers this file spawns."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if old is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = old


@pytest.fixture(autouse=True)
def _no_lane_faults():
    set_lane_fault_injector(None)
    jax_set_lane_fault_injector(None)
    tjr.reset()
    yield
    set_lane_fault_injector(None)
    jax_set_lane_fault_injector(None)
    tjr.reset()


_STATE = {}


def _model(seed=0):
    """(JAX params, the port's, the one-device mesh) at ``seed``."""
    if seed not in _STATE:
        jp = jax_init(jax.random.PRNGKey(seed), VOCAB, D, HEADS, LAYERS,
                      max_len=64, pos_impl="rope")
        tp = from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        mesh = mn.make_nd_mesh(("model",), (1,), jax.devices()[:1])
        _STATE[seed] = (jp, tp, mesh)
    return _STATE[seed]


def _oracle(prompt, n, seed=0):
    """JAX ``lm_generate``'s greedy tokens for ``prompt``, the first ``n``."""
    jp, _, mesh = _model(seed)
    cache = _STATE.setdefault("oracle", {})
    key = (seed, tuple(int(t) for t in prompt))
    if key not in cache:
        gen = _STATE.get("gen")
        if gen is None:
            gen = _STATE["gen"] = make_lm_generator(
                mesh, "model", head_dim=HEAD_DIM, max_new_tokens=ORACLE_NEW)
        cache[key] = np.asarray(
            gen(jp, np.asarray(prompt, np.int32)[None]))[0].tolist()
    assert n <= ORACLE_NEW
    return cache[key][:n]


def _prompts(seed, n, length=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, length).astype(np.int32)
            for _ in range(n)]


def _drive(router, runtimes, n=1, live=None):
    for _ in range(n):
        for rt in (live if live is not None else runtimes):
            rt.step()
        router.step()


def _drive_until(router, runtimes, pred, live=None, timeout=60,
                 what="condition"):
    t0 = time.time()
    while not pred():
        assert time.time() - t0 < timeout, f"fleet hung: {what}"
        _drive(router, runtimes, live=live)
        time.sleep(0.0005)


def _drive_until_terminal(router, runtimes, handles, live=None):
    _drive_until(router, runtimes,
                 lambda: all(h.status in ("done", "evicted")
                             for h in handles), live=live,
                 what=str([(h.status, h.finish_reason) for h in handles]))


def _close(router, runtimes):
    for rt in runtimes:
        rt.finished = True
    router.close()


@pytest.fixture
def local_fleet(tmp_path):
    _, tp, _ = _model()
    router, runtimes = build_local_fleet(
        tp, {"engine": 2}, head_dim=HEAD_DIM,
        bundle_dir=str(tmp_path / "bundles"),
        beat_interval_s=0.01, miss_beats=3, worker_kwargs=dict(WK))
    yield router, runtimes, str(tmp_path / "bundles")
    _close(router, runtimes)


# ---------------------------------------------------------------------------
# mailboxes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store_kind", ["file", "inprocess"])
def test_mailbox_order_and_at_most_once(tmp_path, store_kind):
    store = (FileLaneStore(str(tmp_path)) if store_kind == "file"
             else InProcessLaneStore())
    tx = MailboxSender(store, "ctl.w0")
    rx = MailboxReceiver(store, "ctl.w0")
    assert rx.recv() is None                    # empty is not a fault
    for i in range(5):
        assert tx.send({"kind": "submit", "i": i}) == i
    got = rx.drain()
    assert [m["i"] for m in got] == list(range(5))
    assert all(m["schema"] == MSG_SCHEMA == jlanes.MSG_SCHEMA
               for m in got)
    assert rx.recv() is None                    # consumed exactly once
    tx.send({"kind": "drain"})
    assert rx.recv()["kind"] == "drain"         # the cursor survives
    assert not [t for t in getattr(store, "tags", lambda: [])()
                if t.startswith("mbx/")]         # deleted behind it


def test_mailbox_wire_is_jaxs_both_ways(tmp_path):
    """A JAX receiver reads the port's sender and the reverse: one wire."""
    store = FileLaneStore(str(tmp_path))
    MailboxSender(store, "a").send({"kind": "token", "token": 7,
                                    "trace_id": "t"})
    jlanes.MailboxSender(store, "b").send({"kind": "result", "tokens": [1]})
    assert jlanes.MailboxReceiver(store, "a").recv()["token"] == 7
    assert MailboxReceiver(store, "b").recv()["tokens"] == [1]


def test_mailbox_refuses_foreign_schema(tmp_path):
    store = FileLaneStore(str(tmp_path))
    store.put("mbx/ctl.w0/0", pickle.dumps({"schema": "bogus.v9",
                                            "kind": "submit"}))
    for rx in (MailboxReceiver(store, "ctl.w0"),
               jlanes.MailboxReceiver(store, "ctl.w0")):
        with pytest.raises(ValueError, match="refusing worker-lane message"):
            rx.recv()


def test_mailbox_concurrent_sends_lose_nothing(tmp_path):
    """One sender object, many threads (client submits and the supervisor
    share a control mailbox): distinct seqs, nothing overwritten,
    per-thread order kept; the switch interval shortened to force
    interleavings."""
    store = FileLaneStore(str(tmp_path))
    tx = MailboxSender(store, "ctl.w0")
    rx = MailboxReceiver(store, "ctl.w0")
    n_threads, per_thread = 12, 20
    barrier = threading.Barrier(n_threads)

    def blast(i):
        barrier.wait()
        for j in range(per_thread):
            tx.send({"kind": "submit", "src": i, "j": j})

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=blast, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    got = rx.drain(limit=10_000)
    assert len(got) == n_threads * per_thread
    assert [m["seq"] for m in got] == list(range(n_threads * per_thread))
    for i in range(n_threads):
        assert [m["j"] for m in got if m["src"] == i] == \
            list(range(per_thread))


def test_mailbox_journal_fields_equal_jax():
    for msg in ({"req": {"trace_id": "x"}, "worker": "w", "epoch": 2},
                {"trace_id": "t", "worker": None, "kind": "token"},
                {"kind": "drain"}):
        from chainermn_tpu_torch.serving.lanes import _msg_journal_fields
        assert _msg_journal_fields(msg) == jlanes._msg_journal_fields(msg)


# ---------------------------------------------------------------------------
# submit_with_retry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("retry_after,base,jitter,attempts", [
    (40.0, 5.0, 0.25, 4), (None, 8.0, 0.0, 4), (None, 3.0, 0.5, 6),
    (5000.0, 5.0, 0.1, 3)])
def test_submit_with_retry_schedule_equal_jax(retry_after, base, jitter,
                                              attempts):
    """Bounded attempts, the jittered back-off that honors
    ``retry_after_ms`` (capped), the machine-readable give-up: the same
    delays as JAX's under one seeded jitter source."""
    out = {}
    for name, fn, err in (("jax", jfleet.submit_with_retry,
                           JaxAdmissionError),
                          ("torch", submit_with_retry, AdmissionError)):
        calls, delays = [], []

        def submit(x, rng=None):
            calls.append((x, rng))
            raise err("shed_slo", "busy", retry_after_ms=retry_after,
                      queue_depth=3)

        with pytest.raises(err) as e:
            fn(submit, 7, max_attempts=attempts, base_backoff_ms=base,
               jitter_frac=jitter, jitter_rng=random.Random(11),
               sleep=lambda s: delays.append(s * 1e3), rng="key")
        assert e.value.reason == "shed_slo"
        assert e.value.to_dict().get("retry_after_ms") == retry_after
        assert calls == [(7, "key")] * attempts
        out[name] = delays
    assert out["torch"] == out["jax"] and len(out["torch"]) == attempts - 1
    state = {"n": 0}

    def flaky(x):
        state["n"] += 1
        if state["n"] == 1:
            raise AdmissionError("queue_full", "full", retry_after_ms=1.0)
        return "handle"

    assert submit_with_retry(flaky, 1, max_attempts=3,
                             sleep=lambda s: None) == "handle"
    assert state["n"] == 2


# ---------------------------------------------------------------------------
# the fleet cache index and the pull decision
# ---------------------------------------------------------------------------

def test_fleet_cache_index_equal_jax_under_one_op_stream():
    rng = random.Random(0xEC0)
    roots = [tuple(rng.randrange(16) for _ in range(4)) for _ in range(6)]
    workers = [f"w{i}" for i in range(4)]
    idx = {"jax": jfleet_cache.FleetCacheIndex(min_prefix_len=2),
           "torch": FleetCacheIndex(min_prefix_len=2)}
    geom = {"n_layers": 2, "kv_dim": 16, "dtype": "float32",
            "model_id": "default"}

    def seq():
        return rng.choice(roots) + tuple(
            rng.randrange(16) for _ in range(rng.randrange(0, 5)))

    for step in range(2500):
        op, w = rng.random(), rng.choice(workers)
        if op < 0.3:
            s, tier = seq(), rng.choice(["hot", "hot", "spill"])
            args = (w, rng.randrange(1, 4), s, len(s))
            res = [i.insert(*args, geom=geom, tier=tier).length
                   for i in idx.values()]
        elif op < 0.45:
            s = seq()
            tier = rng.choice([None, "spill"])
            res = [i.evict(w, s, tier=tier) for i in idx.values()]
        elif op < 0.55:
            s = seq()
            res = [i.demote(w, s) for i in idx.values()]
        elif op < 0.6:
            res = [i.drop_worker(w) for i in idx.values()]
        elif op < 0.65:
            ents = [{"seq": list(seq()), "length": rng.randrange(2, 6)}
                    for _ in range(rng.randrange(4))]
            res = [i.snapshot(w, 2, ents, geom=geom) for i in idx.values()]
        elif op < 0.7:
            reason = rng.choice(["stale", "crc"])
            res = [i.count_stale(reason) for i in idx.values()]
        else:
            prompt = seq() + (99,)
            live = set(rng.sample(workers, rng.randrange(1, 5)))
            mid = rng.choice([None, "default", "other"])
            res = []
            for i in idx.values():
                rec, mlen = i.match(prompt, workers=live, model_id=mid)
                res.append((None if rec is None else
                            (rec.worker, rec.seq, rec.tier), mlen,
                            i.match_for(w, prompt)))
        assert res[0] == res[1], (step, res)
        if step % 500 == 499:
            for i in idx.values():
                i.check_invariants()
            assert idx["torch"].stats() == idx["jax"].stats()
            assert idx["torch"].state() == idx["jax"].state()
    assert idx["torch"].inserts > 500 and idx["torch"].hits > 50


def _bare_router(mod, store):
    clients = [mod.WorkerClient(f"engine{i}", "engine", store)
               for i in range(3)]
    return mod.FleetRouter(clients, store)


def test_pull_plans_equal_jax():
    """The KV economy's transfer-vs-re-prefill decision in token units:
    the same announces and leases into both routers, the same plans (or
    the same refusals) for a seeded stream of prompts and destinations,
    the geometry-mismatch and model-mismatch fallbacks counted alike."""
    rng = random.Random(3)
    routers = {"jax": _bare_router(jfleet, InProcessLaneStore()),
               "torch": _bare_router(tfleet, InProcessLaneStore())}
    try:
        roots = [tuple(rng.randrange(VOCAB) for _ in range(12))
                 for _ in range(3)]
        for i in range(3):
            for r in routers.values():
                wc = r.workers[f"engine{i}"]
                wc.state = "live"
                wc.last_lease = {"geom": {
                    "n_layers": 2, "kv_dim": 16 if i < 2 else 8,
                    "dtype": "float32", "model_id": "default"}}
        for _ in range(30):
            w = f"engine{rng.randrange(3)}"
            root = rng.choice(roots)
            n = rng.randrange(3, 12)
            msg = {"op": rng.choice(["insert", "insert", "evict"]),
                   "prefix": list(root[:n]), "length": n,
                   "geom": {"n_layers": 2, "kv_dim": 16,
                            "dtype": rng.choice(["float32", "bfloat16"]),
                            "model_id": rng.choice(["default", "x"])},
                   "spilled": rng.random() < 0.3}
            for r in routers.values():
                r._on_cache_announce(r.workers[w], msg)
        plans = {name: [] for name in routers}
        for k in range(60):
            root = rng.choice(roots)
            prompt = list(root[:rng.randrange(2, 12)]) + [
                rng.randrange(VOCAB) for _ in range(rng.randrange(3))]
            dst = f"engine{rng.randrange(3)}"
            for name, r in routers.items():
                plans[name].append(r._plan_pull(r.workers[dst], prompt,
                                                f"req-{k}"))
        assert plans["torch"] == plans["jax"]
        assert any(p is not None for p in plans["torch"])
        for name in routers:
            m = {k: v for k, v in routers[name].metrics().items()
                 if k.startswith("fleet/cache/")}
            plans[name] = m
        assert plans["torch"] == plans["jax"]
    finally:
        for r in routers.values():
            r.close()


# ---------------------------------------------------------------------------
# the in-process fleet: tokens and dispatch equal JAX's
# ---------------------------------------------------------------------------

def _share_jax_programs(runtimes):
    """Point the JAX runtimes' engines at one set of compiled programs
    (pure functions of their operands: each shape still compiles once)."""
    progs = _STATE.setdefault("jax_progs", {"tick": None, "prefill": {}})
    for rt in runtimes:
        e = rt.engine.engine
        if progs["tick"] is None:
            progs["tick"] = e._tick_prog
        e._tick_prog = progs["tick"]
        e._prefill_progs = progs["prefill"]


@pytest.mark.parametrize("sampled", [False, True])
def test_local_fleet_tokens_and_dispatch_equal_jax(sampled):
    """``build_local_fleet`` of 2 engines, fp32: the same requests, in the
    same order and the same drive, land on the same workers and decode to
    the same tokens in both packages; sampled requests carry their
    threefry key as two uint32 words across the wire, bit for bit."""
    jp, tp, mesh = _model()
    prompts = _prompts(7, 6)
    keys = [np.asarray(jax.random.fold_in(jax.random.PRNGKey(5), i),
                       np.uint32) for i in range(6)]
    out = {}
    for name in ("jax", "torch"):
        if name == "jax":
            router, runtimes = jfleet.build_local_fleet(
                jp, {"engine": 2}, head_dim=HEAD_DIM, beat_interval_s=0.05,
                miss_beats=40, worker_kwargs=dict(n_slots=2, max_total=24,
                                                  mesh=mesh))
            _share_jax_programs(runtimes)
        else:
            router, runtimes = build_local_fleet(
                tp, {"engine": 2}, head_dim=HEAD_DIM, beat_interval_s=0.05,
                miss_beats=40, worker_kwargs=dict(WK))
        try:
            _drive(router, runtimes, n=3)
            handles, went = [], []
            for i, p in enumerate(prompts):
                kw = ({"temperature": 0.8, "rng": keys[i]}
                      if sampled and i % 2 else {})
                handles.append(router.submit(p, 6, **kw))
                with router._lock:
                    went.append(router._inflight[handles[-1].trace_id]
                                ["worker"])
            _drive_until_terminal(router, runtimes, handles)
            m = router.metrics()
            out[name] = ([h.tokens for h in handles], went,
                         [h.finish_reason for h in handles],
                         m["fleet/dispatched_total"], m["fleet/shed_rate"],
                         sorted(m))
        finally:
            _close(router, runtimes)
    assert out["torch"] == out["jax"]
    tokens, went = out["torch"][0], out["torch"][1]
    assert set(went) == {"engine0", "engine1"}
    for i, (p, t) in enumerate(zip(prompts, tokens)):
        if not (sampled and i % 2):
            assert t == _oracle(p, 6)


# ---------------------------------------------------------------------------
# supervision: failover, the orphan sweep, fencing, the breaker, drain
# ---------------------------------------------------------------------------

def test_kill_failover_exactly_one_outcome(local_fleet):
    """A worker killed mid-decode: detection within the lease window,
    every in-flight request either completes (JAX's tokens) on the
    survivor or is shed with a ``worker_lost`` payload, never both; the
    bundle names the worker, its lane and each outcome once."""
    from chainermn_tpu_torch.observability.flight import (find_bundles,
                                                          read_bundle)

    router, runtimes, bundles = local_fleet
    w0, w1 = runtimes
    _drive(router, runtimes, n=3)
    prompts = _prompts(1, 6)
    handles = [router.submit(p, 8) for p in prompts]
    _drive(router, runtimes, n=2)
    t_kill = time.monotonic()
    w0.kill()
    _drive_until_terminal(router, runtimes, handles, live=[w1])
    det = router.last_detection
    assert det is not None and det["worker"] == "engine0"
    assert "out.engine0" in det["lane"]
    assert det["lease_age_s"] <= router.lease_window_s + 0.5
    assert time.monotonic() - t_kill >= router.lease_window_s * 0.9
    for p, h in zip(prompts, handles):
        if h.status == "done":
            assert h.shed_payload is None and h.tokens == _oracle(p, 8)
        else:
            assert h.finish_reason == "shed"
            assert h.shed_payload["reason"] == "worker_lost"
            assert h.tokens == []
    wl = (read_bundle(find_bundles(bundles)[-1])["manifest"]["extra"]
          or {})["worker_lost"]
    traced = [r["trace_id"] for r in wl["in_flight"]]
    assert wl["worker"] == "engine0" and len(traced) == len(set(traced))
    assert all(r["outcome"] in ("redispatched", "shed")
               for r in wl["in_flight"])
    m = router.metrics()
    assert m["fleet/redispatched_total"] >= 1
    assert router._results + m["fleet/shed_inflight_total"] == len(handles)


def test_orphan_sweep_rescues_entry_on_dead_worker(local_fleet):
    """The submit / death race: an entry registered on a worker after the
    supervisor enumerated its in-flight requests is failed over by the
    orphan sweep, not left to hang."""
    router, runtimes, _ = local_fleet
    _drive(router, runtimes, n=3)
    prompt = (np.arange(5) % VOCAB).astype(np.int32)
    h = router.submit(prompt, 6)
    with router._lock:
        trace_id, entry = next(iter(router._inflight.items()))
        router._inflight.pop(trace_id)
    victim = entry["worker"]
    rt_victim = next(rt for rt in runtimes if rt.name == victim)
    survivors = [rt for rt in runtimes if rt.name != victim]
    rt_victim.kill()
    _drive_until(router, runtimes,
                 lambda: router.workers[victim].state == "dead",
                 live=survivors, what="death")
    assert router.last_detection["in_flight"] == []
    with router._lock:
        router._inflight[trace_id] = entry
    _drive_until_terminal(router, runtimes, [h], live=survivors)
    assert h.status == "done" and h.tokens == _oracle(prompt, 6)
    assert router.metrics()["fleet/redispatched_total"] >= 1


def test_submit_send_failure_rejects_cleanly(local_fleet):
    router, runtimes, _ = local_fleet
    _drive(router, runtimes, n=3)

    def injector(lane, attempt):
        if lane.startswith("worker_lane/ctl.") and lane.endswith("/send"):
            raise RuntimeError("assertion failed: injected lane fault")

    set_lane_fault_injector(injector)
    try:
        with pytest.raises(AdmissionError) as e:
            router.submit((np.arange(5) % VOCAB).astype(np.int32), 6)
    finally:
        set_lane_fault_injector(None)
    assert e.value.reason == "worker_lost"
    assert router.requests_table()["in_flight"] == [] and not router.busy
    m = router.metrics()
    assert m["fleet/dispatched_total"] == 0
    assert m["fleet/rejected/worker_lost"] == 1 and m["fleet/shed_rate"] == 1
    h = router.submit((np.arange(5) % VOCAB).astype(np.int32), 4)
    _drive_until_terminal(router, runtimes, [h])
    assert h.status == "done"


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_router_thread_death_is_bounded_and_loud(local_fleet):
    from chainermn_tpu_torch.observability.flight import find_bundles

    router, runtimes, bundles = local_fleet
    _drive(router, runtimes, n=3)
    h = router.submit((np.arange(5) % VOCAB).astype(np.int32), 8)
    router.start(poll_s=0.001)

    def injector(lane, attempt):
        if lane.startswith("worker_lane/out.") and lane.endswith("/recv"):
            raise RuntimeError("assertion failed: injected store fault")

    set_lane_fault_injector(injector)
    try:
        t0 = time.time()
        while router._thread.is_alive():
            assert time.time() - t0 < 30
            time.sleep(0.005)
    finally:
        set_lane_fault_injector(None)
    assert h.finish_reason == "shed"
    assert "router thread died" in h.shed_payload["detail"]
    with pytest.raises(AdmissionError, match="router thread died"):
        router.submit((np.arange(5) % VOCAB).astype(np.int32), 4)
    assert any("fleet_router_death" in os.path.basename(p)
               for p in find_bundles(bundles))


def test_zombie_fencing_and_breaker_readmission(local_fleet):
    """A paused-then-resumed worker's stale-epoch leases, tokens and
    results are refused and counted; a corpse stays dead; re-admission is
    the breaker's call, with a fresh epoch the worker adopts."""
    router, runtimes, _ = local_fleet
    w0, w1 = runtimes
    _drive(router, runtimes, n=3)
    prompts = _prompts(2, 4)
    handles = [router.submit(p, 8) for p in prompts]
    _drive(router, runtimes, n=2)
    w0.kill()
    _drive_until_terminal(router, runtimes, handles, live=[w1])
    assert router.workers["engine0"].state == "dead"
    old_epoch = w0.epoch
    time.sleep(0.6)                       # past the breaker's hold-off
    corpse = dict(router.fence.refusal_counts())
    for _ in range(20):
        _drive(router, runtimes, live=[w1])
        time.sleep(0.002)
    assert router.workers["engine0"].state == "dead"
    assert router._readmitted == 0
    assert router.fence.refusal_counts().get("lease", 0) \
        <= corpse.get("lease", 0) + 1
    baseline = dict(router.fence.refusal_counts())
    w0.killed = False                     # resumed: a zombie now
    for _ in range(10):
        _drive(router, runtimes)
        time.sleep(0.002)
    counts = router.fence.refusal_counts()
    assert counts.get("lease", 0) > baseline.get("lease", 0), counts
    for p, h in zip(prompts, handles):
        assert h.status == "done" and h.tokens == _oracle(p, 8)
    time.sleep(0.6)
    for _ in range(10):
        _drive(router, runtimes)
        time.sleep(0.002)
    wc = router.workers["engine0"]
    assert wc.state == "live" and wc.epoch > old_epoch == 1
    assert w0.epoch == wc.epoch            # the hello was adopted
    h = router.submit(prompts[0], 6)
    _drive_until_terminal(router, runtimes, [h])
    assert h.tokens == _oracle(prompts[0], 6)


def test_graceful_drain_sheds_nothing(local_fleet):
    from chainermn_tpu_torch.observability.flight import find_bundles

    router, runtimes, bundles = local_fleet
    w0, w1 = runtimes
    _drive(router, runtimes, n=3)
    prompts = _prompts(3, 4)
    handles = [router.submit(p, 8) for p in prompts]
    _drive(router, runtimes, n=2)
    router.drain("engine0")
    _drive_until(router, runtimes,
                 lambda: router.workers["engine0"].state == "drained",
                 what="drain")
    assert w0.finished
    _drive_until_terminal(router, runtimes, handles, live=[w1])
    for p, h in zip(prompts, handles):
        assert h.status == "done" and h.tokens == _oracle(p, 8)
    m = router.metrics()
    assert m["fleet/shed_inflight_total"] == 0
    assert m["fleet/rejected_total"] == 0
    assert m["fleet/drained_workers"] == 1
    h = router.submit(prompts[0], 6)
    _drive_until_terminal(router, runtimes, [h], live=[w1])
    assert h.status == "done"
    assert any("drain" in os.path.basename(p) for p in find_bundles(bundles))


# ---------------------------------------------------------------------------
# the role split, the KV economy, the heterogeneous fleet, rolling upgrade
# ---------------------------------------------------------------------------

def test_prefill_decode_roles_over_the_lane_plane():
    """prompts → the prefill worker → slabs over the lane → installs on
    the decode workers → JAX's tokens; every pool drained, no decode
    worker prefilled."""
    _, tp, _ = _model()
    router, runtimes = build_local_fleet(
        tp, {"prefill": 1, "decode": 2}, head_dim=HEAD_DIM,
        worker_kwargs=dict(WK))
    try:
        _drive(router, runtimes, n=3)
        prompts = _prompts(4, 5)
        handles = [router.submit(p, 6) for p in prompts]
        _drive_until_terminal(router, runtimes, handles)
        for p, h in zip(prompts, handles):
            assert h.status == "done" and h.tokens == _oracle(p, 6)
        for rt in runtimes:
            rt.pool.allocator.check_invariants()
            assert rt.pool.busy_count == 0 and rt.pool.reserved_count == 0
        assert runtimes[0].dec_engine.prefill_calls == 5
        assert sum(rt.engine.engine.prefill_calls
                   for rt in runtimes[1:]) == 0
        assert router.metrics()["fleet/dispatched_total"] == 5
    finally:
        _close(router, runtimes)


def test_shared_prefix_pulled_not_prefilled():
    """The KV economy end to end: one prompt's slab announced by its
    owner is pulled by the other workers' local misses (priced and
    planned as JAX plans), one prefill fleet-wide, JAX's tokens."""
    _, tp, _ = _model()
    router, runtimes = build_local_fleet(
        tp, {"engine": 3}, head_dim=HEAD_DIM, beat_interval_s=0.01,
        miss_beats=3, worker_kwargs=dict(WK, n_slots=3, queue_capacity=8))
    try:
        _drive(router, runtimes, n=3)
        prompt = (np.arange(10) % VOCAB).astype(np.int32)
        leader = router.submit(prompt, 6)
        _drive_until_terminal(router, runtimes, [leader])
        _drive_until(router, runtimes,
                     lambda: router.cache_index.n_entries >= 1,
                     what="cache announce")
        followers = [router.submit(prompt, 6) for _ in range(2)]
        _drive_until_terminal(router, runtimes, followers)
        for h in [leader] + followers:
            assert h.tokens == _oracle(prompt, 6)
        assert sum(rt.engine.engine.prefill_calls for rt in runtimes) == 1
        m = router.metrics()
        assert m["fleet/cache/remote_pulls"] >= 1
        assert m["fleet/cache/stale_fallbacks"] == 0
        for rt in runtimes:
            rt.pool.allocator.check_invariants()
            assert rt.engine.prefix_cache.total_refcount() == 0
    finally:
        _close(router, runtimes)


def test_heterogeneous_fleet_routes_by_model(tmp_path):
    _, p_small, _ = _model(0)
    _, p_big, _ = _model(1)
    reg = ModelRegistry()
    reg.register(ModelVariant("small", p_small, head_dim=HEAD_DIM))
    reg.register(ModelVariant("big", p_big, head_dim=HEAD_DIM))
    with pytest.raises(ValueError, match="already registered"):
        reg.register(ModelVariant("big", p_big, head_dim=HEAD_DIM))
    router, runtimes = build_local_fleet(
        None, {"engine": ["small", "big"]}, registry=reg,
        beat_interval_s=0.02, miss_beats=16, worker_kwargs=dict(WK))
    try:
        _drive(router, runtimes, n=3)
        prompt = [3, 1, 4, 1, 5]
        hs = router.submit(prompt, 6, model_id="small")
        hb = router.submit(prompt, 6, model_id="big")
        _drive_until_terminal(router, runtimes, [hs, hb])
        assert hs.tokens == _oracle(prompt, 6, seed=0)
        assert hb.tokens == _oracle(prompt, 6, seed=1)
        assert hs.tokens != hb.tokens
        assert {w.model_id for w in router.workers.values()} == \
            {"small", "big"}
        with pytest.raises(AdmissionError) as ei:
            router.submit(prompt, 4, model_id="ghost")
        assert ei.value.reason == "no_model_worker"
        assert router.metrics()["fleet/rejected/no_model_worker"] == 1
    finally:
        _close(router, runtimes)


def test_rolling_upgrade_zero_shed_token_exact():
    """A new weight generation, re-saved by a 2-process world with the
    embedding row-sharded, installed worker by worker: the old workers
    drain, nothing sheds, the pinned request decodes as before."""
    _, tp, _ = _model()
    router, runtimes = build_local_fleet(
        tp, {"engine": 2}, head_dim=HEAD_DIM, beat_interval_s=0.02,
        miss_beats=16, worker_kwargs=dict(WK))
    threads = [threading.Thread(target=rt.run, daemon=True)
               for rt in runtimes]
    for t in threads:
        t.start()
    router.start()
    try:
        pinned = [2, 7, 1, 8, 2]
        before = router.submit(pinned, 6)
        assert before.wait(60) and before.tokens == _oracle(pinned, 6)
        layout = tree_map(tp, lambda t: None)
        layout["embed"] = 0
        shards = []
        for i in range(2):
            s = dict(tp)
            s["embed"] = torch.chunk(tp["embed"], 2, dim=0)[i]
            shards.append(s)
        old = set(router.workers)
        report = rolling_upgrade(router, runtimes, shards, layout,
                                 generation=2, head_dim=HEAD_DIM,
                                 worker_kwargs=dict(WK), timeout_s=60.0)
        assert report["generation"] == 2 and report["drain_shed"] == 0
        assert len(report["upgraded"]) == 2
        assert all(router.workers[n].state == "drained" for n in old)
        live = [w for w in router.workers.values()
                if w.state in ("starting", "live")]
        assert len(live) == 2 and not {w.name for w in live} & old
        after = router.submit(pinned, 6)
        assert after.wait(60) and after.tokens == before.tokens
        assert all(w.weights_generation == 2 for w in live)
        with pytest.raises(ValueError, match="no live engine worker"):
            rolling_upgrade(router, runtimes, shards, layout,
                            generation=2, head_dim=HEAD_DIM,
                            worker_kwargs=dict(WK))
    finally:
        router.stop()
        _close(router, runtimes)


# ---------------------------------------------------------------------------
# worker processes: the journal and JAX's conformance monitor, the CLI
# ---------------------------------------------------------------------------

def test_process_fleet_journal_passes_jax_conformance(tmp_path):
    """``build_proc_fleet`` on the CPU with the causal journal on: two
    worker processes serve four requests and drain; the merged journal
    (the router and both workers) passes the JAX package's conformance
    monitor (done-xor-shed, the lease fence, the slot lifecycle) and has
    the cross-process mailbox and lease edges."""
    from chainermn_tpu.observability.conform import check_dir, render_report

    _, tp, _ = _model()
    jdir = str(tmp_path / "journal")
    router = build_proc_fleet(
        tp, {"engine": 2}, str(tmp_path / "lanes"), head_dim=HEAD_DIM,
        device="cpu", journal_dir=jdir, beat_interval_s=0.05,
        worker_kwargs=dict(n_slots=2, max_total=24))
    try:
        t0 = time.time()
        while any(w.state != "live" for w in router.workers.values()):
            assert time.time() - t0 < 60, "workers never live"
            router.step()
            time.sleep(0.002)
        router.start()
        prompts = _prompts(5, 4)
        handles = [router.submit(p, 6) for p in prompts]
        for h in handles:
            assert h.wait(60)
        router.stop()
        for name in list(router.workers):
            router.drain(name)
            assert router.wait_drained(name, timeout_s=30)
    finally:
        codes = router.shutdown(timeout_s=30)
        router.close()
        tjr.reset()
    assert codes == {"engine0": 0, "engine1": 0}
    for p, h in zip(prompts, handles):
        assert h.tokens == _oracle(p, 6)
    report = check_dir(jdir)
    assert report["ok"], render_report(report)
    assert report["checked"]["done_xor_shed"] == 4
    assert report["checked"]["slot_lifecycle"] >= 2
    assert report["checked"]["lease_fence"] >= 2
    merged = tjr.merge_journals(jdir)
    assert merged["procs"] == ["engine0", "engine1", "router"]
    assert any(e["kind"] == "mailbox" for e in merged["edges"])
    assert any(e["kind"] == "lease" for e in merged["edges"])
    story = tjr.request_story(merged, handles[0].trace_id)
    assert story["outcome"]["kind"] == "done"


def _jax_fleet_metric_keys():
    """The metric keys of JAX's ``FleetRouter`` after it served: a local
    fleet of 2 engines, one request each (the CLI's ``metrics`` block)."""
    if "jax_fleet_keys" not in _STATE:
        jp, _, mesh = _model()
        router, runtimes = jfleet.build_local_fleet(
            jp, {"engine": 2}, head_dim=HEAD_DIM, beat_interval_s=0.05,
            miss_beats=40, worker_kwargs=dict(n_slots=2, max_total=24,
                                              mesh=mesh))
        _share_jax_programs(runtimes)
        try:
            _drive(router, runtimes, n=3)
            hs = [router.submit(p, 2) for p in _prompts(9, 2)]
            _drive_until_terminal(router, runtimes, hs)
            _STATE["jax_fleet_keys"] = set(router.metrics())
        finally:
            _close(router, runtimes)
    return _STATE["jax_fleet_keys"]


def test_serve_cli_fleet_procs_equal_jax(tmp_path, capsys):
    """``serve --fleet-procs 2`` on the CPU: every worker exits 0, the
    summary has the JAX CLI's keys (and the port's own four) and JAX's
    ``FleetRouter`` metric keys, and the tokens of the in-process run,
    which are the JAX CLI's; ``--disagg 1:1 --procs`` serves the same
    tokens."""
    from chainermn_tpu.observability.slo import GoodputLedger
    from chainermn_tpu.serve import main as jax_main
    from chainermn_tpu_torch.serve import run

    argv = ["--train-steps", "0", "--requests", "4", "--max-new-tokens",
            "4", *MODEL_ARGV]
    jax_main(argv)
    io = capsys.readouterr()
    js = json.loads(io.out.strip().splitlines()[-1])
    jtokens = [eval(m.group(1)) for m in re.finditer(
        r"^prompt \[[^\]]*\] -> (\[[^\]]*\])", io.err, re.M)]
    params = jax.tree_util.tree_map(np.asarray, _model()[0])
    fleet = run(["--device", "cpu", *argv, "--fleet-procs", "2",
                 "--lane-dir", str(tmp_path / "lanes")], params=params)
    split = run(["--device", "cpu", *argv, "--disagg", "1:1", "--procs"],
                params=params)
    assert fleet["fleet_exit_codes"] == {"engine0": 0, "engine1": 0}
    assert split["fleet_exit_codes"] == {"prefill0": 0, "decode0": 0}
    assert set(fleet) == set(js) | {"device", "dtype", "tp", "world"}
    assert set(fleet["metrics"]) == _jax_fleet_metric_keys()
    assert set(fleet["goodput"]) == set(GoodputLedger().report())
    assert fleet["fleet_procs"] == split["fleet_procs"] == 2
    assert split["disagg"] == "1:1"
    tokens = [r["tokens"] for r in fleet["requests"]]
    assert tokens == jtokens and len(tokens) == 4
    assert [r["tokens"] for r in split["requests"]] == tokens
    for s in (fleet, split):
        assert all(r["status"] == "done" for r in s["requests"])
        assert s["metrics"]["fleet/shed_rate"] == 0
        assert s["metrics"]["fleet/redispatched_total"] == 0


def test_fleet_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    """A worker, a process fleet and the worker's process entry default
    to the card and raise without one: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from chainermn_tpu_torch.serving import WorkerRuntime
    from chainermn_tpu_torch.serving.worker import main as worker_main

    _, tp, _ = _model()
    with pytest.raises(RuntimeError, match="cuda"):
        WorkerRuntime("w0", "engine", tp, InProcessLaneStore(),
                      head_dim=HEAD_DIM)
    with pytest.raises(RuntimeError, match="cuda"):
        WorkerRuntime("w0", "prefill", tp, InProcessLaneStore(),
                      head_dim=HEAD_DIM)
    with pytest.raises(RuntimeError, match="cuda"):
        build_proc_fleet(tp, {"engine": 1}, str(tmp_path / "lanes"),
                         head_dim=HEAD_DIM)
    assert not os.path.exists(tmp_path / "lanes")   # nothing spawned
    spec = tfleet.write_params_file(str(tmp_path / "p.pkl"), tp,
                                    head_dim=HEAD_DIM)
    with pytest.raises(RuntimeError, match="cuda"):
        worker_main(["--name", "w0", "--role", "engine", "--lane-dir",
                     str(tmp_path / "l"), "--params", spec])
    with open(spec, "rb") as f:
        loaded = pickle.load(f)
    assert loaded["head_dim"] == HEAD_DIM
    assert torch.equal(loaded["params"]["embed"], tp["embed"])
    assert loaded["params"]["embed"].device.type == "cpu"

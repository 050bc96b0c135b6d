"""The port's disaggregated prefill / decode fleet vs the JAX package's.

JAX's ``build_disagg_fleet`` on a one-device mesh and the port's
(``device="cpu"``), built over the same weights (GQA: 2 KV heads of 4,
RoPE; carried by ``convert.from_jax``), take the same schedules: every
request's tokens, the dispatch choices, the transfer / requeue / shed
counters and the plane's bytes must be equal, and the tokens equal to
JAX's ``lm_generate`` alone (greedy tokens come from one 7-token
generation a prompt; a shorter request's are its first tokens).  Both
transports: the same-process row copy (``local``) and pack / object lane
/ unpack (``lanes``, its ``kv_transfer_lane@dcn`` ledger row byte-exact
against ``transfer_cost``).  Also: the reservation gate, the cost model
and the request wire, the slab refusals, backpressure, lane chaos (a
requeue on the survivor, a ``worker_lost`` shed with no survivor, a loss
under concurrent submits), the role threads, ``prefill_bucket`` on the
fused engine and the prefill worker, ``install_request``, ``serve
--disagg`` against the JAX CLI and its refusals, and ``NOT_PORTED``.

The JAX fleets' engines share one set of compiled programs (pure
functions of their operands; each shape still compiles once), which keeps
this file inside its time budget.  The CPU only, width 16, 2 layers.
"""

import json
import os
import pickle
import re
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

import chainermn_tpu as mn
from chainermn_tpu.communicators.base import \
    set_lane_fault_injector as jax_set_lane_fault_injector
from chainermn_tpu.parallel import init_tp_transformer_lm as jax_init
from chainermn_tpu.parallel import make_lm_generator
from chainermn_tpu.serving import AdmissionError as JaxAdmissionError
from chainermn_tpu.serving import Request as JaxRequest
from chainermn_tpu.serving import ServingEngine as JaxServingEngine
from chainermn_tpu.serving import build_disagg_fleet as jax_build
from chainermn_tpu.serving import transfer as jtransfer
from chainermn_tpu.serving.disagg import request_wire as jax_request_wire
from chainermn_tpu_torch.communicators.base import set_lane_fault_injector
from chainermn_tpu_torch.convert import from_jax
from chainermn_tpu_torch.serving import (AdmissionError, Request,
                                         ServingEngine, SlotAllocator,
                                         build_disagg_fleet, request_wire)
from chainermn_tpu_torch.serving import transfer as ttransfer
from chainermn_tpu_torch.serving.frontend import RequestHandle

VOCAB, D, HEADS, LAYERS, KV_HEADS = 32, 16, 4, 2, 2
HEAD_DIM = D // HEADS
ORACLE_NEW = 7
MODEL_ARGV = ["--vocab", str(VOCAB), "--d-model", str(D), "--n-heads",
              str(HEADS), "--n-layers", str(LAYERS), "--kv-heads",
              str(KV_HEADS), "--pos-impl", "rope"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch in one thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_lane_faults():
    set_lane_fault_injector(None)
    jax_set_lane_fault_injector(None)
    yield
    set_lane_fault_injector(None)
    jax_set_lane_fault_injector(None)


_STATE = {}


def _model():
    """(JAX params, the port's, the one-device mesh), built once."""
    if "model" not in _STATE:
        # the serve CLI's model at MODEL_ARGV (RoPE has no max_len table)
        jp = jax_init(jax.random.PRNGKey(0), VOCAB, D, HEADS, LAYERS,
                      max_len=64, pos_impl="rope", n_kv_heads=KV_HEADS)
        tp = from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        mesh = mn.make_nd_mesh(("model",), (1,), jax.devices()[:1])
        _STATE["model"] = (jp, tp, mesh)
        _STATE["progs"] = {"tick": None, "prefill": {}, "local": {},
                           "inject": {}}
    return _STATE["model"]


def _share(engines, plane=None):
    """Point JAX engines (and a plane) at the shared compiled programs."""
    progs = _STATE["progs"]
    for e in engines:
        if progs["tick"] is None:
            progs["tick"] = e._tick_prog
        e._tick_prog = progs["tick"]
        e._prefill_progs = progs["prefill"]
    if plane is not None:
        plane._programs = progs["local"]
        plane._inject_programs = progs["inject"]


def _fleets(p, d, **kw):
    """The JAX fleet and the port's, P:D, the same configuration."""
    jp, tp, mesh = _model()
    jf = jax_build(jp, p, d, head_dim=HEAD_DIM, mesh=mesh, **kw)
    _share([w.engine for w in jf.prefill_workers]
           + [w.engine.engine for w in jf.decode_workers], jf.plane)
    tf = build_disagg_fleet(tp, p, d, head_dim=HEAD_DIM, device="cpu", **kw)
    return jf, tf


def _oracle(prompt, n):
    """JAX ``lm_generate``'s greedy tokens for ``prompt``, the first ``n``."""
    jp, _, mesh = _model()
    cache = _STATE.setdefault("oracle", {})
    key = tuple(int(t) for t in prompt)
    if key not in cache:
        gen = _STATE.get("gen")
        if gen is None:
            gen = _STATE["gen"] = make_lm_generator(
                mesh, "model", head_dim=HEAD_DIM, max_new_tokens=ORACLE_NEW)
        cache[key] = np.asarray(
            gen(jp, np.asarray(prompt, np.int32)[None]))[0].tolist()
    assert n <= ORACLE_NEW
    return cache[key][:n]


def _prompts(seed, n, lo=4, hi=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _drained(fleet):
    """Every pool back to all-free: no leaked slot, no stuck reservation,
    no pending inbox entry, on both roles."""
    for pw in fleet.prefill_workers:
        alloc = pw.pool.allocator
        alloc.check_invariants()
        assert alloc.busy_count == 0 and alloc.reserved_count == 0, pw.name
    for dw in fleet.decode_workers:
        alloc = dw.engine.pool.allocator
        alloc.check_invariants()
        assert alloc.busy_count == 0 and alloc.reserved_count == 0, dw.name
        assert not dw.inbox


def _counters(fleet):
    m = fleet.metrics()
    keys = ("disagg/dispatched_total", "disagg/transfers_total",
            "disagg/requeued_total", "disagg/rejected_total",
            "disagg/dead_prefill_workers", "disagg/plane/transfers",
            "disagg/plane/lane_transfers", "disagg/plane/bytes_moved")
    return ({k: m[k] for k in keys}, dict(fleet._dispatched_by),
            [pw.prefills for pw in fleet.prefill_workers])


# ---------------------------------------------------------------------------
# the reservation gate, the cost model, the wire (host only)
# ---------------------------------------------------------------------------

def test_reservation_state_machine_and_violations():
    from chainermn_tpu.serving.cache_pool import SlotAllocator as JaxAlloc

    for cls in (JaxAlloc, SlotAllocator):
        alloc = cls(3)
        r = alloc.reserve()
        assert r == 0 and alloc.free_count == 2
        assert alloc.acquire() == 1      # never the reserved slot
        alloc.commit_reservation(r)
        assert alloc.busy_count == 2
        alloc.release(r)
        alloc.cancel_reservation(alloc.reserve())
        assert alloc.free_count == 2 and alloc.reserved_count == 0
        alloc.check_invariants()
        alloc = cls(2)
        r = alloc.reserve()
        alloc.commit_reservation(r)
        for bad in (lambda: alloc.commit_reservation(r),
                    lambda: alloc.cancel_reservation(r),
                    lambda: alloc.cancel_reservation(1)):
            with pytest.raises(ValueError, match="not reserved"):
                bad()
        alloc.reserve()
        assert alloc.reserve() is None


def test_admission_never_races_inflight_transfers():
    """Random interleavings of admission, transfer reservations, landings
    and failures: the same state sequence in both allocators, and no
    slot is ever handed out twice."""
    import random

    from chainermn_tpu.serving.cache_pool import SlotAllocator as JaxAlloc

    for seed in range(40):
        trace = {}
        for cls in (JaxAlloc, SlotAllocator):
            rng = random.Random(seed)
            alloc, busy, reserved, seen = cls(4), [], [], []
            for _ in range(60):
                roll = rng.random()
                if roll < 0.35:
                    got = alloc.acquire()
                    if got is not None:
                        assert got not in reserved
                        busy.append(got)
                elif roll < 0.6:
                    got = alloc.reserve()
                    if got is not None:
                        reserved.append(got)
                elif roll < 0.8 and reserved:
                    s = reserved.pop(rng.randrange(len(reserved)))
                    alloc.commit_reservation(s)
                    busy.append(s)
                elif roll < 0.9 and reserved:
                    alloc.cancel_reservation(
                        reserved.pop(rng.randrange(len(reserved))))
                elif busy:
                    alloc.release(busy.pop(rng.randrange(len(busy))))
                alloc.check_invariants()
                seen.append((alloc.free_count, alloc.busy_count,
                             alloc.reserved_count))
            trace[cls] = seen
        assert trace[JaxAlloc] == trace[SlotAllocator]


def test_transfer_cost_and_request_wire_equal_jax():
    from chainermn_tpu.parallel.reshard import reshard_cost as jax_cost

    cases = [dict(mode="lanes"),
             dict(mode="local", axis_size=2, src_spec=2, dst_spec=2,
                  copy_rows=16),
             dict(mode="local", axis_size=2, src_spec=2, dst_spec=None,
                  copy_rows=16),
             dict(mode="local", axis_size=4, src_spec=None, dst_spec=2),
             dict(mode="local")]
    for kw in cases:
        want = jtransfer.transfer_cost(2, 10, 8, np.float32, **kw)
        assert ttransfer.transfer_cost(2, 10, 8, np.float32, **kw) == want
        assert ttransfer.transfer_cost(2, 10, 8, torch.float32, **kw) \
            == want
    per_row = jax_cost((1, 16, 8), np.float32, 2, None, 2)
    got = ttransfer.transfer_cost(2, 10, 8, np.float32, mode="local",
                                  axis_size=2, src_spec=2, dst_spec=None,
                                  copy_rows=16)
    assert got["ledger_bytes"] == 4 * per_row["ledger_bytes"] > 0
    assert ttransfer.slab_nbytes(8, 512, 1024, "bfloat16") \
        == ttransfer.slab_nbytes(8, 512, 1024, torch.bfloat16) \
        == 16 * 1024 * 1024
    for spec in ((None, None, "model"), (None, ("data", "model")), (),
                 (None, "data")):
        assert ttransfer._shard_axis_of(spec, "model") \
            == jtransfer._shard_axis_of(jax.sharding.PartitionSpec(*spec),
                                        "model")
    with pytest.raises(ValueError, match="local.*lanes"):
        ttransfer.transfer_cost(1, 1, 1, np.float32, mode="bogus")

    deadline = time.monotonic() + 5.0
    kw = dict(eos_id=7, deadline_t=deadline, temperature=0.7,
              rng=np.array([1, 2], np.uint32), trace_id="req-wire")
    want = jax_request_wire(JaxRequest([1, 2, 3], 8, **kw), [4])
    got = request_wire(Request([1, 2, 3], 8, **kw), [4])
    assert set(got) == set(want)
    assert abs(got.pop("deadline_rel_s") - want.pop("deadline_rel_s")) < 0.5
    assert got == want and json.dumps(got)


# ---------------------------------------------------------------------------
# exactness against JAX's fleet and lm_generate
# ---------------------------------------------------------------------------

def _fuzz(fleet, prompts, max_new):
    handles = []
    for i, (p, n) in enumerate(zip(prompts, max_new)):
        handles.append(fleet.submit(p, n))
        if i % 3 == 2:
            fleet.step()                 # stagger arrivals across rounds
    fleet.run(steps_budget=600)
    return handles


@pytest.mark.parametrize("transport", ["local", "lanes"])
def test_transfer_exactness_fuzz(transport):
    """2:2, 12 staggered requests of mixed lengths through 2 staging and
    3 decode slots a worker (both sides recycle slots several times): the
    tokens, dispatches and counters of JAX's fleet, the tokens of
    ``lm_generate`` alone, a non-zero ``transfer`` goodput bucket, the role
    split, every pool drained; the plane's stats and the metric keys as
    JAX's."""
    prompts = _prompts(5, 12)
    assert sorted({len(p) for p in prompts}) == [4, 5, 6]
    rng = np.random.RandomState(6)
    max_new = [int(rng.randint(2, ORACLE_NEW + 1)) for _ in prompts]
    jf, tf = _fleets(2, 2, max_total=16, n_slots=3, staging_slots=2,
                     queue_capacity=16, transport_mode=transport)
    try:
        jh, th = _fuzz(jf, prompts, max_new), _fuzz(tf, prompts, max_new)
        for i, (j, t) in enumerate(zip(jh, th)):
            assert j.status == t.status == "done", (i, t.finish_reason)
            assert t.tokens == j.tokens == _oracle(prompts[i], max_new[i]), i
        assert _counters(tf) == _counters(jf)
        tm, jm = tf.metrics(), jf.metrics()
        assert set(tm) == set(jm)
        assert tm["disagg/transfers_total"] == 12.0
        if transport == "lanes":
            assert tm["disagg/plane/bytes_moved"] == sum(
                ttransfer.slab_nbytes(LAYERS, len(p), KV_HEADS * HEAD_DIM,
                                      "float32") for p in prompts)
        assert sum(pw.goodput.buckets()["transfer"]
                   for pw in tf.prefill_workers) > 0.0
        for dw in tf.decode_workers:
            assert dw.engine.engine.prefill_calls == 0
            assert dw.engine.spill is None and dw.engine.prefix_cache is None
        for pw in tf.prefill_workers:
            assert pw.engine.tick_calls == 0 and pw.engine.prefill_calls > 0
        # one set of parameter tensors behind every worker
        ptrs = {w.engine._params["embed"].data_ptr()
                for w in tf.prefill_workers} | {
            w.engine.engine._params["embed"].data_ptr()
            for w in tf.decode_workers}
        assert len(ptrs) == 1
        _drained(tf)
        _drained(jf)
        state = tf.introspect_state()
        assert set(state) == set(jf.introspect_state())
        assert state["plane"]["programs"] == 1.0     # one pool pair
        assert set(tf.requests_table()["workers"]) == set(
            jf.requests_table()["workers"])
        for w in tf.prefill_workers:
            assert set(w.introspect_state()) == set(
                jf.prefill_workers[0].introspect_state())
    finally:
        jf.close()
        tf.close()


def test_sampled_requests_equal_jax_at_fixed_keys():
    """Mixed greedy and sampled requests cross the lanes with their keys:
    the tokens of JAX's fleet at the same keys (and greedy ones
    ``lm_generate``'s); a silent default key is refused."""
    prompts = _prompts(3, 4, 5, 6)
    temps = [0.0, 0.7, 1.3, 0.7]
    keys = [None if t == 0 else np.asarray(jax.random.PRNGKey(100 + i))
            for i, t in enumerate(temps)]
    jf, tf = _fleets(1, 1, max_total=16, n_slots=3, staging_slots=2,
                     queue_capacity=8, transport_mode="lanes")
    try:
        out = {}
        for name, fleet in (("jax", jf), ("torch", tf)):
            hs = [fleet.submit(p, 6, temperature=t, rng=k)
                  for p, t, k in zip(prompts, temps, keys)]
            fleet.run(steps_budget=400)
            assert all(h.status == "done" for h in hs)
            out[name] = [h.tokens for h in hs]
            with pytest.raises(ValueError, match="explicit"):
                fleet.submit([1, 2], 4, temperature=0.8)
        assert out["torch"] == out["jax"]
        assert out["torch"][0] == _oracle(prompts[0], 6)
        assert out["torch"][1] != out["torch"][3]    # sampling is live
        _drained(tf)
    finally:
        jf.close()
        tf.close()


def test_lanes_ledger_bytes_reconcile():
    """Each lanes transfer books its raw slab bytes as one noted
    ``kv_transfer_lane@dcn`` row while tracing: byte-exact against
    ``transfer_cost(mode="lanes")``, the same row as JAX's ledger."""
    from chainermn_tpu import observability as jobs
    from chainermn_tpu_torch import observability as tobs

    prompts = _prompts(1, 3)
    jf, tf = _fleets(1, 1, max_total=16, n_slots=3, staging_slots=2,
                     queue_capacity=8, transport_mode="lanes")
    rows = {}
    try:
        for name, fleet, o in (("jax", jf, jobs), ("torch", tf, tobs)):
            o.reset_all()
            o.enable()
            try:
                hs = [fleet.submit(p, 4) for p in prompts]
                fleet.run(steps_budget=300)
                assert all(h.status == "done" for h in hs)
                rows[name] = o.comm_report()["per_op"][
                    f"{ttransfer.LANE_OP}@{ttransfer.LANE_AXIS}"]
            finally:
                o.disable()
                o.reset_all()
        pool = tf.prefill_workers[0].pool
        want = sum(ttransfer.transfer_cost(
            pool.n_layers, len(p), pool.kv_dim, pool.caches[0][0].dtype,
            mode="lanes")["ledger_bytes"] for p in prompts)
        assert rows["torch"]["bytes"] == rows["jax"]["bytes"] == want
        assert rows["torch"]["calls"] == rows["jax"]["calls"] == 3
        assert tf.plane.bytes_moved == jf.plane.bytes_moved == want
    finally:
        jf.close()
        tf.close()


@pytest.mark.parametrize("backend", ["naive", "xla"])
def test_comm_kv_lane_transport_backs_the_plane(backend):
    """``build_disagg_fleet(comm=..., transport_mode="lanes")`` runs every
    transfer through the communicator's lane transport (the loopback
    store, or the one-rank process group's store), and consumed tags are
    deleted."""
    from chainermn_tpu_torch.communicators import create_communicator

    _, tp, _ = _model()
    comm = (create_communicator("naive", size=1) if backend == "naive"
            else create_communicator("xla", device="cpu"))
    fleet = build_disagg_fleet(tp, 1, 1, head_dim=HEAD_DIM, max_total=16,
                               n_slots=3, staging_slots=2, queue_capacity=4,
                               transport_mode="lanes", comm=comm,
                               device="cpu")
    try:
        prompt = _prompts(3, 1, 5, 6)[0]
        h = fleet.submit(prompt, 4)
        fleet.run(steps_budget=200)
        assert h.status == "done" and h.tokens == _oracle(prompt, 4)
        assert fleet.plane.lane_transfers == 1
        tag = f"{h.trace_id}.slab"
        if backend == "naive":
            assert fleet.plane.transport is comm.kv_lane_transport()
            assert not fleet.plane.transport._store
        else:
            with pytest.raises(TimeoutError):
                comm.kv_lane_transport().get(tag, timeout_s=0.01)
        _drained(fleet)
    finally:
        fleet.close()


def test_unpack_refuses_foreign_slabs():
    """A slab of another schema, another geometry, too long for the pool,
    or with one bit flipped is refused before the pool is touched, in
    JAX's words."""
    jp, tp, mesh = _model()
    kv = KV_HEADS * HEAD_DIM
    ok = {"schema": ttransfer.WIRE_SCHEMA, "meta": {}, "pos": 2,
          "n_layers": LAYERS, "kv_dim": kv, "dtype": "float32",
          "rows": [(np.ones((2, kv), np.float32),) * 2
                   for _ in range(LAYERS)]}
    ok["crc32"] = ttransfer.slab_crc32(ok["rows"])
    flipped = pickle.loads(pickle.dumps(ok))
    k = np.array(flipped["rows"][0][0])
    k.view(np.uint8).flat[0] ^= 1
    flipped["rows"][0] = (k, flipped["rows"][0][1])
    bad = [dict(ok, schema="bogus.v9"), dict(ok, n_layers=7),
           dict(ok, pos=99), flipped]
    from chainermn_tpu.serving.cache_pool import CachePool as JaxPool
    from chainermn_tpu_torch.serving import CachePool

    tpool = CachePool(2, 8, LAYERS, kv, torch.float32, "cpu")
    jpool = JaxPool(2, 8, LAYERS, kv, np.float32, mesh, "model")
    before = [c.clone() for kvp in tpool.caches for c in kvp]
    for data in bad:
        msgs = []
        for plane, pool in ((jtransfer.KvTransferPlane(), jpool),
                            (ttransfer.KvTransferPlane(), tpool)):
            with pytest.raises(ValueError) as e:
                plane.unpack_into(pickle.dumps(data), pool, 0)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert all(torch.equal(a, b) for a, b in zip(
        before, [c for kvp in tpool.caches for c in kvp]))
    assert int(tpool.pos[0]) == 0
    # the good slab lands
    plane = ttransfer.KvTransferPlane()
    stats = plane.unpack_into(pickle.dumps(ok), tpool, 1)
    assert stats["length"] == 2 and int(tpool.pos[1]) == 2
    assert torch.equal(tpool.caches[0][0][1, :2], torch.ones(2, kv))
    assert plane.stats()["lane_transfers"] == 1.0


def test_transfer_local_checks_and_copies():
    """``transfer_local`` copies rows ``[0, min(max_total))`` of every layer
    and sets ``pos``; its range and shape refusals are JAX's."""
    from chainermn_tpu_torch.serving import CachePool

    kv = KV_HEADS * HEAD_DIM
    src = CachePool(2, 8, LAYERS, kv, torch.float32, "cpu")
    dst = CachePool(3, 6, LAYERS, kv, torch.float32, "cpu")
    for c in (c for kvp in src.caches for c in kvp):
        c.copy_(torch.randn(c.shape))
    plane = ttransfer.KvTransferPlane()
    stats = plane.transfer_local(src, 1, dst, 2, 5)
    assert stats == {"mode": "local", "ms": stats["ms"], "ledger_bytes": 0,
                     "length": 5}
    assert int(dst.pos[2]) == 5
    for (ks, vs), (kd, vd) in zip(src.caches, dst.caches):
        assert torch.equal(kd[2], ks[1, :6]) and torch.equal(vd[2],
                                                             vs[1, :6])
    plane.transfer_local(src, 0, dst, 0, 3)
    assert plane.stats() == {"transfers": 2.0, "lane_transfers": 0.0,
                             "bytes_moved": 0.0,
                             "last_transfer_ms": plane.last_transfer_ms,
                             "programs": 1.0}
    with pytest.raises(ValueError, match=r"out of range \(0, 6\]"):
        plane.transfer_local(src, 0, dst, 0, 7)
    other = CachePool(2, 8, LAYERS + 1, kv, torch.float32, "cpu")
    with pytest.raises(ValueError, match="pool shape mismatch"):
        plane.transfer_local(src, 0, other, 0, 3)


# ---------------------------------------------------------------------------
# backpressure, the admission gate
# ---------------------------------------------------------------------------

def test_reservations_gate_admission_no_deadlock():
    """While every decode slot is held by an in-flight transfer's
    reservation, the prefill worker defers its queue (no slot stolen, no
    deadlock); once the reservations resolve, the fleet drains."""
    prompt = _prompts(7, 1, 4, 5)[0]
    jf, tf = _fleets(1, 1, max_total=16, n_slots=3, staging_slots=2,
                     queue_capacity=8, transport_mode="local")
    try:
        out = []
        for fleet in (jf, tf):
            h = fleet.submit(prompt, 4)
            dpool = fleet.decode_workers[0].engine.pool
            held = [dpool.reserve() for _ in range(3)]
            assert fleet.decode_free_slots() == 0
            for _ in range(5):
                fleet.step()
            assert h.status == "queued"
            assert dpool.allocator.reserved_count == 3
            for s in held:
                dpool.cancel_reservation(s)
            fleet.run(steps_budget=200)
            out.append((h.status, h.tokens, _counters(fleet)[0]))
            _drained(fleet)
        assert out[1] == out[0]
        assert out[1][1] == _oracle(prompt, 4)
    finally:
        jf.close()
        tf.close()


def test_transfer_backpressure_requeues_not_strands():
    """A finished slab whose destination saturated after the admission
    check goes back to the head of the prefill queue (never shed), its
    staging slot recycles, and the fleet completes it once capacity
    frees."""
    prompt = _prompts(8, 1, 4, 5)[0]
    jf, tf = _fleets(1, 1, max_total=16, n_slots=3, staging_slots=2,
                     queue_capacity=8, transport_mode="local")
    try:
        out = []
        for fleet, req_cls in ((jf, JaxRequest), (tf, Request)):
            pw = fleet.prefill_workers[0]
            dpool = fleet.decode_workers[0].engine.pool
            req = req_cls(list(prompt), 4, trace_id="req-backpressure")
            req.timestamps["submitted"] = time.monotonic()
            slot = pw.pool.acquire()
            first = pw.engine.prefill_into_slot(list(prompt), slot)
            held = [dpool.reserve() for _ in range(3)]
            assert fleet.transfer_out(pw, req, slot, first) is False
            assert fleet.metrics()["disagg/requeued_total"] == 1.0
            assert pw.scheduler.queue_depth == 1
            assert pw.pool.allocator.busy_count == 0
            for s in held:
                dpool.cancel_reservation(s)
            fleet.run(steps_budget=200)
            out.append((req.status, list(req.tokens)))
            _drained(fleet)
        assert out[1] == out[0] == ("done", _oracle(prompt, 4))
        assert RequestHandle(req).tokens == out[1][1]
    finally:
        jf.close()
        tf.close()


# ---------------------------------------------------------------------------
# chaos: lane faults
# ---------------------------------------------------------------------------

def _first_put_fault(fired):
    def injector(lane, attempt):
        if lane.startswith("kv_transfer/put/") and fired["n"] < 1:
            fired["n"] += 1
            raise RuntimeError("injected permanent lane fault (chaos)")
    return injector


def test_chaos_kill_prefill_worker_mid_transfer(tmp_path):
    """A permanent fault on the first publish lane kills prefill0
    mid-transfer: a bundle whose ring names the lane, the request requeued
    on the survivor (a re-prefill, still token-exact), the victim's queue
    re-dispatched, no decode worker wedged; the counters as JAX's."""
    prompts = _prompts(1, 4)
    out = []
    jf, tf = _fleets(2, 1, max_total=16, n_slots=3, staging_slots=2,
                     queue_capacity=8, transport_mode="lanes",
                     bundle_dir=str(tmp_path / "bundles"))
    try:
        for fleet, setter in ((jf, jax_set_lane_fault_injector),
                              (tf, set_lane_fault_injector)):
            setter(_first_put_fault({"n": 0}))
            hs = [fleet.submit(p, 5) for p in prompts]
            fleet.run(steps_budget=600)
            setter(None)
            assert [w.dead for w in fleet.prefill_workers] == [True, False]
            out.append(([h.tokens for h in hs], [h.status for h in hs],
                        _counters(fleet)[0]))
            _drained(fleet)
        assert out[1] == out[0]
        assert out[1][0] == [_oracle(p, 5) for p in prompts]
        assert out[1][2]["disagg/requeued_total"] >= 1
        assert out[1][2]["disagg/dead_prefill_workers"] == 1.0
        bundles = tmp_path / "bundles"
        dirs = sorted(d for d in os.listdir(bundles)
                      if "kv_transfer_fault" in d)
        assert len(dirs) == 2            # JAX's and the port's
        for d in dirs:
            ring = (bundles / d / "flight.jsonl").read_text()
            assert "kv_transfer/put/" in ring and "worker_lost" in ring
    finally:
        jf.close()
        tf.close()


def test_chaos_no_survivors_sheds_machine_readably():
    """Every publish fails with one prefill worker: each accepted request
    is shed with JAX's ``AdmissionError.to_dict()`` payload (reason
    ``worker_lost``), a new submit is refused the same way, and the decode
    worker is left clean."""
    def always(lane, attempt):
        if lane.startswith("kv_transfer/put/"):
            raise RuntimeError("injected permanent lane fault (chaos)")

    jf, tf = _fleets(1, 1, max_total=16, n_slots=3, staging_slots=2,
                     queue_capacity=8, transport_mode="lanes")
    out = []
    try:
        for fleet, setter, err_t in (
                (jf, jax_set_lane_fault_injector, JaxAdmissionError),
                (tf, set_lane_fault_injector, AdmissionError)):
            setter(always)
            h1 = fleet.submit([1, 2, 3, 4], 4)
            h2 = fleet.submit([4, 5, 6, 7], 4)
            fleet.run(steps_budget=200)
            pays = []
            for h in (h1, h2):
                assert h.finish_reason == "shed" and h.tokens == []
                pay = dict(h.shed_payload)
                assert pay["retry_after_ms"] >= 1.0 and json.dumps(pay)
                pay.pop("retry_after_ms")
                pays.append(pay)
            with pytest.raises(err_t) as e:
                fleet.submit([7, 8], 4)
            out.append((pays, e.value.reason,
                        fleet.rejection_counters()["worker_lost"]))
            setter(None)
            _drained(fleet)
        assert out[1] == out[0]
        assert out[1][0][0]["reason"] == "worker_lost" and out[1][2] == 3
    finally:
        jf.close()
        tf.close()


def test_concurrent_submissions_during_worker_loss():
    """Four threads submit while the third publish dies: every accepted
    request ends exactly once (done with ``lm_generate``'s tokens, or shed
    with the ``worker_lost`` payload and no token), and nothing leaks."""
    _, tp, _ = _model()
    fleet = build_disagg_fleet(tp, 2, 1, head_dim=HEAD_DIM, max_total=16,
                               n_slots=3, staging_slots=2, queue_capacity=32,
                               transport_mode="lanes", device="cpu")
    fired = {"n": 0}

    def injector(lane, attempt):
        if lane.startswith("kv_transfer/put/"):
            fired["n"] += 1
            if fired["n"] == 3:
                raise RuntimeError("injected permanent lane fault (chaos)")

    set_lane_fault_injector(injector)
    prompts = _prompts(9, 12, 4, 5)
    handles, rejected, lock = [], [], threading.Lock()

    def submitter(t):
        for i in range(3):
            p = prompts[3 * t + i]
            try:
                h = fleet.submit(p, 4)
                with lock:
                    handles.append((p, h))
            except AdmissionError as e:
                with lock:
                    rejected.append(e.to_dict())
            time.sleep(0.001 * (t + 1))

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(4)]
    try:
        for s in threads:
            s.start()
        t0 = time.time()
        while any(s.is_alive() for s in threads):
            assert time.time() - t0 < 60, "submitter thread hung"
            fleet.step()
        for s in threads:
            s.join(timeout=10)
        fleet.run(steps_budget=600)
        assert fired["n"] >= 3
        done = 0
        for p, h in handles:
            if h.status == "done":
                done += 1
                assert h.shed_payload is None
                assert h.tokens == _oracle(p, 4)
            else:
                assert h.finish_reason == "shed" and h.tokens == []
                assert h.shed_payload["reason"] == "worker_lost"
        assert done > 0 and len(handles) + len(rejected) == 12
        assert all(r["reason"] in ("queue_full", "worker_lost", "shed_slo")
                   for r in rejected)
        _drained(fleet)
        assert fleet.metrics()["disagg/dead_prefill_workers"] == 1.0
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# role threads, observability faces, TP refusal
# ---------------------------------------------------------------------------

def test_role_threads_serve_what_run_serves(tmp_path):
    """``start()`` / ``stop()`` (one driver thread per role) finishes every
    request with ``run()``'s tokens; the flight providers, the request
    table, ``reset_stats``, the Prometheus file and ``close`` behave as
    JAX's."""
    from chainermn_tpu_torch.observability import export as texport
    from chainermn_tpu_torch.observability import flight

    _, tp, _ = _model()
    prompts = _prompts(11, 6)
    tokens = {}
    for mode in ("run", "threads"):
        fleet = build_disagg_fleet(tp, 1, 2, head_dim=HEAD_DIM, max_total=16,
                                   n_slots=3, staging_slots=2,
                                   queue_capacity=8, transport_mode="local",
                                   device="cpu")
        if mode == "threads":
            fleet.start()
            hs = [fleet.submit(p, 5) for p in prompts]
            assert all(h.wait(timeout=60) for h in hs)
            fleet.stop()
        else:
            hs = [fleet.submit(p, 5) for p in prompts]
            fleet.run(steps_budget=400)
        assert all(h.status == "done" for h in hs)
        tokens[mode] = [h.tokens for h in hs]
        _drained(fleet)
        snaps = flight.provider_snapshots()
        assert snaps["disagg_router"]["transfers"] == 6
        assert set(snaps["disagg_prefill"]) == {"prefill0"}
        assert set(snaps["disagg_decode"]) == {"decode0", "decode1"}
        table = fleet.requests_table()
        recent = [r["trace_id"] for w in table["workers"].values()
                  for r in w["recent"]]
        assert sorted(recent) == sorted(h.trace_id for h in hs)
        text = fleet.write_prometheus(str(tmp_path / f"{mode}.prom"))
        doc = texport.parse_prometheus_text(text)
        names = {n for n, _, _ in doc["samples"]}
        assert "chainermn_tpu_disagg_transfers_total" in names
        fleet.reset_stats()
        assert fleet.metrics()["disagg/transfers_total"] == 0.0
        fleet.close()
        assert "disagg_router" not in flight.provider_snapshots()
    assert tokens["threads"] == tokens["run"] == [_oracle(p, 5)
                                                  for p in prompts]


def test_fleet_refuses_tp_and_bad_configuration():
    _, tp, _ = _model()
    mesh = types.SimpleNamespace(shape={"model": 2})
    with pytest.raises(NotImplementedError, match="A11"):
        build_disagg_fleet(tp, 1, 1, head_dim=HEAD_DIM, mesh=mesh,
                           device="cpu")
    fleet = build_disagg_fleet(tp, 1, 1, head_dim=HEAD_DIM, max_total=16,
                               device="cpu")
    with pytest.raises(ValueError, match="unique"):
        type(fleet)([fleet.prefill_workers[0]],
                    [fleet.decode_workers[0]] * 2)
    with pytest.raises(ValueError, match="local|lanes"):
        type(fleet)(fleet.prefill_workers, fleet.decode_workers,
                    transport_mode="rdma")
    fleet.close()


# ---------------------------------------------------------------------------
# prefill_bucket, install_request
# ---------------------------------------------------------------------------

def test_prefill_bucket_fused_and_prefill_worker_equal_jax():
    """Prompts right-padded to multiples of 4: the fused engine's and a
    bucketed fleet's tokens equal JAX's (and, greedy, ``lm_generate``'s);
    ``prefill_compiles`` counts the padded lengths; a prompt whose padded
    length overruns the slot is refused ``too_long`` in JAX's words."""
    jp, tp, mesh = _model()
    prompts = _prompts(12, 4)
    kw = dict(head_dim=HEAD_DIM, n_slots=2, max_total=16, queue_capacity=8,
              prefix_cache=False, spill_bytes=0)
    out = {}
    for bucket in (1, 4):
        jeng = JaxServingEngine(jp, mesh=mesh, prefill_bucket=bucket, **kw)
        _share([jeng.engine])
        teng = ServingEngine(tp, prefill_bucket=bucket, device="cpu", **kw)
        for name, eng in (("jax", jeng), ("torch", teng)):
            hs = [eng.submit(p, 5) for p in prompts]
            eng.run()
            out[name, bucket] = [h.tokens for h in hs]
        assert teng.engine.prefill_compiles == len(
            {teng.engine.padded_len(len(p)) for p in prompts})
        assert teng.introspect_state()["prefill_compiles"] \
            == teng.engine.prefill_compiles
        jeng.close()
        teng.close()
    for bucket in (1, 4):
        assert out["torch", bucket] == out["jax", bucket]
    assert out["torch", 1] == [_oracle(p, 5) for p in prompts]
    assert out["torch", 4] == out["torch", 1]

    # the bucketed prefill worker behind the lanes
    jf, tf = _fleets(1, 1, max_total=16, n_slots=3, staging_slots=2,
                     queue_capacity=8, transport_mode="lanes",
                     prefill_bucket=4)
    try:
        res = []
        for fleet in (jf, tf):
            hs = [fleet.submit(p, 5) for p in prompts]
            fleet.run(steps_budget=300)
            res.append([h.tokens for h in hs])
            # a slab carries the REAL rows only
            assert fleet.plane.bytes_moved == sum(
                ttransfer.slab_nbytes(LAYERS, len(p), KV_HEADS * HEAD_DIM,
                                      "float32") for p in prompts)
            _drained(fleet)
        assert res[1] == res[0] == out["torch", 1]
        assert tf.prefill_workers[0].engine.prefill_compiles == len(
            {-(-len(p) // 4) * 4 for p in prompts})
        errs = []
        for fleet, err_t in ((jf, JaxAdmissionError), (tf, AdmissionError)):
            with pytest.raises(err_t) as e:
                fleet.submit(list(range(17)), 2)
            errs.append(e.value.to_dict())
            errs[-1].pop("retry_after_ms")
        assert errs[1] == errs[0]
        assert errs[1]["reason"] == "too_long"
        assert "pads to 20 (prefill_bucket 4), exceeding staging " \
            "capacity 16" in errs[1]["detail"]
    finally:
        jf.close()
        tf.close()

    refusals = []
    for cls, params, extra in ((JaxServingEngine, jp, {"mesh": mesh}),
                               (ServingEngine, tp, {"device": "cpu"})):
        eng = cls(params, prefill_bucket=4, **dict(kw, max_total=10),
                  **extra)
        with pytest.raises(Exception) as e:
            eng.submit(list(range(9)), 1)
        refusals.append((type(e.value).__name__, e.value.to_dict()))
        eng.close()
    assert refusals[0] == refusals[1]
    assert refusals[1][1]["reason"] == "too_long"
    assert "pads to 12 (prefill_bucket 4)" in refusals[1][1]["detail"]


def test_install_request_on_a_fused_engine():
    """A request prefilled in another pool and landed by the plane joins a
    fused engine's tick through ``install_request``: its first token
    streams and stamps TTFT, and its tokens are ``lm_generate``'s; a
    one-token request finishes at install."""
    from chainermn_tpu_torch.serving import CachePool, DecodeEngine

    _, tp, _ = _model()
    kv = KV_HEADS * HEAD_DIM
    staging = CachePool(1, 16, LAYERS, kv, torch.float32, "cpu")
    prefill = DecodeEngine(tp, staging, head_dim=HEAD_DIM)
    eng = ServingEngine(tp, head_dim=HEAD_DIM, n_slots=2, max_total=16,
                        prefix_cache=False, spill_bytes=0, device="cpu")
    plane = ttransfer.KvTransferPlane()
    prompts = _prompts(13, 2, 5, 7)
    streamed = {}
    handles = []
    try:
        for p, n in zip(prompts, (6, 1)):
            req = Request(list(p), n,
                          on_token=lambda t, rid: streamed.setdefault(
                              rid, []).append(t))
            req.timestamps["submitted"] = time.monotonic()
            first = prefill.prefill_into_slot(p, 0)
            dst = eng.pool.reserve()
            plane.transfer_local(staging, 0, eng.pool, dst, len(p))
            eng.pool.commit_reservation(dst)
            eng.install_request(req, dst, [first])
            handles.append(RequestHandle(req))
        assert handles[1].status == "done" and handles[1].tokens == \
            _oracle(prompts[1], 1)
        eng.run()
        assert handles[0].tokens == _oracle(prompts[0], 6)
        assert handles[0].ttft_ms is not None
        assert streamed[handles[0].id] == handles[0].tokens
        assert eng.engine.prefill_calls == 0 and eng.pool.busy_count == 0
        assert eng.metrics()["serving/tokens_total"] == 7.0
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the CLI, NOT_PORTED
# ---------------------------------------------------------------------------

def test_serve_cli_disagg_equals_jax(tmp_path, capsys):
    """``serve --disagg 1:2 --transport lanes --temperature 0.8 --tenants``
    with the JSONL and Prometheus outputs: the JAX CLI's tokens,
    ``disagg/transfers_total``, metric keys, tenancy state and record
    kinds."""
    from chainermn_tpu.serve import main as jax_main
    from chainermn_tpu_torch.serve import run

    argv = ["--disagg", "1:2", "--transport", "lanes", "--temperature",
            "0.8", "--tenants", "--train-steps", "0", "--requests", "5",
            "--max-new-tokens", "4", *MODEL_ARGV]
    out = {}
    for name in ("jax", "torch"):
        files = [str(tmp_path / f"{name}.{x}") for x in ("jsonl", "prom")]
        extra = ["--metrics-out", files[0], "--prom-out", files[1]]
        if name == "jax":
            jax_main(argv + extra)
            io = capsys.readouterr()
            summary = json.loads(io.out.strip().splitlines()[-1])
            tokens = [eval(m.group(1)) for m in re.finditer(
                r"^prompt \[[^\]]*\] -> (\[[^\]]*\])", io.err, re.M)]
        else:
            # the JAX CLI's init at --seed 0: the file's model
            summary = run(["--device", "cpu", *argv, *extra],
                          params=jax.tree_util.tree_map(np.asarray,
                                                        _model()[0]))
            tokens = [r["tokens"] for r in summary["requests"]]
        records = [json.loads(line) for line in open(files[0])]
        out[name] = (summary, tokens, records,
                     open(files[1]).read().count("chainermn_tpu_disagg_"))
    (js, jt, jr, jn), (ts, tt, tr, tn) = out["jax"], out["torch"]
    assert tt == jt and len(tt) == 5
    assert all(r["status"] == "done" for r in ts["requests"])
    assert ts["disagg"] == "1:2"
    assert ts["metrics"]["disagg/transfers_total"] == \
        js["metrics"]["disagg/transfers_total"] == 5.0
    assert set(ts["metrics"]) == set(js["metrics"])
    assert ts["tenancy"] == js["tenancy"]
    assert set(ts["goodput"]) == set(js["goodput"]) == {
        "prefill0", "decode0", "decode1"}
    assert [r["kind"] for r in tr] == [r["kind"] for r in jr]
    assert tr[-1]["kind"] == "disagg_summary"
    assert set(tr[-1]) == set(jr[-1])
    assert tn == jn >= 5


def test_serve_cli_refusals_in_jax_words():
    from chainermn_tpu.serve import main as jax_main
    from chainermn_tpu_torch.serve import run

    _model()                             # the JAX CLI's init, once
    base = ["--train-steps", "0", "--requests", "1", *MODEL_ARGV]
    for extra in (["--disagg", "1:2", "--replicas", "2"],
                  ["--disagg", "1:0"], ["--disagg", "2"], ["--tenants"],
                  ["--fleet-procs", "2", "--replicas", "2"],
                  ["--fleet-procs", "2", "--disagg", "1:1"]):
        msgs = []
        for fn, dev in ((jax_main, []), (run, ["--device", "cpu"])):
            with pytest.raises(SystemExit) as e:
                fn([*dev, *base, *extra])
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0], extra
    with pytest.raises(SystemExit, match="--tp > 1 is not ported.*A11"):
        run(["--device", "cpu", *base, "--disagg", "1:1", "--tp", "2"])


def test_disagg_names_resolve_and_step_three_still_raises():
    import chainermn_tpu.serving as jserving
    import chainermn_tpu_torch.serving as tserving

    for name in ("DisaggRouter", "PrefillWorker", "DecodeWorker",
                 "build_disagg_fleet", "request_wire"):
        assert (name in tserving.__all__) == (name in jserving.__all__)
        assert name not in tserving.NOT_PORTED
        assert getattr(tserving, name).__name__ == \
            getattr(jserving.disagg, name).__name__
    # step 3a's names resolve as JAX's do
    for name in ("FleetRouter", "WorkerRuntime", "WorkerClient",
                 "submit_with_retry", "build_proc_fleet",
                 "build_local_fleet", "rolling_upgrade", "FleetCacheIndex",
                 "IndexRecord", "ModelRegistry", "ModelVariant"):
        assert name in tserving.__all__ and name not in tserving.NOT_PORTED
        assert getattr(tserving, name).__name__ == \
            getattr(jserving, name).__name__
    # step 3b's still raise, naming A11
    for name in ("FleetAutoscaler", "AutoscalePolicy", "SCENARIO_SCHEMA",
                 "build_scenario", "run_scenario", "stream_digest",
                 "materialize_prompt"):
        assert name in tserving.NOT_PORTED
        with pytest.raises(AttributeError, match="A11"):
            getattr(tserving, name)

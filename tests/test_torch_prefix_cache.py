"""The port's host-side serving pieces vs the JAX package's, on the CPU.

One seeded op stream goes into JAX's and the port's ``SlotAllocator`` +
``PrefixCache`` (donate, match, pin, release, evict, reserve) and
``HostSpillStore`` (put, match, get, covering, drop under a byte budget):
every return, counter and invariant must be equal.  The slab format:
``slab_crc32`` of the same fp32 (and bf16) numbers equals JAX's, the
port's packed rows equal the slot's bytes, a bit flip is refused before
the pool is touched, and an fp32 payload is JAX's byte for byte.  Also
the copied admission payload, the retry hint, the SLO tracker, the
goodput ledger and the rate meter against JAX's under one clock, and the
names the serving package does not have yet.
"""

import pickle
import random

import jax
import numpy as np
import pytest
import torch

import chainermn_tpu as mn
from chainermn_tpu.observability import slo as jslo
from chainermn_tpu.serving import autoscale as jautoscale
from chainermn_tpu.serving import cache_pool as jpool
from chainermn_tpu.serving import prefix_cache as jprefix
from chainermn_tpu.serving import scheduler as jsched
from chainermn_tpu.serving import spill as jspill
from chainermn_tpu.serving import transfer as jtransfer
from chainermn_tpu_torch.observability import slo as tslo
from chainermn_tpu_torch.serving import autoscale as tautoscale
from chainermn_tpu_torch.serving import cache_pool as tpool
from chainermn_tpu_torch.serving import prefix_cache as tprefix
from chainermn_tpu_torch.serving import scheduler as tsched
from chainermn_tpu_torch.serving import spill as tspill
from chainermn_tpu_torch.serving import transfer as ttransfer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch in one thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the allocator and the radix trie: one op stream, two implementations
# ---------------------------------------------------------------------------

def _entry_view(e):
    return None if e is None else (e.seq, e.slot, e.length)


class _Cache:
    """One package's allocator + prefix cache, driven by name."""

    def __init__(self, pool_mod, prefix_mod, n_slots, min_len):
        self.alloc = pool_mod.SlotAllocator(n_slots)
        self.evicted = []
        self.pc = prefix_mod.PrefixCache(
            retain_slot=self.alloc.retain, release_slot=self.alloc.unretain,
            evict_slot=self.alloc.uncache, min_prefix_len=min_len,
            on_evict=lambda e: self.evicted.append(_entry_view(e)))
        self.readers = []          # (entry or None, slot)
        self.reserved = []

    def op(self, kind, seq, pick):
        """One op; returns what it returned, in comparable form."""
        if kind == "admit":
            entry, n = self.pc.match(seq)
            if entry is not None:
                self.pc.retain(entry)
            slot = self.alloc.acquire()
            if slot is None and self.pc.evictable_count():
                self.pc.evict_lru()
                slot = self.alloc.acquire()
            if slot is None:
                if entry is not None:
                    self.pc.release(entry)
                return ("full", _entry_view(entry), n)
            self.readers.append((entry, slot))
            return ("admit", _entry_view(entry), n, slot)
        if kind == "finish" and self.readers:
            entry, slot = self.readers.pop(pick % len(self.readers))
            if entry is not None:
                self.pc.release(entry)
            got = self.pc.insert(seq, slot, len(seq))
            if got is not None:
                self.alloc.cache(slot)
            else:
                self.alloc.release(slot)
            return ("finish", slot, _entry_view(got))
        if kind == "evict":
            return ("evict", self.pc.evict_lru())
        if kind == "peek":
            return ("peek", self.pc.peek_len(seq))
        if kind == "pin":
            e = self.pc.pin_covering(seq)
            if e is not None:
                self.pc.release(e)
            return ("pin", _entry_view(e))
        if kind == "reserve":
            slot = self.alloc.reserve()
            if slot is not None:
                self.reserved.append(slot)
            return ("reserve", slot)
        if kind == "land" and self.reserved:
            slot = self.reserved.pop(pick % len(self.reserved))
            if pick % 2:
                self.alloc.commit_reservation(slot)
                self.readers.append((None, slot))
            else:
                self.alloc.cancel_reservation(slot)
            return ("land", slot, pick % 2)
        return ("noop",)

    def state(self):
        self.alloc.check_invariants()
        self.pc.check_invariants()
        a = self.alloc
        return (sorted(a._free), sorted(a._busy), dict(a._cached),
                sorted(a._reserved), a.free_count, a.busy_count,
                a.cached_count, a.reserved_count, self.pc.stats(),
                self.pc.evictable_count(), self.pc.total_refcount(),
                sorted(_entry_view(e) for e in self.pc.entries()),
                list(self.evicted))


@pytest.mark.parametrize("seed", range(4))
def test_allocator_and_prefix_cache_fuzz_equal_jax(seed):
    rng = random.Random(seed)
    n_slots = rng.choice([3, 4, 6])
    min_len = rng.choice([1, 2, 3])
    jc = _Cache(jpool, jprefix, n_slots, min_len)
    tc = _Cache(tpool, tprefix, n_slots, min_len)
    bases = [[rng.randrange(8) for _ in range(rng.randint(2, 6))]
             for _ in range(3)]
    kinds = ["admit"] * 8 + ["finish"] * 7 + ["evict", "peek", "pin",
                                              "reserve", "land"]
    for step in range(300):
        kind = rng.choice(kinds)
        seq = rng.choice(bases) + [rng.randrange(8)
                                   for _ in range(rng.randint(0, 4))]
        pick = rng.randrange(1000)
        assert jc.op(kind, seq, pick) == tc.op(kind, seq, pick), (step,
                                                                  kind)
        assert jc.state() == tc.state(), step
    # drain: every pin returns, every cached slot frees
    for c in (jc, tc):
        for entry, slot in c.readers:
            if entry is not None:
                c.pc.release(entry)
            c.alloc.release(slot)
        for slot in c.reserved:
            c.alloc.cancel_reservation(slot)
        while c.pc.evict_lru() is not None:
            pass
    assert jc.state() == tc.state()
    assert tc.alloc.free_count == n_slots and tc.pc.total_refcount() == 0


def test_allocator_hard_errors_equal_jax():
    for mod in (jpool, tpool):
        a = mod.SlotAllocator(2)
        s = a.acquire()
        with pytest.raises(ValueError, match="not cached"):
            a.retain(s)
        a.cache(s)
        with pytest.raises(ValueError, match="refcount underflow"):
            a.unretain(s)
        a.retain(s)
        with pytest.raises(ValueError, match="still has 1 reader"):
            a.uncache(s)
        with pytest.raises(ValueError, match="not reserved"):
            a.commit_reservation(s)
        r = a.reserve()
        assert a.reserve() is None and a.acquire() is None
        with pytest.raises(ValueError, match="not busy"):
            a.cache(r)
        assert (a.refcount(s), a.refcount(r)) == (1, None)
        a.check_invariants()


def test_pool_faces_keep_jax_position_rules():
    """``cache`` leaves ``pos`` alone and ``uncache`` resets it; a
    cancelled reservation resets it, a committed one does not."""
    pool = tpool.CachePool(3, 8, 1, 4, torch.float32, "cpu")
    s = pool.acquire()
    pool.pos[s] = 5
    pool.cache(s)
    assert pool.pos[s] == 5 and pool.cached_count == 1
    pool.retain(s)
    pool.unretain(s)
    pool.uncache(s)
    assert pool.pos[s] == 0 and pool.free_count == 3
    r = pool.reserve()
    pool.pos[r] = 3
    pool.commit_reservation(r)
    assert pool.pos[r] == 3 and pool.busy_count == 1
    r2 = pool.reserve()
    pool.pos[r2] = 4
    pool.cancel_reservation(r2)
    assert pool.pos[r2] == 0 and pool.reserved_count == 0


# ---------------------------------------------------------------------------
# the spill store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_spill_store_fuzz_equal_jax(seed):
    rng = random.Random(100 + seed)
    cap = rng.choice([40, 64, 100])
    evicted = {"j": [], "t": []}
    js = jspill.HostSpillStore(cap, on_evict=lambda s, n:
                               evicted["j"].append((s, n)))
    ts = tspill.HostSpillStore(cap, on_evict=lambda s, n:
                               evicted["t"].append((s, n)))
    seqs = [tuple(rng.randrange(6) for _ in range(rng.randint(2, 7)))
            for _ in range(8)]
    for step in range(300):
        op = rng.randrange(5)
        seq = rng.choice(seqs)
        if op == 0:
            payload = bytes(rng.randrange(256)
                            for _ in range(rng.randint(1, 50)))
            n = rng.randint(1, len(seq))
            got = (js.put(seq, n, payload), ts.put(seq, n, payload))
        elif op == 1:
            prompt = list(seq) + [rng.randrange(6)
                                  for _ in range(rng.randint(0, 3))]
            k = rng.randint(1, 3)
            got = (js.match(prompt, min_len=k), ts.match(prompt, min_len=k))
        elif op == 2:
            got = (js.get(seq), ts.get(seq))
        elif op == 3:
            head = seq[:rng.randint(1, len(seq))]
            got = (js.covering(head), ts.covering(head))
        else:
            js.drop(seq)
            ts.drop(seq)
            got = (None, None)
        assert got[0] == got[1], (step, op, got)
        assert js.stats() == ts.stats() and js.state() == ts.state()
        assert js.entries() == ts.entries()
    assert evicted["j"] == evicted["t"]
    with pytest.raises(ValueError, match="capacity_bytes"):
        tspill.HostSpillStore(0)


# ---------------------------------------------------------------------------
# the slab format: CRC32, pack, inject, refusal
# ---------------------------------------------------------------------------

def _pools(dtype_np, dtype_torch, n_slots=3, max_total=8, layers=2,
           kv_dim=8):
    mesh = mn.make_nd_mesh(("model",), (1,), jax.devices()[:1])
    jp = jpool.CachePool(n_slots, max_total, layers, kv_dim, dtype_np, mesh)
    tp = tpool.CachePool(n_slots, max_total, layers, kv_dim, dtype_torch,
                         "cpu")
    rng = np.random.RandomState(3)
    jcaches = []
    for (kt, vt), (kj, vj) in zip(tp.caches, jp.caches):
        k = rng.randn(*kt.shape).astype(np.float32)
        v = rng.randn(*vt.shape).astype(np.float32)
        kt.copy_(torch.from_numpy(k))
        vt.copy_(torch.from_numpy(v))
        jcaches.append((jax.numpy.asarray(k, kj.dtype),
                        jax.numpy.asarray(v, vj.dtype)))
    jp.caches = jcaches
    return jp, tp


def _flip(payload, dtype=np.float32):
    data = pickle.loads(payload)
    k, v = data["rows"][0]
    k = np.array(k, copy=True)
    k.view(np.uint8).flat[0] ^= 1
    data["rows"][0] = (k, v)
    return pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slab_crc_and_pack_equal_jax(dtype):
    jdt = np.float32 if dtype == "float32" else jax.numpy.bfloat16
    jp, tp = _pools(jdt, getattr(torch, dtype))
    meta = {"seq": [1, 2, 3, 4, 5], "length": 5}
    jpay = jtransfer.KvTransferPlane().pack(jp, 1, 5, meta)
    tpay = ttransfer.KvTransferPlane().pack(tp, 1, 5, meta)
    jd, td = pickle.loads(jpay), pickle.loads(tpay)
    # the CRC hashes the raw bits: bf16 as its 16-bit pattern
    assert td["crc32"] == jd["crc32"]
    assert ttransfer.slab_crc32(jd["rows"]) == jd["crc32"]
    assert jtransfer.slab_crc32(td["rows"]) == td["crc32"]
    assert ttransfer.slab_crc32(
        [(ttransfer._host_rows(k[1, :5]), ttransfer._host_rows(v[1, :5]))
         for k, v in tp.caches]) == td["crc32"]
    for (jk, jv), (tk, tv) in zip(jd["rows"], td["rows"]):
        assert jk.tobytes() == tk.tobytes() and jv.tobytes() == tv.tobytes()
    assert {k: td[k] for k in ("schema", "meta", "pos", "n_layers",
                               "kv_dim", "dtype")} == \
        {k: jd[k] for k in ("schema", "meta", "pos", "n_layers", "kv_dim",
                            "dtype")}
    if dtype == "float32":
        assert tpay == jpay            # the same payload, byte for byte
    assert ttransfer.slab_nbytes(2, 5, 8, dtype) == \
        jtransfer.slab_nbytes(2, 5, 8, jdt)
    assert (ttransfer.WIRE_SCHEMA, ttransfer.SPILL_OP, ttransfer.SPILL_AXIS,
            ttransfer.LANE_OP, ttransfer.LANE_AXIS) == \
        (jtransfer.WIRE_SCHEMA, jtransfer.SPILL_OP, jtransfer.SPILL_AXIS,
         jtransfer.LANE_OP, jtransfer.LANE_AXIS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unpack_lands_rows_and_refuses_a_bit_flip(dtype):
    _, tp = _pools(np.float32, getattr(torch, dtype))
    plane = ttransfer.KvTransferPlane()
    payload = plane.pack(tp, 0, 6, {"seq": list(range(6))})
    stats = plane.unpack_into(payload, tp, 2)
    assert stats["length"] == 6 and tp.pos[2] == 6
    assert stats["ledger_bytes"] == ttransfer.slab_nbytes(2, 6, 8, dtype)
    for k, v in tp.caches:
        assert torch.equal(k[2, :6], k[0, :6])
        assert torch.equal(v[2, :6], v[0, :6])
    before = [(k.clone(), v.clone()) for k, v in tp.caches]
    pos = tp.pos.copy()
    with pytest.raises(ValueError, match="CRC mismatch"):
        plane.unpack_into(_flip(payload), tp, 1)
    # refused before anything touched the pool
    assert (tp.pos == pos).all()
    for (k, v), (k0, v0) in zip(tp.caches, before):
        assert torch.equal(k, k0) and torch.equal(v, v0)
    # JAX's receiver refuses the port's flipped fp32 payload the same way
    if dtype == "float32":
        jp, _ = _pools(np.float32, torch.float32)
        with pytest.raises(ValueError, match="CRC mismatch"):
            jtransfer.KvTransferPlane().unpack_into(_flip(payload), jp, 1)
    bad = pickle.loads(payload)
    bad["schema"] = "other.v0"
    with pytest.raises(ValueError, match="schema"):
        plane.unpack_into(pickle.dumps(bad), tp, 1)
    with pytest.raises(ValueError, match="out of range"):
        plane.pack(tp, 0, 9, {})


def test_restore_books_the_ledger_when_tracing():
    from chainermn_tpu_torch.observability import comm, trace

    _, tp = _pools(np.float32, torch.float32)
    plane = ttransfer.KvTransferPlane()
    payload = plane.pack(tp, 0, 4, {"seq": [1, 2, 3, 4]})
    comm.get_accountant().reset()
    try:
        plane.unpack_into(payload, tp, 1, ledger_op=ttransfer.SPILL_OP,
                          ledger_axis=ttransfer.SPILL_AXIS)
        assert comm.get_accountant().report()["calls"] == 0   # tracer off
        trace.enable()
        try:
            plane.unpack_into(payload, tp, 1, ledger_op=ttransfer.SPILL_OP,
                              ledger_axis=ttransfer.SPILL_AXIS)
        finally:
            trace.disable()
        row = comm.get_accountant().report()["per_op"][
            "kv_spill_restore@host"]
    finally:
        comm.get_accountant().reset()
    nbytes = ttransfer.slab_nbytes(2, 4, 8, "float32")
    assert row["calls"] == 1 and row["bytes"] == row["noted_bytes"] == nbytes
    assert row["dtypes"] == ["float32"]


# ---------------------------------------------------------------------------
# payloads, hints and trackers
# ---------------------------------------------------------------------------

def test_admission_error_and_request_equal_jax():
    kw = dict(retry_after_ms=12.34567, queue_depth=7, tenant="gold", rung=2)
    assert tsched.AdmissionError("shed_slo", "burning", **kw).to_dict() == \
        jsched.AdmissionError("shed_slo", "burning", **kw).to_dict()
    assert tsched.AdmissionError("queue_full").to_dict() == \
        jsched.AdmissionError("queue_full").to_dict()
    r = tsched.Request([1, 2, 3], 4, trace_id="t-1", tenant="free")
    assert (r.trace_id, r.tenant, list(r.forced), r.prefix_entry,
            r.prefix_len) == ("t-1", "free", [], None, 0)
    sched = tsched.Scheduler(4, 16)
    reqs = [tsched.Request([1], 2) for _ in range(3)]
    for q in reqs:
        sched.submit(q, 0.0)
    first = sched.admissions(1, 0.0)
    sched.requeue_front(first[0])
    assert sched.queued_requests() == reqs and sched.drain() == reqs
    assert sched.queue_depth == 0


def test_retry_hint_equal_jax():
    for backlog, tps in ((0, 0.0), (100, 0.0), (100, 50.0), (1e9, 1.0),
                         (5, 1e6)):
        for jitter in (0.0, 0.1):
            got = tautoscale.derive_retry_after_ms(
                backlog, tps, jitter_frac=jitter, rng=random.Random(3))
            want = jautoscale.derive_retry_after_ms(
                backlog, tps, jitter_frac=jitter, rng=random.Random(3))
            assert got == want, (backlog, tps, jitter)
    # the rest of JAX's module is ported: nothing is left to raise
    assert tautoscale.NOT_PORTED == {}
    for name in ("AutoscalePolicy", "FleetAutoscaler", "UP_SIGNALS",
                 "local_spawn_factory", "proc_spawn_factory"):
        assert hasattr(jautoscale, name) and hasattr(tautoscale, name)
    assert tautoscale.UP_SIGNALS == jautoscale.UP_SIGNALS


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_slo_tracker_ledger_and_meter_equal_jax(capsys):
    out = {}
    for name, mod in (("jax", jslo), ("torch", tslo)):
        clock = _Clock()
        seen = []
        slo = mod.SLOTracker(ttft_target_ms=50.0,
                             tokens_per_sec_target=100.0,
                             windows_s=(10.0, 60.0), burn_threshold=2.0,
                             min_observations=3, clock=clock,
                             escalate=seen.append)
        ledger = mod.GoodputLedger(wall_clock=clock)
        meter = mod.RateMeter(window_s=5.0, clock=clock)
        res = mod.ReservoirSample(16, seed=1)
        r = random.Random(5)
        trail = []
        total = 0.0
        for i in range(120):
            clock.t += r.uniform(0.05, 1.5)
            slo.observe_ttft(r.uniform(0, 120))
            slo.observe_throughput(r.uniform(50, 200))
            ledger.add(r.choice(mod.GoodputLedger.BUCKETS), r.uniform(0, 1))
            total += r.randrange(20)
            meter.observe(total)
            res.add(r.uniform(0, 10))
            trail.append((slo.short_window_burn(), meter.rate(),
                          slo.burn_rate("ttft", 60.0)))
        out[name] = (trail, slo.status(), len(seen), ledger.report(),
                     ledger.gauges("serving/goodput"), res.values(),
                     res.total_seen, res.percentile(99))
    assert out["jax"] == out["torch"]
    assert out["torch"][2] > 0          # the tracker paged at least once
    capsys.readouterr()


def test_serving_names_not_ported_yet():
    import chainermn_tpu.serving as jserving
    import chainermn_tpu_torch.serving as tserving

    # every serving name of JAX's package is ported (A11 step 3b emptied
    # the map): each resolves to the namesake of JAX's
    assert tserving.NOT_PORTED == {}
    assert set(tserving.__all__) == set(jserving.__all__)
    for name in tserving.__all__:
        got, want = getattr(tserving, name), getattr(jserving, name)
        assert got is not None
        assert getattr(got, "__name__", got) == getattr(want, "__name__", want)

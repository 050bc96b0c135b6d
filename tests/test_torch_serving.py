"""The port's serving slice vs the JAX package's, on the CPU.

The acceptance gate: the JAX ``ServingEngine`` (size-1 model mesh, no
prefix cache, no spill) and the port's ``ServingEngine(device="cpu")``
serve the same staggered 8-request schedule on a 4-slot pool with the same
weights (converted by ``chainermn_tpu_torch.convert``); every request's
tokens must be equal.  Also: the port's copies of the scheduler and slot
allocator keep the JAX package's policy invariants, and the engine's
metrics, rejections and unported paths behave as documented.
"""

import random

import jax
import numpy as np
import pytest
import torch

import chainermn_tpu as mn
from chainermn_tpu.parallel import init_tp_transformer_lm as jax_init
from chainermn_tpu.serving import ServingEngine as JaxServingEngine
from chainermn_tpu_torch.convert import from_jax
from chainermn_tpu_torch.serving import (AdmissionError, Request, Scheduler,
                                         ServingEngine, SlotAllocator)

VOCAB, D, HEADS, LAYERS = 64, 32, 4, 2
HEAD_DIM = D // HEADS


def _params(pos_impl, seed=0, n_kv_heads=None):
    jp = jax_init(jax.random.PRNGKey(seed), VOCAB, D, HEADS, LAYERS,
                  max_len=64, pos_impl=pos_impl, n_kv_heads=n_kv_heads)
    return jp, from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _schedule(eng, prompts, max_new):
    """tests/test_serving.py's staggered schedule: four requests, two
    steps, four more, then run to idle."""
    handles = [eng.submit(prompts[i], max_new[i]) for i in range(4)]
    for _ in range(2):
        eng.step()
    handles += [eng.submit(prompts[i], max_new[i]) for i in range(4, 8)]
    eng.run(steps_budget=200)
    return handles


@pytest.mark.parametrize("pos_impl", ["learned", "rope"])
def test_serving_slice_token_exact_vs_jax(pos_impl):
    jp, tp = _params(pos_impl)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, VOCAB, 6).astype(np.int32) for _ in range(8)]
    max_new = [12, 4, 4, 4, 6, 6, 6, 6]
    kw = dict(head_dim=HEAD_DIM, n_slots=4, max_total=32, queue_capacity=8,
              max_prefills_per_tick=2)
    jeng = JaxServingEngine(
        jp, mesh=mn.make_nd_mesh(("model",), (1,), jax.devices()[:1]),
        prefix_cache=False, spill_bytes=0, **kw)
    try:
        want = _schedule(jeng, prompts, max_new)
    finally:
        jeng.close()
    teng = ServingEngine(tp, device="cpu", **kw)
    got = _schedule(teng, prompts, max_new)
    for i, (g, w) in enumerate(zip(got, want)):
        assert w.status == "done" and g.status == "done", (i, g.status)
        assert g.finish_reason == w.finish_reason == "max_tokens"
        assert g.tokens == w.tokens, (i, g.tokens, w.tokens)
    # iteration-level batching: a late request decoded before the longest
    # first-wave request finished
    assert got[4].timestamps["first_token"] < got[0].timestamps["finished"]
    m = teng.metrics()
    for key in ("tokens_per_sec", "tokens_total", "ticks", "active_slots",
                "slot_occupancy_pct", "ttft_p50_ms", "ttft_p99_ms",
                "token_latency_p50_ms", "token_latency_p99_ms",
                "tick_gap_p50_ms", "tick_gap_p99_ms"):
        assert f"serving/{key}" in m, key
    assert m["serving/tokens_total"] == sum(max_new)
    assert m["serving/active_slots"] == 0.0
    teng.close()
    with pytest.raises(RuntimeError, match="closed"):
        teng.submit(prompts[0], 2)


def test_streaming_and_eos_eviction():
    _, tp = _params("learned", seed=2)
    eng = ServingEngine(tp, head_dim=HEAD_DIM, n_slots=2, max_total=32,
                        device="cpu")
    streamed = []
    probe = eng.submit([1, 2, 3], 5)
    eng.run()
    eos = probe.tokens[2]
    h = eng.submit([1, 2, 3], 5, eos_id=eos,
                   on_token=lambda t, rid: streamed.append((rid, t)))
    eng.run()
    assert h.status == "done" and h.finish_reason == "eos"
    assert h.tokens == probe.tokens[: probe.tokens.index(eos) + 1]
    assert [t for _, t in streamed] == h.tokens
    assert eng.pool.busy_count == 0 and eng.pool.free_count == 2


def test_rejections_and_unported_paths():
    _, tp = _params("learned", seed=3)
    eng = ServingEngine(tp, head_dim=HEAD_DIM, n_slots=1, max_total=16,
                        queue_capacity=1, device="cpu")
    with pytest.raises(AdmissionError) as e:
        eng.submit(list(range(10)), 10)                   # 20 > 16
    assert e.value.reason == "too_long"
    eng.submit([1, 2], 2)
    with pytest.raises(AdmissionError) as e:
        eng.submit([1, 2], 2)
    assert e.value.reason == "queue_full"
    assert eng.metrics()["serving/rejected_total"] == 2.0
    with pytest.raises(NotImplementedError, match="sampling"):
        eng.submit([1, 2], 2, temperature=0.8)
    _, gqa = _params("learned", n_kv_heads=2)
    with pytest.raises(NotImplementedError, match="GQA"):
        ServingEngine(gqa, head_dim=HEAD_DIM, device="cpu")


def test_deadline_expires_queued_request():
    _, tp = _params("rope", seed=4)
    eng = ServingEngine(tp, head_dim=HEAD_DIM, n_slots=1, max_total=32,
                        device="cpu")
    busy = eng.submit([1, 2, 3], 4)
    late = eng.submit([4, 5], 4, deadline_s=0.0)
    eng.run()
    assert busy.status == "done"
    assert late.status == "evicted" and late.finish_reason == "deadline"


# ---------------------------------------------------------------------------
# the copied host policy keeps the JAX package's invariants
# ---------------------------------------------------------------------------

def test_slot_allocator_invariants():
    alloc = SlotAllocator(3)
    assert (alloc.acquire(), alloc.acquire()) == (0, 1)
    alloc.release(0)
    assert alloc.acquire() == 0 and alloc.acquire() == 2
    assert alloc.acquire() is None
    with pytest.raises(ValueError, match="not busy"):
        alloc.release(1)
        alloc.release(1)
    alloc.check_invariants()


def test_scheduler_fifo_bound_and_eviction_precedence():
    sched = Scheduler(queue_capacity=8, slot_capacity=64,
                      max_prefills_per_tick=2)
    reqs = [Request([1], 2) for _ in range(5)]
    for r in reqs:
        sched.submit(r, 0.0)
    assert [r.id for r in sched.admissions(4, 0.0)] == [reqs[0].id, reqs[1].id]
    assert [r.id for r in sched.admissions(1, 0.0)] == [reqs[2].id]
    r = Request([1], 2, eos_id=9, deadline_t=10.0)
    r.tokens = [5, 9]
    assert sched.eviction_reason(r, 99.0) == "eos"
    r.tokens = [5, 6]
    assert sched.eviction_reason(r, 0.0) == "max_tokens"
    r3 = Request([1], 8, deadline_t=1.0)
    r3.tokens = [5]
    assert sched.eviction_reason(r3, 2.0) == "deadline"
    tight = Scheduler(queue_capacity=2, slot_capacity=64, max_positions=8)
    with pytest.raises(AdmissionError) as e:
        tight.submit(Request([1, 2, 3, 4], 6), 0.0)
    assert e.value.reason == "too_long"


def test_fuzzed_arrival_eviction_no_leak_fifo():
    rng = random.Random(0)
    for _ in range(10):
        sched = Scheduler(queue_capacity=3, slot_capacity=32,
                          max_prefills_per_tick=rng.choice([1, 2]))
        alloc = SlotAllocator(4)
        running, accepted, admitted = {}, [], []
        for step in range(80):
            now = float(step)
            for _ in range(rng.randrange(3)):
                req = Request([1] * rng.randint(1, 8), rng.randint(1, 6),
                              eos_id=7 if rng.random() < 0.3 else None)
                try:
                    sched.submit(req, now)
                except AdmissionError as e:
                    assert e.reason == "queue_full" and sched.queue_depth == 3
                else:
                    accepted.append(req)
            for req in sched.admissions(alloc.free_count, now):
                running[alloc.acquire()] = (req, rng.randint(
                    1, req.max_new_tokens))
                admitted.append(req)
            for slot in list(running):
                req, rem = running[slot]
                req.tokens.append(0 if rem > 1 else 7)
                running[slot] = (req, rem - 1)
                reason = sched.eviction_reason(req, now)
                if reason:
                    req.finish(reason, now)
                    del running[slot]
                    alloc.release(slot)
            alloc.check_invariants()
            assert alloc.busy_count == len(running)
        order = {r.id: i for i, r in enumerate(accepted)}
        assert [order[r.id] for r in admitted] == sorted(
            order[r.id] for r in admitted)


def test_engine_tick_advances_every_slot_and_copies_positions():
    """The tick reads the host position vector through a copy: advancing
    it afterwards never changes what the tick consumed."""
    _, tp = _params("learned", seed=5)
    eng = ServingEngine(tp, head_dim=HEAD_DIM, n_slots=3, max_total=16,
                        device="cpu")
    slot = eng.pool.acquire()
    first = eng.engine.prefill_into_slot([3, 4, 5], slot)
    assert 0 <= first < VOCAB and eng.pool.pos[slot] == 3
    before = eng.pool.pos.copy()
    nxt = eng.engine.tick(np.array([first, 0, 0], np.int32))
    assert nxt.shape == (3,) and (eng.pool.pos == before + 1).all()
    assert isinstance(eng.pool.caches[0][0], torch.Tensor)

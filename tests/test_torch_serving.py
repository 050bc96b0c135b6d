"""The port's serving slice vs the JAX package's, on the CPU.

The acceptance gate: the JAX ``ServingEngine`` (size-1 model mesh, no
prefix cache, no spill) and the port's ``ServingEngine(device="cpu")``
serve the same staggered 8-request schedule on a 4-slot pool with the same
weights (converted by ``chainermn_tpu_torch.convert``); every request's
tokens must be equal.  GQA requests and sampled requests through the
port's engine are token-exact against JAX's ``lm_generate`` (sampled: at
B = 1 with the request's key, JAX's own oracle for its serving pool).
Also: the port's copies of the scheduler and slot allocator keep the JAX
package's policy invariants, and the engine's metrics and rejections
behave as documented.
"""

import random

import jax
import numpy as np
import pytest
import torch

import chainermn_tpu as mn
from chainermn_tpu.parallel import init_tp_transformer_lm as jax_init
from chainermn_tpu.parallel import make_lm_generator as jax_generator
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
    # sampling needs the request's key (the lm_generate rng contract)
    with pytest.raises(ValueError, match="rng"):
        eng.submit([1, 2], 2, temperature=0.8)
    # a GQA model serves: its pool holds the KV heads only
    _, gqa = _params("learned", n_kv_heads=2)
    geng = ServingEngine(gqa, head_dim=HEAD_DIM, n_slots=2, max_total=16,
                         device="cpu")
    assert tuple(geng.pool.caches[0][0].shape) == (2, 16, 2 * HEAD_DIM)


def test_deadline_expires_queued_request():
    _, tp = _params("rope", seed=4)
    eng = ServingEngine(tp, head_dim=HEAD_DIM, n_slots=1, max_total=32,
                        device="cpu")
    busy = eng.submit([1, 2, 3], 4)
    late = eng.submit([4, 5], 4, deadline_s=0.0)
    eng.run()
    assert busy.status == "done"
    assert late.status == "evicted" and late.finish_reason == "deadline"


def _mesh():
    return mn.make_nd_mesh(("model",), (1,), jax.devices()[:1])


def _jax_oracle(jp, prompt, max_new, temperature=0.0, key=None):
    gen = jax_generator(_mesh(), "model", head_dim=HEAD_DIM,
                        max_new_tokens=max_new, temperature=temperature)
    args = (jp, np.asarray(prompt, np.int32)[None])
    if key is not None:
        args += (key,)
    return np.asarray(gen(*args))[0].tolist()


@pytest.mark.parametrize("pos_impl,n_kv_heads", [("learned", 2),
                                                 ("rope", 1)])
def test_gqa_serving_token_exact_vs_jax_lm_generate(pos_impl, n_kv_heads):
    jp, tp = _params(pos_impl, seed=6, n_kv_heads=n_kv_heads)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, VOCAB, 5 + i).astype(np.int32)
               for i in range(5)]
    max_new = [7, 3, 5, 6, 4]
    eng = ServingEngine(tp, head_dim=HEAD_DIM, n_slots=3, max_total=24,
                        max_prefills_per_tick=2, device="cpu")
    handles = [eng.submit(p, n) for p, n in zip(prompts, max_new)]
    eng.run(steps_budget=200)
    for h, p, n in zip(handles, prompts, max_new):
        assert h.status == "done"
        assert h.tokens == _jax_oracle(jp, p, n), h.id


def test_sampled_serving_token_exact_vs_jax_lm_generate():
    """Sampled and greedy requests share the pool; each sampled request is
    token-exact against JAX's ``lm_generate(rng=key)`` at B = 1 (its
    first token salted by the prompt length, each tick's by the position
    it generates)."""
    jp, tp = _params("learned", seed=8, n_kv_heads=2)
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, VOCAB, 5).astype(np.int32) for _ in range(4)]
    keys = [jax.random.fold_in(jax.random.PRNGKey(5), i) for i in range(4)]
    temps = [0.7, 0.0, 1.1, 0.7]
    eng = ServingEngine(tp, head_dim=HEAD_DIM, n_slots=3, max_total=24,
                        device="cpu")
    handles = [eng.submit(p, 8, temperature=t,
                          rng=np.asarray(k) if t > 0 else None)
               for p, t, k in zip(prompts, temps, keys)]
    eng.run(steps_budget=200)
    for h, p, t, k in zip(handles, prompts, temps, keys):
        assert h.status == "done"
        want = _jax_oracle(jp, p, 8, t, k if t > 0 else None)
        assert h.tokens == want, (h.id, h.tokens, want)
    # two requests, same prompt and temperature, different keys
    a = eng.submit(prompts[0], 8, temperature=0.7,
                   rng=np.asarray(jax.random.PRNGKey(1)))
    b = eng.submit(prompts[0], 8, temperature=0.7,
                   rng=np.asarray(jax.random.PRNGKey(2)))
    eng.run()
    assert a.tokens != b.tokens
    assert (eng._slot_temps == 0).all()     # freed slots tick greedy


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

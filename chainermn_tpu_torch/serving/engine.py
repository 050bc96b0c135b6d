"""Per-tick decode steps over the slot pool.

Counterpart of ``chainermn_tpu/serving/engine.py``.  The closed-batch
generator runs prefill and all ticks in one call; this engine splits the
same numerics into two steps driven from the host, so requests join and
leave between ticks:

* **prefill_into_slot** — full-prompt forward (``lm_prefill``), the first
  token (greedy, or sampled with the request's key salted by the prompt
  length) from the last prompt position, and a copy of the prompt's K/V
  slab into the slot's rows of the pool.
* **tick** — one token for EVERY slot (``lm_decode_tick`` with the
  per-row position vector + ``_next_token``, each slot greedy or sampled
  with its own key salted by the position it generates), K/V appended per
  row.

The salts are ``lm_generate``'s, so a sampled request is token-exact
against ``lm_generate(rng=key)`` at B = 1.

The JAX engine is functional: each program returns new pool caches.  This
one updates the pool's tensors IN PLACE (the append kernel writes into
them, and the prefill slab is copied into the slot's rows), so the pool is
allocated once and never copied.

Tensor parallelism: with ``mesh``, the params are this rank's shards
(``transformer_lm_specs`` over ``axis_name``) and the pool holds this
rank's KV heads.  JAX runs one controller; here every model rank is a
process.  Model rank 0 leads: before each device call it broadcasts the
call's plan over the model group (:meth:`DecodeEngine.publish`: a
prefill's prompt, slot, key and temperature; a slot reset; a tick's
tokens, keys and temperatures; the stop), and the other ranks run
:meth:`DecodeEngine.follow`, which executes exactly those calls, in that
order, and reads nothing else.  So every rank enters every collective of
the same call with the same slots.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops import collective as col
from ..parallel.decode import _kv_heads, _next_token, lm_decode_tick, lm_prefill


class DecodeEngine:
    """Device half of the serving engine: owns the params (on the pool's
    device) and runs prefill and tick over the :class:`CachePool`.  With
    ``mesh``, ``params`` are this rank's shards over ``axis_name``."""

    def __init__(self, params, pool, mesh=None, axis_name: str = "model", *,
                 head_dim: int):
        self.head_dim = int(head_dim)
        self.pool = pool
        self.device = pool.device
        self.n_kv_heads = _kv_heads(params, head_dim)
        self.rope = "pos_embed" not in params
        self.max_positions = (None if self.rope
                              else int(params["pos_embed"].shape[0]))
        self._params = params
        # the model axis' 1-D mesh, which the layers reduce over
        self._axis = None if mesh is None else mesh.axis(axis_name)
        self.leader = self._axis is None or col.axis_index(self._axis) == 0
        self.prefill_calls = 0
        self.tick_calls = 0

    # ---- the plan: model rank 0 leads, the others follow ----
    def publish(self, op) -> None:
        """Leader: broadcast ``op`` (the next device call) over the model
        group; a no-op without one, and on a follower, which only
        receives."""
        if self.leader and self._axis is not None and self._axis.size > 1:
            dist.broadcast_object_list(
                [op], src=col._peer(self._axis, 0), group=self._axis.group)

    def follow(self) -> int:
        """Follower: receive and run the leader's calls until its stop;
        returns the number of calls run."""
        if self.leader:
            raise RuntimeError("model rank 0 leads; follow() is for the "
                               "other ranks of the model axis")
        n = 0
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=col._peer(self._axis, 0),
                                       group=self._axis.group)
            kind, args = box[0]
            if kind == "stop":
                return n
            {"prefill": self._prefill, "reset": self._reset,
             "tick": self._tick}[kind](*args)
            n += 1

    def stop(self) -> None:
        """Leader: release the followers from :meth:`follow` (a no-op on
        a follower)."""
        self.publish(("stop", ()))

    def reset_slot(self, slot: int) -> None:
        """Set ``slot``'s write position to 0 (on every model rank)."""
        self.publish(("reset", (slot,)))
        self._reset(slot)

    def _reset(self, slot):
        self.pool.pos[slot] = 0

    def prefill_into_slot(self, prompt_tokens, slot: int, rng=None,
                          temperature: float = 0.0) -> int:
        """Prefill ``prompt_tokens (S,)`` into ``slot``: writes the K/V slab
        into the pool's caches, sets ``pool.pos[slot]`` and returns the first
        generated token (position ``S``: greedy, or sampled with ``rng`` at
        ``temperature > 0``)."""
        prompt = np.asarray(prompt_tokens, np.int64).reshape(1, -1)
        s_p = prompt.shape[1]
        if s_p > self.pool.max_total:
            raise ValueError(f"prompt length {s_p} exceeds pool max_total "
                             f"{self.pool.max_total}")
        rng = None if rng is None else np.asarray(rng, np.uint32)
        self.publish(("prefill", (prompt, slot, rng, float(temperature))))
        return self._prefill(prompt, slot, rng, float(temperature))

    def _prefill(self, prompt, slot, rng, temperature):
        s_p = prompt.shape[1]
        self.prefill_calls += 1
        with torch.inference_mode():
            h, slabs = lm_prefill(self._params,
                                  torch.tensor(prompt, device=self.device),
                                  s_p, head_dim=self.head_dim,
                                  axis_name=self._axis)
            keys = None if rng is None else rng[None]
            tok = _next_token(self._params["embed"], h[:, -1], keys,
                              np.array([temperature], np.float32),
                              torch.tensor([s_p], device=self.device),
                              axis_name=self._axis)
            for (kc, vc), (ks, vs) in zip(self.pool.caches, slabs):
                kc[slot, :s_p].copy_(ks[0])
                vc[slot, :s_p].copy_(vs[0])
            first = int(tok[0])
        self.pool.pos[slot] = s_p
        return first

    def tick(self, last_tokens: np.ndarray, keys=None,
             temps=None) -> np.ndarray:
        """One decode tick for ALL slots: consume ``last_tokens (n_slots,)``
        at the pool's per-slot positions, append K/V in place, advance every
        position, and return the next token per slot.  ``keys (n_slots,
        2)`` and ``temps (n_slots,)`` are the slots' sampling operands
        (``None``, or temperatures <= 0: greedy)."""
        last_tokens = np.asarray(last_tokens, np.int64)
        self.publish(("tick", (last_tokens, keys, temps)))
        return self._tick(last_tokens, keys, temps)

    def _tick(self, last_tokens, keys, temps):
        self.tick_calls += 1
        # torch.tensor copies the host arrays before returning, so the
        # position update below cannot race the device's read of them
        tokens = torch.tensor(np.asarray(last_tokens, np.int64),
                              device=self.device)
        pos = torch.tensor(np.asarray(self.pool.pos, np.int32),
                           device=self.device)
        with torch.inference_mode():
            h_last, _ = lm_decode_tick(self._params, tokens, self.pool.caches,
                                       pos, head_dim=self.head_dim,
                                       axis_name=self._axis)
            # the consumed token sits at row pos; the next is position pos+1
            nxt = _next_token(self._params["embed"], h_last, keys, temps,
                              pos + 1, axis_name=self._axis)
            out = nxt.cpu().numpy()
        self.pool.pos = self.pool.pos + 1
        return out

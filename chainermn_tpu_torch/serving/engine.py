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
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.decode import _kv_heads, _next_token, lm_decode_tick, lm_prefill


class DecodeEngine:
    """Device half of the serving engine: owns the params (on the pool's
    device) and runs prefill and tick over the :class:`CachePool`."""

    def __init__(self, params, pool, *, head_dim: int):
        self.head_dim = int(head_dim)
        self.pool = pool
        self.device = pool.device
        self.n_kv_heads = _kv_heads(params, head_dim)
        self.rope = "pos_embed" not in params
        self.max_positions = (None if self.rope
                              else int(params["pos_embed"].shape[0]))
        self._params = params
        self.prefill_calls = 0
        self.tick_calls = 0

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
        self.prefill_calls += 1
        with torch.inference_mode():
            h, slabs = lm_prefill(self._params,
                                  torch.tensor(prompt, device=self.device),
                                  s_p, head_dim=self.head_dim)
            keys = None if rng is None else np.asarray(rng, np.uint32)[None]
            tok = _next_token(self._params["embed"], h[:, -1], keys,
                              np.array([temperature], np.float32),
                              torch.tensor([s_p], device=self.device))
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
        self.tick_calls += 1
        # torch.tensor copies the host arrays before returning, so the
        # position update below cannot race the device's read of them
        tokens = torch.tensor(np.asarray(last_tokens, np.int64),
                              device=self.device)
        pos = torch.tensor(np.asarray(self.pool.pos, np.int32),
                           device=self.device)
        with torch.inference_mode():
            h_last, _ = lm_decode_tick(self._params, tokens, self.pool.caches,
                                       pos, head_dim=self.head_dim)
            # the consumed token sits at row pos; the next is position pos+1
            nxt = _next_token(self._params["embed"], h_last, keys, temps,
                              pos + 1)
            out = nxt.cpu().numpy()
        self.pool.pos = self.pool.pos + 1
        return out

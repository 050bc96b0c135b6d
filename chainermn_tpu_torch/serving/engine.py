"""Per-tick decode steps over the slot pool.

Counterpart of ``chainermn_tpu/serving/engine.py``.  The closed-batch
generator runs prefill and all ticks in one call; this engine splits the
same numerics into two steps driven from the host, so requests join and
leave between ticks:

* **prefill_into_slot** — full-prompt forward (``lm_prefill``), the first
  token (greedy, or sampled with the request's key salted by the prompt
  length) from the last REAL prompt position, and a copy of the prompt's
  K/V slab into the slot's rows of the pool.  ``prefill_bucket > 1``
  right-pads prompts to bucket multiples, as JAX does to bound its
  compiled program family (``prefill_compiles`` counts the distinct padded
  lengths): causal attention never lets a real token see a pad, and pad
  rows in the cache sit above ``pos``, where the per-row mask and the
  occupant's own later writes keep them unreachable.  The default is 1
  (no padding): padding changes the flash forward's reduction length.
* **tick** — one token for EVERY slot (``lm_decode_tick`` with the
  per-row position vector + ``_next_token``, each slot greedy or sampled
  with its own key salted by the position it generates), K/V appended per
  row.

* **copy_prefix** — the prefix cache's copy-on-extend: the whole source
  slot row of every layer copied into the destination slot in place
  (``copy_``, on the pool's device), then ``pos[dst]`` set to the matched
  length; the prompt's uncached suffix then feeds through the tick.

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
prefill's prompt, slot, key and temperature; a slot's new position; a
tick's tokens, keys and temperatures; a prefix copy; a spill's pack, drop
and restore; the stop), and the other ranks run
:meth:`DecodeEngine.follow`, which executes exactly those calls, in that
order, and reads nothing else.  So every rank enters every collective of
the same call with the same slots, and every pool change (a copy, a
restore, the position ``uncache`` resets) lands on every rank.  Under
the host spill tier each rank keeps its own columns' payloads: the
leader's store decides, and a follower packs (``spill``), drops
(``unspill``) and lands (``restore``) its own under the leader's plan.
A restore's outcome is agreed over the model group: a CRC refusal on any
rank refuses it on every rank, and all of them re-prefill.

A fleet of engines at TP > 1 (the router's replicas, the role-split
fleet's workers) shares ONE :class:`ModelPlan`: each op names the engine
it is for (its index in the plan, the same on every rank because every
rank builds the same fleet in the same order), model rank 0 hosts the
router and every engine, and the other ranks run one fleet-level
:meth:`ModelPlan.follow` loop.  Announcing an op and running its device
call is one step under the plan's lock, so driver threads of several
engines never interleave their collectives.  The role-split fleet's
transfers are plan ops too: a row copy between two engines' pools
(:meth:`DecodeEngine.copy_slab_from`, each rank its own columns), and the
lanes' pack (:meth:`DecodeEngine.pack_slab`: the ranks' columns gathered
to one global slab, so its bytes and CRC are those of JAX's global pool)
and landing (:meth:`DecodeEngine.land_slab`: the leader checks the global
slab, then every rank writes its own columns), and a spilled prefix served
to another worker (:meth:`DecodeEngine.pack_spilled`: every rank's spilled
columns gathered into the global slab).  The followers mirror only
device state (caches and positions); the allocators, queues and
reservations live on the leader.
"""

from __future__ import annotations

import pickle
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops import collective as col
from ..parallel.decode import _kv_heads, _next_token, lm_decode_tick, lm_prefill
from .scheduler import AdmissionError
from .transfer import SPILL_AXIS, SPILL_OP, KvTransferPlane, _host_rows


class ModelPlan:
    """The plan channel of one model group: model rank 0 broadcasts each
    device call of its engines, the other ranks run them.  ``axis``: the
    model axis' 1-D mesh (None: one rank, nothing to broadcast).  Engines
    :meth:`register` in construction order; an op names its engine by
    that index."""

    def __init__(self, axis):
        self.axis = axis
        self.leader = axis is None or col.axis_index(axis) == 0
        self.broadcasting = axis is not None and axis.size > 1
        # held from an op's broadcast to the end of its device call: one
        # op at a time on the model group, whatever thread announces it
        self.lock = threading.RLock()
        self.engines = []
        self.stopped = False

    def register(self, engine) -> int:
        self.engines.append(engine)
        return len(self.engines) - 1

    def publish(self, eid, op) -> None:
        """Leader: broadcast ``op`` for engine ``eid`` over the model
        group (a no-op on one rank, and on a follower)."""
        if not (self.leader and self.broadcasting):
            return
        with self.lock:
            if self.stopped:
                raise RuntimeError("the model plan is stopped: its "
                                   "followers have left")
            dist.broadcast_object_list(
                [(eid, op)], src=col._peer(self.axis, 0),
                group=self.axis.group)

    def follow(self) -> int:
        """Follower: receive and run the leader's ops, each on the engine
        it names, until the stop; returns the number of ops run."""
        if self.leader:
            raise RuntimeError("model rank 0 leads; follow() is for the "
                               "other ranks of the model axis")
        n = 0
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=col._peer(self.axis, 0),
                                       group=self.axis.group)
            eid, (kind, args) = box[0]
            if kind == "stop":
                self.stopped = True
                return n
            self.engines[eid]._ops[kind](*args)
            n += 1

    def stop(self) -> None:
        """Leader: release the followers from :meth:`follow`, once (later
        calls are no-ops)."""
        with self.lock:
            if not self.stopped:
                self.publish(None, ("stop", ()))
                self.stopped = True


class DecodeEngine:
    """Device half of the serving engine: owns the params (on the pool's
    device) and runs prefill and tick over the :class:`CachePool`.  With
    ``mesh``, ``params`` are this rank's shards over ``axis_name``.
    ``plan``: the fleet's shared :class:`ModelPlan` (default: one of this
    engine's own)."""

    def __init__(self, params, pool, mesh=None, axis_name: str = "model", *,
                 head_dim: int, prefill_bucket: int = 1, plan=None):
        self.head_dim = int(head_dim)
        self.pool = pool
        self.prefill_bucket = max(int(prefill_bucket), 1)
        self.device = pool.device
        self.n_kv_heads = _kv_heads(params, head_dim)
        self.rope = "pos_embed" not in params
        self.max_positions = (None if self.rope
                              else int(params["pos_embed"].shape[0]))
        self._params = params
        # the model axis' 1-D mesh, which the layers reduce over
        self._axis = None if mesh is None else mesh.axis(axis_name)
        self._owns_plan = plan is None
        self.plan = ModelPlan(self._axis) if plan is None else plan
        self.leader = self.plan.leader
        self.eid = self.plan.register(self)
        self._ops = {"prefill": self._prefill, "pos": self._set_pos,
                     "tick": self._tick, "copy": self._copy,
                     "spill": self._spill, "unspill": self._unspill,
                     "restore": self._restore, "xfer": self._xfer,
                     "pack": self._pack, "land": self._land,
                     "pack_spilled": self._pack_spilled}
        self.prefill_calls = 0
        self._padded_lens = set()
        self.tick_calls = 0
        self.prefix_copies = 0
        # the spill tier's slab format; a follower keeps its own columns'
        # payloads here, keyed by the leader's spilled sequence
        self.kv_plane = KvTransferPlane()
        self._spilled = {}

    # ---- the plan: model rank 0 leads, the others follow ----
    def publish(self, op) -> None:
        """Leader: broadcast ``op`` (the next device call) for this engine
        over the model group; a no-op without one, and on a follower,
        which only receives."""
        self.plan.publish(self.eid, op)

    def _call(self, kind, *args):
        """Leader: announce ``kind(*args)`` and run it, as one step of the
        plan (no other thread's op between the two)."""
        with self.plan.lock:
            self.publish((kind, args))
            return self._ops[kind](*args)

    def follow(self) -> int:
        """Follower: run the leader's calls (every engine's of a shared
        plan) until its stop; returns the number of calls run."""
        return self.plan.follow()

    def stop(self) -> None:
        """Leader: release the followers from :meth:`follow` (a no-op on
        a follower, and for an engine of a fleet's shared plan, which the
        fleet releases once)."""
        if self._owns_plan:
            self.plan.stop()

    def reset_slot(self, slot: int) -> None:
        """Set ``slot``'s write position to 0 (on every model rank)."""
        self._call("pos", int(slot), 0)

    def _set_pos(self, slot, pos):
        self.pool.pos[slot] = pos

    # ---- the prefix cache's copy-on-extend ----
    def copy_prefix(self, src_slot: int, dst_slot: int,
                    prefix_len: int) -> None:
        """Copy ``src_slot``'s K/V slab into ``dst_slot`` and set
        ``pos[dst_slot] = prefix_len``, so the occupant's next write lands
        at the first uncached position.  The whole row of every layer is
        copied: rows past ``prefix_len`` are stale but lie above the
        occupant's ``pos``, so the copy needs no length."""
        if not (0 < int(prefix_len) <= self.pool.max_total):
            raise ValueError(f"prefix_len {prefix_len} out of range (0, "
                             f"{self.pool.max_total}]")
        self._call("copy", int(src_slot), int(dst_slot), int(prefix_len))

    def _copy(self, src, dst, prefix_len):
        self.prefix_copies += 1
        with torch.inference_mode():
            for kc, vc in self.pool.caches:
                kc[dst].copy_(kc[src])
                vc[dst].copy_(vc[src])
        self.pool.pos[dst] = int(prefix_len)

    # ---- the host spill tier on the followers ----
    def spill_followers(self, slot: int, length: int, meta) -> None:
        """Leader, after its own slab went into the spill store: each
        follower packs its own columns of ``slot``'s rows ``[0, length)``
        under ``meta["seq"]``."""
        self.publish(("spill", (int(slot), int(length), dict(meta))))

    def _spill(self, slot, length, meta):
        self._spilled[tuple(meta["seq"])] = self.kv_plane.pack(
            self.pool, slot, length, meta)

    def unspill_followers(self, seq) -> None:
        """Leader: its store dropped ``seq``; the followers drop theirs."""
        self.publish(("unspill", (tuple(int(t) for t in seq),)))

    def _unspill(self, seq):
        self._spilled.pop(tuple(seq), None)

    def restore(self, payload: bytes, slot: int, seq,
                prefix_len: int) -> None:
        """Land a spilled slab in ``slot`` on every rank (the leader's
        ``payload``, each follower its own under ``seq``) and set
        ``pos[slot] = prefix_len``.  Raises :class:`ValueError` when any
        rank refused its payload (CRC, schema, shape) and
        :class:`RuntimeError` when any rank failed otherwise; then no
        rank's ``pos`` moved and the request re-prefills."""
        seq = tuple(int(t) for t in seq)
        with self.plan.lock:
            self.publish(("restore", (int(slot), seq, int(prefix_len))))
            errs = [e for e in self._restore(slot, seq, prefix_len, payload)
                    if e is not None]
        if errs:
            refused = [msg for kind, msg in errs if kind == "refused"]
            if refused:
                raise ValueError(refused[0])
            raise RuntimeError(errs[0][1])

    def _restore(self, slot, seq, prefix_len, payload=None):
        """Land this rank's payload; returns every rank's error (or
        None), agreed over the model group."""
        if payload is None:
            payload = self._spilled.get(tuple(seq))
        old_pos = int(self.pool.pos[slot])
        err = None
        try:
            if payload is None:
                raise ValueError(f"no spilled payload for a {len(seq)}-"
                                 f"token prefix on this rank")
            self.kv_plane.unpack_into(payload, self.pool, slot,
                                      ledger_op=SPILL_OP,
                                      ledger_axis=SPILL_AXIS)
        except ValueError as e:
            err = ("refused", str(e))
        except Exception as e:  # noqa: BLE001 — agreed, then re-raised
            err = ("failed", repr(e))
        errs = [err]
        if self._axis is not None and self._axis.size > 1:
            errs = [None] * self._axis.size
            dist.all_gather_object(errs, err, group=self._axis.group)
        self.pool.pos[slot] = old_pos if any(errs) else int(prefix_len)
        return errs

    @property
    def prefill_compiles(self) -> int:
        """Distinct padded prompt lengths prefilled: the size of JAX's
        compiled prefill family, which the goodput ledgers book as
        ``compile``."""
        return len(self._padded_lens)

    def padded_len(self, s_real: int) -> int:
        """``s_real`` rounded up to a multiple of ``prefill_bucket``."""
        b = self.prefill_bucket
        return ((int(s_real) + b - 1) // b) * b

    def check_padded_fit(self, prompt_len: int,
                         capacity: str = "per-slot") -> None:
        """Admission's bucket-aware bound: raise ``AdmissionError`` (reason
        ``too_long``) when the PADDED prompt overruns the slot or the
        learned positions (the scheduler knows raw lengths only)."""
        s_pad = self.padded_len(prompt_len)
        cap = self.pool.max_total
        if self.max_positions is not None:
            cap = min(cap, self.max_positions)
        if s_pad > cap:
            raise AdmissionError(
                "too_long",
                f"prompt {prompt_len} pads to {s_pad} (prefill_bucket "
                f"{self.prefill_bucket}), exceeding {capacity} capacity "
                f"{cap}")

    def prefill_into_slot(self, prompt_tokens, slot: int, rng=None,
                          temperature: float = 0.0) -> int:
        """Prefill ``prompt_tokens (S,)`` into ``slot``: writes the K/V slab
        (at the padded length) into the pool's caches, sets
        ``pool.pos[slot] = S`` and returns the first generated token
        (position ``S``: greedy, or sampled with ``rng`` at ``temperature >
        0``)."""
        prompt = np.asarray(prompt_tokens, np.int64).reshape(1, -1)
        s_real = prompt.shape[1]
        s_pad = self.padded_len(s_real)
        if s_pad > self.pool.max_total:
            raise ValueError(
                f"padded prompt length {s_pad} exceeds pool max_total "
                f"{self.pool.max_total}")
        if self.max_positions is not None and s_pad > self.max_positions:
            raise ValueError(
                f"padded prompt length {s_pad} exceeds the learned "
                f"pos_embed max_len {self.max_positions}")
        if s_pad > s_real:
            prompt = np.pad(prompt, ((0, 0), (0, s_pad - s_real)))
        rng = None if rng is None else np.asarray(rng, np.uint32)
        return self._call("prefill", prompt, s_real, slot, rng,
                          float(temperature))

    def _prefill(self, prompt, s_real, slot, rng, temperature):
        s_pad = prompt.shape[1]
        self.prefill_calls += 1
        self._padded_lens.add(s_pad)
        with torch.inference_mode():
            h, slabs = lm_prefill(self._params,
                                  torch.tensor(prompt, device=self.device),
                                  s_pad, head_dim=self.head_dim,
                                  axis_name=self._axis)
            keys = None if rng is None else rng[None]
            # the first token comes from the last REAL position, salted
            # with its position s_real (lm_generate's)
            tok = _next_token(self._params["embed"], h[:, s_real - 1], keys,
                              np.array([temperature], np.float32),
                              torch.tensor([s_real], device=self.device),
                              axis_name=self._axis)
            for (kc, vc), (ks, vs) in zip(self.pool.caches, slabs):
                kc[slot, :s_pad].copy_(ks[0])
                vc[slot, :s_pad].copy_(vs[0])
            first = int(tok[0])
        self.pool.pos[slot] = s_real
        return first

    def tick(self, last_tokens: np.ndarray, keys=None,
             temps=None) -> np.ndarray:
        """One decode tick for ALL slots: consume ``last_tokens (n_slots,)``
        at the pool's per-slot positions, append K/V in place, advance every
        position, and return the next token per slot.  ``keys (n_slots,
        2)`` and ``temps (n_slots,)`` are the slots' sampling operands
        (``None``, or temperatures <= 0: greedy)."""
        return self._call("tick", np.asarray(last_tokens, np.int64), keys,
                          temps)

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

    # ---- the role-split fleet's transfers, as plan ops ----
    def copy_slab_from(self, src: "DecodeEngine", src_slot: int,
                       dst_slot: int, length: int, plane: KvTransferPlane):
        """The ``local`` transport: copy ``src``'s slot ``src_slot`` into
        this engine's ``dst_slot`` and set its position to ``length``, on
        every model rank (each its own columns).  ``plane`` books the
        leader's counters; returns its stats row."""
        with self.plan.lock:
            self.publish(("xfer", (src.eid, int(src_slot), int(dst_slot),
                                   int(length))))
            return plane.transfer_local(src.pool, src_slot, self.pool,
                                        dst_slot, length)

    def _xfer(self, src_eid, src_slot, dst_slot, length):
        self.kv_plane.transfer_local(self.plan.engines[src_eid].pool,
                                     src_slot, self.pool, dst_slot, length)

    def pack_slab(self, plane: KvTransferPlane, slot: int, length: int,
                  meta) -> bytes:
        """The ``lanes`` transport's pack: slot ``slot``'s rows ``[0,
        length)`` and ``meta`` as one ``kv_transfer.v1`` payload.  At TP >
        1 every rank's columns are gathered to the leader first, so the
        payload holds the GLOBAL slab (JAX's bytes, its CRC)."""
        if not self.plan.broadcasting:
            return plane.pack(self.pool, slot, length, meta)
        with self.plan.lock:
            self.publish(("pack", (int(slot), int(length))))
            host = self._pack(slot, length)
        return plane.pack_host(host, meta, self.pool.caches[0][0].dtype)

    def _pack(self, slot, length):
        """Every rank's columns of the rows, concatenated in rank order
        (JAX's global cache layout: axis 2 over the model axis)."""
        with torch.inference_mode():
            own = _host_rows(torch.stack([c[slot, :length]
                                          for kv in self.pool.caches
                                          for c in kv]))
        parts = [None] * self._axis.size
        dist.all_gather_object(parts, own, group=self._axis.group)
        return np.concatenate(parts, axis=-1)

    def pack_spilled(self, plane: KvTransferPlane, payload: bytes):
        """A spilled prefix served to another worker: ``payload`` is the
        leader's spill-tier slab; at TP > 1 it holds only the leader's
        columns, so every rank's spilled columns of the same sequence are
        gathered into the GLOBAL slab (JAX's bytes, its CRC).  Returns
        None when any rank's payload is missing or refused."""
        if not self.plan.broadcasting:
            return payload
        meta = pickle.loads(payload)["meta"]
        seq = tuple(int(t) for t in meta["seq"])
        with self.plan.lock:
            self.publish(("pack_spilled", (seq,)))
            host = self._pack_spilled(seq, payload)
        if host is None:
            return None
        return plane.pack_host(host, meta, self.pool.caches[0][0].dtype)

    def _pack_spilled(self, seq, payload=None):
        """This rank's spilled columns of ``seq``, gathered in rank order
        (None on every rank when any rank has no good payload)."""
        if payload is None:
            payload = self._spilled.get(tuple(seq))
        own = None
        if payload is not None:
            try:
                data = self.kv_plane.open_payload(
                    payload, self.pool.n_layers, self.pool.kv_dim,
                    self.pool.max_total)
                own = np.stack([a for kv in data["rows"] for a in kv])
            except ValueError:
                own = None
        parts = [None] * self._axis.size
        dist.all_gather_object(parts, own, group=self._axis.group)
        if any(p is None for p in parts):
            return None
        return np.concatenate(parts, axis=-1)

    def land_slab(self, plane: KvTransferPlane, payload: bytes,
                  slot: int):
        """The ``lanes`` transport's landing: check ``payload`` (schema,
        shape, CRC32 over the global slab) and write it into ``slot``,
        every model rank its own columns; ``ValueError`` before any rank
        is touched when the payload is refused.  The leader books the
        ledger row.  Returns the landing's stats."""
        if not self.plan.broadcasting:
            return plane.unpack_into(payload, self.pool, slot)
        t0 = time.monotonic()
        data = plane.open_payload(payload, self.pool.n_layers,
                                  self.pool.kv_dim * self._axis.size,
                                  self.pool.max_total)
        host = np.stack([a for kv in data["rows"] for a in kv])
        with self.plan.lock:
            self.publish(("land", (int(slot), host, data["dtype"])))
            self._land(slot, host, data["dtype"])
        return plane.book_landing(data, payload, t0)

    def _land(self, slot, host, dtype_name):
        kv = self.pool.kv_dim
        r = col.axis_index(self._axis)
        own = host[..., r * kv:(r + 1) * kv]
        rows = [(own[2 * i], own[2 * i + 1])
                for i in range(self.pool.n_layers)]
        self.kv_plane.inject_program(self.pool)(
            self.pool.caches, rows, slot, getattr(torch, dtype_name))
        self.pool.pos[slot] = host.shape[1]

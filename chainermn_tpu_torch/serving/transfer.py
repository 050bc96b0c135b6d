"""KV-transfer plane: ship a finished prefill's KV slab between pools.

Counterpart of ``chainermn_tpu/serving/transfer.py``, the disaggregation
primitive: a prefill worker computes a prompt's K/V slab into a staging
slot of its own :class:`~chainermn_tpu_torch.serving.cache_pool.CachePool`,
and this plane moves the slab, with the request metadata riding with it,
into a decode worker's reserved slot.  Two transports, one contract:

* **Same process** (:meth:`KvTransferPlane.transfer_local`): every layer's
  K and V row of the source slot, rows ``[0, min(src.max_total,
  dst.max_total))``, copied into the destination slot (``copy_``, on the
  pools' card), and ``pos`` set on the destination.  JAX computes it as a
  ``dynamic_update_slice`` outside any Pallas kernel; here it is plain
  torch too.  One "program" per pool pair, keyed as JAX keys its compiled
  ones.
* **Object lanes** (:meth:`pack` -> :meth:`lane_put` / :meth:`lane_get`
  -> :meth:`unpack_into`): the slab's written rows ``[0, length)`` are
  serialised with the request wire dict and a CRC32 over their raw bytes
  (the ``chainermn_tpu.kv_transfer.v1`` wire dict), shipped over a
  put / get / delete store under ``lane_call``'s retry discipline (a
  terminal fault raises :class:`~chainermn_tpu_torch.communicators.base
  .DcnLaneError` naming the lane), then checked before anything touches
  the pool and landed in the destination slot.  Each landing books its
  raw slab bytes as a noted ``kv_transfer_lane@dcn`` comm-ledger row: the
  number :func:`transfer_cost` predicts.  The rows travel as numpy arrays
  of their raw bits: a bfloat16 row is its 16-bit pattern (``uint16``;
  numpy has no bfloat16), so the CRC hashes exactly the bytes the card
  holds, and an fp32 slab's CRC equals JAX's over the same numbers.

Rows above ``length`` in the destination keep whatever they held: they
sit above the occupant's ``pos`` and are unreachable (the masking
argument of ``cache_pool.py``), so neither copy needs a length operand.
"""

from __future__ import annotations

import pickle
import threading
import time
import zlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

#: Wire schema of one packed transfer (a receiver refuses a slab it
#: cannot interpret, never guesses).
WIRE_SCHEMA = "chainermn_tpu.kv_transfer.v1"

#: The ledger key a lane-mode transfer books under (op@axis).
LANE_OP = "kv_transfer_lane"
LANE_AXIS = "dcn"

#: The ledger key a host-RAM spill restore books under: the slab
#: round-tripped through the local spill tier, not a wire.
SPILL_OP = "kv_spill_restore"
SPILL_AXIS = "host"

# dtypes numpy lacks travel as the unsigned integer of their width
_RAW_VIEW = {torch.bfloat16: (torch.int16, np.uint16)}


def _host_rows(t: torch.Tensor) -> np.ndarray:
    """A device tensor's raw bits as a host numpy array."""
    t = t.detach().contiguous().cpu()
    view = _RAW_VIEW.get(t.dtype)
    if view is None:
        return t.numpy()
    return t.view(view[0]).numpy().view(view[1])


def _device_rows(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_host_rows` on the host (a CPU tensor)."""
    view = _RAW_VIEW.get(dtype)
    if view is None:
        return torch.from_numpy(np.ascontiguousarray(a))
    return torch.from_numpy(
        np.ascontiguousarray(a).view(np.int16)).view(dtype)


def slab_crc32(rows) -> int:
    """CRC32 over a packed slab's raw K/V bytes, in layer order (K then V
    per layer): the integrity stamp every ``kv_transfer.v1`` payload
    carries.  ``rows`` holds numpy arrays of the rows' raw bits."""
    crc = 0
    for k, v in rows:
        crc = zlib.crc32(np.ascontiguousarray(k).tobytes(), crc)
        crc = zlib.crc32(np.ascontiguousarray(v).tobytes(), crc)
    return crc & 0xFFFFFFFF


def slab_nbytes(n_layers: int, length: int, kv_dim: int, dtype) -> int:
    """RAW K/V payload bytes of one slab: 2 (K and V) x layers x written
    rows x kv_dim x itemsize (pickle framing excluded).  ``dtype``: a
    torch dtype, its name (``'bfloat16'``) or a numpy dtype."""
    return 2 * int(n_layers) * int(length) * int(kv_dim) * _itemsize(dtype)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    named = getattr(torch, str(dtype).replace("torch.", ""), None)
    if isinstance(named, torch.dtype):
        return named.itemsize
    return np.dtype(dtype).itemsize


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


#: The pools' cache layout in JAX's spec language: each model rank holds
#: its own KV heads' columns, axis 2 over the model axis.
CACHE_SPEC = (None, None, "model")


def _shard_axis_of(spec, axis_name: str) -> Optional[int]:
    """The logical axis a cache spec shards over ``axis_name`` (None:
    replicated), the glue into ``reshard_cost``'s spec language."""
    for i, s in enumerate(tuple(spec)):
        names = s if isinstance(s, tuple) else (s,)
        if axis_name in [n for n in names if n is not None]:
            return i
    return None


def transfer_cost(n_layers: int, length: int, kv_dim: int, dtype, *,
                  mode: str, axis_size: int = 1,
                  src_spec: Optional[int] = 2,
                  dst_spec: Optional[int] = 2,
                  copy_rows: Optional[int] = None) -> Dict[str, Any]:
    """Static prediction of one transfer's comm-ledger booking, the
    number the runtime reproduces byte for byte.

    ``mode="local"``: the same-process copy, per K or V row the
    :func:`~chainermn_tpu_torch.parallel.reshard.reshard_cost` of the
    ``(1, copy_rows, kv_dim)`` block between the two pools' cache specs
    (zero when they match, one all_to_all a row otherwise).
    ``mode="lanes"``: :func:`slab_nbytes` of the written rows, booked as
    one noted ``kv_transfer_lane@dcn`` row a transfer."""
    if mode == "lanes":
        nbytes = slab_nbytes(n_layers, length, kv_dim, dtype)
        return {"mode": mode, "primitive": LANE_OP,
                "ledger_bytes": nbytes, "wire_bytes": nbytes,
                "messages": 1}
    if mode != "local":
        raise ValueError(f"mode must be 'local' or 'lanes', got {mode!r}")
    from ..parallel.reshard import reshard_cost

    rows = int(copy_rows if copy_rows is not None else length)
    total = {"mode": mode, "primitive": None, "ledger_bytes": 0,
             "wire_bytes": 0, "messages": 0}
    for _ in range(2 * int(n_layers)):
        c = reshard_cost((1, rows, int(kv_dim)), dtype, src_spec,
                         dst_spec, axis_size)
        total["ledger_bytes"] += c["ledger_bytes"]
        total["wire_bytes"] += c["wire_bytes"]
        total["messages"] += c["messages"]
        if c["primitive"]:
            total["primitive"] = c["primitive"]
    return total


class InProcessLaneStore:
    """Loopback object-lane transport: the one-process stand-in for a
    cross-process lane store, with the same put / get / delete face.
    Faults are injected through ``lane_call``'s injector, not here, so
    tests exercise the real retry and classification path."""

    def __init__(self):
        self._store: Dict[str, bytes] = {}
        self._cv = threading.Condition()

    def put(self, tag: str, payload: bytes) -> None:
        with self._cv:
            self._store[str(tag)] = bytes(payload)
            self._cv.notify_all()

    def get(self, tag: str, timeout_s: float = 10.0) -> bytes:
        deadline = time.monotonic() + float(timeout_s)
        with self._cv:
            while str(tag) not in self._store:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"kv transfer tag {tag!r} not published within "
                        f"{timeout_s}s (deadline exceeded)")
                self._cv.wait(left)
            return self._store[str(tag)]

    def delete(self, tag: str) -> None:
        with self._cv:
            self._store.pop(str(tag), None)

    def tags(self):
        """Every tag published now."""
        with self._cv:
            return list(self._store)


class KvTransferPlane:
    """The transfer-plane object a disaggregated fleet shares.

    ``transport``: the object lane (put / get / delete) of the lanes path,
    :class:`InProcessLaneStore` by default; a deployment passes a
    communicator's (``CommunicatorBase.kv_lane_transport()``).
    ``lane_config``: ``lane_call``'s retry and timeout settings.  The
    same-process path needs no transport."""

    def __init__(self, transport=None, lane_config=None):
        self.transport = transport or InProcessLaneStore()
        self.lane_config = lane_config
        self._programs: Dict[Any, Callable] = {}      # local copies
        self._inject_programs: Dict[Any, Callable] = {}
        # host-side counters (the fleet's metrics read these)
        self.transfers = 0
        self.lane_transfers = 0
        self.bytes_moved = 0            # ledger-convention slab bytes
        self.last_transfer_ms = 0.0

    # ---- same process: one program per pool pair ----
    @staticmethod
    def _sig(pool):
        return (pool.n_layers, pool.n_slots, pool.max_total, pool.kv_dim,
                _dtype_name(pool.caches[0][0].dtype))

    def _local_key(self, src_pool, dst_pool):
        return (self._sig(src_pool), self._sig(dst_pool),
                str(src_pool.device), str(dst_pool.device))

    def _build_local(self, src_pool, dst_pool) -> Callable:
        if src_pool.device != dst_pool.device:
            raise ValueError(
                "local transfer needs src and dst pools on ONE device; "
                "cross-device transfers go over the object lanes "
                "(pack/unpack_into)")
        if src_pool.kv_dim != dst_pool.kv_dim \
                or src_pool.n_layers != dst_pool.n_layers:
            raise ValueError(
                f"pool shape mismatch: src (layers={src_pool.n_layers}, "
                f"kv_dim={src_pool.kv_dim}) vs dst "
                f"(layers={dst_pool.n_layers}, kv_dim={dst_pool.kv_dim})")
        copy_rows = min(src_pool.max_total, dst_pool.max_total)

        def copy(src_caches, dst_caches, src_slot: int,
                 dst_slot: int) -> None:
            with torch.inference_mode():
                for (ks, vs), (kd, vd) in zip(src_caches, dst_caches):
                    kd[dst_slot, :copy_rows].copy_(ks[src_slot, :copy_rows])
                    vd[dst_slot, :copy_rows].copy_(vs[src_slot, :copy_rows])

        return copy

    def local_program(self, src_pool, dst_pool) -> Callable:
        """The (src pool, dst pool) copy ``prog(src_caches, dst_caches,
        src_slot, dst_slot)``, built once per pool-shape pair."""
        key = self._local_key(src_pool, dst_pool)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self._build_local(src_pool,
                                                           dst_pool)
            from ..observability import flight as _flight
            _flight.note("compile", program="serving_kv_transfer",
                         family_size=len(self._programs))
        return prog

    def transfer_local(self, src_pool, src_slot: int, dst_pool,
                       dst_slot: int, length: int) -> Dict[str, Any]:
        """Copy slot ``src_slot``'s slab into ``dst_slot`` of a pool on the
        same card and set ``dst_pool.pos[dst_slot] = length``.  The copy
        is enqueued on the current CUDA stream, behind whatever wrote the
        source rows there.  Returns the transfer's stats row (mode, ms,
        ledger bytes, length)."""
        copy_rows = min(src_pool.max_total, dst_pool.max_total)
        if not (0 < int(length) <= copy_rows):
            raise ValueError(
                f"transfer length {length} out of range (0, {copy_rows}] "
                f"(src max_total {src_pool.max_total}, dst "
                f"{dst_pool.max_total})")
        prog = self.local_program(src_pool, dst_pool)
        t0 = time.monotonic()
        prog(src_pool.caches, dst_pool.caches, int(src_slot), int(dst_slot))
        dst_pool.pos[dst_slot] = int(length)
        ms = (time.monotonic() - t0) * 1e3
        self.transfers += 1
        self.last_transfer_ms = ms
        spec = _shard_axis_of(CACHE_SPEC, "model")
        cost = transfer_cost(
            src_pool.n_layers, length, src_pool.kv_dim,
            src_pool.caches[0][0].dtype, mode="local", axis_size=1,
            src_spec=spec, dst_spec=spec, copy_rows=copy_rows)
        return {"mode": "local", "ms": ms,
                "ledger_bytes": cost["ledger_bytes"],
                "length": int(length)}

    # ---- object lanes: pack -> lane -> unpack_into ----
    def pack(self, src_pool, src_slot: int, length: int,
             meta: Dict[str, Any]) -> bytes:
        """Serialise slot ``src_slot``'s written rows ``[0, length)`` plus
        ``meta``.  One device-to-host copy of every layer's rows."""
        if not (0 < int(length) <= src_pool.max_total):
            raise ValueError(f"pack length {length} out of range "
                             f"(0, {src_pool.max_total}]")
        length = int(length)
        with torch.inference_mode():
            slab = torch.stack([c[src_slot, :length]
                                for kv in src_pool.caches for c in kv])
            host = _host_rows(slab)
        return self.pack_host(host, meta, src_pool.caches[0][0].dtype)

    @staticmethod
    def pack_host(host: np.ndarray, meta: Dict[str, Any],
                  dtype: torch.dtype) -> bytes:
        """Serialise a slab already on the host: ``host (2 * layers,
        length, kv_dim)``, K then V per layer, the raw bits of ``dtype``."""
        # read-only, as a device array's host copy is: the payload pickles
        # the rows as bytes (JAX's framing, byte for byte in fp32)
        host.flags.writeable = False
        n_layers = host.shape[0] // 2
        rows = [(host[2 * i], host[2 * i + 1]) for i in range(n_layers)]
        return pickle.dumps({
            "schema": WIRE_SCHEMA,
            "meta": dict(meta),
            "pos": int(host.shape[1]),
            "n_layers": n_layers,
            "kv_dim": int(host.shape[2]),
            "dtype": _dtype_name(dtype),
            # the receiver recomputes this over the decoded rows and
            # refuses a mismatch: a corrupt slab re-prefills, never serves
            "crc32": slab_crc32(rows),
            "rows": rows,
        }, protocol=pickle.HIGHEST_PROTOCOL)

    def lane_put(self, tag: str, payload: bytes) -> None:
        """Publish a packed slab on the object lane under ``lane_call``'s
        retry discipline; a terminal fault names the lane
        (``kv_transfer/put/<tag>``)."""
        from ..communicators.base import lane_call

        lane_call(f"kv_transfer/put/{tag}",
                  lambda: self.transport.put(tag, payload),
                  self.lane_config)

    def lane_get(self, tag: str, timeout_s: float = 10.0) -> bytes:
        from ..communicators.base import lane_call

        return lane_call(
            f"kv_transfer/get/{tag}",
            lambda: self.transport.get(tag, timeout_s),
            self.lane_config)

    def lane_delete(self, tag: str) -> None:
        from ..communicators.base import lane_call

        lane_call(f"kv_transfer/gc/{tag}",
                  lambda: self.transport.delete(tag), self.lane_config)

    def inject_program(self, dst_pool) -> Callable:
        """The slab write that lands a transfer, built once per pool
        shape: ``inject(caches, rows, dst_slot, dtype)`` copies each
        layer's host rows ``(length, kv_dim)``, the raw bits of ``dtype``,
        into the slot's first ``length`` rows of ``caches`` (one
        host-to-device copy of the stacked slab, cast to the pool's dtype,
        then a row copy a layer).  Each tensor-parallel rank writes its own
        KV columns."""
        key = self._sig(dst_pool) + (str(dst_pool.device),)
        prog = self._inject_programs.get(key)
        if prog is None:
            device = dst_pool.device

            def inject(caches, rows, dst_slot: int,
                       dtype: torch.dtype) -> None:
                stacked = np.stack([a for kv in rows for a in kv])
                slab = _device_rows(stacked, dtype).to(
                    device=device, dtype=caches[0][0].dtype)
                length = slab.shape[1]
                with torch.inference_mode():
                    for i, (kc, vc) in enumerate(caches):
                        kc[dst_slot, :length].copy_(slab[2 * i])
                        vc[dst_slot, :length].copy_(slab[2 * i + 1])

            prog = self._inject_programs[key] = inject
            from ..observability import flight as _flight
            _flight.note("compile", program="serving_kv_inject")
        return prog

    def unpack_into(self, payload: bytes, dst_pool, dst_slot: int, *,
                    ledger_op: str = LANE_OP,
                    ledger_axis: str = LANE_AXIS) -> Dict[str, Any]:
        """Land a packed slab in ``dst_slot`` and set ``dst_pool.pos`` to
        its length.  The schema, shape and CRC32 are checked before
        anything touches the pool: a corrupt or foreign slab raises
        :class:`ValueError`.  With the tracer on, the RAW slab bytes are
        booked as a noted ``ledger_op@ledger_axis`` ledger row (the spill
        tier's restores book ``kv_spill_restore@host``).  Returns the wire
        dict's ``meta`` and the transfer's stats."""
        t0 = time.monotonic()
        data = self.open_payload(payload, dst_pool.n_layers,
                                 dst_pool.kv_dim, dst_pool.max_total)
        self.inject_program(dst_pool)(dst_pool.caches, data["rows"],
                                      dst_slot, getattr(torch, data["dtype"]))
        dst_pool.pos[dst_slot] = int(data["pos"])
        return self.book_landing(data, payload, t0, ledger_op=ledger_op,
                                 ledger_axis=ledger_axis)

    @staticmethod
    def open_payload(payload: bytes, n_layers: int, kv_dim: int,
                     max_total: int) -> Dict[str, Any]:
        """Decode a packed slab and check it against a destination of
        ``n_layers`` x ``kv_dim`` columns and ``max_total`` rows a slot:
        the schema, the shape, the length and the CRC32; ``ValueError``
        names the first that is wrong.  Returns the wire dict."""
        data = pickle.loads(payload)
        if data.get("schema") != WIRE_SCHEMA:
            raise ValueError(
                f"refusing KV transfer with schema {data.get('schema')!r} "
                f"(this receiver speaks {WIRE_SCHEMA})")
        if data["n_layers"] != n_layers or data["kv_dim"] != kv_dim:
            raise ValueError(
                f"slab shape mismatch: wire (layers={data['n_layers']}, "
                f"kv_dim={data['kv_dim']}) vs pool "
                f"(layers={n_layers}, kv_dim={kv_dim})")
        length = int(data["pos"])
        if length > max_total:
            raise ValueError(
                f"slab length {length} exceeds destination per-slot "
                f"capacity {max_total}")
        want_crc = data.get("crc32")
        if want_crc is not None:
            got_crc = slab_crc32(data["rows"])
            if got_crc != int(want_crc):
                raise ValueError(
                    f"refusing KV transfer: CRC mismatch (payload says "
                    f"{int(want_crc):#010x}, rows hash {got_crc:#010x}) "
                    f"— the slab was corrupted in transit/storage and "
                    f"must re-prefill, never serve")
        return data

    def book_landing(self, data: Dict[str, Any], payload: bytes, t0: float,
                     *, ledger_op: str = LANE_OP,
                     ledger_axis: str = LANE_AXIS) -> Dict[str, Any]:
        """Count one landed slab (``data``, from :meth:`open_payload`,
        landing since ``t0``) and, with the tracer on, book its RAW bytes
        as a noted ``ledger_op@ledger_axis`` row; returns its stats."""
        length = int(data["pos"])
        nbytes = slab_nbytes(data["n_layers"], length, data["kv_dim"],
                             data["dtype"])
        ms = (time.monotonic() - t0) * 1e3
        self.transfers += 1
        self.lane_transfers += 1
        self.bytes_moved += nbytes
        self.last_transfer_ms = ms
        from ..observability import comm as _comm
        from ..observability import trace as _trace
        if _trace.get_tracer().enabled:
            _comm.get_accountant().record(
                ledger_op, ledger_axis, nbytes, data["dtype"],
                latency_s=ms / 1e3, noted=True)
        return {"mode": "lanes", "ms": ms, "ledger_bytes": nbytes,
                "wire_payload_bytes": len(payload), "length": length,
                "meta": data["meta"]}

    def stats(self) -> Dict[str, float]:
        return {
            "transfers": float(self.transfers),
            "lane_transfers": float(self.lane_transfers),
            "bytes_moved": float(self.bytes_moved),
            "last_transfer_ms": float(self.last_transfer_ms),
            "programs": float(len(self._programs)
                              + len(self._inject_programs)),
        }

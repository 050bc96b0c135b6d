"""The KV-transfer plane's slab format, and the in-process lane store.

Counterpart of ``chainermn_tpu/serving/transfer.py``, the part the host
spill tier needs: :meth:`KvTransferPlane.pack` serialises a slot's
written rows ``[0, length)`` with a CRC32 over their raw bytes (the
``chainermn_tpu.kv_transfer.v1`` wire dict), and
:meth:`KvTransferPlane.unpack_into` verifies the stamp before anything
touches the pool, then lands the rows in a destination slot through
:meth:`KvTransferPlane.inject_program` and books the slab bytes in the
comm ledger.  The rows travel as numpy arrays of their raw bits: a
bfloat16 row is its 16-bit pattern (``uint16``; numpy has no bfloat16),
so the CRC hashes exactly the bytes the card holds, and an fp32 slab's
CRC equals JAX's over the same numbers.

The device halves are plain slot-row copies (``copy_``), as JAX computes
them outside any Pallas kernel; a pool on the card copies on the card.
Rows above ``length`` in the destination keep whatever they held: they
sit above the occupant's ``pos`` and are unreachable (the masking
argument of ``cache_pool.py``).  ``transfer_local``, the object-lane
faces and ``transfer_cost`` are ROADMAP.md's A11 step 2.
"""

from __future__ import annotations

import pickle
import threading
import time
import zlib
from typing import Any, Callable, Dict

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
    torch dtype or its name (``'bfloat16'``)."""
    if not isinstance(dtype, torch.dtype):
        dtype = getattr(torch, str(dtype).replace("torch.", ""))
    return 2 * int(n_layers) * int(length) * int(kv_dim) * dtype.itemsize


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


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
    """Packs slot slabs into ``kv_transfer.v1`` payloads and lands them in
    a pool (the object-lane transport is A11 step 2)."""

    def pack(self, src_pool, src_slot: int, length: int,
             meta: Dict[str, Any]) -> bytes:
        """Serialise slot ``src_slot``'s written rows ``[0, length)`` plus
        ``meta``.  One device-to-host copy of every layer's rows."""
        if not (0 < int(length) <= src_pool.max_total):
            raise ValueError(f"pack length {length} out of range "
                             f"(0, {src_pool.max_total}]")
        length = int(length)
        dtype = src_pool.caches[0][0].dtype
        with torch.inference_mode():
            slab = torch.stack([c[src_slot, :length]
                                for kv in src_pool.caches for c in kv])
            host = _host_rows(slab)
        # read-only, as a device array's host copy is: the payload pickles
        # the rows as bytes (JAX's framing, byte for byte in fp32)
        host.flags.writeable = False
        rows = [(host[2 * i], host[2 * i + 1])
                for i in range(src_pool.n_layers)]
        return pickle.dumps({
            "schema": WIRE_SCHEMA,
            "meta": dict(meta),
            "pos": length,
            "n_layers": src_pool.n_layers,
            "kv_dim": src_pool.kv_dim,
            "dtype": _dtype_name(dtype),
            # the receiver recomputes this over the decoded rows and
            # refuses a mismatch: a corrupt slab re-prefills, never serves
            "crc32": slab_crc32(rows),
            "rows": rows,
        }, protocol=pickle.HIGHEST_PROTOCOL)

    def inject_program(self, dst_pool) -> Callable:
        """The slab write that lands a transfer: ``inject(rows, dst_slot,
        dtype)`` copies each layer's host rows ``(length, kv_dim)``, the raw
        bits of ``dtype``, into the slot's first ``length`` rows (one
        host-to-device copy of the stacked slab, cast to the pool's dtype,
        then a row copy a layer).  Each tensor-parallel rank writes its own
        KV columns."""
        caches = dst_pool.caches

        def inject(rows, dst_slot: int, dtype: torch.dtype) -> None:
            stacked = np.stack([a for kv in rows for a in kv])
            slab = _device_rows(stacked, dtype).to(
                device=dst_pool.device, dtype=caches[0][0].dtype)
            length = slab.shape[1]
            with torch.inference_mode():
                for i, (kc, vc) in enumerate(caches):
                    kc[dst_slot, :length].copy_(slab[2 * i])
                    vc[dst_slot, :length].copy_(slab[2 * i + 1])

        return inject

    def unpack_into(self, payload: bytes, dst_pool, dst_slot: int, *,
                    ledger_op: str = LANE_OP,
                    ledger_axis: str = LANE_AXIS) -> Dict[str, Any]:
        """Land a packed slab in ``dst_slot`` and set ``dst_pool.pos`` to
        its length.  The schema, shape and CRC32 are checked before
        anything touches the pool: a corrupt or foreign slab raises
        :class:`ValueError`.  With the tracer on, the RAW slab bytes are
        booked as a noted ``ledger_op@ledger_axis`` ledger row.  Returns
        the wire dict's ``meta`` and the transfer's stats."""
        t0 = time.monotonic()
        data = pickle.loads(payload)
        if data.get("schema") != WIRE_SCHEMA:
            raise ValueError(
                f"refusing KV transfer with schema {data.get('schema')!r} "
                f"(this receiver speaks {WIRE_SCHEMA})")
        if data["n_layers"] != dst_pool.n_layers \
                or data["kv_dim"] != dst_pool.kv_dim:
            raise ValueError(
                f"slab shape mismatch: wire (layers={data['n_layers']}, "
                f"kv_dim={data['kv_dim']}) vs pool "
                f"(layers={dst_pool.n_layers}, kv_dim={dst_pool.kv_dim})")
        length = int(data["pos"])
        if length > dst_pool.max_total:
            raise ValueError(
                f"slab length {length} exceeds destination per-slot "
                f"capacity {dst_pool.max_total}")
        want_crc = data.get("crc32")
        if want_crc is not None:
            got_crc = slab_crc32(data["rows"])
            if got_crc != int(want_crc):
                raise ValueError(
                    f"refusing KV transfer: CRC mismatch (payload says "
                    f"{int(want_crc):#010x}, rows hash {got_crc:#010x}) "
                    f"— the slab was corrupted in transit/storage and "
                    f"must re-prefill, never serve")
        self.inject_program(dst_pool)(data["rows"], dst_slot,
                                      getattr(torch, data["dtype"]))
        dst_pool.pos[dst_slot] = length

        nbytes = slab_nbytes(data["n_layers"], length, data["kv_dim"],
                             data["dtype"])
        ms = (time.monotonic() - t0) * 1e3
        from ..observability import comm as _comm
        from ..observability import trace as _trace
        if _trace.get_tracer().enabled:
            _comm.get_accountant().record(
                ledger_op, ledger_axis, nbytes, data["dtype"],
                latency_s=ms / 1e3, noted=True)
        return {"mode": "lanes", "ms": ms, "ledger_bytes": nbytes,
                "wire_payload_bytes": len(payload), "length": length,
                "meta": data["meta"]}

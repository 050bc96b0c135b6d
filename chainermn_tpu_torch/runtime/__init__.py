"""Native runtime components: the C++ prefetching data loader.

A copy of ``chainermn_tpu/runtime/__init__.py`` and its ``_prefetch.cpp``
(the reference's ``MultiprocessIterator`` role): a C++ thread pool
assembles batches from an in-memory record buffer, or ``pread``s them from
a :func:`write_file_dataset` file, into a ring of slots without taking the
GIL.  The library compiles with the system ``g++`` at first use into
``build/chainermn_tpu_torch/`` at the root of the checkout (gitignored),
named by a hash of the source; where it cannot be built, the iterator
falls back to a pure-Python path with the same batches.  Batches are numpy
arrays; ``train.shard_batch`` moves them to the card through pinned memory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "_prefetch.cpp")
_LIB_LOCK = threading.Lock()
_LIB = None
_LIB_ERR: Optional[str] = None
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                          "chainermn_tpu_torch")


def _build_library() -> Optional[ctypes.CDLL]:
    """Compile _prefetch.cpp once per interpreter into the build directory,
    keyed by a hash of the source (a stale binary is never loaded)."""
    global _LIB, _LIB_ERR
    with _LIB_LOCK:
        if _LIB is not None or _LIB_ERR is not None:
            return _LIB
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        so_path = os.path.join(_BUILD_DIR, f"_prefetch-{tag}.so")
        try:
            if not os.path.exists(so_path):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                tmp = f"{so_path}.tmp{os.getpid()}"
                try:
                    subprocess.run(["g++", "-O3", "-std=c++17", "-shared",
                                    "-fPIC", "-pthread", _SRC, "-o", tmp],
                                   check=True, capture_output=True,
                                   timeout=120)
                    os.replace(tmp, so_path)  # atomic vs other builders
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            _LIB = ctypes.CDLL(so_path)
        except (OSError, subprocess.SubprocessError) as e:
            _LIB_ERR = str(e) or "unknown"
            return None
        _LIB.pfl_create.restype = ctypes.c_void_p
        _LIB.pfl_create.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int]
        _LIB.pfl_create_file.restype = ctypes.c_void_p
        _LIB.pfl_create_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        _LIB.pfl_set_order.restype = ctypes.c_int
        _LIB.pfl_set_order.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        _LIB.pfl_cancel.restype = ctypes.c_int
        _LIB.pfl_cancel.argtypes = [ctypes.c_void_p]
        _LIB.pfl_acquire.restype = ctypes.c_int64
        _LIB.pfl_acquire.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        _LIB.pfl_release.restype = None
        _LIB.pfl_release.argtypes = [ctypes.c_void_p]
        _LIB.pfl_destroy.restype = None
        _LIB.pfl_destroy.argtypes = [ctypes.c_void_p]
        return _LIB


def native_available() -> bool:
    """True when the C++ prefetcher compiled (or was already cached)."""
    return _build_library() is not None


class _Fields:
    """Field packing: (N, …) arrays ⇄ one contiguous (N, record_bytes)
    uint8 buffer the C++ side can memcpy rows from."""

    def __init__(self, arrays: Sequence[np.ndarray]):
        n = len(arrays[0])
        if any(len(a) != n for a in arrays):
            raise ValueError("all field arrays must share the leading dim")
        self.shapes = [a.shape[1:] for a in arrays]
        self.dtypes = [a.dtype for a in arrays]
        flat = [np.ascontiguousarray(a).reshape(n, -1).view(np.uint8)
                for a in arrays]
        self.packed = (flat[0] if len(flat) == 1
                       else np.concatenate(flat, axis=1))
        self.packed = np.ascontiguousarray(self.packed)
        self.record_bytes = self.packed.shape[1]
        self.n_records = n

    def unpack(self, raw: np.ndarray):
        """(B, record_bytes) uint8 → tuple of (B, …) field arrays."""
        out, off = [], 0
        for shape, dtype in zip(self.shapes, self.dtypes):
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            fld = raw[:, off:off + nbytes].view(dtype).reshape(
                (len(raw),) + tuple(shape))
            out.append(fld)
            off += nbytes
        return tuple(out) if len(out) > 1 else out[0]


_META_NAME = "meta.json"
_DATA_NAME = "data.bin"


def write_file_dataset(path: str, arrays: Sequence[np.ndarray],
                       chunk_records: int = 256) -> None:
    """Materialize a dataset to disk in the prefetcher's record format.

    Layout: ``path/data.bin`` holds N contiguous packed records (each
    record = the concatenated raw bytes of every field's row — exactly
    what the C++ workers pread into batch slots), ``path/meta.json``
    holds shapes/dtypes.  Written in ``chunk_records`` blocks so an
    ImageNet-scale dataset never needs 2× memory.

    Reference frame: the on-disk stage the reference's
    ``examples/imagenet/train_imagenet.py`` [uv] read via Chainer dataset
    files + MultiprocessIterator; here the format is flat records because
    the consumer is ``pread``-ing C++ threads, not worker processes.
    """
    import json

    arrays = [np.ascontiguousarray(a) for a in arrays]
    n = len(arrays[0])
    if any(len(a) != n for a in arrays):
        raise ValueError("all field arrays must share the leading dim")
    os.makedirs(path, exist_ok=True)
    meta = {
        "version": 1,
        "n_records": int(n),
        "fields": [{"shape": list(a.shape[1:]), "dtype": str(a.dtype)}
                   for a in arrays],
    }
    meta["record_bytes"] = int(sum(
        int(np.prod(f["shape"], dtype=np.int64))
        * np.dtype(f["dtype"]).itemsize for f in meta["fields"]))
    with open(os.path.join(path, _DATA_NAME), "wb") as f:
        for start in range(0, n, chunk_records):
            stop = min(start + chunk_records, n)
            rows = [a[start:stop].reshape(stop - start, -1).view(np.uint8)
                    for a in arrays]
            block = rows[0] if len(rows) == 1 else np.concatenate(rows, axis=1)
            f.write(np.ascontiguousarray(block).tobytes())
    tmp = os.path.join(path, f".{_META_NAME}.tmp{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(path, _META_NAME))  # meta last = commit


class FileDataset:
    """A dataset materialized by :func:`write_file_dataset`.

    Random access (``len`` / ``[i]`` → tuple of field rows) goes through a
    lazy ``np.memmap``; the fast path is handing the WHOLE object to
    :class:`PrefetchIterator`, whose C++ workers then ``pread`` batches
    straight from the file without Python or the memmap in the loop.
    """

    def __init__(self, path: str):
        import json

        self.path = path
        self.data_path = os.path.join(path, _DATA_NAME)
        with open(os.path.join(path, _META_NAME)) as f:
            meta = json.load(f)
        if meta.get("version") != 1:
            raise ValueError(f"unsupported dataset version {meta.get('version')}")
        self.n_records = int(meta["n_records"])
        self.record_bytes = int(meta["record_bytes"])
        self.shapes = [tuple(f["shape"]) for f in meta["fields"]]
        self.dtypes = [np.dtype(f["dtype"]) for f in meta["fields"]]
        expect = self.n_records * self.record_bytes
        actual = os.path.getsize(self.data_path)
        if actual != expect:
            raise ValueError(
                f"{self.data_path}: size {actual} != n_records×record_bytes "
                f"{expect} — truncated or foreign file")
        self._mm = None

    @property
    def packed(self) -> np.ndarray:
        if self._mm is None:
            self._mm = np.memmap(self.data_path, dtype=np.uint8, mode="r",
                                 shape=(self.n_records, self.record_bytes))
        return self._mm

    def unpack(self, raw: np.ndarray):
        out, off = [], 0
        for shape, dtype in zip(self.shapes, self.dtypes):
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            fld = raw[:, off:off + nbytes].view(dtype).reshape(
                (len(raw),) + tuple(shape))
            out.append(fld)
            off += nbytes
        return tuple(out) if len(out) > 1 else out[0]

    def __len__(self) -> int:
        return self.n_records

    def __getitem__(self, i: int):
        row = self.unpack(np.asarray(self.packed[i:i + 1]))
        return (tuple(f[0] for f in row) if isinstance(row, tuple)
                else row[0])


class PrefetchIterator:
    """The JAX package's ``SerialIterator`` contract with
    native prefetch: batches are (tuples of) stacked numpy arrays.

    ``dataset``: one array ``(N, …)`` or a tuple of arrays (e.g. images,
    labels).  The batch contract matches SerialIterator exactly: with
    ``repeat=True`` every batch has ``batch_size`` rows (epoch-boundary
    batches pad from the next epoch's order, so a step never sees a
    shape change); with ``repeat=False`` the final batch may be short.
    Epoch-interior batches are assembled by the C++ workers; boundary
    batches are gathered in Python.  Exposes the same epoch/position/
    reset/state_dict surface so the Trainer, multi-node iterator wrappers
    and checkpointer compose unchanged.
    """

    def __init__(self, dataset, batch_size: int, repeat: bool = True,
                 shuffle: bool = True, seed: Optional[int] = None,
                 n_threads: int = 8, n_slots: int = 16,
                 copy: bool = False, use_native: Optional[bool] = None):
        file_backed = isinstance(dataset, FileDataset)
        if file_backed:
            # FileDataset quacks like _Fields (n_records/record_bytes/
            # packed/unpack); the native handle preads from its data file.
            self._fields = dataset
        else:
            arrays = (dataset if isinstance(dataset, (tuple, list))
                      else (dataset,))
            self._fields = _Fields([np.asarray(a) for a in arrays])
        self._copy = copy
        self._held = False  # consumer currently holds a slot (deferred release)
        self.batch_size = int(batch_size)
        self.repeat = repeat
        self.shuffle = shuffle
        self._seed = seed
        self._rng = np.random.RandomState(seed)
        self.epoch = 0
        self.current_position = 0
        self.is_new_epoch = False
        self._order = self._new_order()

        lib = _build_library() if use_native in (None, True) else None
        if use_native is True and lib is None:
            raise RuntimeError(f"native prefetcher unavailable: {_LIB_ERR}")
        self._lib = lib
        self._handle = None
        if lib is not None:
            if file_backed:
                self._handle = lib.pfl_create_file(
                    dataset.data_path.encode(), 0,
                    self._fields.record_bytes, self._fields.n_records,
                    self.batch_size, int(n_slots), int(n_threads))
            else:
                self._handle = lib.pfl_create(
                    self._fields.packed.ctypes.data,
                    self._fields.record_bytes, self._fields.n_records,
                    self.batch_size, int(n_slots), int(n_threads))
            if self._handle:
                self._push_stream()

    # -- ordering ---------------------------------------------------------
    def _new_order(self) -> np.ndarray:
        n = self._fields.n_records
        return (self._rng.permutation(n) if self.shuffle
                else np.arange(n)).astype(np.int64)

    def _push_stream(self):
        """Hand the C++ side the full batches from the current position."""
        self._release_held()
        rest = np.ascontiguousarray(self._order[self.current_position:])
        rc = self._lib.pfl_set_order(
            self._handle,
            rest.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(rest))
        if rc != 0:
            raise RuntimeError("pfl_set_order called with batches in flight")
        self._stream = rest  # keep alive: C++ copies, but be defensive

    # -- iteration --------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        n = self._fields.n_records
        if not self.repeat and self.epoch > 0 and self.current_position == 0:
            self._release_held()
            raise StopIteration
        i = self.current_position
        stop = min(i + self.batch_size, n)
        native_ok = self._handle is not None and stop - i == self.batch_size

        if native_ok:
            batch = self._next_native()
            idx = None
        else:
            idx = list(self._order[i:stop])

        # Position/epoch accounting — identical to SerialIterator,
        # including cross-epoch padding of the boundary batch.
        if stop >= n:
            self.epoch += 1
            self.is_new_epoch = True
            self.current_position = 0
            self._order = self._new_order()
            if self.repeat and idx is not None:
                while len(idx) < self.batch_size:
                    take = min(self.batch_size - len(idx), n)
                    idx.extend(self._order[:take])
                    self.current_position = take % n
                    if take == n:
                        self.epoch += 1
                        self._order = self._new_order()
        else:
            self.is_new_epoch = False
            self.current_position = stop

        if idx is not None:
            sel = np.asarray(idx, np.int64)
            batch = self._fields.unpack(
                np.ascontiguousarray(self._fields.packed[sel]))

        if self.is_new_epoch and self._handle and self.repeat:
            # The new stream may recycle the slot backing `batch` —
            # detach it before handing the ring back to the workers.
            if self._held and not self._copy:
                batch = (tuple(np.array(f) for f in batch)
                         if isinstance(batch, tuple) else np.array(batch))
            self._push_stream()
        return batch

    next = __next__

    def reset(self) -> None:
        self._rng = np.random.RandomState(self._seed)
        self.epoch = 0
        self.current_position = 0
        self.is_new_epoch = False
        self._order = self._new_order()
        if self._handle:
            self._drain()
            self._push_stream()

    def _release_held(self):
        if self._held:
            self._lib.pfl_release(self._handle)
            self._held = False

    def _next_native(self):
        # Deferred release: the PREVIOUS batch's slot goes back to the
        # workers now, so by default the yielded arrays are views valid
        # until the next ``next()`` (the training loop copies them to the
        # card immediately; pass copy=True to detach instead).  This keeps the
        # visible per-batch cost at ~zero — assembly happened in C++
        # threads while the previous step computed.
        self._release_held()
        out = ctypes.c_void_p()
        b = self._lib.pfl_acquire(self._handle, ctypes.byref(out))
        if b == -3:
            raise RuntimeError(
                "prefetcher disk read failed (file truncated/removed or "
                "I/O error mid-stream); the stream is poisoned — recreate "
                "the iterator after fixing the data file")
        if b < 0:
            raise RuntimeError(f"prefetcher stream desync (code {b})")
        self._held = True
        raw = np.ctypeslib.as_array(
            ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)),
            shape=(self.batch_size, self._fields.record_bytes))
        batch = self._fields.unpack(raw)
        if self._copy:
            batch = (tuple(np.array(f) for f in batch)
                     if isinstance(batch, tuple) else np.array(batch))
        return batch

    @property
    def epoch_detail(self) -> float:
        return self.epoch + self.current_position / max(
            self._fields.n_records, 1)

    # -- resume (same contract as SerialIterator) -------------------------
    def state_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "current_position": self.current_position,
            "is_new_epoch": self.is_new_epoch,
            "order": np.asarray(self._order),
            "rng_state": self._rng.get_state(),
        }

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self.current_position = int(state["current_position"])
        self.is_new_epoch = bool(state["is_new_epoch"])
        self._order = np.asarray(state["order"], np.int64)
        self._rng.set_state(state["rng_state"])
        if self._handle:
            # Drain whatever the workers had queued, then restart the
            # stream from the restored position.
            self._drain()
            self._push_stream()

    def _drain(self):
        """Abandon the in-flight stream in O(1) (pfl_cancel), not O(stream)."""
        self._release_held()
        rc = self._lib.pfl_cancel(self._handle)
        if rc != 0:
            raise RuntimeError("pfl_cancel with a slot still held")

    def close(self):
        if getattr(self, "_handle", None):
            self._release_held()
            self._lib.pfl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


__all__ = ["FileDataset", "PrefetchIterator", "native_available",
           "write_file_dataset"]

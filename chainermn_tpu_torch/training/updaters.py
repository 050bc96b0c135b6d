"""Updaters: advance training by one iteration.

Counterpart of ``chainermn_tpu/training/updaters.py`` (Chainer's
``StandardUpdater``): the updater pulls a batch, converts it, puts this
rank's rows on the device and calls the step.  ``shard=True`` takes the
GLOBAL batch every process draws from the same iterator and gives rank
``r`` rows ``[r·B/P, (r+1)·B/P)`` (the port's ``shard_batch``), so every
process follows JAX's single-controller trajectory; ``shard=False`` puts
the whole batch (this process's own rows) on the device.

``prefetch=True`` assembles batch ``k+1`` on a background thread while
step ``k`` runs: the thread pulls, converts and stages the rows in host
memory (pinned on the card); the copy to the card is issued on the main
thread, on the step's stream, when the step takes the batch, so no copy
in flight races a buffer the thread reuses.
"""

from __future__ import annotations

import copy
import queue
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..observability import trace as _trace
from ..observability.comm import get_accountant as _get_accountant
from ..topology import DEFAULT_AXIS_NAME, make_mesh
from ..train import local_rows


class _Prefetcher:
    """One-deep background input pipeline: while step *k* runs, a daemon
    thread assembles batch *k+1* (iterator pull + convert + host staging).

    Exact-resume contract: each queued item carries the iterator
    ``state_dict`` captured right AFTER its batch was pulled, i.e. the
    state a resumed run needs so its next pull yields the FOLLOWING
    batch.  The updater checkpoints that per-item state, not the live
    iterator's (which runs up to two batches ahead).

    Errors raised while assembling re-raise in ``update()`` on the main
    thread, and stay latched there.
    """

    def __init__(self, iterator, converter, stage):
        self.iterator = iterator
        self.converter = converter
        self.stage = stage
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="chainermn-tpu-torch-input-prefetch")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                batch = self.iterator.next()
                meta = {
                    "iterator_state": (self.iterator.state_dict()
                                       if hasattr(self.iterator,
                                                  "state_dict") else None),
                    "epoch": getattr(self.iterator, "epoch", 0),
                    "is_new_epoch": getattr(self.iterator, "is_new_epoch",
                                            False),
                    "epoch_detail": getattr(self.iterator, "epoch_detail",
                                            None),
                }
                item = ("batch", self.stage(self.converter(batch)), meta)
            except BaseException as e:  # noqa: BLE001 — re-raised in update()
                item = ("error", e, None)
            # bounded put that stays responsive to close()
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if item[0] == "error":
                return

    def get(self):
        # latched: the worker exits after enqueueing one error, so a caller
        # that swallowed the first raise must get it again, not block
        if self._error is not None:
            raise self._error
        kind, payload, meta = self._q.get()
        if kind == "error":
            self._error = payload
            self.close()
            raise payload
        return payload, meta

    def close(self) -> None:
        self._stop.set()
        try:                     # unblock a put-blocked thread
            self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                print("[chainermn_tpu_torch prefetch] WARNING: prefetch "
                      "worker still blocked in iterator.next() after "
                      "close(); its in-flight pull may race a restored "
                      "iterator cursor", file=sys.stderr, flush=True)


def default_converter(batch):
    """List of (x, y, ...) tuples → tuple of stacked arrays."""
    if isinstance(batch[0], tuple):
        n = len(batch[0])
        return tuple(np.stack([b[i] for b in batch]) for i in range(n))
    return np.stack(batch)


def _snapshot(x):
    """A detached copy of updater state: ``state_dict()`` of modules and
    optimizers, clones of tensors, containers rebuilt."""
    if callable(getattr(x, "state_dict", None)):
        return copy.deepcopy(x.state_dict())
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _snapshot(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_snapshot(v) for v in x)
    return copy.deepcopy(x)


def _restore(template, value):
    """Load ``value`` into ``template`` in place where it is a module,
    optimizer or tensor (keeping its device); other leaves are replaced."""
    if callable(getattr(template, "load_state_dict", None)):
        template.load_state_dict(value)
        return template
    if isinstance(template, torch.Tensor):
        with torch.no_grad():
            template.copy_(torch.as_tensor(value))
        return template
    if isinstance(template, dict):
        return {k: _restore(template[k], v) for k, v in value.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_restore(t, v)
                              for t, v in zip(template, value))
    return value


class StandardUpdater:
    """Owns the train state and the iterator; one ``update()`` = one step.

    ``step_fn(state, batch) -> (state, observation_dict)``, ``batch`` the
    converted arrays as tensors on ``device`` (the card by default).
    ``state`` is whatever the step carries (modules, optimizers, tensor
    dicts); ``state_dict`` snapshots it and ``load_state_dict`` restores
    it in place.  Observation values may be device scalars; they are not
    synced here (extensions decide when to read them).
    """

    def __init__(self, iterator, step_fn: Callable, state: Any,
                 converter: Callable = default_converter,
                 mesh=None, axis_name: Optional[str] = None,
                 shard: bool = True, prefetch: bool = False,
                 device="cuda"):
        self.iterator = iterator
        self.step_fn = step_fn
        self.state = state
        self.converter = converter
        self.shard = shard
        self.device = resolve_device(device)
        self.iteration = 0
        self.phase_times: Optional[Dict[str, float]] = None
        self.last_batch_size: Optional[int] = None
        self.mesh = (mesh if mesh is not None or not shard
                     else make_mesh(axis_name or DEFAULT_AXIS_NAME))
        self.prefetch = bool(prefetch)
        self._prefetcher: Optional[_Prefetcher] = None
        self._consumed_meta: Optional[Dict[str, Any]] = None

    def _stage(self, arrays):
        """Host side (the prefetch thread's share): this rank's rows as
        CPU tensors, pinned when they go to the card."""
        single = not isinstance(arrays, tuple)
        parts = (arrays,) if single else arrays
        if self.shard:
            parts = local_rows(parts, self.mesh)
        pin = self.device.type == "cuda"
        host = tuple(torch.as_tensor(np.asarray(p)) for p in parts)
        if pin:
            host = tuple(t.pin_memory() for t in host)
        return host[0] if single else host

    def _upload(self, staged):
        """Main thread: the staged tensors onto the device, on the current
        stream (non-blocking from pinned memory)."""
        if isinstance(staged, tuple):
            return tuple(t.to(self.device, non_blocking=True)
                         for t in staged)
        return staged.to(self.device, non_blocking=True)

    @property
    def epoch(self) -> int:
        if self._consumed_meta is not None:
            return self._consumed_meta["epoch"]
        return getattr(self.iterator, "epoch", 0)

    @property
    def is_new_epoch(self) -> bool:
        if self._consumed_meta is not None:
            return self._consumed_meta["is_new_epoch"]
        return getattr(self.iterator, "is_new_epoch", False)

    @property
    def epoch_detail(self) -> float:
        if self._consumed_meta is not None \
                and self._consumed_meta["epoch_detail"] is not None:
            return self._consumed_meta["epoch_detail"]
        return getattr(self.iterator, "epoch_detail", float(self.epoch))

    def close(self) -> None:
        """Stop the prefetch thread (no-op without ``prefetch=True``)."""
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None

    def update(self) -> Dict[str, Any]:
        # the data phase (batch assembly + upload) vs the compute phase (the
        # step call: asynchronous on the card, so its device tail surfaces
        # at the next host sync); both land on the trace timeline, and the
        # comm ledger's step capture attributes the step's collectives to
        # this iteration
        tracer = _trace.get_tracer()
        t0 = time.perf_counter()
        with tracer.span("step/data", cat="phase"):
            if self.prefetch:
                if self._prefetcher is None:
                    self._prefetcher = _Prefetcher(
                        self.iterator, self.converter, self._stage)
                staged, self._consumed_meta = self._prefetcher.get()
            else:
                staged = self._stage(self.converter(self.iterator.next()))
            arrays = self._upload(staged)
        t1 = time.perf_counter()
        with _get_accountant().step("updater/step_fn"):
            with tracer.span("step/compute", cat="phase"):
                self.state, observation = self.step_fn(self.state, arrays)
        t2 = time.perf_counter()
        self.phase_times = {"data": t1 - t0, "compute": t2 - t1}
        first = arrays[0] if isinstance(arrays, tuple) else arrays
        if first.dim():
            self.last_batch_size = int(first.shape[0])
        self.iteration += 1
        return dict(observation)

    # ---- resume contract ----
    def state_dict(self) -> dict:
        out = {"iteration": self.iteration, "state": _snapshot(self.state)}
        if self.prefetch and self._consumed_meta is not None:
            # the CONSUMED batch's iterator snapshot, not the live
            # iterator's (which has prefetched ahead)
            if self._consumed_meta["iterator_state"] is not None:
                out["iterator"] = self._consumed_meta["iterator_state"]
        elif hasattr(self.iterator, "state_dict"):
            out["iterator"] = self.iterator.state_dict()
        return out

    def load_state_dict(self, state: dict) -> None:
        self.iteration = int(state["iteration"])
        self.state = _restore(self.state, state["state"])
        # a running prefetcher holds batches pulled under the OLD cursor
        self.close()
        self._consumed_meta = None
        if "iterator" in state and hasattr(self.iterator, "load_state_dict"):
            self.iterator.load_state_dict(state["iterator"])

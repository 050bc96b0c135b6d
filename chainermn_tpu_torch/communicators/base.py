"""The communicator interface.

Counterpart of ``chainermn_tpu/communicators/base.py :: CommunicatorBase``
(reference: ``chainermn/communicators/communicator_base.py``): the rank
properties, the array collectives ``allreduce`` / ``bcast`` / ``gather`` /
``allgather`` / ``alltoall`` / ``scatter`` / ``send`` / ``recv``, the
object transport ``bcast_obj`` / ``gather_obj`` / ``allgather_obj`` /
``allreduce_obj`` / ``send_obj`` / ``recv_obj``, ``split``, ``device_of``,
``owns_rank``, ``stack`` / ``unstack`` and the model helpers
``broadcast_data`` / ``multi_node_mean_grad`` (older name
``allreduce_grad``).

Two data faces, as in ChainerMN and the JAX package:

* :class:`~.torch_dist.TorchDistCommunicator` is multi-process SPMD, one
  process per rank (ChainerMN's own face): every rank passes its own
  tensor and gets its own result;
* :class:`~.naive.NaiveCommunicator` is the one-process numpy oracle over
  rank-major stacks ``(size, *s)``, slab ``r`` being rank ``r``'s value,
  exactly as the JAX package's naive communicator.

The hardened object lanes come with them: :class:`DcnLaneError`,
:class:`LaneConfig` (the same ``CHAINERMN_TPU_LANE_*`` environment
overrides), :func:`classify_lane_error`, the fault injector and
:func:`lane_call`, and on the communicator the bounded best-effort
``allgather_obj_eventual``, the tag-addressed ``kv_lane_transport`` and
the health plane's ``gang_lease_store``.  The JAX package runs the lanes
over the jax.distributed KV store; the process-group communicator here
runs them over the ``torch.distributed`` store of its process group.

Every backend's eager collectives (JAX's ``_ACCOUNTED_OPS``) are wrapped
by ``__init_subclass__`` with the collective guard of
:mod:`chainermn_tpu_torch.health` (outermost call only).  The JAX package
also books them in its comm ledger; that ledger is ROADMAP.md's A12.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# Hardened lanes: retry / timeout / backoff with a failure classification
# every rank makes the same way, for the object side channels.  A transient
# fault (a store blip, a reset connection) backs off and retries; a
# permanent one dies loudly with the lane named in the flight ring and in
# the error, never a silent hang.
# ---------------------------------------------------------------------------

class DcnLaneError(RuntimeError):
    """Permanent (or retries-exhausted) failure of a named lane.

    Caught nowhere in the package: it propagates to the global except
    hook, which dumps a flight bundle (the ring's ``dcn_lane_fault`` event
    names the lane) and aborts the gang.
    """

    def __init__(self, lane: str, attempts: int, cause: BaseException):
        self.lane = lane
        self.attempts = attempts
        self.cause = cause
        super().__init__(
            f"DCN lane '{lane}' failed after {attempts} attempt(s): "
            f"{type(cause).__name__}: {cause}")


class LaneConfig:
    """Retry policy for one process's lanes.

    Every field reads an environment override, so a launcher tunes the
    whole gang uniformly (a gang whose ranks classified or retried
    differently could leave half of it retrying while the other half
    dies):

    * ``CHAINERMN_TPU_LANE_RETRIES``       (default 4 transient retries)
    * ``CHAINERMN_TPU_LANE_BACKOFF_S``     (base, default 0.05; doubles
      per retry up to ``CHAINERMN_TPU_LANE_BACKOFF_MAX_S``, default 2.0)
    * ``CHAINERMN_TPU_LANE_TIMEOUT_MS``    (blocking get, default 300000)
    """

    def __init__(self,
                 max_retries: Optional[int] = None,
                 backoff_base_s: Optional[float] = None,
                 backoff_max_s: Optional[float] = None,
                 timeout_ms: Optional[int] = None):
        env = os.environ.get
        self.max_retries = int(
            env("CHAINERMN_TPU_LANE_RETRIES", 4)
            if max_retries is None else max_retries)
        self.backoff_base_s = float(
            env("CHAINERMN_TPU_LANE_BACKOFF_S", 0.05)
            if backoff_base_s is None else backoff_base_s)
        self.backoff_max_s = float(
            env("CHAINERMN_TPU_LANE_BACKOFF_MAX_S", 2.0)
            if backoff_max_s is None else backoff_max_s)
        self.timeout_ms = int(
            env("CHAINERMN_TPU_LANE_TIMEOUT_MS", 300_000)
            if timeout_ms is None else timeout_ms)


#: Message fingerprints of TRANSIENT faults.  Classification keys on the
#: error's text, not its type, so every rank seeing the same fault makes
#: the same retry-or-die call; anything else is permanent (retrying an
#: unknown error could desynchronise the lanes across the gang).
TRANSIENT_LANE_PATTERNS = (
    "deadline exceeded",
    "deadline_exceeded",
    "unavailable",
    "connection reset",
    "connection refused",
    "timed out",
    "injected transient",        # the chaos harness's marker
)


def classify_lane_error(e: BaseException) -> str:
    """``"transient"`` or ``"permanent"``: total and deterministic."""
    msg = str(e).lower()
    if any(p in msg for p in TRANSIENT_LANE_PATTERNS):
        return "transient"
    return "permanent"


#: Fault injection for tests and chaos drills: ``fn(lane, attempt)``
#: raising to simulate a fault, or None.  ``CHAINERMN_TPU_LANE_FAULT=
#: <lane_pattern>:<transient|permanent>:<count>[:after=N]`` arms an
#: environment-driven injector for subprocess gangs.  ``lane_pattern`` is
#: a substring, or an ``fnmatch`` glob over the whole lane name when it
#: holds ``*``, ``?`` or ``[``; ``after=N`` lets the first N matching calls
#: pass before the fault budget starts burning.
_FAULT_INJECTOR: Optional[Callable[[str, int], None]] = None
_ENV_FAULT: Optional[Dict[str, Any]] = None


def set_lane_fault_injector(fn: Optional[Callable[[str, int], None]]) -> None:
    global _FAULT_INJECTOR
    _FAULT_INJECTOR = fn


def _lane_matches(pattern: str, lane: str) -> bool:
    """A substring match, or an fnmatch glob over the whole lane name when
    the pattern holds glob characters."""
    if any(c in pattern for c in "*?["):
        import fnmatch
        return fnmatch.fnmatchcase(lane, pattern)
    return pattern in lane


def _env_fault_state() -> Optional[Dict[str, Any]]:
    global _ENV_FAULT
    spec = os.environ.get("CHAINERMN_TPU_LANE_FAULT")
    if not spec:
        return None
    if _ENV_FAULT is None or _ENV_FAULT.get("spec") != spec:
        body, skip = spec, 0
        if ":after=" in spec:
            body, after = spec.rsplit(":after=", 1)
            skip = int(after)
        lane_pattern, kind, count = body.rsplit(":", 2)
        if kind not in ("transient", "permanent"):
            raise ValueError(
                f"CHAINERMN_TPU_LANE_FAULT kind must be transient|"
                f"permanent, got {kind!r} in {spec!r}")
        _ENV_FAULT = {"spec": spec, "lane": lane_pattern, "kind": kind,
                      "remaining": int(count), "skip": skip}
    return _ENV_FAULT


def _maybe_inject_fault(lane: str, attempt: int) -> None:
    if _FAULT_INJECTOR is not None:
        _FAULT_INJECTOR(lane, attempt)
    st = _env_fault_state()
    if st and st["remaining"] > 0 and _lane_matches(st["lane"], lane):
        if st.get("skip", 0) > 0:
            st["skip"] -= 1   # fire-after-N: this matching call passes
            return
        st["remaining"] -= 1
        if st["kind"] == "transient":
            raise RuntimeError(
                f"injected transient lane fault on '{lane}' (chaos)")
        raise RuntimeError(
            f"injected permanent lane fault on '{lane}' (chaos)")


def lane_call(lane: str, fn: Callable[[], Any],
              config: Optional[LaneConfig] = None) -> Any:
    """Run one lane operation under the hardened retry discipline.

    Transient faults (:func:`classify_lane_error`) retry with exponential
    backoff up to ``config.max_retries`` times, each retry noted in the
    flight ring (``dcn_lane_retry``); a permanent fault or exhausted
    retries raises :class:`DcnLaneError` after noting ``dcn_lane_fault``,
    so the crash bundle always names the lane.

    Retries are also bounded by the total elapsed time
    (``config.timeout_ms``): a blocking get that already waited the whole
    window gave the peer its budget, and re-waiting it ``max_retries``
    more times would multiply the dead-peer detection time, so a
    timeout-classified fault past the budget dies loudly instead.
    Fast-failing transients (a refused or reset connection) are not
    affected.
    """
    cfg = config or LaneConfig()
    from ..observability import flight as _flight

    attempt = 0
    t_start = time.monotonic()
    while True:
        try:
            _maybe_inject_fault(lane, attempt)
            return fn()
        except DcnLaneError:
            raise
        except Exception as e:  # noqa: BLE001 — classified below
            kind = classify_lane_error(e)
            attempt += 1
            budget_spent = (time.monotonic() - t_start
                            >= cfg.timeout_ms / 1000.0)
            if kind == "permanent" or attempt > cfg.max_retries \
                    or budget_spent:
                _flight.note("dcn_lane_fault", lane=lane, attempts=attempt,
                             classification=kind, error=repr(e))
                import sys as _sys
                print(f"[chainermn_tpu_torch lanes] DCN lane '{lane}' "
                      f"{'permanent fault' if kind == 'permanent' else 'transient fault persisted'}"
                      f" after {attempt} attempt(s): {e!r}",
                      file=_sys.stderr, flush=True)
                raise DcnLaneError(lane, attempt, e) from e
            delay = min(cfg.backoff_base_s * (2 ** (attempt - 1)),
                        cfg.backoff_max_s)
            _flight.note("dcn_lane_retry", lane=lane, attempt=attempt,
                         backoff_s=round(delay, 4), error=repr(e))
            time.sleep(delay)


#: The eager collectives every backend's class gets the collective guard
#: on (JAX's accounted ops).  Object transport is absent: it is a setup
#: path.
_ACCOUNTED_OPS = (
    "allreduce", "bcast", "gather", "allgather", "alltoall", "scatter",
    "send", "recv", "broadcast_data", "multi_node_mean_grad",
)


def _process_index() -> int:
    """This process's rank in the default process group (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


class CommunicatorBase:
    """API contract shared by the port's communicator backends."""

    def __init_subclass__(cls, **kwargs):
        # every backend gets the collective guard on its eager collectives
        # without per-backend code; with no guard installed the wrapper
        # costs one module-global read per call
        super().__init_subclass__(**kwargs)
        from ..health import guarded
        for name in _ACCOUNTED_OPS:
            fn = cls.__dict__.get(name)
            if callable(fn) and not getattr(fn, "_guard_wrapped", False):
                setattr(cls, name, guarded(name)(fn))

    @property
    def rank(self) -> int:
        raise NotImplementedError

    @property
    def size(self) -> int:
        raise NotImplementedError

    @property
    def intra_rank(self) -> int:
        raise NotImplementedError

    @property
    def intra_size(self) -> int:
        raise NotImplementedError

    @property
    def inter_rank(self) -> int:
        raise NotImplementedError

    @property
    def inter_size(self) -> int:
        raise NotImplementedError

    # ---- array collectives ----
    def allreduce(self, x, op: str = "sum"):
        raise NotImplementedError

    def bcast(self, x, root: int = 0):
        raise NotImplementedError

    def gather(self, x, root: int = 0):
        raise NotImplementedError

    def allgather(self, x):
        raise NotImplementedError

    def alltoall(self, x):
        raise NotImplementedError

    def scatter(self, x, root: int = 0):
        raise NotImplementedError

    def send(self, x, dest: int, source: int):
        """Move rank ``source``'s value to rank ``dest`` (one-shot p2p)."""
        raise NotImplementedError

    def recv(self, x, source: int, dest: int):
        return self.send(x, dest=dest, source=source)

    # ---- object (pickle) transport: the setup path, never hot ----
    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        raise NotImplementedError

    def gather_obj(self, obj: Any, root: int = 0) -> Optional[List[Any]]:
        raise NotImplementedError

    def allgather_obj(self, obj: Any) -> List[Any]:
        raise NotImplementedError

    @property
    def process_index(self) -> int:
        """This process's index among the processes the communicator spans
        (JAX's ``jax.process_index()``): the checkpointer's shard owner."""
        return _process_index()

    @property
    def process_count(self) -> int:
        """How many processes the communicator spans (JAX's
        ``jax.process_count()``)."""
        import torch.distributed as dist

        return dist.get_world_size() if dist.is_initialized() else 1

    def allgather_obj_eventual(self, tag: str, obj: Any,
                               timeout_s: float = 10.0,
                               discard_tag: Optional[str] = None
                               ) -> Dict[int, Any]:
        """Bounded best-effort per-PROCESS gather, deliberately not a gang
        collective.  Each calling process publishes ``obj`` under a
        caller-unique ``tag`` (holding every identity the exchange is
        scoped by: name, iteration, world size) and collects whatever its
        peers published within ``timeout_s`` in total (shared across the
        peers, so a dead gang costs the budget once, not n-1 times);
        ``timeout_s <= 0`` publishes without reading any peer.  A peer
        that never calls (crashed, preempted or skipping this generation)
        is absent from the returned ``{process: obj}`` dict instead of
        wedging the gang, so any subset of processes may call, in any
        order: the checkpoint manifest's checksum exchange rides this, so
        ``save()`` stays a local operation.  ``discard_tag`` removes this
        process's entry of an earlier exchange (best effort).  A
        one-process backend completes at once."""
        del tag, timeout_s, discard_tag
        return {_process_index(): obj}

    def kv_lane_transport(self):
        """Object-lane transport (``put(tag, bytes)`` / ``get(tag,
        timeout_s)`` / ``delete(tag)``) for payloads addressed by tag
        rather than gathered by gang.  Callers wrap each operation in
        :func:`lane_call`.  One-process backends loop back through an
        in-process store; the process-group communicator overrides this
        with its ``torch.distributed`` store.  An elastic fleet whose
        members die and join independently uses
        ``chainermn_tpu_torch.serving.lanes.FileLaneStore`` (the same face
        over a shared directory) instead."""
        store = getattr(self, "_kv_lane_store", None)
        if store is None:
            from ..serving.transfer import InProcessLaneStore
            store = self._kv_lane_store = InProcessLaneStore()
        return store

    def gang_lease_store(self):
        """The rank health plane's store: this communicator's lane
        transport adapted to the lease-store face (``SelfHealingGang``
        publishes heartbeat leases, consensus proposals and shard leases
        through it).  An absent tag surfaces as ``TimeoutError`` (the
        ``FileLaneStore`` contract), so a lease poll reads absence as
        absence, not as a retryable fault."""
        from ..health import KvLeaseStore
        return KvLeaseStore(self.kv_lane_transport())

    def allreduce_obj(self, obj: Any, op: Optional[Callable] = None) -> Any:
        """Every rank's ``obj`` folded by ``op`` (default ``a + b``) in
        rank order."""
        op = op or (lambda a, b: a + b)
        gathered = self.allgather_obj(obj)
        out = gathered[0]
        for o in gathered[1:]:
            out = op(out, o)
        return out

    def send_obj(self, obj: Any, dest: int) -> None:
        raise NotImplementedError

    def recv_obj(self, source: int) -> Any:
        raise NotImplementedError

    # ---- placement ----
    def device_of(self, rank: int):
        """The device that runs ``rank``, or None when the communicator has
        no device (the naive loopback)."""
        return None

    # ---- model helpers ----
    def broadcast_data(self, params):
        """Replicate parameters from rank 0 to every rank (reference:
        ``broadcast_data(model)``)."""
        raise NotImplementedError

    def multi_node_mean_grad(self, grads):
        """Mean gradients across ranks (reference: ``multi_node_mean_grad``)."""
        raise NotImplementedError

    def allreduce_grad(self, grads):
        return self.multi_node_mean_grad(grads)

    # ---- structure ----
    def split(self, color, key: int = 0):
        """Partition the ranks into sub-communicators (reference:
        ``mpi_comm.Split(color, key)``); see each backend for its face."""
        raise NotImplementedError

    def owns_rank(self, r: int) -> bool:
        """Whether this process runs rank ``r``'s host-side work."""
        return True

    def finalize(self) -> None:
        pass

    # ---- conveniences shared by all backends ----
    def stack(self, per_rank: Sequence[Any]):
        """A rank-major stack ``(size, *s)`` from one array per rank."""
        if len(per_rank) != self.size:
            raise ValueError(f"need {self.size} per-rank arrays, got "
                             f"{len(per_rank)}")
        return self._place(np.stack([_host(a) for a in per_rank]))

    def unstack(self, x) -> List[np.ndarray]:
        """A rank-major stack back into one numpy array per rank."""
        x = _host(x)
        return [x[r] for r in range(x.shape[0])]

    def _place(self, x):
        """Backend hook: a host array into the backend's native layout."""
        return x

    def _check_leading(self, x):
        if x.shape[0] != self.size:
            raise ValueError(f"rank-major stack must have leading dim "
                             f"{self.size}, got {tuple(x.shape)}")
        return x


def _host(x) -> np.ndarray:
    """A numpy array of ``x`` (a torch tensor anywhere, or array-like)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)

"""The process-group communicator: collectives over ``torch.distributed``.

Counterpart of ``chainermn_tpu/communicators/xla.py :: XlaCommunicator``
(reference: ``PureNcclCommunicator``): one process per rank, NCCL between
cards (gloo on the CPU), so every collective is a collective of the
process group, also at world size 1.  Each rank passes its own tensor and
gets its own result (ChainerMN's face; the JAX package's rank-major
stacks are its one-process stand-in for the same thing):

* ``allreduce`` / ``bcast`` / ``allgather``: this rank's reduced,
  broadcast or ``(size, *s)`` gathered tensor;
* ``gather(x, root)``: the ``(size, *s)`` stack on ``root``, ``None``
  elsewhere; ``scatter(x, root)``: root's ``(size, *s)`` tensor, slab ``r``
  to rank ``r`` (other ranks may pass ``None``);
* ``alltoall(x)``: ``x`` is ``(size, *s)``, slab ``s`` goes to rank ``s``;
  the result's slab ``s`` came from rank ``s``;
* ``send(x, dest, source)``: ``x`` of rank ``source`` on ``dest``; every
  other rank gets its own ``x`` back (JAX's ``x[dest] = x[source]`` read
  rank by rank).  Only ``source`` and ``dest`` touch the wire;
* the ``*_obj`` calls pickle through the group (gather: the list on
  ``root``, ``None`` elsewhere);
* ``split(color)``: a per-rank color sequence (the JAX face) or this
  rank's own scalar color (MPI's face; the colors are exchanged first)
  builds one process group per color, every process creating every group
  in the same order, and gives this rank the communicator of its own.

``root``, ``dest`` and ``source`` are ranks of this communicator's group.
Gradients cross the wire as one flat bucket
(:func:`chainermn_tpu_torch.optimizers.compressed_mean`).

The object lanes (``allgather_obj_eventual``, ``kv_lane_transport`` and
through it ``gang_lease_store``) run over the process group's
``torch.distributed`` store, where JAX runs them over the jax.distributed
KV store: a ``HashStore`` in a one-rank group, the ``FileStore`` or
``TCPStore`` a caller or ``env://`` gives.  A store raises its own error
on a missing key after blocking for its whole timeout, so every read
here polls ``check`` and never blocks in ``get``; absence becomes
``TimeoutError`` with the lanes' transient text.  Keys carry the group's
ranks, so sub-communicators' lanes never collide.
"""

from __future__ import annotations

import pickle
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..optimizers import compressed_mean
from ..topology import DEFAULT_AXIS_NAME, Topology, init_distributed, make_mesh
from .base import CommunicatorBase, LaneConfig, lane_call

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT}


class TorchDistCommunicator(CommunicatorBase):
    """Collectives of the default process group (created by
    :func:`~chainermn_tpu_torch.topology.init_distributed` if there is
    none), or of ``group``, on ``device``: this process's card by
    default."""

    def __init__(self, device="cuda", axis_name: str = DEFAULT_AXIS_NAME,
                 group=None):
        dev = resolve_device(device)
        init_distributed(dev)
        self.group = group
        self._topo = Topology.detect(group)
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if dev.type == "cuda" else dev)
        self.axis_name = axis_name
        self.mesh = make_mesh(axis_name, group)
        self._mailbox: List[bytes] = []   # send_obj / recv_obj to oneself
        self.lane_config = LaneConfig()
        self._lane_prefix = ("w" if group is None else "g" + "-".join(
            str(r) for r in dist.get_process_group_ranks(group)))

    @property
    def rank(self) -> int:
        return self._topo.rank

    @property
    def size(self) -> int:
        return self._topo.size

    @property
    def intra_rank(self) -> int:
        return self._topo.intra_rank

    @property
    def intra_size(self) -> int:
        return self._topo.intra_size

    @property
    def inter_rank(self) -> int:
        return self._topo.inter_rank

    @property
    def inter_size(self) -> int:
        return self._topo.inter_size

    def owns_rank(self, r: int) -> bool:
        return r == self.rank

    @property
    def process_index(self) -> int:
        return self.rank

    @property
    def process_count(self) -> int:
        return self.size

    def _global(self, r: int) -> int:
        """Rank ``r`` of this communicator's group as a world rank."""
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def device_of(self, rank: int):
        """The card of ``rank`` (the ``intra_rank``-th card of its host),
        or the CPU."""
        if self.device.type != "cuda":
            return self.device
        if rank == self.rank:
            return self.device
        per_host = Topology.detect().intra_size
        return torch.device("cuda", self._global(rank) % per_host)

    def _place(self, x):
        return torch.as_tensor(x, device=self.device)

    def _tensor(self, x):
        return torch.as_tensor(x, device=self.device).clone()

    # ---- array collectives ----
    def allreduce(self, x, op: str = "sum"):
        """This rank's tensor reduced over every rank (``"mean"`` is the
        sum over the size, as ``pmean`` is)."""
        out = self._tensor(x)
        dist.all_reduce(out, op=_OPS["sum" if op == "mean" else op],
                        group=self.group)
        return out / self.size if op == "mean" else out

    def bcast(self, x, root: int = 0):
        out = self._tensor(x)
        dist.broadcast(out, src=self._global(root), group=self.group)
        return out

    def gather(self, x, root: int = 0):
        """``(size, *s)`` on ``root`` (rank-major), ``None`` elsewhere."""
        x = self._tensor(x)
        if self.rank != root:
            dist.gather(x, None, dst=self._global(root), group=self.group)
            return None
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.gather(x, parts, dst=self._global(root), group=self.group)
        return torch.stack(parts)

    def allgather(self, x):
        """``(size, *s)``: every rank's tensor, rank-major."""
        x = self._tensor(x)
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.stack(parts)

    def alltoall(self, x):
        """``x`` is ``(size, *s)``: slab ``s`` goes to rank ``s``, and slab
        ``s`` of the result came from rank ``s``."""
        x = self._check_leading(self._tensor(x)).contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def scatter(self, x, root: int = 0):
        """Slab ``r`` of root's ``(size, *s)`` tensor on rank ``r``; the
        other ranks' ``x`` is not read (it may be ``None``)."""
        if self.rank == root:
            x = self._check_leading(self._tensor(x))
            meta = (tuple(x.shape[1:]), x.dtype)
        else:
            meta = None
        shape, dtype = self.bcast_obj(meta, root=root)
        out = torch.empty(shape, dtype=dtype, device=self.device)
        parts = ([t.contiguous() for t in x.unbind(0)]
                 if self.rank == root else None)
        dist.scatter(out, parts, src=self._global(root), group=self.group)
        return out

    def send(self, x, dest: int, source: int):
        """Every rank calls it: ``dest`` gets ``source``'s ``x``, every
        other rank its own ``x``."""
        x = self._tensor(x)
        if source == dest:
            return x
        if self.rank == source:
            dist.send(x.contiguous(), dst=self._global(dest), group=self.group)
        elif self.rank == dest:
            dist.recv(x, src=self._global(source), group=self.group)
        return x

    # ---- object transport ----
    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        box = [obj]
        dist.broadcast_object_list(box, src=self._global(root),
                                   group=self.group)
        return box[0]

    def gather_obj(self, obj: Any, root: int = 0) -> Optional[List[Any]]:
        """Every rank's ``obj`` in rank order on ``root``, ``None``
        elsewhere."""
        out = [None] * self.size if self.rank == root else None
        dist.gather_object(obj, out, dst=self._global(root), group=self.group)
        return out

    def allgather_obj(self, obj: Any) -> List[Any]:
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    # ---- the object lanes over the process group's store ----
    def _store(self):
        from torch.distributed import distributed_c10d

        return distributed_c10d._get_default_store()

    def allgather_obj_eventual(self, tag: str, obj: Any,
                               timeout_s: float = 10.0,
                               discard_tag: Optional[str] = None
                               ) -> Dict[int, Any]:
        """Bounded best-effort gather over the store (the base contract).

        Keys are unique per (tag, process), so any subset of processes
        may call in any order.  The publish rides ``lane_call`` (``set``
        overwrites, so a retried or repeated publish of a tag is legal);
        ``timeout_s`` is the total read budget shared by all peers,
        spent in round-robin short polls so that an absent low rank costs
        one slice a round, not the whole budget; ``timeout_s <= 0``
        publishes only."""
        me = self.rank
        if self.size <= 1:
            return {me: obj}
        store = self._store()
        base = f"chainermn_tpu_evt/{self._lane_prefix}"
        payload = pickle.dumps(obj)
        lane_call(f"store/evt_set/{tag}",
                  lambda: store.set(f"{base}/{tag}/{me}", payload),
                  self.lane_config)
        if discard_tag is not None and discard_tag != tag:
            try:
                store.delete_key(f"{base}/{discard_tag}/{me}")
            except Exception:
                pass  # best effort
        out = {me: obj}
        if timeout_s <= 0:
            return out
        deadline = time.monotonic() + timeout_s
        poll_s = max(0.005, min(0.05, timeout_s / 64))
        pending = [p for p in range(self.size) if p != me]
        while pending:
            for p in list(pending):
                key = f"{base}/{tag}/{p}"
                try:
                    if store.check([key]):
                        out[p] = pickle.loads(store.get(key))
                        pending.remove(p)
                except Exception:
                    pass  # absent or unreadable this round: degraded
            if not pending or time.monotonic() >= deadline:
                return out
            time.sleep(poll_s)
        return out

    def kv_lane_transport(self):
        """Tag-addressed put / get / delete over the store.  The raw
        operations raise freely (callers wrap them in ``lane_call``); a
        tag absent past ``timeout_s`` raises ``TimeoutError``."""
        store = self._store()
        base = f"chainermn_tpu_kvxfer/{self._lane_prefix}"

        class _StoreLane:
            def put(self, tag: str, payload: bytes) -> None:
                store.set(f"{base}/{tag}", bytes(payload))

            def get(self, tag: str, timeout_s: float = 10.0) -> bytes:
                key = f"{base}/{tag}"
                deadline = time.monotonic() + float(timeout_s)
                while not store.check([key]):
                    if time.monotonic() >= deadline:
                        raise TimeoutError(
                            f"lane tag {tag!r} not published within "
                            f"{timeout_s}s (deadline exceeded)")
                    time.sleep(0.002)
                return bytes(store.get(key))

            def delete(self, tag: str) -> None:
                try:
                    store.delete_key(f"{base}/{tag}")
                except Exception as e:
                    if not isinstance(e, (AttributeError,
                                          NotImplementedError)) \
                            and "implement" not in str(e).lower():
                        raise
                    raise NotImplementedError(
                        f"{type(store).__name__} cannot delete keys: lane "
                        f"tag {tag!r} stays in the store") from e

        return _StoreLane()

    def send_obj(self, obj: Any, dest: int) -> None:
        if dest == self.rank:
            self._mailbox.append(pickle.dumps(obj))
            return
        dist.send_object_list([obj], dst=self._global(dest), group=self.group)

    def recv_obj(self, source: int) -> Any:
        if source == self.rank:
            return pickle.loads(self._mailbox.pop(0))
        box = [None]
        dist.recv_object_list(box, src=self._global(source), group=self.group)
        return box[0]

    # ---- model helpers ----
    def broadcast_data(self, params):
        """Overwrite every tensor of ``params`` (a module: its parameters
        and buffers; or an iterable of tensors) with rank 0's, in place."""
        tensors = (list(params.parameters()) + list(params.buffers())
                   if isinstance(params, torch.nn.Module) else list(params))
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=self._global(0), group=self.group)
        return params

    def multi_node_mean_grad(self, grads, allreduce_grad_dtype=None):
        """The cross-rank mean of a list of gradient tensors, one bucket."""
        return compressed_mean(list(grads), self, allreduce_grad_dtype)

    # ---- structure ----
    def split(self, color, key: int = 0):
        """A sequence of per-rank colors gives ``{my color: communicator}``
        (the JAX face, from this rank's side); a scalar is this rank's own
        color (MPI's face) and gives the communicator itself, so a scalar
        every rank shares is the whole world.  Every process creates every
        color's group, in color order.  ``key`` is accepted and ignored:
        a group's ranks follow the world's order, as in the JAX package."""
        per_rank = not isinstance(color, int)
        colors = (list(color) if per_rank
                  else self.allgather_obj(int(color)))
        if len(colors) != self.size:
            raise ValueError(f"need {self.size} colors, got {len(colors)}")
        mine = None
        for c in sorted({int(c) for c in colors}):
            group = dist.new_group([self._global(r) for r, rc
                                    in enumerate(colors) if int(rc) == c])
            if int(colors[self.rank]) == c:
                mine = TorchDistCommunicator(self.device, self.axis_name,
                                             group=group)
        return {int(colors[self.rank]): mine} if per_rank else mine

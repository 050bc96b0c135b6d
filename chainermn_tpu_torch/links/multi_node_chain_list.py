"""Model-parallel graph container.

Counterpart of ``chainermn_tpu/links/multi_node_chain_list.py``
(reference: ``chainermn/links/multi_node_chain_list.py ::
MultiNodeChainList``, BASELINE config #5).  Stages registered with
``rank_in`` / ``rank_out`` run in registration order, and the routing
table is the JAX package's:

* ``rank_in=None`` → the stage takes the model input ``x``;
  ``rank_in=r`` → the first pending message sent to its rank by rank
  ``r``; ``rank_in=[r, ...]`` → one such message per listed rank (a join);
* ``rank_out=None`` → the stage's output is the model output;
  ``rank_out=r`` / ``[r, ...]`` → it is sent to those ranks (a fan-out).

**How it differs from the JAX package.**  JAX is single-controller: every
stage runs in one process, placed on its chip by ``device_put``.  Here
there is one process per rank, as in ChainerMN itself:

* each process runs only the stages whose rank it owns
  (``comm.owns_rank``), their parameters on ``comm.device_of(rank)``;
* an edge between processes is the differentiable
  :func:`~chainermn_tpu_torch.functions.send` / ``recv`` (the sender
  first sends the shape and dtype, as ChainerMN's ``recv`` received
  them); an edge within a process is the identity;
* the process that owns the ``rank_out=None`` stage gets the output;
  every other process gets a zero-dimensional delegate tensor, tied by
  :func:`~chainermn_tpu_torch.functions.pseudo_connect` to its pending
  sends, and must call ``backward()`` on it: that runs those sends'
  backward receives, latest first, while the output's process
  backpropagates its loss.

Every process checks the whole routing table before anything is sent, so
each raises the same errors and none is left waiting for a peer that
raised.  With the naive communicator one process owns every
rank: every stage runs in-process and every edge is the identity, JAX's
single-controller meaning.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..communicators.base import CommunicatorBase
from ..functions import pseudo_connect, recv, send

Rank = Optional[Union[int, Sequence[int]]]
_REMOTE = object()     # a message whose payload lives in another process


def _place(tree, device):
    """A tree (dicts, lists, tuples) of parameters onto ``device``: numpy
    arrays become tensors, floating ones leaf tensors that require
    gradients."""
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        t = torch.from_numpy(np.array(tree))
        t = t.to(device) if device is not None else t
        return t.requires_grad_(t.is_floating_point())
    if isinstance(tree, torch.Tensor) and device is not None \
            and tree.device != torch.device(device):
        return tree.detach().to(device).requires_grad_(tree.requires_grad)
    return tree


class _Stage:
    def __init__(self, apply_fn, params, rank: int, rank_in: Rank,
                 rank_out: Rank):
        self.apply_fn = apply_fn
        self.params = params
        self.rank = rank
        self.rank_in = rank_in
        self.rank_out = rank_out


class MultiNodeChainList:
    """Sequentially registered model-parallel graph.

    ``add_link(apply_fn, params, rank, rank_in, rank_out)`` registers a
    stage of rank ``rank``; ``apply_fn(params, x)`` is any differentiable
    callable.  Every process registers every stage, in the same order.
    """

    def __init__(self, comm: CommunicatorBase):
        self._comm = comm
        self._stages: List[_Stage] = []

    def add_link(self, apply_fn: Callable, params: Any, rank: int,
                 rank_in: Rank = None, rank_out: Rank = None) -> None:
        if not 0 <= rank < self._comm.size:
            raise ValueError(f"rank {rank} out of range for size "
                             f"{self._comm.size}")
        if self._comm.owns_rank(rank):
            params = _place(params, self._comm.device_of(rank))
        self._stages.append(_Stage(apply_fn, params, rank, rank_in,
                                   rank_out))

    def params(self) -> List[Any]:
        """Per-stage parameters, in registration order (a stage of a rank
        this process does not own keeps what was registered)."""
        return [s.params for s in self._stages]

    def _to_rank(self, value, rank: int):
        device = self._comm.device_of(rank)
        return value if device is None else value.to(device)

    def _route(self):
        """Check the routing table before anything is sent: for each
        stage, its inputs' source ranks; raises JAX's errors."""
        pending = {r: [] for r in range(self._comm.size)}
        for stage in self._stages:
            sources = ([] if stage.rank_in is None else
                       [stage.rank_in] if isinstance(stage.rank_in, int)
                       else list(stage.rank_in))
            for src in sources:
                if src not in pending[stage.rank]:
                    raise RuntimeError(
                        f"stage on rank {stage.rank} expects a message from "
                        f"rank {src} but none is pending — check "
                        "registration order (reference: forward order must "
                        "match the send/recv pairing)")
                pending[stage.rank].remove(src)
            for r in _dests(stage.rank_out):
                pending[r].append(stage.rank)
        outputs = [s.rank for s in self._stages if s.rank_out is None]
        if not outputs:
            raise RuntimeError("no stage declared rank_out=None "
                               "(model output)")
        return outputs[-1]

    def __call__(self, x, params: Optional[List[Any]] = None):
        """Run the graph.  ``params`` overrides the stage parameters."""
        comm = self._comm
        output_rank = self._route()
        if params is None:
            params = [s.params for s in self._stages]
        # mailbox[r]: (source rank, payload) addressed to rank r, in send
        # order; the payload is a tensor when both ends are this process's
        mailbox = {r: [] for r in range(comm.size)}
        chain = None        # this process's pending send delegates
        output = None

        def pop_from(rank: int, source: int):
            for i, (src, v) in enumerate(mailbox[rank]):
                if src == source:
                    return mailbox[rank].pop(i)[1]

        def receive(source: int, rank: int):
            nonlocal chain
            payload = pop_from(rank, source)
            if payload is not _REMOTE:
                return self._to_rank(payload, rank)
            shape, dtype = comm.recv_obj(source)
            slot = torch.zeros(shape, dtype=dtype,
                               device=comm.device_of(rank),
                               requires_grad=dtype.is_floating_point)
            if chain is not None:       # the receive follows the sends
                slot = pseudo_connect(chain, slot)
                chain = None
            return recv(slot, source=source, dest=rank, axis_name=comm.mesh)

        for stage, p in zip(self._stages, params):
            if not comm.owns_rank(stage.rank):
                for r in _dests(stage.rank_out):
                    mailbox[r].append((stage.rank, _REMOTE))
                continue
            if stage.rank_in is None:
                inp = self._to_rank(x, stage.rank)
            elif isinstance(stage.rank_in, int):
                inp = receive(stage.rank_in, stage.rank)
            else:
                inp = [receive(src, stage.rank) for src in stage.rank_in]
            y = stage.apply_fn(p, inp)
            if stage.rank_out is None:
                output = y
            for r in _dests(stage.rank_out):
                if comm.owns_rank(r):
                    mailbox[r].append((stage.rank, y))
                    continue
                mailbox[r].append((stage.rank, _REMOTE))
                comm.send_obj((tuple(y.shape), y.dtype), r)
                d = send(y, dest=r, source=stage.rank, axis_name=comm.mesh)
                chain = d if chain is None else pseudo_connect(chain, d)
        if comm.owns_rank(output_rank):
            return output if chain is None else pseudo_connect(chain, output)
        delegate = torch.zeros((), device=comm.device_of(comm.rank),
                               requires_grad=True)
        return delegate if chain is None else pseudo_connect(chain, delegate)


def _dests(rank_out: Rank) -> List[int]:
    if rank_out is None:
        return []
    return [rank_out] if isinstance(rank_out, int) else list(rank_out)

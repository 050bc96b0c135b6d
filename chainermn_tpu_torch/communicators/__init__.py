"""Communicator factory.

Counterpart of ``chainermn_tpu/communicators/__init__.py ::
create_communicator``.  ``naive`` is the one-process numpy oracle; every
other name of the reference's CLI surface resolves to
:class:`~.torch_dist.TorchDistCommunicator`, whose collectives run over
NCCL between cards (gloo on the CPU).
"""

from __future__ import annotations

from typing import Optional

from .base import CommunicatorBase
from .naive import NaiveCommunicator
from .torch_dist import TorchDistCommunicator

# the JAX package's name for its process-group communicator
XlaCommunicator = TorchDistCommunicator

# name → what it meant in the reference, and what it is here
_ALIASES = {
    "xla": "the JAX package's backend → torch.distributed (NCCL)",
    "pure_nccl": "reference's NCCL-everywhere path → torch.distributed (NCCL)",
    "hierarchical": "reference's NCCL-intra + MPI-inter → one NCCL group",
    "two_dimensional": "reference's 2-D reduce-scatter/allgather → NCCL's all-reduce",
    "flat": "reference's flat CUDA-aware-MPI path → NCCL",
    "single_node": "reference's single-node NCCL path → NCCL",
    "non_cuda_aware": "reference's host-staged path → NCCL (no host staging)",
}


def create_communicator(communicator_name: str = "xla",
                        size: Optional[int] = None,
                        device="cuda") -> CommunicatorBase:
    """A communicator by name.  ``naive`` takes ``size`` logical ranks in
    this process; every other name joins the process group (torchrun's, or
    a one-rank group) on ``device``, the card by default."""
    name = communicator_name.lower()
    if name == "naive":
        return NaiveCommunicator(size=size)
    if name in _ALIASES:
        comm = TorchDistCommunicator(device=device)
        if size is not None and size != comm.size:
            raise ValueError(f"size={size} requested but the process group "
                             f"has {comm.size} ranks")
        return comm
    raise ValueError(f"unknown communicator {communicator_name!r}; known: "
                     f"{['naive', *sorted(_ALIASES)]}")


__all__ = ["CommunicatorBase", "NaiveCommunicator", "TorchDistCommunicator",
           "XlaCommunicator", "create_communicator"]

"""Process-group bootstrap and rank topology over ``torch.distributed``.

Counterpart of ``chainermn_tpu/topology.py``.  One process per card (the
reference's one MPI rank per GPU), launched by ``torchrun``:

=================  ==============================================
ChainerMN concept  here
=================  ==============================================
``rank``           ``torch.distributed.get_rank()``
``size``           the world size
``intra_rank``     ``LOCAL_RANK`` (the card's index on its host)
``intra_size``     ``LOCAL_WORLD_SIZE`` (processes on the host)
``inter_rank``     ``rank // intra_size`` (the host's index)
``inter_size``     ``size // intra_size``
=================  ==============================================

:func:`init_distributed` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``); without it, it builds a
one-rank group over an in-process store, so a single-process run still
sends its collectives through a process group.  The backend is NCCL on
the card (with gloo beside it for host tensors) and gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ._device import resolve_device

# the data-parallel axis's name, as in the JAX package
DEFAULT_AXIS_NAME = "mn"


def _backend_for(device) -> str:
    """NCCL for the card's tensors; gloo for host tensors (a group on the
    card carries both, so a CPU reference can share its process group)."""
    return "cpu:gloo,cuda:nccl" if torch.device(device).type == "cuda" \
        else "gloo"


def init_distributed(device="cuda", timeout_s: float = 600.0,
                     store=None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> None:
    """Join (or create) the default process group; a no-op when one
    exists.  Under torchrun the environment names the group and, on the
    card, ``LOCAL_RANK`` picks this process's card.  A caller may pass its
    own ``store``, ``rank`` and ``world_size`` (the tests' ``FileStore``);
    with none of them and no torchrun environment the group has one rank."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kw = dict(backend=_backend_for(dev),
              timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        dist.init_process_group(store=store, rank=rank, world_size=world_size,
                                **kw)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(init_method="env://", **kw)
    else:
        dist.init_process_group(store=dist.HashStore(), rank=0, world_size=1,
                                **kw)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Rank bookkeeping of the default process group."""

    rank: int
    size: int
    intra_rank: int
    intra_size: int
    inter_rank: int
    inter_size: int

    @classmethod
    def detect(cls, group=None) -> "Topology":
        """The default group's topology, or ``group``'s: its rank and size,
        the members on this host (intra) and the hosts it spans (inter),
        a host being ``LOCAL_WORLD_SIZE`` consecutive global ranks."""
        rank, size = dist.get_rank(), dist.get_world_size()
        intra_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
        if group is None:
            intra_rank = int(os.environ.get("LOCAL_RANK", rank % intra_size))
            return cls(rank=rank, size=size, intra_rank=intra_rank,
                       intra_size=intra_size, inter_rank=rank // intra_size,
                       inter_size=max(size // intra_size, 1))
        members = dist.get_process_group_ranks(group)
        local = [g for g in members if g // intra_size == rank // intra_size]
        hosts = sorted({g // intra_size for g in members})
        return cls(rank=dist.get_rank(group), size=len(members),
                   intra_rank=local.index(rank), intra_size=len(local),
                   inter_rank=hosts.index(rank // intra_size),
                   inter_size=len(hosts))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 1-D data-parallel world: an axis name, its process group (None:
    the default group) and its size.  Stands where JAX passes a
    ``jax.sharding.Mesh``."""

    axis_name: str
    group: Optional[object]
    size: int


def make_mesh(axis_name: str = DEFAULT_AXIS_NAME, group=None) -> Mesh:
    """A 1-D mesh over every rank of ``group`` (default: the world)."""
    return Mesh(axis_name, group, dist.get_world_size(group))


def abort_process_group(timeout_s: float = 5.0) -> bool:
    """Tear the default process group down from a side thread, waiting at
    most ``timeout_s``: the abort paths (the except hook, the watchdog,
    the collective guard) call it before ``os._exit``, where JAX calls
    ``jax.distributed.shutdown()``.  A peer wedged in the collective the
    crash abandoned can make the teardown block (NCCL waits on it), so the
    caller exits whatever happens.  Returns whether it finished."""
    import threading

    if not dist.is_initialized():
        return True

    def _down():
        try:
            dist.destroy_process_group()
        except Exception:
            pass

    t = threading.Thread(target=_down, daemon=True,
                         name="chainermn-tpu-torch-pg-teardown")
    t.start()
    t.join(timeout=timeout_s)
    return not t.is_alive()

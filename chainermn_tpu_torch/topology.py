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

:func:`make_nd_mesh` lays the ranks out on an N-D mesh (``('data',
'model')`` for hybrid DP x TP), as JAX reshapes ``jax.devices()``:
row-major over the axis sizes, the last axis fastest.  Each axis of the
mesh holds this rank's process group along it, made by ``dist.new_group``
(every rank creates every group, in the same order).  ``with mesh:`` binds
its axis names, so ``psum(x, 'model')`` inside runs over this rank's
``'model'`` group, where JAX's ``shard_map`` binds them.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
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


# the N-D meshes bound by ``with mesh:``, innermost last
_BOUND: list = []


class NdMesh:
    """An N-D mesh of ranks: JAX's ``jax.sharding.Mesh`` over processes.

    ``devices`` is the ``(*axis_sizes)`` array of global ranks (JAX's
    ``Mesh.devices``), ``shape`` maps each axis name to its size, and
    :meth:`axis` gives the 1-D :class:`Mesh` (this rank's group) along an
    axis, which every collective of ``ops.collective`` takes.  A rank
    outside ``devices`` holds no group (``coords`` is None)."""

    def __init__(self, axis_names: Tuple[str, ...], devices: np.ndarray,
                 axes: Dict[str, Mesh], coords: Optional[Tuple[int, ...]]):
        self.axis_names = tuple(axis_names)
        self.devices = devices
        self.shape = dict(zip(self.axis_names, devices.shape))
        self._axes = axes
        self.coords = coords

    def axis(self, name: str) -> Mesh:
        if self.coords is None:
            raise ValueError(f"rank {dist.get_rank()} is not on this mesh "
                             f"of ranks {self.devices.ravel().tolist()}")
        if name not in self._axes:
            raise ValueError(f"axis {name!r} not in mesh axes "
                             f"{self.axis_names}")
        return self._axes[name]

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along ``name``."""
        self.axis(name)
        return self.coords[self.axis_names.index(name)]

    def __enter__(self):
        _BOUND.append(self)
        return self

    def __exit__(self, *exc):
        _BOUND.pop()
        return False

    def __repr__(self):
        return f"NdMesh({self.shape}, ranks={self.devices.tolist()})"


def bound_axis(name: str) -> Optional[Mesh]:
    """The 1-D mesh of axis ``name`` of the innermost bound N-D mesh that
    has it (``with mesh:``), or None."""
    for mesh in reversed(_BOUND):
        if name in mesh.axis_names and mesh.coords is not None:
            return mesh.axis(name)
    return None


def make_nd_mesh(axis_names: Sequence[str], axis_sizes: Sequence[int],
                 ranks: Optional[Sequence[int]] = None) -> NdMesh:
    """An N-D mesh (e.g. ``('data', 'model')``) for hybrid DP x TP over
    ``ranks`` (default: every rank of the world, in order), laid out
    row-major over ``axis_sizes`` as JAX's ``make_nd_mesh`` reshapes its
    devices.  Every rank of the world must call it (each axis group is a
    ``dist.new_group``), members or not.  A group spanning the whole world
    in rank order is the default group itself."""
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    devices = np.asarray(ranks, dtype=np.int64).reshape(tuple(axis_sizes))
    me = dist.get_rank()
    where = np.argwhere(devices == me)
    coords = tuple(int(c) for c in where[0]) if len(where) else None
    axes = {}
    for i, name in enumerate(axis_names):
        lines = np.moveaxis(devices, i, -1).reshape(-1, devices.shape[i])
        for line in lines.tolist():
            if line != sorted(line):
                # a group's ranks are numbered in ascending order: the
                # mesh coordinate along the axis must be that number
                raise ValueError(f"axis {name!r} runs over ranks {line}, "
                                 f"not in ascending order")
            group = (None if line == list(range(world))
                     else dist.new_group(line))
            if me in line:
                axes[name] = Mesh(name, group, len(line))
    return NdMesh(tuple(axis_names), devices, axes, coords)


def dp_tp_mesh(tp: int, message: str) -> NdMesh:
    """The ``(world/tp, tp)`` ``('data', 'model')`` mesh of every rank;
    ``SystemExit(message)`` when ``tp`` does not divide the world (the
    message's ``{n}`` is the world size, ``{tp}`` is ``tp``)."""
    n = dist.get_world_size()
    if tp < 1 or n % tp:
        raise SystemExit(message.format(n=n, tp=tp))
    return make_nd_mesh(("data", "model"), (n // tp, tp))


def slice_index_of(rank: Optional[int] = None) -> int:
    """Which slice (host) ``rank`` (default: this one) belongs to: its host
    index, a host being ``LOCAL_WORLD_SIZE`` consecutive ranks.  JAX reads
    a TPU's ``slice_index`` and falls back to the process index; the
    port's ranks are processes, so the host plays the slice."""
    rank = dist.get_rank() if rank is None else int(rank)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    return rank // max(local, 1)


def make_multislice_mesh(ranks: Optional[Sequence[int]] = None,
                         axis_names: Sequence[str] = ("slice", "chip"),
                         num_slices: Optional[int] = None) -> NdMesh:
    """A 2-D ``('slice', 'chip')`` mesh: collectives over ``chip`` stay on
    a host (NVLink), those over ``slice`` cross hosts.  Slices come from
    :func:`slice_index_of` unless ``num_slices`` cuts ``ranks`` into that
    many equal blocks; uneven slices raise."""
    ranks = (list(range(dist.get_world_size())) if ranks is None
             else [int(r) for r in ranks])
    if num_slices is None:
        groups: Dict[int, list] = {}
        for r in ranks:
            groups.setdefault(slice_index_of(r), []).append(r)
        sizes = {len(v) for v in groups.values()}
        if len(sizes) != 1:
            raise ValueError(
                f"uneven slices: {{idx: len}} = "
                f"{ {k: len(v) for k, v in groups.items()} }")
        ranks = [r for _, grp in sorted(groups.items()) for r in grp]
        num_slices = len(groups)
    elif len(ranks) % num_slices:
        raise ValueError(
            f"{len(ranks)} ranks not divisible into {num_slices} slices")
    return make_nd_mesh(axis_names, (num_slices, len(ranks) // num_slices),
                        ranks)


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

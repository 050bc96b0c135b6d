"""One rank of the port's communicator and in-step collectives, for
tests/test_torch_comm.py.

Run as ``python tests/_torch_comm_worker.py RANK WORLD STORE_FILE OUT``.
Joins a gloo group through a ``FileStore`` (no port), calls every method
of ``TorchDistCommunicator`` and every collective of
``chainermn_tpu_torch.ops.collective`` on this rank's slab of
:func:`make_inputs`, and pickles what this rank got to ``OUT``.  The test
holds each result to slab ``rank`` of the JAX package's answer.  Imports
no JAX.
"""

import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.ops import collective as col
from chainermn_tpu_torch.topology import init_distributed

SPLITS = {"pair": [0, 1], "one": [0, 0]}
PERMS = {"one_way": [(0, 1)], "swap": [(0, 1), (1, 0)], "self": [(0, 0),
                                                               (1, 1)]}


def make_inputs(world):
    """Rank-major stacks ``(world, *s)``: slab ``r`` is rank ``r``'s."""
    rng = np.random.RandomState(11)
    return {
        "f": rng.randn(world, 4, 3).astype(np.float32),
        "i": rng.randint(-50, 50, (world, 4, 3)).astype(np.int32),
        "a2a": rng.randn(world, world, 3).astype(np.float32),
        "wide": rng.randn(world, 2 * world, 3 * world).astype(np.float32),
    }


def _np(x):
    return None if x is None else x.detach().cpu().numpy()


def communicator_results(comm, inputs):
    r, out = comm.rank, {}
    for dt in ("f", "i"):
        x = torch.from_numpy(inputs[dt][r])
        for op in ("sum", "max", "min"):
            out[f"allreduce/{op}/{dt}"] = _np(comm.allreduce(x, op))
        for root in range(comm.size):
            out[f"bcast/{root}/{dt}"] = _np(comm.bcast(x, root))
            out[f"gather/{root}/{dt}"] = _np(comm.gather(x, root))
            stack = inputs[dt] if r == root else None
            out[f"scatter/{root}/{dt}"] = _np(comm.scatter(stack, root))
            for dest in range(comm.size):
                out[f"send/{root}/{dest}/{dt}"] = _np(
                    comm.send(x, dest=dest, source=root))
                out[f"recv/{root}/{dest}/{dt}"] = _np(
                    comm.recv(x, source=root, dest=dest))
        out[f"allgather/{dt}"] = _np(comm.allgather(x))
    out["allreduce/mean/f"] = _np(comm.allreduce(
        torch.from_numpy(inputs["f"][r]), "mean"))
    out["alltoall"] = _np(comm.alltoall(torch.from_numpy(inputs["a2a"][r])))
    out["mean_grad"] = [_np(g) for g in comm.multi_node_mean_grad(
        [torch.from_numpy(inputs["f"][r]), torch.from_numpy(inputs["a2a"][r])])]
    out["stack"] = _np(comm.stack([inputs["f"][q] for q in range(comm.size)]))
    out["unstack"] = comm.unstack(torch.from_numpy(inputs["f"]))

    obj = {"rank": r, "vals": [r, r * 2]}
    out["bcast_obj"] = [comm.bcast_obj(obj, root) for root in range(comm.size)]
    out["gather_obj"] = [comm.gather_obj(obj, root)
                         for root in range(comm.size)]
    out["allgather_obj"] = comm.allgather_obj(obj)
    out["allreduce_obj"] = comm.allreduce_obj(r + 1)
    out["allreduce_obj_op"] = comm.allreduce_obj(
        [r], op=lambda a, b: a + b)
    for dest in range(comm.size):      # one object to each rank, in order
        if r != dest:
            comm.send_obj({"from": r, "to": dest}, dest=dest)
        else:
            got = [comm.recv_obj(source=s) for s in range(comm.size)
                   if s != r]
            out[f"recv_obj/{dest}"] = got
    comm.send_obj("loop", dest=r)
    out["recv_obj/self"] = comm.recv_obj(source=r)

    for name, colors in SPLITS.items():
        subs = comm.split(colors)
        (color, sub), = subs.items()
        x = torch.from_numpy(inputs["f"][r])
        out[f"split/{name}"] = {
            "color": color, "rank": sub.rank, "size": sub.size,
            "intra": (sub.intra_rank, sub.intra_size),
            "inter": (sub.inter_rank, sub.inter_size),
            "allreduce": _np(sub.allreduce(x)),
            "bcast_obj": sub.bcast_obj(("root of", color, r), root=0),
            "gather": _np(sub.gather(x, 0)),
            "psum": _np(col.psum(x, sub.mesh))}
    own = comm.split(r % 2)     # MPI's face: this rank's own color
    out["split/scalar"] = (own.size, own.rank,
                           _np(own.allreduce(torch.full((2,), r + 1.0))))
    out["device_of"] = [str(comm.device_of(q)) for q in range(comm.size)]
    out["topology"] = (comm.rank, comm.size, comm.intra_rank,
                       comm.intra_size, comm.inter_rank, comm.inter_size)
    return out


def collective_results(comm, inputs):
    r, mesh, out = comm.rank, comm.mesh, {}
    f = torch.from_numpy(inputs["f"][r])
    i = torch.from_numpy(inputs["i"][r])
    wide = torch.from_numpy(inputs["wide"][r])
    for name in ("psum", "pmean", "pmax", "pmin"):
        out[name] = _np(getattr(col, name)(f))
        if name != "pmean":
            out[f"{name}/int"] = _np(getattr(col, name)(i))
    tree = col.psum({"a": f, "b": [f * 2, f[0]]})
    out["psum/tree"] = {"a": _np(tree["a"]), "b": [_np(t) for t in tree["b"]]}
    out["pmean_if_bound"] = _np(col.pmean_if_bound(f))
    out["pmean_if_bound/none"] = _np(col.pmean_if_bound(f, None))
    for axis in (0, 1):
        for tiled in (True, False):
            out[f"all_gather/{axis}/{tiled}"] = _np(
                col.all_gather(f, axis=axis, tiled=tiled))
        out[f"reduce_scatter/{axis}"] = _np(
            col.reduce_scatter(wide, scatter_axis=axis))
    for split, concat in ((0, 0), (0, 1), (1, 0), (1, 1)):
        out[f"all_to_all/{split}/{concat}"] = _np(col.all_to_all(
            wide, split_axis=split, concat_axis=concat, tiled=True))
    out["all_to_all/untiled"] = _np(col.all_to_all(
        torch.from_numpy(inputs["a2a"][r]), split_axis=0, concat_axis=1,
        tiled=False))
    for name, perm in PERMS.items():
        out[f"ppermute/{name}"] = _np(col.ppermute(f, perm))
        out[f"ppermute/{name}/int"] = _np(col.ppermute(i, perm))
    for offset in (1, -1):
        out[f"shift/{offset}"] = _np(col.shift(f, offset))
    out["axis"] = (col.axis_index(), col.axis_size(),
                   col.axis_index(mesh), col.axis_size(mesh))
    for root in range(comm.size):
        out[f"bcast/{root}"] = _np(col.bcast(f, root))
    return out


def main(rank, world, store_file, out_path):
    store = dist.FileStore(store_file, world)
    init_distributed("cpu", timeout_s=60, store=store, rank=rank,
                     world_size=world)
    comm = create_communicator("xla", device="cpu")
    inputs = make_inputs(world)
    out = {"comm": communicator_results(comm, inputs),
           "col": collective_results(comm, inputs)}
    with open(out_path, "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:5])

"""One rank of the port's differentiable communication and links, for
tests/test_torch_functions.py and tests/test_torch_links.py.

Run as ``python tests/_torch_functions_worker.py SUITE RANK WORLD
STORE_FILE OUT_DIR``.  Joins a gloo group through a ``FileStore`` (no port),
then runs every case of ``SUITE``:

* ``functions``: each case of :data:`FUNCTION_CASES` on this rank's block
  of :func:`function_inputs`; keeps the output and the gradient of the
  block from ``backward()`` of the local ``out.sum()``;
* ``links``: the chain-list graphs of :func:`links_results` (a pipeline,
  the branching graph, a chain that returns to rank 0, the errors),
  ``MultiNodeBatchNormalization`` and ``allreduce_persistent``;

and pickles what this rank got to ``OUT_DIR/rank<r>.pkl``.  Imports no
JAX.
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch import functions as F
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.extensions import allreduce_persistent
from chainermn_tpu_torch.functions.collective import _pmean, _psum
from chainermn_tpu_torch.functions.point_to_point import ring_exchange
from chainermn_tpu_torch.links import (MultiNodeBatchNormalization,
                                       MultiNodeChainList)
from chainermn_tpu_torch.topology import init_distributed


def _w(r):
    return float(r + 1)


# name -> (block shape as a function of the world, fn(block, rank, world));
# each is JAX's test_functions.py case at world W (tests/test_torch_functions
# holds the JAX twin of each)
FUNCTION_CASES = {
    "send": ((1, 3), lambda b, r, W: F.send(b, dest=W - 1, source=W - 2)
             * (3.0 if r == W - 1 else 0.0)),
    "send_multi": ((1, 3), lambda b, r, W: F.send(
        b, dest=[1, 2 % W], source=[0, W - 1]) * _w(r)),
    "recv": ((1, 3), lambda b, r, W: F.recv(b, source=W - 1, dest=0)
             * _w(r)),
    "ring_exchange": ((1, 3), lambda b, r, W: ring_exchange(b, 1) * _w(r)),
    "ring_exchange_back": ((2, 3), lambda b, r, W: ring_exchange(b, -1)
                           * _w(r)),
    "bcast": ((1, 3), lambda b, r, W: F.bcast(b, root=W - 1) * _w(r)),
    "allgather": ((1, 3), lambda b, r, W: F.allgather(b) * _w(r)),
    "allgather_tiled": ((2, 3), lambda b, r, W: F.allgather(
        b, axis=1, tiled=True) * _w(r)),
    "all_to_all": ((None, 3), lambda b, r, W: F.all_to_all(b) * _w(r)),
    "all_to_all_tiled": ((2, None), lambda b, r, W: F.all_to_all(
        b, split_axis=1, concat_axis=0, tiled=True) * _w(r)),
    "scatter": ((None, 2), lambda b, r, W: F.scatter(b, root=0) * _w(r)),
    "gather": ((1, 3), lambda b, r, W: F.gather(b, root=W - 2) * _w(r)),
    "pseudo_connect": ((1, 3), lambda b, r, W: F.pseudo_connect(
        F.send(b, dest=1, source=0), b * 2.0)),
    "pseudo_connect_multiple": ((1, 3), lambda b, r, W: sum(
        F.pseudo_connect(F.send(b, dest=1, source=0), b + 1, b + 2))),
    "psum": ((1, 3), lambda b, r, W: _psum(b) * _w(r)),
    "pmean": ((1, 3), lambda b, r, W: _pmean(b) * _w(r)),
}


def function_inputs(name, world):
    """The rank-major stack ``(world, *block)`` of case ``name``; a None
    in the block shape is the world size."""
    shape = tuple(world if s is None else s
                  for s in FUNCTION_CASES[name][0])
    seed = sorted(FUNCTION_CASES).index(name)
    return np.random.RandomState(seed).randn(world, *shape).astype(np.float32)


def functions_results(rank, world):
    out = {}
    for name, (_, fn) in FUNCTION_CASES.items():
        b = torch.from_numpy(function_inputs(name, world)[rank]) \
            .requires_grad_(True)
        y = fn(b, rank, world)
        y.sum().backward()
        out[name] = (y.detach().numpy(), b.grad.numpy())
    return out


def dense_params(key, n_in, n_out):
    """A stage's weights from ``RandomState(key)`` (the test passes the same
    arrays to JAX's chain list)."""
    rng = np.random.RandomState(100 + key)
    return {"w": (rng.randn(n_in, n_out) * 0.5).astype(np.float32),
            "b": (rng.randn(n_out) * 0.1).astype(np.float32)}


def dense_apply(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def join_apply(p, xs):
    return dense_apply(p, xs[0] + xs[1])


def chain_input(seed, rows=5, width=4):
    return np.random.RandomState(seed).randn(rows, width).astype(np.float32)


# name -> (minimum world, [(apply, stage key, rank, rank_in, rank_out)])
GRAPHS = {
    "pipeline": (3, [("dense", 0, 0, None, 1), ("dense", 1, 1, 0, 2),
                     ("dense", 2, 2, 1, None)]),
    "branching": (4, [("dense", 0, 0, None, [1, 2]), ("dense", 1, 1, 0, 3),
                      ("dense", 2, 2, 0, 3), ("join", 3, 3, [1, 2], None)]),
    "two_stage": (2, [("dense", 0, 0, None, 1), ("dense", 1, 1, 0, None)]),
    "round_trip": (2, [("dense", 0, 0, None, 1), ("dense", 1, 1, 0, 0),
                       ("dense", 2, 0, 1, None)]),
}
_APPLY = {"dense": dense_apply, "join": join_apply}


def run_graph(comm, name):
    """``(output or None, {stage index: {leaf: grad}})`` of this process:
    the loss is ``mean(out²)`` on the output's process, ``backward()`` of
    the delegate elsewhere."""
    _, stages = GRAPHS[name]
    mnc = MultiNodeChainList(comm)
    for apply, key, rank, rank_in, rank_out in stages:
        mnc.add_link(_APPLY[apply], dense_params(key, 4, 4), rank=rank,
                     rank_in=rank_in, rank_out=rank_out)
    out = mnc(torch.from_numpy(chain_input(7)))
    output_rank = [s[2] for s in stages if s[4] is None][-1]
    if comm.owns_rank(output_rank):
        (out ** 2).mean().backward()
        value = out.detach().numpy()
    else:
        assert out.dim() == 0, out.shape
        out.backward()
        value = None
    grads = {i: {k: v.grad.numpy() for k, v in p.items()}
             for i, p in enumerate(mnc.params())
             if comm.owns_rank(stages[i][2])}
    return value, grads


def _errors(comm):
    caught = {}
    mnc = MultiNodeChainList(comm)
    try:
        mnc.add_link(dense_apply, {}, rank=comm.size)
    except ValueError:
        caught["rank_out_of_range"] = True
    mnc.add_link(dense_apply, dense_params(0, 2, 2), rank=0,
                 rank_in=comm.size - 1, rank_out=None)
    try:
        mnc(torch.ones(1, 2))
    except RuntimeError as e:
        caught["missing_message"] = "none is pending" in str(e)
    mnc = MultiNodeChainList(comm)
    mnc.add_link(dense_apply, dense_params(0, 2, 2), rank=0, rank_out=1)
    mnc.add_link(dense_apply, dense_params(1, 2, 2), rank=1, rank_in=0,
                 rank_out=0)
    try:
        mnc(torch.ones(1, 2))
    except RuntimeError as e:
        caught["no_output"] = "rank_out=None" in str(e)
    return caught


def bn_inputs(world, rows=4, feat=6):
    """``(x, w)`` rank-major: the input blocks and the loss weights."""
    rng = np.random.RandomState(5)
    x = (rng.randn(world, rows, feat) * 3 + 1).astype(np.float32)
    w = rng.randn(world, rows, feat).astype(np.float32)
    return x, w


def bn_results(rank, world):
    """Two training-mode calls (the statistics move twice), then one with
    the running average; the loss of the first is ``sum(y · w)``."""
    x, w = bn_inputs(world)
    bn = MultiNodeBatchNormalization(6)
    with torch.no_grad():
        bn.scale.copy_(torch.linspace(0.5, 1.5, 6))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, 6))
    xb = torch.from_numpy(x[rank]).requires_grad_(True)
    y = bn(xb)
    (y * torch.from_numpy(w[rank])).sum().backward()
    bn(torch.from_numpy(x[rank] * 0.5))
    y_ra = bn(torch.from_numpy(x[rank]), use_running_average=True)
    return {"y": y.detach().numpy(), "dx": xb.grad.numpy(),
            "dscale": bn.scale.grad.numpy(), "dbias": bn.bias.grad.numpy(),
            "mean": bn.mean.numpy().copy(), "var": bn.var.numpy().copy(),
            "y_ra": y_ra.detach().numpy()}


def links_results(comm, rank, world):
    out = {"graphs": {name: run_graph(comm, name)
                      for name, (least, _) in GRAPHS.items()
                      if world >= least},
           "errors": _errors(comm), "bn": bn_results(rank, world)}
    tree = {"a": torch.full((3,), float(rank)),
            "b": [torch.arange(4.0) * (rank + 1)]}
    mean = allreduce_persistent(tree, comm)
    out["persistent"] = {"a": mean["a"].numpy(), "b": mean["b"][0].numpy()}
    bn = MultiNodeBatchNormalization(2)
    with torch.no_grad():
        bn.mean.fill_(rank)
        bn.var.fill_(2.0 * rank)
    allreduce_persistent(bn, comm)
    out["persistent_module"] = (bn.mean.numpy().copy(),
                                bn.var.numpy().copy())
    return out


def main(suite, rank, world, store_file, out_dir):
    store = dist.FileStore(store_file, world)
    init_distributed("cpu", timeout_s=60, store=store, rank=rank,
                     world_size=world)
    comm = create_communicator("xla", device="cpu")
    out = (functions_results(rank, world) if suite == "functions"
           else links_results(comm, rank, world))
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6])

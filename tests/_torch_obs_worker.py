"""One rank of the comm ledger at world 2, for tests/test_torch_observability.py.

Run as ``python tests/_torch_obs_worker.py RANK WORLD STORE_FILE OUT_DIR``.
Joins a gloo group through a ``FileStore`` (no port) and, with tracing on,
books each case on a fresh ledger:

* every collective of ``ops.collective`` (:data:`OP_CASES`) and every
  eager collective of the process-group communicator;
* the step reports of ``make_demo_step``, ``make_train_step`` (with and
  without aux) and ``make_flax_train_step`` over a BatchNorm model, on
  this rank's rows of :func:`step_batch`;
* the hops of one ring-attention forward and the ticks of one 1F1B
  pipeline (an axis of both ranks bound by ``with mesh:``);
* ``cross_rank_report`` over this rank's :func:`skew_local`;
* ``python -m chainermn_tpu_torch.train`` with ``--metrics-out`` and
  ``--trace-out`` (4 steps);

and pickles it all to ``OUT_DIR/rank<r>.pkl``.  Imports no JAX.
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch import observability as obs
from chainermn_tpu_torch import train
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.observability.export import read_metrics_jsonl
from chainermn_tpu_torch.ops import collective as col
from chainermn_tpu_torch.topology import init_distributed, make_nd_mesh

#: ops.collective cases: name -> (call(x, mesh), per-rank block shape,
#: dtype); JAX's counterpart is tests/test_torch_observability.py's
OP_CASES = {
    "psum": (lambda x, m: col.psum(x, m), (8,), "float32"),
    "psum_tree": (lambda x, m: col.psum({"a": x, "b": x[:2].to(
        torch.int32)}, m), (8,), "float32"),
    "pmean": (lambda x, m: col.pmean(x, m), (8,), "bfloat16"),
    "pmax": (lambda x, m: col.pmax(x, m), (8,), "float32"),
    "pmin": (lambda x, m: col.pmin(x, m), (8,), "float32"),
    "pmean_if_bound": (lambda x, m: col.pmean_if_bound(x, m), (8,),
                       "float32"),
    "all_gather": (lambda x, m: col.all_gather(x, m), (8,), "float32"),
    "reduce_scatter": (lambda x, m: col.reduce_scatter(x, m), (8,),
                       "float32"),
    "all_to_all": (lambda x, m: col.all_to_all(x, m), (4, 4), "float32"),
    "ppermute": (lambda x, m: col.ppermute(
        x, [(i, (i + 1) % m.size) for i in range(m.size)], m), (8,),
        "float32"),
    "shift": (lambda x, m: col.shift(x, 1, m), (8,), "float32"),
    "bcast": (lambda x, m: col.bcast(x, 0, m), (8,), "float32"),
    "quantized_ring_pmean": (lambda x, m: col.quantized_ring_pmean(x, m),
                             (16,), "float32"),
}

STEP_ROWS = 16          # the global batch of the step cases
D_IN, D_OUT = 16, 4


def rows(report):
    """The fields the ledgers are compared on (not host time)."""
    keep = ("calls", "bytes", "dtypes", "noted_bytes")
    return {k: {f: v[f] for f in keep if f in v}
            for k, v in report["per_op"].items()}


def block(shape, dtype, rank):
    x = np.random.RandomState(10 + rank).randn(*shape).astype(np.float32)
    return torch.tensor(x).to(getattr(torch, dtype))


def step_batch():
    """``(x, y, labels)``: the global batch of the step cases."""
    rng = np.random.RandomState(0)
    return (rng.randn(STEP_ROWS, D_IN).astype(np.float32),
            rng.randn(STEP_ROWS, D_OUT).astype(np.float32),
            (np.arange(STEP_ROWS) % 10).astype(np.int32))


def skew_local(rank):
    rng = np.random.RandomState(20 + rank)
    return {"rank": rank, "steps": 3,
            "step_time_s": [float(v) for v in 0.1 + rng.rand(3) * rank],
            "comm_bytes": 1000 * (rank + 1), "comm_calls": 4,
            "comm_wait_s": float(rng.rand())}


class BNNet(torch.nn.Module):
    """Dense(8) → BatchNorm → relu → Dense(3): the flax step's model."""

    def __init__(self):
        super().__init__()
        from chainermn_tpu_torch.models.resnet import BatchNorm
        torch.manual_seed(0)
        self.fc1 = torch.nn.Linear(D_IN, 8)
        self.bn = BatchNorm(8, dtype=torch.float32)
        self.fc2 = torch.nn.Linear(8, 3)

    def forward(self, x):
        return self.fc2(torch.relu(self.bn(self.fc1(x))))


def fresh():
    obs.reset_all()
    obs.enable()


def step_reports(comm):
    """The second step's report of each step builder (the first step is
    JAX's compile step; the second its cache hit)."""
    from chainermn_tpu_torch.train import (local_rows, make_demo_step,
                                           make_flax_train_step,
                                           make_train_step)

    mesh = comm.mesh
    xs, ys, labels = (torch.tensor(a)
                      for a in local_rows(step_batch(), mesh))
    out = {}
    acct = obs.get_accountant()

    def two_steps(name, run):
        fresh()
        for _ in range(2):
            with acct.step(name):
                run()
        out[name] = rows(acct.last_step_report)

    params = {"w1": torch.zeros(D_IN, 8, requires_grad=True),
              "b1": torch.zeros(8, requires_grad=True),
              "w2": torch.zeros(8, 10, requires_grad=True),
              "b2": torch.zeros(10, requires_grad=True)}
    demo = make_demo_step(mesh)
    state = (params, torch.optim.SGD(list(params.values()), lr=0.1))
    two_steps("demo", lambda: demo(state, (xs, labels)))

    lin = torch.nn.Linear(D_IN, D_OUT)
    opt = torch.optim.SGD(lin.parameters(), lr=0.1)
    step = make_train_step(
        lambda m, b: ((m(b[0]) - b[1]) ** 2).mean(), opt, mesh=mesh)
    two_steps("train", lambda: step(lin, (xs, ys)))
    step_aux = make_train_step(
        lambda m, b: (((m(b[0]) - b[1]) ** 2).mean(),
                      {"mae": (m(b[0]) - b[1]).abs().mean()}),
        opt, mesh=mesh, has_aux=True)
    two_steps("train_aux", lambda: step_aux(lin, (xs, ys)))

    net = BNNet()
    fopt = torch.optim.SGD(net.parameters(), lr=0.1)
    fstep = make_flax_train_step(
        net, lambda out, b: (((out - b[1][:, :3]) ** 2).mean(),
                             {"acc": out.mean()}), fopt, mesh=mesh)
    two_steps("flax", lambda: fstep(net, (xs, ys)))
    return out


def loops(world):
    """Booked ppermute calls / bytes of one ring-attention forward and one
    1F1B pipeline at this world size."""
    from chainermn_tpu_torch.parallel.pipeline import pipeline_1f1b_grads
    from chainermn_tpu_torch.parallel.ring_attention import ring_attention

    out = {}
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 2, 4, generator=g) for _ in range(3))
    with make_nd_mesh(("sp",), (world,)):
        fresh()
        ring_attention(q, k, v, "sp", attn_impl="xla")
        out["ring"] = rows(obs.comm_report())
    w = {"w": torch.randn(1, 4, 4, generator=g)}
    x, t = torch.randn(8, 4, generator=g), torch.randn(8, 4, generator=g)
    with make_nd_mesh(("pp",), (world,)):
        fresh()
        pipeline_1f1b_grads(lambda p, a: torch.tanh(a @ p["w"]),
                            lambda y, tt: ((y - tt) ** 2).mean(), w, x, t,
                            axis_name="pp", num_microbatches=4)
        out["pipeline"] = rows(obs.comm_report())
    return out


def comm_methods(comm, rank):
    """Each eager collective of the communicator, booked alone."""
    size = comm.size
    x = block((4,), "float32", rank)
    stack = torch.stack([x] * size)
    cases = {
        "allreduce": lambda: comm.allreduce(x),
        "bcast": lambda: comm.bcast(x),
        "gather": lambda: comm.gather(x),
        "allgather": lambda: comm.allgather(x),
        "alltoall": lambda: comm.alltoall(stack),
        "scatter": lambda: comm.scatter(stack),
        "send": lambda: comm.send(x, dest=size - 1, source=0),
        "recv": lambda: comm.recv(x, source=0, dest=size - 1),
        "broadcast_data": lambda: comm.broadcast_data(
            torch.nn.Linear(4, 2)),
        "multi_node_mean_grad": lambda: comm.multi_node_mean_grad(
            [x, x[:2]]),
    }
    out = {}
    for name, fn in cases.items():
        fresh()
        fn()
        out[name] = rows(obs.comm_report())
    return out


def collect(comm, out_dir):
    """Every case at ``comm``'s rank and size (also run in-process at
    world 1 by the test)."""
    rank, world = comm.rank, comm.size
    out = {"ops": {}}
    for name, (fn, shape, dtype) in OP_CASES.items():
        fresh()
        fn(block(shape, dtype, rank), comm.mesh)
        out["ops"][name] = rows(obs.comm_report())
    out["comm"] = comm_methods(comm, rank)
    out["steps"] = step_reports(comm)
    out["loops"] = loops(world)
    out["skew"] = obs.cross_rank_report(comm, skew_local(rank))
    obs.disable()

    d = Path(out_dir)
    result, _ = train.run(["--device", "cpu", "--steps", "4", "--log-every",
                           "2", "--out", str(d / f"demo{rank}"),
                           "--metrics-out", str(d / "m.jsonl"),
                           "--trace-out", str(d / "t.json")])
    metrics = str(d / "m.jsonl")
    out["cli"] = {"result": result, "records": read_metrics_jsonl(
        obs.shard_path(metrics, rank) if world > 1 else metrics)}
    return out


def main(rank, world, store_file, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(store_file, world)
    init_distributed("cpu", timeout_s=60, store=store, rank=rank,
                     world_size=world)
    out = collect(create_communicator("xla", device="cpu"), out_dir)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:5])

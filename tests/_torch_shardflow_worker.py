"""One rank of the shard-flow analyzer at world 2, for tests/test_torch_shardflow.py.

Run as ``python tests/_torch_shardflow_worker.py RANK WORLD STORE_FILE OUT_DIR``.
Joins a gloo group through a ``FileStore`` (no port) and analyzes, on the
CPU:

* the int8 ring (``quantized_ring_pmean``) for each case of
  :data:`RING_CASES`, under JAX's ``composite`` declaration;
* the quantized train step (int8 wire, error feedback, double buffering)
  on this rank's rows, under the declaration JAX's entry point makes at
  axis size 2;
* the accounted gradient ring (reduce_scatter, all_gather, shift, psum)
  over both ranks, with the tracer's counters written to this rank's
  Chrome trace shard (``OUT_DIR/trace.rank0000N.json``) for the merge;

and pickles the reports and findings to ``OUT_DIR/rank<r>.pkl``.
Imports no JAX.
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch import observability as obs
from chainermn_tpu_torch.analysis import entrypoints as TE
from chainermn_tpu_torch.analysis import shardflow as S
from chainermn_tpu_torch.analysis.trace_engine import EntryPoint
from chainermn_tpu_torch.ops import collective as C
from chainermn_tpu_torch.parallel._factory import P
from chainermn_tpu_torch.topology import init_distributed, make_nd_mesh

#: (n_elements, block, pipeline) of the ring cases
RING_CASES = [(64, 32, 1), (64, 32, 4), (1000, 32, 2), (1000, 256, 1),
              (40, 8, 2)]


def _composite(n, p, block, k):
    return {"quantized_ring_pmean@mn": {
        "ledger_bytes": C.quantized_ring_cost(
            n, p, "int8", block, k)["ledger_bytes"],
        "static_groups": C.quantized_ring_static_groups(
            n, p, "mn", "int8", block, k)}}


def _result(findings, report):
    return {"report": report.to_dict(),
            "findings": [(f.rule, f.snippet, f.message) for f in findings]}


def ring_case(n, block, k, world):
    def build(device="cpu", size="tiny"):
        mesh = make_nd_mesh(("mn",), (world,))

        def body(x):
            with mesh:
                return C.quantized_ring_pmean(x, "mn", "int8", block, k)

        rank = dist.get_rank()
        x = torch.as_tensor(np.random.RandomState(rank).randn(n)
                            .astype(np.float32))
        return {"trace": (body, (x,)), "bound_axes": {"mn"},
                "data_axis": "mn", "arg_labels": ("x",),
                "in_specs": (P(),),
                "composite": _composite(n, world, block, k)}

    return _result(*S.analyze_entrypoint(
        EntryPoint(name=f"w2.ring.{n}.{block}.{k}", build=build),
        device="cpu"))


def quantized_step(world):
    """JAX's quantized entry at axis size 2: the builder of
    ``entrypoints._build_quantized_train_step`` over both ranks."""
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.topology import make_mesh
    from chainermn_tpu_torch.train import make_train_step

    block, pipeline = 8, 2

    def build(device="cpu", size="tiny"):
        mesh = make_mesh("mn")
        module, batch = TE._tiny_mlp(device)
        rank = dist.get_rank()
        per = batch[0].shape[0] // world
        batch = tuple(b[rank * per:(rank + 1) * per] for b in batch)
        inner = torch.optim.SGD(module.parameters(), 1e-2, momentum=0.9)
        TE._init_optimizer_state(inner)
        optimizer = create_multi_node_optimizer(
            inner, mesh, allreduce_grad_dtype="int8", error_feedback=True,
            double_buffering=True, quant_block=block,
            quant_pipeline=pipeline, world=world)
        step = make_train_step(TE._mlp_loss, optimizer, mesh,
                               allreduce_grad_dtype="int8",
                               error_feedback=True)
        tparams = TE._module_params(module)
        n_total = sum(int(p.numel()) for p in tparams.values())
        opt_state = TE._QuantOptState(TE._state_tree(inner, tparams),
                                      optimizer.state.stale_grads,
                                      optimizer.state.ef.residuals)
        opt_specs = TE._QuantOptState(TE._state_specs(inner, tparams), P(),
                                      P("mn", None))
        return {"trace": (step, (module, batch)), "bound_axes": {"mn"},
                "data_axis": "mn",
                "arg_labels": ("params", "opt_state", "batch"),
                "shardflow_args": (tparams, opt_state, batch),
                "in_specs": (P(), opt_specs, P("mn")),
                "expected_replication": {
                    "opt_state.inner": "inner momentum, per replica",
                    "opt_state.stale_grads": "identical mean gradients"},
                "composite": _composite(n_total, world, block, pipeline)}

    return _result(*S.analyze_entrypoint(
        EntryPoint(name="w2.train.quantized_step", build=build),
        device="cpu"))


def ring_with_trace(world, out_dir, rank):
    """The accounted ring over both ranks, its comm counters exported to
    this rank's trace shard."""
    def build(device="cpu", size="tiny"):
        mesh = make_nd_mesh(("mn",), (world,))

        def body(x):
            with mesh:
                g = C.reduce_scatter(x, "mn")
                g = C.all_gather(g, "mn")
                g = C.shift(g, 1, "mn")
                return C.psum(g, "mn")

        return {"trace": (body, (torch.ones(4),)), "bound_axes": {"mn"},
                "data_axis": "mn", "arg_labels": ("x",),
                "in_specs": (P(),)}

    obs.get_tracer().reset()
    obs.get_accountant().reset()
    out = _result(*S.analyze_entrypoint(
        EntryPoint(name="w2.ring", build=build), device="cpu"))
    obs.export_chrome_trace(str(Path(out_dir) / "trace.json"), rank=rank)
    out["ledger_bytes"] = sum(
        row["bytes"] for row in obs.get_accountant().totals.values())
    obs.get_tracer().reset()
    obs.get_accountant().reset()
    return out


def main(rank: int, world: int, store_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_file, world)
    init_distributed("cpu", timeout_s=60, store=store, rank=rank,
                     world_size=world)
    out = {"rings": {c: ring_case(*c, world) for c in RING_CASES},
           "quantized_step": quantized_step(world),
           "ring": ring_with_trace(world, out_dir, rank)}
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:5])

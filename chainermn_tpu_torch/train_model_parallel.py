#!/usr/bin/env python
"""CLI: an MLP split over two ranks (BASELINE config #5), one process per rank.

The port of ``examples/model_parallel/train_model_parallel.py``, with both
of its faces:

1. ``MultiNodeChainList``: stage 0 (16 → hidden, tanh) on rank 0, stage 1
   (hidden → 1) on rank 1, which holds the model output; sigmoid binary
   cross-entropy, Adam 1e-2.  Each rank's ``torch.optim.Adam`` steps its
   own stage; rank 0 backpropagates from the chain list's delegate, rank 1
   from the loss.
2. The raw SPMD split with :func:`chainermn_tpu_torch.functions.send`:
   every rank runs the same program on its own slab of the weights (rank
   0's stage 0, rank 1's stage 1), SGD 0.05.  Each rank's ``backward()``
   starts from its local term (the mean loss on rank 0, 0 elsewhere):
   the JAX example differentiates the psum of those terms, which on one
   process per rank is the sum of the local backward passes; the psum is
   taken only to report the loss.

The task is the example's (64 rows of 16 inputs from ``RandomState(0)``,
labels ``sin(Σx) > 0``).  Rank 0 holds the input rows; the other ranks
iterate ``create_empty_dataset`` placeholders of the same length, as the
reference's non-input ranks did.  A world of 1 is refused, as in the
example.

Run:  torchrun --nproc-per-node 2 -m chainermn_tpu_torch.train_model_parallel
      (on the CPU: add --device cpu)
"""

import argparse
import json

import numpy as np


def _parse(argv):
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch: model parallel")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: this process's card) or cpu")
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--hidden", type=int, default=32)
    return parser.parse_args(argv)


def init_params(hidden):
    """The two stages' weights, ``{"w0": {"w", "b"}, "w1": {...}}``, from
    ``RandomState(0)`` (N(0, 0.3²) kernels, zero biases)."""
    rng = np.random.RandomState(0)
    return {"w0": {"w": (rng.randn(16, hidden) * 0.3).astype(np.float32),
                   "b": np.zeros((hidden,), np.float32)},
            "w1": {"w": (rng.randn(hidden, 1) * 0.3).astype(np.float32),
                   "b": np.zeros((1,), np.float32)}}


def make_task():
    """The example's rows and labels."""
    rng = np.random.RandomState(0)
    xs = rng.randn(64, 16).astype(np.float32)
    ys = (np.sin(xs.sum(axis=1, keepdims=True)) > 0).astype(np.float32)
    return xs, ys


def run(argv=None, params=None):
    """``result``: both faces' losses at every step and this rank's final
    weights.  ``params`` (the JAX example's ``dense(0, 16, hidden)`` and
    ``dense(1, hidden, 1)`` as numpy, under ``"w0"`` / ``"w1"``) replaces
    the seeded initial weights."""
    import torch
    import torch.nn.functional as F

    from chainermn_tpu_torch import functions as MF
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.datasets import create_empty_dataset
    from chainermn_tpu_torch.links import MultiNodeChainList
    from chainermn_tpu_torch.ops import collective as col

    args = _parse(argv)
    comm = create_communicator("xla", device=args.device)
    if comm.rank == 0:
        print(f"ranks: {comm.size}", flush=True)
    if comm.size < 2:
        raise SystemExit(
            "model parallelism needs at least 2 ranks to place stages on; "
            "run under torchrun --nproc-per-node 2 (or more)")
    params = params or init_params(args.hidden)
    dev = comm.device

    xs, ys = make_task()
    if comm.rank == 0:
        inputs = xs
    else:       # the non-input ranks iterate placeholders of equal length
        empty = create_empty_dataset(list(xs))
        assert len(empty) == len(xs)
        inputs = np.zeros_like(xs)
    x = torch.from_numpy(inputs).to(dev)
    y = torch.from_numpy(ys).to(dev)

    def bce(logits):
        return F.binary_cross_entropy_with_logits(logits, y,
                                                  reduction="none")

    def stage0(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    def stage1(p, h):
        return h @ p["w"] + p["b"]

    # ---- face 1: MultiNodeChainList ----
    mnc = MultiNodeChainList(comm)
    mnc.add_link(stage0, params["w0"], rank=0, rank_in=None, rank_out=1)
    mnc.add_link(stage1, params["w1"], rank=1, rank_in=0, rank_out=None)
    owned = {i: p for i, (p, rank) in enumerate(zip(mnc.params(), (0, 1)))
             if rank == comm.rank}
    leaves = [t for p in owned.values() for t in p.values()]
    opt = torch.optim.Adam(leaves, lr=1e-2) if leaves else None
    chain_losses = []
    for i in range(args.steps):
        out = mnc(x)
        if comm.rank == 1:          # the output's rank holds the loss
            loss = bce(out).mean()
            loss.backward()
            local = loss.detach()
        else:
            out.backward()
            local = torch.zeros((), device=dev)
        if opt is not None:
            opt.step()
            opt.zero_grad(set_to_none=True)
        chain_losses.append(float(col.psum(local)))
        if comm.rank == 0 and i in (0, args.steps - 1):
            print(f"[chain-list] step {i}  loss {chain_losses[-1]:.4f}",
                  flush=True)

    # ---- face 2: the raw SPMD split over send ----
    slab = {k: torch.from_numpy(np.array(params[s][leaf])).to(dev)
            .requires_grad_(True)
            for k, (s, leaf) in {"w0": ("w0", "w"), "b0": ("w0", "b"),
                                 "w1": ("w1", "w"), "b1": ("w1", "b")}.items()}
    spmd_losses = []
    for i in range(args.steps):
        h = torch.tanh(x @ slab["w0"] + slab["b0"])   # rank 0 computes...
        h = MF.send(h, dest=1, source=0, axis_name=comm.mesh)   # ...ships
        logits = h @ slab["w1"] + slab["b1"]          # ...rank 1 finishes
        out = MF.send(logits, dest=0, source=1, axis_name=comm.mesh)
        valid = torch.where(torch.tensor(comm.rank == 0, device=dev),
                            bce(out).mean(), torch.zeros((), device=dev))
        valid.backward()            # this rank's local term only
        with torch.no_grad():
            for t in slab.values():
                t -= 0.05 * t.grad
                t.grad = None
        spmd_losses.append(float(col.psum(valid.detach())))
        if comm.rank == 0 and i in (0, args.steps - 1):
            print(f"[spmd p2p]   step {i}  loss {spmd_losses[-1]:.4f}",
                  flush=True)

    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    return {"world": comm.size, "rank": comm.rank,
            "chain_losses": chain_losses, "spmd_losses": spmd_losses,
            "chain_params": {i: {k: host(v) for k, v in p.items()}
                             for i, p in owned.items()},
            "spmd_params": {k: host(v) for k, v in slab.items()}}


def main(argv=None) -> int:
    result = run(argv)
    if result["rank"] == 0:
        print(json.dumps({k: result[k] for k in
                          ("world", "chain_losses", "spmd_losses")}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

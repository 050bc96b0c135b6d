"""One rank of the port's mesh-axis strategies, for tests/test_torch_sp.py and tests/test_torch_moe_pipeline.py.

Run as ``python tests/_torch_sp_worker.py SUITE RANK WORLD STORE_FILE
OUT_DIR``.  Joins a gloo group through a ``FileStore`` (no port), reads
``OUT_DIR/inputs.pkl`` (the test's numpy inputs: JAX's initial params and
the data), runs every case of ``SUITE`` on a ``('sp',)`` mesh of the world
and pickles what this rank got to ``OUT_DIR/rank<r>.pkl``:

* ``sp``: each case of :data:`ATTN_CASES` through ``make_ring_attention``
  or ``make_ulysses_attention`` (output and the gradients of ``sum(out ·
  R)``); this world's cases of :data:`LM_PAIRS`: the gradients of
  ``sp_transformer_lm_loss`` after the mean over the axis, then three
  Adam steps of ``make_hybrid_shard_map_step`` (losses, final params);
  ``train_long_context`` with ``--sp-impl ring`` and ``ulysses``; the
  ``ValueError`` messages of :func:`sp_errors`;
* ``moe``: each case of :data:`MOE_CASES` through ``make_moe_mlp`` (output,
  aux and the gradients of ``sum(y · R) + 3 aux``), ``make_pipeline``
  with and without ``remat`` (output and the gradients of ``sum(y · R)``)
  and ``make_pipeline_1f1b`` (loss and gradients), ``train_moe`` with
  ``--router-topk 1`` and ``2``, and the ``ValueError`` messages of
  :func:`moe_errors`.

Imports no JAX.
"""

import contextlib
import importlib
import io
import pickle
import sys
from functools import partial
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch.convert import flatten, tree_map
from chainermn_tpu_torch.topology import init_distributed, make_nd_mesh

AX = "sp"
# name -> (sp_impl, causal, n_kv_heads, attn_impl); q is (2, 16, 8, 8)
ATTN_CASES = {
    f"{impl}_{'causal' if causal else 'full'}_{'gqa' if kv < 8 else 'mha'}":
        (impl, causal, kv, "xla")
    for impl in ("ring", "ulysses") for causal in (False, True)
    for kv in (8, 4)}
# the flash path (the kernels' plain twins on the CPU) at one tiny shape
ATTN_CASES["ring_causal_gqa_flash"] = ("ring", True, 4, "flash")
ATTN_CASES["ulysses_causal_mha_flash"] = ("ulysses", True, 8, "flash")
ATTN = dict(batch=2, seq=16, heads=8, head_dim=8)
# name -> (n_kv_heads, pos_impl, sp_impl)
LM_CASES = {
    "learned_ring": (None, "learned", "ring"),
    "rope_ring_gqa": (2, "rope", "ring"),
    "learned_ulysses": (None, "learned", "ulysses"),
    "rope_ulysses": (None, "rope", "ulysses"),
}
# each world runs one ring and one Ulysses case, learned positions at one
# and RoPE at the other (the JAX side compiles each)
LM_PAIRS = [("learned_ring", 2), ("rope_ulysses", 2), ("rope_ring_gqa", 4),
            ("learned_ulysses", 4)]
LM = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, seq=256, batch=2,
          lr=1e-4, steps=3)
LC_ARGV = ["--vocab", "64", "--d-model", "32", "--n-heads", "4",
           "--n-layers", "2", "--seq-len", "32", "--batchsize", "2",
           "--steps", "3"]
# name -> (router_topk, capacity_factor): 8.0 keeps every token (capacity
# at least the local tokens at P = 2 and 4), 0.5 drops some
MOE_CASES = {f"top{k}_cf{cf}": (k, cf) for k in (1, 2) for cf in (8.0, 0.5)}
MOE = dict(tokens=32, d_model=8, d_hidden=16, experts_per_rank=2)
PIPE = dict(batch=16, d=8, microbatches=4)
MOE_ARGV = ["--steps", "5"]


def attn_inputs(name):
    """The case's global numpy ``q, k, v`` and cotangent weights ``R``."""
    _, _, kv, _ = ATTN_CASES[name]
    rng = np.random.RandomState(sorted(ATTN_CASES).index(name))
    b, s, h, d = (ATTN[k] for k in ("batch", "seq", "heads", "head_dim"))
    return [rng.randn(*shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d),
                          (b, s, h, d))]


def lm_tokens(seed):
    """``(inputs, targets)``: a ``(B, S + 1)`` draw shifted before any
    sharding."""
    t = np.random.RandomState(seed).randint(
        0, LM["vocab"], (LM["batch"], LM["seq"] + 1)).astype(np.int64)
    return t[:, :-1], t[:, 1:]


def moe_inputs(name):
    rng = np.random.RandomState(50 + sorted(MOE_CASES).index(name))
    t, d = MOE["tokens"], MOE["d_model"]
    return rng.randn(t, d).astype(np.float32), \
        rng.randn(t, d).astype(np.float32)


def pipe_inputs(world):
    """``test_pipeline.py``'s stage params (``w`` 0.5-normal, ``b``
    0.1-normal) for ``world`` stages, ``x``, the cotangent weights and
    the 1F1B targets."""
    rng = np.random.RandomState(world)
    d = PIPE["d"]
    per = [{"w": rng.randn(d, d).astype(np.float32) * 0.5,
            "b": rng.randn(d).astype(np.float32) * 0.1}
           for _ in range(world)]
    x, r, tgt = (rng.randn(PIPE["batch"], d).astype(np.float32)
                 for _ in range(3))
    return per, x, r, tgt


def stage_fn(params, x):
    """``tests/test_pipeline.py``'s stage: one dense + tanh block."""
    return torch.tanh(x @ params["w"] + params["b"])


def mse(y, t):
    return ((y - t) ** 2).mean()


def attn_results(world):
    """Each case's output and gradients; for the ring's flash case also
    what each block's backward got: ``(causal, max |dlse|, dlse finite)``
    a block, in call order."""
    from chainermn_tpu_torch.parallel import (make_ring_attention,
                                              make_ulysses_attention)

    # the module (the package's name of the same spelling is the function)
    ra = importlib.import_module("chainermn_tpu_torch.parallel.ring_attention")
    mesh = make_nd_mesh((AX,), (world,))
    out, seen = {}, []
    fwd, bwd = ra._BLOCKS["flash"]

    def recording_bwd(q, k, v, o, lse, do, causal, dlse):
        seen.append((causal, float(dlse.abs().max()),
                     bool(torch.isfinite(dlse).all())))
        return bwd(q, k, v, o, lse, do, causal, dlse)

    ra._BLOCKS["flash"] = (fwd, recording_bwd)
    for name, (impl, causal, _, attn_impl) in ATTN_CASES.items():
        make = {"ring": make_ring_attention,
                "ulysses": make_ulysses_attention}[impl]
        q, k, v, r = (torch.tensor(a) for a in attn_inputs(name))
        for t in (q, k, v):
            t.requires_grad_(True)
        seen.clear()
        y = make(mesh, AX, causal=causal, attn_impl=attn_impl)(q, k, v)
        (y * r).sum().backward()
        out[name] = [y.detach().numpy()] + [t.grad.numpy() for t in (q, k, v)]
        if seen:
            out[f"{name}_blocks"] = list(seen)
    ra._BLOCKS["flash"] = (fwd, bwd)
    return out


def lm_results(world, inputs):
    from chainermn_tpu_torch.optimizers import gradient_average
    from chainermn_tpu_torch.parallel import (P, make_hybrid_shard_map_step,
                                              param_leaves,
                                              sp_transformer_lm_loss)
    from chainermn_tpu_torch.parallel._factory import local_block

    mesh = make_nd_mesh((AX,), (world,))
    head_dim = LM["d_model"] // LM["n_heads"]
    out = {}
    for i, (name, (_, _, sp_impl)) in enumerate(LM_CASES.items()):
        if (name, world) not in LM_PAIRS:
            continue
        host = inputs["lm"][name]
        batch = tuple(local_block(torch.tensor(t), P(None, AX), mesh)
                      for t in lm_tokens(i))
        loss_fn = partial(sp_transformer_lm_loss, head_dim=head_dim,
                          axis_name=AX, sp_impl=sp_impl)
        local = tree_map(host, lambda a: torch.tensor(a).requires_grad_(True))
        with mesh:
            loss_fn(local, batch).backward()
        gradient_average(param_leaves(local), mesh.axis(AX))
        grads = {k: t.grad.numpy() for k, t in flatten(local).items()}

        local = tree_map(host, lambda a: torch.tensor(a))
        opt = torch.optim.Adam(param_leaves(local), lr=LM["lr"])
        step = make_hybrid_shard_map_step(loss_fn, opt, local, mesh,
                                          data_axis=AX)
        losses = [float(step(local, batch)) for _ in range(LM["steps"])]
        out[name] = {"grads": grads, "losses": losses,
                     "params": {k: t.detach().numpy()
                                for k, t in flatten(local).items()}}
    return out


def sp_errors(world):
    """JAX's ``ValueError`` cases: Ulysses with heads (world + 1) not
    divisible by the axis, GQA kv heads (world / 2) not divisible by it,
    an unknown ``sp_impl``, a learned ``pos_embed`` shorter than the
    global sequence."""
    from chainermn_tpu_torch.parallel import (init_tp_transformer_lm,
                                              make_ulysses_attention,
                                              sp_transformer_lm_loss)

    mesh = make_nd_mesh((AX,), (world,))
    z = torch.zeros
    params = init_tp_transformer_lm(0, 32, 16, 2, 1, max_len=8,
                                    device="cpu")
    toks = torch.zeros(1, 8, dtype=torch.int64)
    cases = {
        "ulysses_heads": lambda: make_ulysses_attention(mesh, AX)(
            z(1, 8, world + 1, 4), z(1, 8, world + 1, 4),
            z(1, 8, world + 1, 4)),
        "ulysses_gqa": lambda: make_ulysses_attention(mesh, AX)(
            z(1, 8, 2 * world, 4), z(1, 8, world // 2, 4),
            z(1, 8, world // 2, 4)),
        "sp_impl": lambda: sp_transformer_lm_loss(
            params, (toks, toks), head_dim=8, axis_name=None,
            sp_impl="bogus"),
        "pos_embed": lambda: _with(mesh, lambda: sp_transformer_lm_loss(
            params, (toks, toks), head_dim=8, axis_name=AX)),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _with(mesh, fn):
    with mesh:
        return fn()


def long_context_cli(inputs):
    from chainermn_tpu_torch import train_long_context

    out = {}
    for sp_impl in ("ring", "ulysses"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = train_long_context.run(
                ["--device", "cpu", *LC_ARGV, "--sp-impl", sp_impl],
                params=inputs["long_context"])
        out[sp_impl] = ([res["initial_loss"]] + res["losses"],
                        buf.getvalue())
    return out


def moe_results(world, inputs):
    from chainermn_tpu_torch.parallel import make_moe_mlp

    mesh = make_nd_mesh((AX,), (world,))
    e = MOE["experts_per_rank"] * world
    out = {}
    for name, (topk, cf) in MOE_CASES.items():
        x, r = (torch.tensor(a) for a in moe_inputs(name))
        params = tree_map(inputs["moe"][world],
                          lambda a: torch.tensor(a).requires_grad_(True))
        x.requires_grad_(True)
        y, aux = make_moe_mlp(e, mesh, AX, capacity_factor=cf,
                              router_topk=topk)(x, params)
        ((y * r).sum() + 3.0 * aux).backward()
        out[name] = {"y": y.detach().numpy(), "aux": float(aux),
                     "dx": x.grad.numpy(),
                     "dparams": {k: t.grad.numpy()
                                 for k, t in flatten(params).items()}}
    return out


def pipe_results(world):
    from chainermn_tpu_torch.parallel import (make_pipeline,
                                              make_pipeline_1f1b,
                                              stack_stage_params)

    mesh = make_nd_mesh((AX,), (world,))
    per, x, r, tgt = pipe_inputs(world)
    out = {}
    for remat in (False, True):
        stacked = stack_stage_params([tree_map(p, torch.tensor)
                                      for p in per])
        for t in stacked.values():
            t.requires_grad_(True)
        xt = torch.tensor(x).requires_grad_(True)
        y = make_pipeline(stage_fn, mesh, AX,
                          num_microbatches=PIPE["microbatches"],
                          remat=remat)(stacked, xt)
        (y * torch.tensor(r)).sum().backward()
        out[f"gpipe_remat{int(remat)}"] = {
            "y": y.detach().numpy(), "dx": xt.grad.numpy(),
            "dparams": {k: t.grad.numpy() for k, t in stacked.items()}}
    stacked = stack_stage_params([tree_map(p, torch.tensor) for p in per])
    loss, grads = make_pipeline_1f1b(
        stage_fn, mse, mesh, AX, num_microbatches=PIPE["microbatches"])(
        stacked, torch.tensor(x), torch.tensor(tgt))
    out["1f1b"] = {"loss": float(loss),
                   "grads": {k: t.numpy() for k, t in grads.items()}}
    return out


def moe_errors(world):
    """JAX's ``ValueError`` cases: ``router_topk=3``, experts not
    divisible by the axis, a batch not divisible by the microbatches, a
    stage-stacked leaf whose leading dim is not the stage count, an
    unsqueezed stage slice."""
    from chainermn_tpu_torch.parallel import (init_moe_mlp_params,
                                              make_moe_mlp, make_pipeline,
                                              pipeline_apply)

    mesh = make_nd_mesh((AX,), (world,))
    x = torch.zeros(4 * world, 4)
    cases = {
        "topk": lambda: make_moe_mlp(world, mesh, AX, router_topk=3)(
            x, init_moe_mlp_params(0, 4, 8, world)),
        "experts": lambda: make_moe_mlp(world + 1, mesh, AX)(
            x, init_moe_mlp_params(0, 4, 8, world * (world + 1))),
        "microbatches": lambda: make_pipeline(
            stage_fn, mesh, AX, num_microbatches=3)(
            {"w": torch.zeros(world, 4, 4), "b": torch.zeros(world, 4)},
            torch.zeros(8, 4)),
        "stages": lambda: make_pipeline(stage_fn, mesh, AX)(
            {"w": torch.zeros(world + 1, 4, 4),
             "b": torch.zeros(world + 1, 4)}, torch.zeros(8, 4)),
        "squeeze": lambda: _with(mesh, lambda: pipeline_apply(
            stage_fn, {"w": torch.zeros(4, 4), "b": torch.zeros(4)},
            torch.zeros(8, 4), axis_name=AX, num_microbatches=2)),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def moe_cli(inputs, world):
    from chainermn_tpu_torch import train_moe

    out = {}
    for topk in (1, 2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = train_moe.run(["--device", "cpu", *MOE_ARGV,
                                 "--router-topk", str(topk)],
                                params=inputs["moe_cli"][world])
        out[topk] = (res["losses"], res["aux"], buf.getvalue())
    return out


def main(suite, rank, world, store_file, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(store_file, world)
    init_distributed("cpu", timeout_s=120, store=store, rank=rank,
                     world_size=world)
    with open(Path(out_dir) / "inputs.pkl", "rb") as fh:
        inputs = pickle.load(fh)
    if suite == "sp":
        out = {"attn": attn_results(world), "lm": lm_results(world, inputs),
               "errors": sp_errors(world)}
        if world == 2:
            out["cli"] = long_context_cli(inputs)
    else:
        out = {"moe": moe_results(world, inputs), "pipe": pipe_results(world),
               "errors": moe_errors(world), "cli": moe_cli(inputs, world)}
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6])

"""One rank of the port's ZeRO-1 / FSDP and int8-wire strategies, for tests/test_torch_zero.py and tests/test_torch_quantized.py.

Run as ``python tests/_torch_zero_worker.py SUITE RANK WORLD STORE_FILE
OUT_DIR``.  Joins a gloo group through a ``FileStore`` (no port), reads
``OUT_DIR/inputs.pkl`` (the test's numpy inputs: JAX's initial params),
runs every case of ``SUITE`` on the world's ``'mn'`` axis and pickles what
this rank got to ``OUT_DIR/rank<r>.pkl``:

* ``zero``: :data:`STEP_CASES` through ``make_zero1_train_step`` and
  ``make_fsdp_train_step`` (losses, aux, the parameters after, the shapes
  of the optimizer's state), and at world 2 ``train_imagenet --fsdp`` from
  JAX's ViT-Ti (:data:`FSDP_ARGV`);
* ``quantized``: ``quantized_ring_pmean`` on :func:`ring_inputs`,
  ``compressed_mean`` int8 with and without residuals
  (:func:`cm_inputs`), the ring's two refusals of a residual; at world 2
  ``hierarchical_gradient_average`` with one axis bound, the combined
  int8 + error-feedback + double-buffered mode (:func:`stale_inputs`) and
  a checkpoint of the residual rows under ``OUT_DIR/ckpt``; at world 4
  ``hierarchical_pmean`` / ``hierarchical_gradient_average`` on the
  ``(2, 2)`` multislice mesh and the error-feedback trajectory
  (:func:`ef_inputs`).

Imports no JAX.
"""

import contextlib
import io
import pickle
import sys
from functools import partial
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch.topology import (init_distributed, make_mesh,
                                          make_multislice_mesh, make_nd_mesh)

AX = "mn"
# name -> (builder, optimizer, has_aux, params of test_zero.py / test_fsdp.py)
STEP_CASES = {
    "zero1_adam": ("zero1", "adam", False, "zero"),
    "zero1_sgd_aux": ("zero1", "sgd", True, "zero"),
    "fsdp_adam": ("fsdp", "adam", False, "fsdp"),
    "fsdp_sgd_aux": ("fsdp", "sgd", True, "fsdp"),
}
STEPS, ADAM_LR, SGD_LR, MOMENTUM = 3, 1e-2, 0.1, 0.9
FSDP_ARGV = ["--fsdp", "--arch", "vit_ti16", "--image-size", "32",
             "--batchsize", "4", "--dataset-size", "16", "--num-classes",
             "10", "--steps", "3", "--optimizer", "lamb", "--agc", "0.01"]
VIT_DEPTH = 2                 # the CLI's ViT, cut alike on both sides
# (block, pipeline) of the ring's cases; None: the defaults
RING_LAYOUTS = [(4, 1), (16, 2), (256, 4), None]
EF = dict(steps=50, lr=1e-3, d=264)
STALE = dict(lr=0.1, quant_block=64)


def step_data(kind):
    """``test_zero.py``'s (kind ``zero``) or ``test_fsdp.py``'s data."""
    rng = np.random.RandomState(0 if kind == "zero" else 1)
    return (rng.randn(32, 16).astype(np.float32),
            rng.randn(32, 4).astype(np.float32))


def step_loss(kind, p, batch):
    xs, ys = batch
    if kind == "zero":
        return ((xs @ p["w"] + p["b"] - ys) ** 2).mean()
    h = torch.tanh(xs @ p["w1"])
    return ((h @ p["w2"] + p["b"] - ys) ** 2).mean()


def ring_inputs(world):
    """``{name: (per-rank rows (world, n), layout)}``: sizes 1, 5, 64 and
    1000 at the defaults (the pad path), 173 at each layout."""
    rng = np.random.RandomState(7 + world)
    out = {f"n{n}": (rng.randn(world, n).astype(np.float32), None)
           for n in (1, 5, 64, 1000)}
    for lay in RING_LAYOUTS[:-1]:
        out[f"b{lay[0]}_k{lay[1]}"] = (
            (rng.randn(world, 173) * rng.lognormal(0, 1, (world, 173)))
            .astype(np.float32), lay)
    return out


def cm_inputs(world):
    """``compressed_mean``'s per-rank gradients ``a`` (3, 4) and ``b`` (7,)
    and residual rows ``(world, 19)``."""
    rng = np.random.RandomState(30 + world)
    return (rng.randn(world, 3, 4).astype(np.float32),
            rng.randn(world, 7).astype(np.float32),
            (0.01 * rng.randn(world, 19)).astype(np.float32))


def hier_inputs(world):
    return np.random.RandomState(40 + world).randn(world, 37).astype(
        np.float32)


def ef_inputs(world):
    """``test_quantized_allreduce.py``'s constant gradient, a row a rank:
    ~0.1 components with one ~100 outlier every 33, so one scale a chunk
    leaves the small ones under the int8 rounding threshold."""
    rng = np.random.RandomState(5)
    d = EF["d"]
    g = (rng.uniform(0.05, 0.15, size=(world, d)).astype(np.float32)
         * np.sign(rng.randn(world, d)).astype(np.float32))
    g[:, ::33] = 100.0 * np.sign(rng.randn(world, d // 33)).astype(
        np.float32)
    return g


def stale_inputs(world):
    rng = np.random.RandomState(2)
    return (rng.randn(world * 4, 3).astype(np.float32),
            rng.randn(world * 4, 1).astype(np.float32))


def rows(a, world, rank):
    n = len(a) // world
    return a[rank * n:(rank + 1) * n]


# ---- zero ----

def step_results(world, rank, inputs):
    from chainermn_tpu_torch.parallel import (init_fsdp_params,
                                              init_fsdp_state,
                                              init_zero1_state,
                                              make_fsdp_train_step,
                                              make_zero1_train_step,
                                              zero1_specs)

    mesh = make_mesh(AX)
    out = {}
    for name, (builder, opt_name, aux, kind) in STEP_CASES.items():
        host = inputs[kind]
        params = {k: torch.tensor(v) for k, v in host.items()}
        batch = tuple(torch.tensor(rows(a, world, rank))
                      for a in step_data(kind))
        opt = (partial(torch.optim.Adam, lr=ADAM_LR) if opt_name == "adam"
               else partial(torch.optim.SGD, lr=SGD_LR, momentum=MOMENTUM))

        def loss_fn(p, b, kind=kind):
            loss = step_loss(kind, p, b)
            return (loss, {"loss2x": 2.0 * loss}) if aux else loss

        if builder == "zero1":
            optimizer = init_zero1_state(opt, params, mesh)
            step = make_zero1_train_step(loss_fn, optimizer, params, mesh,
                                         has_aux=aux)
        else:
            specs = zero1_specs(params, mesh)
            params = init_fsdp_params(params, mesh)
            optimizer = init_fsdp_state(opt, params, mesh, specs)
            step = make_fsdp_train_step(loss_fn, optimizer, params, mesh,
                                        specs, has_aux=aux)
        res = [step(params, batch) for _ in range(STEPS)]
        losses = [float(r[0] if aux else r) for r in res]
        final = step.gather() if builder == "fsdp" else params
        out[name] = {
            "losses": losses,
            "aux": [float(r[1]["loss2x"]) for r in res] if aux else None,
            "params": {k: t.detach().numpy() for k, t in final.items()},
            "local": {k: tuple(t.shape) for k, t in params.items()},
            "state": [sorted(tuple(v.shape)
                             for v in optimizer.state[q].values()
                             if isinstance(v, torch.Tensor) and v.dim())
                      for q in optimizer.param_groups[0]["params"]]}
    return out


def fsdp_cli(inputs):
    from chainermn_tpu_torch import train_imagenet
    from chainermn_tpu_torch.models import ARCHS

    ARCHS["vit_ti16"] = partial(ARCHS["vit_ti16"], depth=VIT_DEPTH)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train_imagenet.run(["--device", "cpu", *FSDP_ARGV],
                                 variables=inputs["vit"],
                                 dtype=torch.float32)
    step = res["step"]
    return {"losses": res["losses"], "printed": buf.getvalue(),
            "params": {k: t.numpy() for k, t in step.gather().items()},
            "local": {k: tuple(t.shape) for k, t in step.params.items()}}


# ---- quantized ----

def ring_results(world, rank):
    from chainermn_tpu_torch.ops import quantized_ring_pmean

    mesh = make_mesh(AX)
    out = {}
    for name, (x, lay) in ring_inputs(world).items():
        args = ("int8", *lay) if lay else ()
        out[name] = quantized_ring_pmean(torch.tensor(x[rank]), mesh,
                                         *args).numpy()
    rng = np.random.RandomState(11)
    tree = {"a": torch.tensor(rng.randn(world, 16).astype(np.float32)[rank]),
            "b": torch.tensor(rng.randn(world, 4, 3).astype(np.float32)[rank]
                              ).bfloat16()}
    got = quantized_ring_pmean(tree, mesh)
    out["tree_dtypes"] = {k: str(v.dtype) for k, v in got.items()}
    return out


def cm_results(world, rank):
    from chainermn_tpu_torch.optimizers import compressed_mean

    mesh = make_mesh(AX)
    a, b, res = cm_inputs(world)
    grads = [torch.tensor(a[rank]), torch.tensor(b[rank])]
    plain = compressed_mean(grads, mesh, "int8")
    ef, new = compressed_mean(grads, mesh, "int8",
                              residuals=torch.tensor(res[rank:rank + 1]))
    errors = {}
    for name, r in (("rows", torch.zeros(2, 19)),
                    ("size", torch.zeros(1, 18))):
        try:
            compressed_mean(grads, mesh, "int8", residuals=r)
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    return {"plain": [g.numpy() for g in plain],
            "ef": [g.numpy() for g in ef], "residuals": new.numpy(),
            "errors": errors}


def hier_results(world, rank):
    """World 4: ``hierarchical_pmean`` (fp32, bf16 slice leg) and the
    reduce of ``hierarchical_gradient_average`` on the ``(2, 2)`` mesh;
    world 2: the reduce with only ``chip`` or only ``slice`` bound (a
    1-D mesh of that name), and with the slice leg in bf16."""
    from chainermn_tpu_torch.ops import hierarchical_pmean
    from chainermn_tpu_torch.optimizers import hierarchical_gradient_average

    x = torch.tensor(hier_inputs(world)[rank])
    out = {}
    if world == 4:
        mesh = make_multislice_mesh(num_slices=2)
        with mesh:
            out["pmean"] = hierarchical_pmean(x).numpy()
            out["pmean_bf16"] = hierarchical_pmean(
                x, dcn_dtype="bfloat16").numpy()
            out["reduce"] = hierarchical_gradient_average()([x])[0].numpy()
        return out
    for axis in ("chip", "slice"):
        with make_nd_mesh((axis,), (world,)):
            out[f"reduce_{axis}"] = hierarchical_gradient_average(
                dcn_dtype="bfloat16")([x])[0].numpy()
    out["reduce_none"] = hierarchical_gradient_average()([x])[0].numpy()
    return out


class _Vector(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(d))


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(3, 1))
        self.b = torch.nn.Parameter(torch.zeros(1))


def ef_trajectory(world, rank):
    """Three runs of ``EF["steps"]`` SGD steps through ``make_train_step``
    on the constant gradient: the fp32 wire, int8, int8 with error
    feedback (one scale a chunk: ``quant_block`` 2^20)."""
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.train import make_train_step

    mesh = make_mesh(AX)
    g = torch.tensor(ef_inputs(world)[rank:rank + 1])
    out = {}
    for name, wire, ef in (("fp32", None, False), ("int8", "int8", False),
                           ("ef", "int8", True)):
        model = _Vector(EF["d"])
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=EF["lr"]), mesh,
            allreduce_grad_dtype=wire, error_feedback=ef,
            quant_block=1 << 20)
        step = make_train_step(
            lambda m, b: (b[0] * m.w[None, :]).sum(1).mean(), opt, mesh,
            allreduce_grad_dtype=wire, error_feedback=ef)
        for _ in range(EF["steps"]):
            loss = step(model, (g,))
        out[name] = {"w": model.w.detach().numpy().copy(),
                     "loss": float(loss),
                     "residuals": (opt.ef.residuals.numpy().copy()
                                   if ef else None)}
    return out


def stale_results(world, rank):
    """The combined mode (int8, error feedback, double buffering,
    ``quant_block`` 64): the params after each of two SGD steps."""
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.train import make_train_step

    mesh = make_mesh(AX)
    model = _Linear()
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=STALE["lr"]), mesh,
        double_buffering=True, allreduce_grad_dtype="int8",
        error_feedback=True, quant_block=STALE["quant_block"])
    step = make_train_step(
        lambda m, b: ((b[0] @ m.w + m.b - b[1]) ** 2).mean(), opt, mesh,
        allreduce_grad_dtype="int8", error_feedback=True)
    batch = tuple(torch.tensor(rows(a, world, rank))
                  for a in stale_inputs(world))
    out = []
    for _ in range(2):
        step(model, batch)
        out.append({k: t.detach().numpy().copy()
                    for k, t in model.named_parameters()})
    return {"params": out, "residuals": opt.ef.residuals.numpy().copy()}


def ef_checkpoint(world, rank, out_dir):
    """Two int8 + error-feedback steps of the combined mode's model, then
    one checkpoint of ``{"opt": state_dict(), "iteration": 2}`` with the
    residual rows sharded by rank (``error_feedback_layout``)."""
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.extensions.checkpoint import \
        create_multi_node_checkpointer
    from chainermn_tpu_torch.optimizers import (create_multi_node_optimizer,
                                                error_feedback_layout)
    from chainermn_tpu_torch.train import make_train_step

    comm = create_communicator("xla", device="cpu")
    model = _Linear()
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=STALE["lr"]), comm,
        allreduce_grad_dtype="int8", error_feedback=True, quant_block=2)
    step = make_train_step(
        lambda m, b: ((b[0] @ m.w + m.b - b[1]) ** 2).mean(), opt,
        comm.mesh, error_feedback=True)
    batch = tuple(torch.tensor(rows(a, world, rank))
                  for a in stale_inputs(world))
    for _ in range(2):
        step(model, batch)
    state = {"opt": opt.state_dict(), "iteration": 2}
    layout = error_feedback_layout(state["opt"], prefix="['opt']")
    cp = create_multi_node_checkpointer(
        "ef", comm, path=str(Path(out_dir) / "ckpt"), async_write=False,
        layout=layout)
    cp.save(state, iteration=2)
    return {"layout": layout,
            "residuals": opt.ef.residuals.numpy().copy(),
            "params": {k: t.detach().numpy().copy()
                       for k, t in model.named_parameters()}}


def main(suite, rank, world, store_file, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(store_file, world)
    init_distributed("cpu", timeout_s=120, store=store, rank=rank,
                     world_size=world)
    with open(Path(out_dir) / "inputs.pkl", "rb") as fh:
        inputs = pickle.load(fh)
    if suite == "zero":
        out = {"steps": step_results(world, rank, inputs)}
        if world == 2:
            out["cli"] = fsdp_cli(inputs)
    else:
        out = {"ring": ring_results(world, rank),
               "cm": cm_results(world, rank),
               "hier": hier_results(world, rank)}
        if world == 2:
            out["stale"] = stale_results(world, rank)
            out["ckpt"] = ef_checkpoint(world, rank, out_dir)
        else:
            out["ef"] = ef_trajectory(world, rank)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6])

"""The port's ZeRO-1 and FSDP vs the JAX package's, on the CPU.

``tests/_torch_zero_worker.py zero`` runs in two and in four gloo
processes (one launch per world that runs every case) on the world's
``'mn'`` axis, and JAX runs the same cases on as many virtual CPU devices,
from the same numpy inputs (JAX's initial params, made once and shared):

* ``make_zero1_train_step`` and ``make_fsdp_train_step`` on
  ``tests/test_zero.py``'s and ``tests/test_fsdp.py``'s models, Adam 1e-2
  and SGD 0.1 with momentum 0.9 and an aux dict, three steps, against
  JAX's builders of the same names: losses (and aux) rtol 1e-5,
  parameters atol 1e-5; the optimizer state ``1/P`` of each sharded leaf,
  the FSDP params sharded at the step boundary;
* ``train_imagenet --fsdp --arch vit_ti16 --image-size 32 --optimizer
  lamb --agc 0.01`` at world 2 (ViT at depth 2 on both sides, fp32)
  against the JAX example's ``--fsdp`` recipe (``examples/imagenet/
  train_imagenet.py:198-226``: ``init_fsdp_params``, ``init_fsdp_state``,
  ``make_fsdp_train_step`` with the optax chain, the seed-0 records through
  the prefetcher): every loss rtol 1e-4, so LAMB's trust ratios and AGC's
  unit norms on the shards cover the whole leaves;
* in this process: ``zero1_specs`` against JAX's on its own trees and on
  ViT's params through ``convert`` (the ``nn.Linear`` weights held
  transposed name JAX's dimension), and the CLI's three ``--fsdp``
  refusals in the example's words.

The JAX example's own ``--fsdp`` cannot run: it sets ``batch_stats`` on
every model's variables (``:147``) before it tests for them (``:207``),
so it refuses every arch.  The recipe here is its ``--fsdp`` lines; the port refuses an arch
with running statistics.  Every launch has its own timeout; the JAX side
runs while the gloo ranks do.
"""

import ast
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as JP

import chainermn_tpu as mn
from chainermn_tpu.models.mlp import cross_entropy_loss as jax_ce
from chainermn_tpu.models.resnet import ARCHS as JAX_ARCHS
from chainermn_tpu.parallel import (init_fsdp_params, init_fsdp_state,
                                    init_zero1_state, make_fsdp_train_step,
                                    make_zero1_train_step)
from chainermn_tpu.parallel import zero1_specs as jax_zero1_specs

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from _torch_zero_worker import (ADAM_LR, AX, FSDP_ARGV, MOMENTUM,  # noqa: E402
                                SGD_LR, STEP_CASES, STEPS, VIT_DEPTH,
                                step_data)
from test_fsdp import init_params as fsdp_init  # noqa: E402
from test_fsdp import loss_fn as fsdp_loss  # noqa: E402
from test_zero import init_params as zero_init  # noqa: E402
from test_zero import loss_fn as zero_loss  # noqa: E402

WORLDS = (2, 4)
LAUNCH_TIMEOUT_S = 240
IMAGE, CLASSES, PER_CARD, RECORDS = 32, 10, 4, 16


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), (AX,))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def start(worker, suite, world, tmp, inputs):
    """Launch ``tests/WORKER SUITE`` as ``world`` gloo ranks with
    ``inputs`` pickled in ``tmp``, not waited for: returns ``finish() ->
    every rank's results``, which waits at most ``LAUNCH_TIMEOUT_S`` for
    the ranks, fails on a rank that did not exit 0 and leaves none
    running."""
    with open(tmp / "inputs.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / worker), suite, str(r),
         str(world), str(tmp / "store"), str(tmp)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]

    def finish():
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S)[0])
        finally:
            for p in procs:
                p.kill()
                p.wait()
        assert [p.returncode for p in procs] == [0] * world, \
            "\n".join(logs)[-4000:]
        outs = []
        for r in range(world):
            with open(tmp / f"rank{r}.pkl", "rb") as fh:
                outs.append(pickle.load(fh))
        return outs

    return finish


def run_worlds(tmp_path_factory, suite, inputs, references,
               worker="_torch_zero_worker.py"):
    """Per world: start the gloo ranks, compute ``references(world)`` (the
    JAX side) while they run, then collect them.  Returns ``({world: every
    rank's results}, {world: references}, {world: the launch's dir})``."""
    out, want, dirs = {}, {}, {}
    for w in WORLDS:
        dirs[w] = tmp_path_factory.mktemp(f"{suite}{w}")
        finish = start(worker, suite, w, dirs[w], inputs)
        try:
            want[w] = references(w)
        finally:
            out[w] = finish()
    return out, want, dirs


@pytest.fixture(scope="module")
def vit_init():
    """JAX's ViT-Ti at depth 2, image 32, 10 classes: the model and its
    variables as numpy (shared by the CLI and the spec cases)."""
    model = JAX_ARCHS["vit_ti16"](num_classes=CLASSES, stem_strides=1,
                                  dtype=jnp.float32, depth=VIT_DEPTH)
    variables = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)))
    return model, _host(dict(variables))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, vit_init):
    inp = {"zero": _host(zero_init()), "fsdp": _host(fsdp_init()),
           "vit": {"params": vit_init[1]["params"]}}

    def references(world):
        refs = {"steps": {n: jax_step(n, world) for n in STEP_CASES}}
        if world == 2:
            refs["cli"] = jax_fsdp_example(*vit_init)
        return refs

    out, want, _ = run_worlds(tmp_path_factory, "zero", inp, references)
    return out, want


def jax_step(name, world):
    builder, opt_name, aux, kind = STEP_CASES[name]
    mesh = _mesh(world)
    init, loss = (zero_init, zero_loss) if kind == "zero" \
        else (fsdp_init, fsdp_loss)
    opt = optax.adam(ADAM_LR) if opt_name == "adam" \
        else optax.sgd(SGD_LR, momentum=MOMENTUM)
    fn = (lambda p, b: (loss(p, b), {"loss2x": 2.0 * loss(p, b)})) \
        if aux else loss
    if builder == "zero1":
        params = mn.replicate(init(), mesh)
        st = init_zero1_state(opt, params, mesh, AX)
        step = make_zero1_train_step(fn, opt, mesh, AX, has_aux=aux,
                                     donate=False)
    else:
        params = init_fsdp_params(init(), mesh, AX)
        st = init_fsdp_state(opt, params, mesh, AX)
        step = make_fsdp_train_step(fn, opt, mesh, AX, has_aux=aux,
                                    donate=False)
    batch = tuple(jax.device_put(b, NamedSharding(mesh, JP(AX)))
                  for b in step_data(kind))
    losses, auxes = [], []
    for _ in range(STEPS):
        out = step(params, st, batch)
        params, st, loss_v = out[:3]
        losses.append(float(loss_v))
        if aux:
            auxes.append(float(out[3]["loss2x"]))
    return {"losses": losses, "aux": auxes or None,
            "params": _host(params),
            "specs": {k: tuple(s) for k, s in jax_zero1_specs(
                init(), mesh, AX).items()}}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(STEP_CASES))
def test_sharded_steps_match_jax(worlds, name, world):
    out, refs = worlds
    want = refs[world]["steps"][name]
    builder = STEP_CASES[name][0]
    for r, res in enumerate(out[world]):
        got = res["steps"][name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                                   err_msg=f"{name} losses rank {r}")
        if want["aux"] is not None:
            np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)
        assert got["params"].keys() == want["params"].keys()
        for k, w in want["params"].items():
            np.testing.assert_allclose(got["params"][k], w, atol=1e-5,
                                       rtol=0, err_msg=f"{name} {k} {r}")
        # each state tensor (Adam's moments, the momentum) is this rank's
        # block of its leaf: 1/P of a sharded one; the FSDP params too
        local = {}
        for k, w in want["params"].items():
            shape = list(w.shape)
            if "mn" in want["specs"][k]:
                shape[want["specs"][k].index("mn")] //= world
            local[k] = tuple(shape)
        per_leaf = 2 if STEP_CASES[name][1] == "adam" else 1
        assert got["state"] == [[local[k]] * per_leaf for k in sorted(local)]
        if builder == "fsdp":
            assert got["local"] == local


def jax_fsdp_example(model, variables):
    """The JAX example's ``--fsdp`` lines at ``FSDP_ARGV`` on two devices,
    fp32: LAMB 0.1 (weight decay 1e-4) behind AGC 0.01, the warm-up step's
    loss then three more."""
    mesh = _mesh(2)
    inner = optax.chain(optax.adaptive_grad_clip(0.01),
                        optax.lamb(0.1, weight_decay=1e-4))

    def loss_fn(p, batch):
        images, labels = batch
        logits = model.apply({"params": p}, images, train=True)
        return jax_ce(logits, labels), {
            "accuracy": (logits.argmax(-1) == labels).mean()}

    params = init_fsdp_params(variables["params"], mesh)
    st = init_fsdp_state(inner, params, mesh)
    step = make_fsdp_train_step(loss_fn, inner, mesh, has_aux=True,
                                donate=False)
    rng = np.random.RandomState(0)
    global_batch = PER_CARD * 2
    n = max(RECORDS, global_batch)
    records = rng.randn(n, IMAGE, IMAGE, 3).astype(np.float32)
    labels = rng.randint(0, CLASSES, n).astype(np.int32)
    it = mn.PrefetchIterator((records, labels), batch_size=global_batch,
                             shuffle=True, seed=1, copy=True)
    losses = []
    for _ in range(1 + int(FSDP_ARGV[FSDP_ARGV.index("--steps") + 1])):
        params, st, loss, _ = step(params, st, mn.shard_batch(it.next(),
                                                              mesh))
        losses.append(float(loss))
    it.close()
    return losses


def test_fsdp_cli_matches_the_jax_example(worlds):
    out, refs = worlds
    want = refs[2]["cli"]
    r0, r1 = (res["cli"] for res in out[2])
    for r, res in enumerate((r0, r1)):
        np.testing.assert_allclose(res["losses"], want, rtol=1e-4,
                                   err_msg=f"rank {r}")
    assert r0["printed"].startswith("vit_ti16  cards=2  global_batch=8")
    assert r1["printed"] == ""
    for k, v in r0["params"].items():       # both ranks gather the same
        np.testing.assert_array_equal(v, r1["params"][k])
    # the blocks are half of each divisible leaf (its first divisible dim)
    assert r0["local"]["_Block_0._MHSA_0.qkv.kernel"] == (96, 3, 3, 64)
    assert r0["local"]["_Block_0.Dense_0.weight"] == (768, 96)


def _torch_mesh(world):
    """The port's 1-D ``'mn'`` mesh of ``world`` ranks, as the specs need
    it: its size (no process group)."""
    from chainermn_tpu_torch.topology import Mesh as TorchMesh

    return TorchMesh(AX, None, world)


def _sharded_dim(spec):
    axes = [d for d, a in enumerate(spec) if a is not None]
    return axes[0] if axes else None


def _lm_init():
    """A small LM of JAX's layout, as shapes: nested dicts with a list of
    blocks (the specs read only the leaves' shapes)."""
    from chainermn_tpu.parallel import init_tp_transformer_lm

    return jax.eval_shape(lambda: init_tp_transformer_lm(
        jax.random.PRNGKey(0), 96, 32, 4, 2, max_len=12))


@pytest.mark.parametrize("world", [2, 4, 8])
def test_zero1_specs_match_jax_on_its_trees(world):
    from chainermn_tpu_torch.convert import flatten
    from chainermn_tpu_torch.parallel import zero1_specs

    for params in (_host(zero_init()), _host(fsdp_init()), _lm_init()):
        want = flatten(jax_zero1_specs(params, _mesh(world), AX))
        got = flatten(zero1_specs(params, _torch_mesh(world)))
        assert {k: tuple(s) for k, s in want.items()} == \
            {k: s.axes for k, s in got.items()}
    with pytest.raises(ValueError, match="not in mesh axes"):
        zero1_specs(params, _torch_mesh(world), "data")


@pytest.mark.parametrize("world", [2, 4])
def test_zero1_specs_match_jax_on_the_vit_through_convert(vit_init, world):
    """Every ViT leaf is cut along the same dimension of the same logical
    tensor: an ``nn.Linear`` weight (JAX's ``Dense`` kernel transposed)
    along the other of its two dims."""
    from chainermn_tpu_torch.convert import _flat_items, vit_from_jax
    from chainermn_tpu_torch.models import ARCHS
    from chainermn_tpu_torch.optim import linear_weights
    from chainermn_tpu_torch.parallel import zero1_specs

    _, variables = vit_init
    model = ARCHS["vit_ti16"](num_classes=CLASSES, image_size=IMAGE,
                              depth=VIT_DEPTH, dtype=torch.float32,
                              device="cpu")
    vit_from_jax(variables, model)
    full = dict(model.named_parameters())
    linear = {id(w) for w in linear_weights(model)}
    flipped = [n for n, t in full.items() if id(t) in linear]
    got = zero1_specs(full, _torch_mesh(world), transposed=flipped)
    want = _flat_items(jax_zero1_specs(variables["params"], _mesh(world),
                                       AX))
    assert len(want) == len(got) and flipped
    for key, spec in want.items():
        jdim = _sharded_dim(tuple(spec))
        if key.endswith(".kernel") and key.replace(".kernel", ".weight") \
                in flipped:
            pdim = _sharded_dim(got[key.replace(".kernel", ".weight")])
            pdim = None if pdim is None else 1 - pdim
        else:
            pdim = _sharded_dim(got[key])
        assert pdim == jdim, (key, spec)


def _example_exits():
    """The JAX example's ``SystemExit`` messages, ``{}`` for a formatted
    value."""
    src = (ROOT / "examples" / "imagenet" / "train_imagenet.py").read_text()
    out = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == \
                "SystemExit" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                out.append(arg.value)
            else:
                out.append("".join(v.value if isinstance(v, ast.Constant)
                                   else "{}" for v in arg.values))
    return out


@pytest.mark.parametrize("argv,which", [
    (["--arch", "resnet18"], 1),
    (["--arch", "vit_s16", "--allreduce-grad-dtype", "float16"], 0),
    (["--arch", "vit_s16", "--double-buffering"], 0)])
def test_fsdp_refusals_say_what_the_example_says(argv, which, capsys):
    import torch.distributed as dist

    from chainermn_tpu_torch.train_imagenet import main

    exits = _example_exits()
    bn = next(m for m in exits if "BatchNorm" in m)
    wire = next(m for m in exits if "BatchNorm" not in m)
    try:
        with pytest.raises(SystemExit) as e:
            main(["--device", "cpu", "--fsdp", *argv])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert str(e.value) == (wire, bn.format(argv[1]))[which]


def test_worker_imports_no_jax():
    """``tests/_torch_zero_worker.py`` runs the port alone."""
    from test_torch_package import _forbidden, _imported_modules

    path = ROOT / "tests" / "_torch_zero_worker.py"
    assert [m for m in _imported_modules(path) if _forbidden(m)] == []

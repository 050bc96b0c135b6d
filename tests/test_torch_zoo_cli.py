"""``python -m chainermn_tpu_torch.train_imagenet`` vs the JAX example, on the CPU.

Each case runs the JAX example's recipe (``examples/imagenet/
train_imagenet.py``: the model and flag checks, the optax chain under the
multi-node optimizer, ``make_flax_train_step`` with the on-device
normalisation, the seed-0 synthetic records through the prefetcher at seed
1, the warm-up step then ``--steps``) on one virtual device, and the port's
``train_imagenet.run`` from the same flax initial weights, at image 32,
batch 4, 10 classes, 3 steps, fp32 (the port's ``run(..., dtype=
torch.float32)``; the recipe's model at ``dtype=float32``).  Between them the cases take every
new flag: the NF-ResNet (``--conv-impl pallas``), ViT and AlexNet archs,
``--norm stalebn`` / ``affine``, ``--optimizer lars`` / ``lamb``,
``--warmup-steps``, ``--agc`` and ``--allreduce-grad-dtype float16``.
The NF-ResNet and ViT cases run at a cut depth (one block a stage, two
layers), set in both registries, as the flags' paths do not depend on it.
Tolerance: every step's loss rtol 1e-4.  Then the example's flag checks
(``--fsdp`` and the int8 wire are in ``test_torch_zero.py`` and
``test_torch_quantized.py``).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import chainermn_tpu as mn
from chainermn_tpu.models.mlp import cross_entropy_loss as jax_ce
from chainermn_tpu.models.resnet import ARCHS as JAX_ARCHS
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.models import ARCHS
from chainermn_tpu_torch.train_imagenet import main, run

COMMON = dict(image_size=32, batchsize=4, dataset_size=16, num_classes=10,
              steps=3, lr=0.1, momentum=0.9, weight_decay=1e-4)
CASES = {
    "nf_lars_warmup_agc_fp16": dict(arch="nf_resnet50", conv_impl="pallas",
                                    optimizer="lars", warmup_steps=2,
                                    agc=0.01, allreduce_grad_dtype="float16"),
    "stalebn_lamb": dict(arch="resnet18", norm="stalebn", optimizer="lamb"),
    "affine_agc": dict(arch="resnet18", norm="affine", agc=0.01),
    "vit_lamb_warmup": dict(arch="vit_ti16", optimizer="lamb",
                            warmup_steps=2),
    "alex_lars": dict(arch="alex", optimizer="lars"),
}
# the depth of the deep archs, cut alike on both sides
DEPTH = {"nf_resnet50": dict(stage_sizes=[1, 1, 1, 1]),
         "vit_ti16": dict(depth=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch in one thread: the suite runs beside other test workers on the
    same cores, where a multi-threaded pool over small ops oversubscribes
    them (this file took ~10x its alone time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def comm1():
    comm = create_communicator("xla", device="cpu")
    yield comm
    dist.destroy_process_group()


def _jax_example(cfg):
    """The example's lines from the model to the loop, at fp32."""
    c = {**COMMON, "norm": "bn", "conv_impl": "xla", "optimizer": "sgd",
         "warmup_steps": 0, "agc": 0.0, "allreduce_grad_dtype": None, **cfg}
    arch_kw = {"norm": c["norm"]} if c["norm"] != "bn" else {}
    if c["conv_impl"] != "xla":
        arch_kw["conv_impl"] = c["conv_impl"]
    comm = mn.create_communicator("xla", size=1)
    s = c["image_size"]
    model = JAX_ARCHS[c["arch"]](num_classes=c["num_classes"],
                                 stem_strides=2 if s >= 64 else 1,
                                 dtype=jnp.float32, **arch_kw,
                                 **DEPTH.get(c["arch"], {}))
    variables = dict(jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3))))
    variables.setdefault("batch_stats", {})
    init = jax.tree_util.tree_map(np.asarray, variables)
    lr = c["lr"]
    if c["warmup_steps"]:
        lr = optax.linear_schedule(0.0, c["lr"], c["warmup_steps"])
    if c["optimizer"] == "lars":
        inner = optax.lars(lr, weight_decay=c["weight_decay"],
                           momentum=c["momentum"])
    elif c["optimizer"] == "lamb":
        inner = optax.lamb(lr, weight_decay=c["weight_decay"])
    else:
        inner = optax.chain(optax.add_decayed_weights(c["weight_decay"]),
                            optax.sgd(lr, momentum=c["momentum"]))
    if c["agc"]:
        inner = optax.chain(optax.adaptive_grad_clip(c["agc"]), inner)
    wire = c["allreduce_grad_dtype"]
    optimizer = mn.create_multi_node_optimizer(inner, comm,
                                               allreduce_grad_dtype=wire)

    def loss_and_metrics(logits, batch):
        _, labels = batch
        return jax_ce(logits, labels), {
            "accuracy": (logits.argmax(-1) == labels).mean()}

    step = mn.make_flax_train_step(model, loss_and_metrics, optimizer,
                                   mesh=comm.mesh,
                                   allreduce_grad_dtype=wire)
    variables = mn.replicate(variables, comm.mesh)
    opt_state = mn.replicate(optimizer.init(variables["params"]), comm.mesh)
    data_rng = np.random.RandomState(0)
    n = max(c["dataset_size"], c["batchsize"])
    records = data_rng.randn(n, s, s, 3).astype(np.float32)
    labels = data_rng.randint(0, c["num_classes"], n).astype(np.int32)
    it = mn.PrefetchIterator((records, labels), batch_size=c["batchsize"],
                             shuffle=True, seed=1, copy=True)
    losses = []
    for _ in range(c["steps"] + 1):
        batch = mn.shard_batch(it.next(), comm.mesh)
        variables, opt_state, loss, _ = step(variables, opt_state, batch)
        losses.append(float(loss))
    it.close()
    return init, losses


def _argv(cfg):
    argv = ["--device", "cpu"]
    for k, v in {**COMMON, **cfg}.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return argv


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_the_jax_example(comm1, case, capsys, monkeypatch):
    arch = CASES[case]["arch"]
    if arch in DEPTH:
        monkeypatch.setitem(ARCHS, arch, partial(ARCHS[arch], **DEPTH[arch]))
    init, want = _jax_example(CASES[case])
    result = run(_argv(CASES[case]), variables=init, dtype=torch.float32)
    assert len(result["losses"]) == COMMON["steps"] + 1
    np.testing.assert_allclose(result["losses"], want, rtol=1e-4)
    assert all(np.isfinite(result["losses"]))
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith(f"{CASES[case]['arch']}  cards=1")


@pytest.mark.parametrize("argv,message", [
    (["--arch", "vit_s16", "--norm", "stalebn"], "resnet archs only"),
    (["--arch", "nf_resnet50", "--norm", "affine"], "resnet archs only"),
    (["--arch", "googlenet", "--conv-impl", "pallas"], "(nf_)resnet"),
    (["--agc", "-0.01"], "--agc must be >= 0")])
def test_imagenet_cli_mirrors_the_example_flag_checks(argv, message, capsys):
    with pytest.raises(SystemExit):
        main(["--device", "cpu", *argv])
    assert message in capsys.readouterr().err


def test_arch_choices_are_the_example_and_the_registry():
    """The port's ``--arch`` choices are the JAX example's literal list, and
    every one of them is in both registries."""
    import ast
    from pathlib import Path

    from chainermn_tpu_torch.models import ARCHS
    from chainermn_tpu_torch.train_imagenet import ARCH_CHOICES

    src = (Path(__file__).resolve().parents[1] / "examples" / "imagenet"
           / "train_imagenet.py").read_text()
    tree = ast.parse(src)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args and getattr(
                node.args[0], "value", None) == "--arch":
            choices = next(k.value for k in node.keywords
                           if k.arg == "choices")
            want = tuple(ast.literal_eval(choices))
    assert ARCH_CHOICES == want
    assert set(ARCH_CHOICES) <= set(ARCHS) and set(ARCHS) <= set(JAX_ARCHS)

"""The port's ResNets vs the JAX package's, on the CPU.

The same flax variables (JAX init, every BatchNorm scale and bias then
redrawn from a numpy seed so that no residual branch is switched off by
its zero-init scale, and every conv's gradient is non-zero) go into the
port through ``convert.resnet_from_jax``; the same numpy images and
labels go through both.  fp32, ``conv_impl="pallas"`` on both sides (JAX
takes XLA's transpose rule off the TPU; the port the plain wgrad / dgrad
versions on the eligible 3x3 convs).  Tolerances, fp32: logits, loss,
every gradient and the updated running statistics at atol = rtol = 1e-4
(the same math summed in another order through up to 50 layers).  The
redrawn scales keep each block's last one small (0.2), as a trained
network's are: with all scales near 1 a 50-layer ReLU network at batch 2-8
is chaotic in fp32, and there JAX's own fp32 gradients differ from its
fp64 ones by ~1% in norm, as much as the port's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models.mlp import cross_entropy_loss as jax_ce
from chainermn_tpu.models.resnet import ARCHS as JAX_ARCHS
from chainermn_tpu.ops.conv_backward import _xla_conv as jax_conv
from chainermn_tpu_torch.convert import resnet_from_jax, resnet_to_numpy
from chainermn_tpu_torch.models import ARCHS, cross_entropy_loss
from chainermn_tpu_torch.models.resnet import Conv, PallasConv
from chainermn_tpu_torch.ops import conv_backward as tcb

TOL = dict(rtol=1e-4, atol=1e-4)
N_CLASSES = 10


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _redraw_norms(variables, seed):
    rng = np.random.RandomState(seed)

    def one(path, v):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":     # zero-init (last of a block): small
            base = 0.2 if not np.asarray(v).any() else 1.0
            return (base * (1.0 + 0.1 * rng.randn(*v.shape))).astype(
                np.float32)
        if name == "bias" and "Dense" not in str(path):
            return (0.05 * rng.randn(*v.shape)).astype(np.float32)
        return np.asarray(v)

    return {"params": jax.tree_util.tree_map_with_path(one, variables["params"]),
            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                  variables["batch_stats"])}


def _models(arch, image, conv_impl="pallas", seed=0):
    stem = 2 if image >= 64 else 1
    jm = JAX_ARCHS[arch](num_classes=N_CLASSES, dtype=jnp.float32,
                         stem_strides=stem, conv_impl=conv_impl)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, image, image, 3)),
                train=False)
    v = _redraw_norms(v, seed + 1)
    tm = ARCHS[arch](num_classes=N_CLASSES, dtype=torch.float32,
                     stem_strides=stem, conv_impl=conv_impl, device="cpu")
    return jm, v, resnet_from_jax(v, tm)


def _data(n, image, seed=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, image, image, 3).astype(np.float32),
            rng.randint(0, N_CLASSES, n).astype(np.int32))


def _jax_train(jm, v, x, y):
    def loss_fn(p):
        logits, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                               x, train=True, mutable=["batch_stats"])
        return jax_ce(logits, y), (logits, mut["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    return float(loss), np.asarray(logits), _flat(grads), _flat(stats)


def _torch_train(tm, x, y):
    tm.train()
    logits = tm(torch.from_numpy(x))
    loss = cross_entropy_loss(logits, torch.from_numpy(y))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    flat = {}
    for n, g in zip(names, grads):
        key = n.replace(".", "/")
        if key == "Dense_0/weight":
            key, g = "Dense_0/kernel", g.t()
        flat[key] = g.numpy()
    stats = _flat(resnet_to_numpy(tm)["batch_stats"])
    return float(loss), logits.detach().numpy(), flat, stats


@pytest.mark.parametrize("arch,image,n", [("resnet18", 16, 4),
                                          ("resnet50", 16, 4)])
def test_train_mode_logits_loss_grads_and_stats_match_flax(arch, image, n):
    jm, v, tm = _models(arch, image)
    x, y = _data(n, image)
    jl, jlog, jg, js = _jax_train(jm, v, x, y)
    tl, tlog, tg, ts = _torch_train(tm, x, y)
    np.testing.assert_allclose(tlog, jlog, **TOL)
    assert abs(tl - jl) <= 1e-4 * abs(jl)
    assert tg.keys() == jg.keys() and ts.keys() == js.keys()
    for k in jg:
        assert np.abs(jg[k]).max() > 0, k      # no switched-off branch
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **TOL)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], err_msg=k, **TOL)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_eval_mode_uses_the_running_statistics(arch):
    jm, v, tm = _models(arch, 16, seed=4)
    rng = np.random.RandomState(5)
    stats = jax.tree_util.tree_map(
        lambda a: (np.abs(a) + 0.5 * rng.rand(*a.shape)).astype(np.float32),
        v["batch_stats"])
    v = {"params": v["params"], "batch_stats": stats}
    resnet_from_jax(v, tm)
    x, _ = _data(3, 16, seed=6)
    want = np.asarray(jm.apply(v, x, train=False))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_stem_stride_two_with_max_pool_matches_flax():
    jm, v, tm = _models("resnet18", 64, conv_impl="xla", seed=7)
    x, _ = _data(2, 64, seed=8)
    want = np.asarray(jm.apply(v, x, train=False))
    tm.eval()
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), want,
                                   **TOL)


@pytest.mark.parametrize("h", [8, 56])
def test_stride_two_same_padding_is_xla_asymmetric(h):
    """At an even plane XLA pads a stride-2 3x3 conv (0, 1): the port's conv
    equals JAX's there and differs from torch's symmetric padding=1."""
    assert tcb._same_pad(h, 3, 2) == (0, 1)
    rng = np.random.RandomState(9)
    x = rng.randn(1, h, h, 4).astype(np.float32)
    conv = Conv(4, 8, (3, 3), 2, torch.float32, gen=torch.Generator())
    w = conv.kernel.detach().numpy()
    want = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(w), 2))
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
        symmetric = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            conv.kernel.permute(3, 2, 0, 1), None, 2, 1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(symmetric.numpy() - want).max() > 1e-2


def test_pallas_impl_swaps_only_the_block_3x3_convs():
    tm = ARCHS["resnet50"](num_classes=N_CLASSES, device="cpu",
                           conv_impl="pallas")
    pallas = {n for n, m in tm.named_modules() if isinstance(m, PallasConv)}
    convs = {n for n, m in tm.named_modules() if isinstance(m, Conv)}
    assert pallas == {f"BottleneckBlock_{i}.Conv_1" for i in range(16)}
    assert "conv_init" in convs - pallas
    xla = ARCHS["resnet50"](num_classes=N_CLASSES, device="cpu")
    assert not any(isinstance(m, PallasConv) for m in xla.modules())
    assert [n for n, _ in xla.named_parameters()] == \
        [n for n, _ in tm.named_parameters()]


def test_bf16_compute_keeps_fp32_params_and_head():
    tm = ARCHS["resnet18"](num_classes=N_CLASSES, device="cpu")
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    x, y = _data(2, 16)
    logits = tm(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and logits.shape == (2, N_CLASSES)
    cross_entropy_loss(logits, torch.from_numpy(y)).backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in tm.parameters())

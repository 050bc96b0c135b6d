"""The port's ImageNet zoo vs the JAX package's, on the CPU.

The same flax variables (JAX's init, with the zero-init gains, scales and
biases redrawn from a numpy seed so that no branch is switched off and
every gradient is non-zero) go into the port through
``convert.*_from_jax``; the same numpy images and labels go through both.

* NF-ResNet-50 / 101, ``conv_impl="pallas"`` on both sides (JAX takes XLA's
  transpose off the TPU, the port the plain wgrad / dgrad on the eligible
  1x1 and 3x3 convs): logits, loss and every gradient; each
  ``ScaledWSConv``'s standardised weight; ``"xla"`` gives the same
  function.  The conv backward at NF-ResNet's 1x1 and 3x3 shapes against
  JAX's interpret-mode kernels.
* ``norm="stalebn"``: two training steps (the first normalises with the
  initial ``last_*``, the second with the first batch's statistics; both
  stat pairs after each) and eval mode (the EMA); ``norm="affine"``.
* AlexNet, VGG-16 and GoogLeNet at ``stem_strides=1``, image 16 (training: logits,
  gradients, running statistics) and at the ImageNet stem (eval: VALID
  pools, GoogLeNet's SAME pools at XLA's split, AlexNet's (3, 4) stem pad).
* ViT-Ti/S at depth 2, ``attn_impl`` ``"xla"`` and ``"flash"`` (JAX's flash
  in Pallas interpret mode, the port's plain version), fp32 and bf16.

Tolerances: fp32 atol = rtol = 1e-4 (the same math summed in another
order); for stalebn's two steps, whose stale statistics leave the
activations unnormalised at random init (logits ~300), the atol is 1e-4
of each array's largest entry; bf16 logits within 4e-2 of max |logit| (a
bf16 ulp is 2^-8 of a value; the two packages round after different ops
through two blocks).
"""

import copy
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models.mlp import cross_entropy_loss as jax_ce
from chainermn_tpu.models.resnet import ARCHS as JAX_ARCHS
from chainermn_tpu.ops import conv_backward as jcb
from chainermn_tpu_torch import convert
from chainermn_tpu_torch.models import ARCHS, ScaledWSConv, cross_entropy_loss
from chainermn_tpu_torch.models.convnets import max_pool
from chainermn_tpu_torch.ops import conv2d

TOL = dict(rtol=1e-4, atol=1e-4)
N_CLASSES = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch in one thread: the suite runs beside other test workers on the
    same cores, where a multi-threaded pool over small ops oversubscribes
    them (this file took ~10x its alone time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _redraw(variables, seed):
    """Zero-init scales (the last of a block), gains and skip gains become
    non-zero, biases small and random, so every branch is open."""
    rng = np.random.RandomState(seed)

    def one(path, v):
        name = str(getattr(path[-1], "key", path[-1]))
        v = np.asarray(v)
        if name == "scale" and not v.any():
            return (0.2 * (1.0 + 0.1 * rng.randn(*v.shape))).astype(np.float32)
        if name in ("scale", "gain"):
            return (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        if name == "skip_gain":
            return np.float32(1.0 + 0.1 * rng.randn())
        if name == "cls":
            return (0.02 * rng.randn(*v.shape)).astype(np.float32)
        if name == "bias" and "Dense" not in str(path):
            return (0.05 * rng.randn(*v.shape)).astype(np.float32)
        return v

    params = jax.tree_util.tree_map_with_path(one, variables["params"])
    return {"params": params, "batch_stats": jax.tree_util.tree_map(
        np.asarray, variables.get("batch_stats", {}))}


@lru_cache(maxsize=None)
def _variables(arch, image, dtype, seed, kw):
    """flax's redrawn variables, one init (one compile) for every test of
    the same model; ``conv_impl`` and ``attn_impl`` change no variable."""
    kw = {k: v for k, v in kw if k not in ("conv_impl", "attn_impl")}
    jm = JAX_ARCHS[arch](num_classes=N_CLASSES, dtype=dtype, **kw)
    v = jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, image, image, 3)))
    return _redraw(v, seed + 1)


def _models(arch, image, dtype=jnp.float32, seed=0, **kw):
    jm = JAX_ARCHS[arch](num_classes=N_CLASSES, dtype=dtype, **kw)
    v = copy.deepcopy(_variables(arch, image, dtype, seed,
                                 tuple(sorted(kw.items()))))
    tkw = dict(kw)
    if arch.startswith(("vit", "alex", "vgg")):
        tkw["image_size"] = image
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tm = ARCHS[arch](num_classes=N_CLASSES, dtype=tdtype, device="cpu", **tkw)
    return jm, v, convert.resnet_from_jax(v, tm)


def _data(n, image, seed=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, image, image, 3).astype(np.float32),
            rng.randint(0, N_CLASSES, n).astype(np.int32))


def _jax_grad_fn(jm, has_stats):
    """Jitted ``(params, stats, x, y) -> ((loss, (logits, new stats)),
    grads)`` of flax training mode."""
    def loss_fn(p, stats, x, y):
        if has_stats:
            logits, mut = jm.apply({"params": p, "batch_stats": stats}, x,
                                   train=True, mutable=["batch_stats"])
            new = mut["batch_stats"]
        else:
            logits, new = jm.apply({"params": p}, x, train=True), {}
        return jax_ce(logits, y), (logits, new)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _jax_train(jm, v, x, y, fn=None):
    fn = fn or _jax_grad_fn(jm, bool(v["batch_stats"]))
    (loss, (logits, new)), grads = fn(v["params"], v["batch_stats"], x, y)
    return (float(loss), np.asarray(logits), _flat(grads),
            jax.tree_util.tree_map(np.asarray, new))


def _jax_eval(jm, v, x):
    return np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x))


def _torch_train(tm, x, y):
    tm.train()
    logits = tm(torch.from_numpy(x))
    loss = cross_entropy_loss(logits, torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    names = [n for n, _ in tm.named_parameters()]
    flat = {}
    for n, g in zip(names, grads):
        if convert._dense(n):
            n, g = n.replace(".weight", ".kernel"), g.t()
        flat[n.replace(".", "/")] = g.float().numpy()
    stats = _flat(convert.resnet_to_numpy(tm)["batch_stats"])
    return (float(loss.detach()), logits.detach().float().numpy(), flat,
            stats)


def _close(got, want, name, scaled):
    """fp32 ``TOL``; ``scaled``: the atol is 1e-4 of the array's largest
    entry (a network without normalisation, whose sums are large)."""
    atol = 1e-4 * max(1.0, float(np.abs(want).max())) if scaled else 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=name)


def _assert_train_matches(jm, v, tm, x, y, scaled=False, fn=None):
    jl, jlog, jg, jstats = _jax_train(jm, v, x, y, fn)
    tl, tlog, tg, tstats = _torch_train(tm, x, y)
    _close(tlog, jlog, "logits", scaled)
    assert abs(tl - jl) <= 1e-4 * abs(jl)
    assert tg.keys() == jg.keys()
    for k in jg:
        assert np.abs(jg[k]).max() > 0, k       # no switched-off branch
        _close(tg[k], jg[k], k, scaled)
    js = _flat(jstats)
    assert tstats.keys() == js.keys()
    for k in js:
        _close(tstats[k], js[k], k, scaled)
    return jstats


# ---- NF-ResNets ----

@pytest.mark.parametrize("arch", ["nf_resnet50", "nf_resnet101"])
def test_nf_resnet_logits_loss_and_grads_match_flax(arch):
    jm, v, tm = _models(arch, 16, stem_strides=1, conv_impl="pallas")
    x, y = _data(2, 16)
    _assert_train_matches(jm, v, tm, x, y)
    assert not list(tm.buffers())


def test_scaled_ws_conv_standardises_as_jax():
    """``W_hat`` of every ``ScaledWSConv`` against JAX's formula (biased
    variance, ``rsqrt(var·fan_in + 1e-4)``, the gain) on the same kernel,
    and torch's unbiased default would differ."""
    _, v, tm = _models("nf_resnet50", 16, stem_strides=1)
    params = v["params"]
    convs = {n: m for n, m in tm.named_modules()
             if isinstance(m, ScaledWSConv)}
    assert len(convs) == 53
    @jax.jit
    def standardize(w, gain):
        fan_in = w.shape[0] * w.shape[1] * w.shape[2]
        return ((w - w.mean((0, 1, 2), keepdims=True))
                * jax.lax.rsqrt(w.var((0, 1, 2), keepdims=True) * fan_in
                                + 1e-4) * gain)

    for name, mod in convs.items():
        node = params
        for part in name.split("."):
            node = node[part]
        want = standardize(node["kernel"], node["gain"])
        got = mod.standardized().detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    w = convs["NFBottleneckBlock_0.ScaledWSConv_0"].kernel.detach()
    assert not torch.allclose(w.var((0, 1, 2)), w.var((0, 1, 2),
                                                       correction=0))


def test_nf_resnet_xla_and_pallas_compute_one_function():
    _, v, pallas = _models("nf_resnet50", 16, stem_strides=1,
                           conv_impl="pallas")
    xla = convert.nf_resnet_from_jax(v, ARCHS["nf_resnet50"](
        num_classes=N_CLASSES, dtype=torch.float32, stem_strides=1,
        device="cpu"))
    x, _ = _data(2, 16, seed=3)
    with torch.no_grad():
        np.testing.assert_allclose(pallas(torch.from_numpy(x)).numpy(),
                                   xla(torch.from_numpy(x)).numpy(), **TOL)


def test_nf_resnet_imagenet_stem_matches_flax():
    jm, v, tm = _models("nf_resnet50", 64, stem_strides=2)
    x, _ = _data(2, 64, seed=4)
    want = _jax_eval(jm, v, x)
    tm.eval()
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), want,
                                   **TOL)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("n,h,ci,co", [(2, 14, 32, 8), (1, 16, 16, 64)])
def test_nf_conv2d_grads_match_jax_interpret_kernels(n, h, ci, co, k):
    """``ops.conv2d``'s gradients at NF-ResNet's shapes (a 1x1 that narrows
    and one that widens, the 3x3) against JAX's Pallas kernels in interpret
    mode on the same dY."""
    rng = np.random.RandomState(k * 100 + h)
    x = rng.randn(n, h, h, ci).astype(np.float32)
    w = rng.randn(k, k, ci, co).astype(np.float32)
    dy = rng.randn(n, h, h, co).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    dx, dw = torch.autograd.grad(conv2d(xt, wt, 1), (xt, wt),
                                 torch.from_numpy(dy))
    want_dw = jcb.conv3x3_wgrad(jnp.asarray(x), jnp.asarray(dy), 1, ksize=k,
                                interpret=True)
    want_dx = jcb.conv3x3_dgrad(jnp.asarray(dy), jnp.asarray(w), x.shape, 1,
                                interpret=True)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **TOL)


# ---- stalebn / affine ----

def test_stalebn_two_steps_and_eval_match_flax():
    jm, v, tm = _models("resnet18", 16, stem_strides=1, norm="stalebn")
    names = {n for n, _ in tm.named_modules()}
    assert "BasicBlock_0.StaleBatchNorm_1" in names
    assert "BasicBlock_0.BatchNorm_0" not in names
    fn = _jax_grad_fn(jm, True)
    for step in range(2):
        x, y = _data(4, 16, seed=10 + step)
        # the first step normalises with the initial (0, 1), the second
        # each layer with statistics of the first step's unnormalised
        # input: activations grow through the 18 layers (logits ~300)
        stats = _assert_train_matches(jm, v, tm, x, y, scaled=True, fn=fn)
        v = {"params": v["params"], "batch_stats": stats}
    # the second step normalised with the first batch's statistics: the
    # stored pairs now differ (EMA vs the last batch)
    last = v["batch_stats"]["bn_init"]
    assert not np.allclose(last["mean"], last["last_mean"])
    x, _ = _data(3, 16, seed=12)
    want = _jax_eval(jm, v, x)
    tm.eval()
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), want,
                                   **TOL)


def test_affine_norm_matches_flax_and_has_no_buffers():
    jm, v, tm = _models("resnet18", 16, stem_strides=1, norm="affine")
    assert not list(tm.buffers())
    assert "BasicBlock_0.Affine_1.scale" in dict(tm.named_parameters())
    x, y = _data(4, 16, seed=13)
    _assert_train_matches(jm, v, tm, x, y)
    tm.eval()
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(),
                                   _jax_eval(jm, v, x),
                                   **TOL)


# ---- the convnets ----

def _rel_norm(got, want):
    """``‖got − want‖ / ‖want‖`` over every leaf of two flat dicts."""
    num = sum(float(np.square(got[k] - want[k]).sum()) for k in want)
    return (num / sum(float(np.square(w).sum()) for w in want.values())) ** 0.5


@pytest.mark.parametrize("arch", ["alex", "vgg16", "googlenet"])
def test_convnet_train_mode_matches_flax(arch):
    """Logits, loss and the running statistics at 1e-4.  The gradients are
    chaotic in fp32 here: a ReLU whose input sits within rounding of 0
    flips, and with a few hundred pixels a channel one flip moves that
    channel's gradients by ~1e-3 (a leaf's own gradient can move by ~1e-2
    of its norm when the images move by 1e-7).  So the whole gradient
    is held to 4x JAX's own change of it when the images move by +1e-7 or
    by -1e-7, the larger (at least 1e-4), measured in the same test; and
    each leaf to 4x the larger of that and its own change.  Which leaves a
    flip lands in is chance: one sign alone can miss a flip that the other
    finds (GoogLeNet's last block here: 1e-5 at +1e-7, 7e-3 at -1e-7), and
    torch's thread count moves its own, so a leaf's own change alone is no
    bound.  A leaf that is wrong (relative error ~1) fails all the same."""
    jm, v, tm = _models(arch, 16, stem_strides=1)
    x, y = _data(2, 16, seed=14)
    fn = _jax_grad_fn(jm, True)
    jl, jlog, jg, jstats = _jax_train(jm, v, x, y, fn)
    tl, tlog, tg, tstats = _torch_train(tm, x, y)
    np.testing.assert_allclose(tlog, jlog, **TOL)
    assert abs(tl - jl) <= 1e-4 * abs(jl)
    js = _flat(jstats)
    assert tstats.keys() == js.keys() and tg.keys() == jg.keys()
    for k in js:
        np.testing.assert_allclose(tstats[k], js[k], err_msg=k, **TOL)
    moved = [_jax_train(jm, v, x * np.float32(1 + e), y, fn)[2]
             for e in (1e-7, -1e-7)]
    chaos = max(_rel_norm(m, jg) for m in moved)
    assert _rel_norm(tg, jg) <= max(1e-4, 4 * chaos), chaos
    for k in jg:
        err = _rel_norm({k: tg[k]}, {k: jg[k]})
        own = max(_rel_norm({k: m[k]}, {k: jg[k]}) for m in moved)
        assert err <= max(1e-4, 4 * max(chaos, own)), (k, err, own, chaos)


@pytest.mark.parametrize("arch,image", [("alex", 67), ("vgg16", 32),
                                        ("googlenet", 64)])
def test_convnet_imagenet_stem_eval_matches_flax(arch, image):
    jm, v, tm = _models(arch, image, stem_strides=2)
    x, _ = _data(2, image, seed=15)
    tm.eval()
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(),
                                   _jax_eval(jm, v, x),
                                   **TOL)


@pytest.mark.parametrize("h,window,stride", [(8, 3, 2), (7, 3, 2),
                                             (8, 3, 1)])
def test_same_max_pool_pads_at_xla_split(h, window, stride):
    import flax.linen as nn

    x = np.random.RandomState(h).randn(2, h, h, 3).astype(np.float32)
    want = np.asarray(nn.max_pool(jnp.asarray(x), (window, window),
                                  strides=(stride, stride), padding="SAME"))
    got = max_pool(torch.from_numpy(x), window, stride, "SAME").numpy()
    np.testing.assert_array_equal(got, want)
    valid = np.asarray(nn.max_pool(jnp.asarray(x), (window, window),
                                   strides=(stride, stride)))
    np.testing.assert_array_equal(
        max_pool(torch.from_numpy(x), window, stride).numpy(), valid)


def test_alexnet_keeps_its_conv_biases():
    tm = ARCHS["alexnet"](num_classes=N_CLASSES, device="cpu")
    params = dict(tm.named_parameters())
    assert all(f"Conv_{i}.bias" in params for i in range(5))
    assert params["Dense_0.weight"].shape == (4096, 6 * 6 * 256)


# ---- ViT ----

@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("arch", ["vit_ti16", "vit_s16"])
def test_vit_matches_flax_fp32(arch, attn_impl):
    jm, v, tm = _models(arch, 64, depth=2, attn_impl=attn_impl)
    x, y = _data(2, 64, seed=16)
    _assert_train_matches(jm, v, tm, x, y)
    assert not list(tm.buffers())
    assert tuple(tm.pos_embed.shape) == (1, 17, tm.d_model)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_vit_matches_flax_bf16(attn_impl):
    jm, v, tm = _models("vit_ti16", 64, dtype=jnp.bfloat16, depth=2,
                        attn_impl=attn_impl)
    x, _ = _data(2, 64, seed=17)
    want = np.asarray(jm.apply(v, x, train=True), np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).float().numpy()
    assert np.abs(got - want).max() <= 4e-2 * np.abs(want).max()


def test_vit_rejects_an_image_below_the_patch_and_a_wrong_size():
    with pytest.raises(ValueError, match="smaller than patch"):
        ARCHS["vit_ti16"](image_size=8, device="cpu")
    tm = ARCHS["vit_ti16"](image_size=32, depth=1, device="cpu")
    with pytest.raises(ValueError, match="pos_embed"):
        tm(torch.zeros(1, 64, 64, 3))

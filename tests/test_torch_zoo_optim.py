"""The port's large-batch optimizers and the fp16 wire vs optax and JAX, on the CPU.

* ``optim.Lars``, ``optim.Lamb``, ``optim.AdaptiveGradClip`` and
  ``optim.Scheduled`` with ``optim.linear_schedule`` against optax 0.2.6's
  ``lars``, ``lamb``, ``adaptive_grad_clip`` and ``linear_schedule``, chained
  as ``examples/imagenet/train_imagenet.py`` chains them, on the parameter
  trees of a ResNet and an NF-ResNet at a quarter of their widths and a
  ViT at depth 1 (flax's init loaded into the
  port; JAX layouts on one side, the port's ``nn.Linear`` (out, in) on the
  other), 5 steps from the same numpy gradients (scaled leaf by leaf over
  four decades, so that the clip engages on some units and not others).
  Tolerance: parameters rtol 1e-5, with an atol of 1e-5 of the leaf's
  largest entry for the entries near 0 (the same elementwise arithmetic;
  the norms of the trust ratio and the clip sum in another order, which
  moves LAMB's steps of ~10% of |p| by ~1e-7 absolute).
* The fp16 gradient wire: ``compressed_mean`` at world 1 against JAX's
  rounding, and at world 2 (two gloo processes, ``tests/_torch_dp_worker.py``
  with ``wire/`` inputs) against JAX's ``compressed_mean`` under
  ``shard_map`` on two virtual devices, rtol 1e-3 (gloo sums fp16).
"""

import os
import subprocess
import sys
from functools import lru_cache, partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import chainermn_tpu as mn
from chainermn_tpu.models.resnet import ARCHS as JAX_ARCHS
from chainermn_tpu_torch import convert, optim
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.models import ARCHS
from chainermn_tpu_torch.optimizers import (compressed_mean,
                                            create_multi_node_optimizer)

ROOT = Path(__file__).resolve().parents[1]
STEPS, LR, WD, MOMENTUM = 5, 0.1, 1e-4, 0.9


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


@pytest.fixture(scope="module")
def comm1():
    comm = create_communicator("xla", device="cpu")
    yield comm
    dist.destroy_process_group()


_SMALL = {False: dict(stem_strides=1, num_filters=16), True: dict(depth=1)}


@lru_cache(maxsize=None)
def _flax_variables(arch):
    """flax's initial variables of ``arch`` at a small size (ViT at depth
    1, the ResNets at a quarter of their widths), as numpy."""
    kw = _SMALL[arch.startswith("vit")]
    jm = JAX_ARCHS[arch](num_classes=10, dtype=jnp.float32, **kw)
    v = jax.jit(partial(jm.init, train=False))(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 32, 32, 3)))
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    v.setdefault("batch_stats", {})
    return v


def _tree(arch):
    """flax params of ``arch`` at a small size and a port model holding
    them."""
    kw = dict(_SMALL[arch.startswith("vit")])
    if arch.startswith("vit"):
        kw["image_size"] = 32
    v = _flax_variables(arch)
    tm = ARCHS[arch](num_classes=10, dtype=torch.float32, device="cpu",
                     **kw)
    return v["params"], convert.resnet_from_jax(v, tm)


def _grads(params, step):
    """Gradients in the JAX layout, each leaf scaled by 10^U(-4, 0)."""
    rng = np.random.RandomState(100 + step)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(rng.randn(*np.shape(p))
                             * 10 ** rng.uniform(-4, 0), np.float32), params)


def _set_torch_grads(model, grads):
    flat = _flat(grads)
    for name, p in model.named_parameters():
        key = name.replace(".weight", ".kernel") if convert._dense(name) \
            else name
        g = flat[key.replace(".", "/")]
        p.grad = torch.from_numpy(g.T.copy() if convert._dense(name) else g)


def _jax_chain(name, warmup, agc):
    lr = optax.linear_schedule(0.0, LR, warmup) if warmup else LR
    if name == "lars":
        inner = optax.lars(lr, weight_decay=WD, momentum=MOMENTUM)
    elif name == "lamb":
        inner = optax.lamb(lr, weight_decay=WD)
    else:
        inner = optax.chain(optax.add_decayed_weights(WD),
                            optax.sgd(lr, momentum=MOMENTUM))
    return optax.chain(optax.adaptive_grad_clip(agc), inner) if agc else inner


def _port_chain(name, model, warmup, agc):
    from chainermn_tpu_torch.train_imagenet import make_optimizer

    return make_optimizer(model, name, LR, MOMENTUM, WD, warmup, agc)


CASES = [  # (arch, optimizer, warmup, agc)
    ("resnet18", "lars", 0, 0.0),
    ("resnet18", "lamb", 0, 0.0),
    ("resnet18", "lars", 2, 0.01),
    ("nf_resnet50", "lars", 0, 0.01),
    ("nf_resnet50", "lamb", 3, 0.01),
    ("resnet18", "sgd", 2, 0.01),
    ("vit_ti16", "lamb", 0, 0.01),
    ("vit_ti16", "lars", 2, 0.05),
    ("vit_ti16", "sgd", 3, 0.0),
]


@pytest.mark.parametrize("arch,name,warmup,agc", CASES)
def test_optimizer_chain_matches_optax(arch, name, warmup, agc):
    params, model = _tree(arch)
    chain = _jax_chain(name, warmup, agc)
    state = chain.init(params)
    opt = _port_chain(name, model, warmup, agc)
    jp = params

    @jax.jit
    def update(grads, state, p):
        updates, state = chain.update(grads, state, p)
        return optax.apply_updates(p, updates), state

    for step in range(STEPS):
        grads = _grads(params, step)
        jp, state = update(grads, state, jp)
        _set_torch_grads(model, grads)
        opt.step()
        opt.zero_grad()
        got = _flat(convert.resnet_to_numpy(model)["params"])
        want = _flat(jp)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(
                got[k], want[k], rtol=1e-5,
                atol=1e-5 * float(np.abs(want[k]).max()),
                err_msg=f"step {step} {k}")


def test_warmup_runs_step_zero_at_lr_zero():
    sched = optim.linear_schedule(0.0, LR, 4)
    want = optax.linear_schedule(0.0, LR, 4)
    for c in range(7):
        assert sched(c) == pytest.approx(float(want(c)), rel=1e-6, abs=1e-9)
    assert sched(0) == 0.0
    p = torch.ones(3, requires_grad=True)
    opt = optim.Scheduled(torch.optim.SGD([p], lr=LR), sched)
    p.grad = torch.ones(3)
    opt.step()
    assert torch.equal(p.detach(), torch.ones(3)) and opt.count == 1
    state = opt.state_dict()
    again = optim.Scheduled(torch.optim.SGD([p], lr=LR), sched)
    again.load_state_dict(state)
    assert again.count == 1


def test_agc_units_follow_the_jax_layout():
    """The clipping units of each leaf: optax's ``unitwise_norm`` on the
    JAX leaf equals the port's on its tensor (``nn.Linear`` transposed);
    ViT's ``cls`` (1, 1, D) is one unit, ``pos_embed`` (1, S, D) reduces
    its axis 0 (one unit an element), ``qkv`` (D, 3, H, Dh) reduces (0, 1,
    2)."""
    from optax.transforms._clipping import unitwise_norm

    params, model = _tree("vit_ti16")
    linear = {id(p) for p in optim.linear_weights(model)}
    flat = _flat(params)
    for name, p in model.named_parameters():
        key = name.replace(".weight", ".kernel") if convert._dense(name) \
            else name
        leaf = jnp.asarray(flat[key.replace(".", "/")])
        want = np.asarray(unitwise_norm(leaf))
        dims = optim.unit_dims(p.shape, id(p) in linear)
        got = optim._norm(p.detach(), dims).expand(p.shape).numpy()
        if convert._dense(name):
            got = got.T
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    assert optim.unit_dims((1, 1, 8)) is None
    assert optim.unit_dims((1, 17, 8)) == (0,)
    assert optim.unit_dims((8, 3, 2, 4)) == (0, 1, 2)
    assert optim.unit_dims(()) is None


def test_agc_clips_some_units_and_keeps_others():
    params, model = _tree("resnet18")
    _set_torch_grads(model, _grads(params, 0))
    before = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt = optim.AdaptiveGradClip(torch.optim.SGD(model.parameters(), lr=0.0),
                                 0.01, transposed=optim.linear_weights(model))
    opt.clip()
    changed = [not torch.equal(before[n], p.grad)
               for n, p in model.named_parameters()]
    assert any(changed) and not all(changed)
    with pytest.raises(ValueError):
        optim.AdaptiveGradClip(opt, -0.01)


def test_multi_node_optimizer_wraps_the_chain(comm1):
    """The clip sees the cross-rank mean: at world 1 the wrapped chain
    steps as the bare chain does."""
    params, model = _tree("resnet18")
    _, bare = _tree("resnet18")
    wrapped = create_multi_node_optimizer(
        _port_chain("lars", model, 2, 0.01), comm1)
    plain = _port_chain("lars", bare, 2, 0.01)
    for step in range(2):
        grads = _grads(params, step)
        for m, o in ((model, wrapped), (bare, plain)):
            _set_torch_grads(m, grads)
            o.step()
            o.zero_grad()
    for (n, a), b in zip(model.named_parameters(), bare.parameters()):
        assert torch.equal(a, b), n
    assert "optimizer" in wrapped.state_dict()


# ---- the fp16 wire ----

def _wire_grads(rank):
    rng = np.random.RandomState(7 + rank)
    return [rng.randn(3, 5).astype(np.float32) * 3,
            rng.randn(7).astype(np.float32) * 1e-3]


def test_fp16_wire_world_1_rounds_as_jax(comm1):
    grads = _wire_grads(0)
    got = compressed_mean([torch.from_numpy(g) for g in grads], comm1,
                          "float16")
    for g, t in zip(grads, got):
        want = np.asarray(jnp.asarray(g).astype(jnp.float16)
                          .astype(jnp.float32))
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), want)
    opt = create_multi_node_optimizer(
        torch.optim.SGD([torch.zeros(2, requires_grad=True)], lr=0.1), comm1,
        allreduce_grad_dtype="float16")
    assert opt.allreduce_grad_dtype == "float16"


def _jax_wire_mean(world):
    comm = mn.create_communicator("xla", size=world)
    stacked = [np.stack([_wire_grads(r)[i] for r in range(world)])
               for i in range(2)]

    spec = jax.sharding.PartitionSpec("mn")

    @partial(jax.shard_map, mesh=comm.mesh, in_specs=spec, out_specs=spec)
    def mean(a, b):
        out = mn.compressed_mean([a[0], b[0]], "mn", "float16")
        return out[0][None], out[1][None]

    return [np.asarray(x) for x in mean(*stacked)]


def test_fp16_wire_world_2_gloo_matches_jax(tmp_path):
    want = _jax_wire_mean(2)
    np.savez(tmp_path / "in.npz", **{f"wire/{r}/{i}": g for r in range(2)
                                     for i, g in enumerate(_wire_grads(r))})
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"     # two ranks beside other test workers
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dp_worker.py"),
         str(r), "2", str(tmp_path / "store"), str(tmp_path / "in.npz"),
         str(tmp_path / f"out{r}.npz")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)[-4000:]
    for r in range(2):
        with np.load(tmp_path / f"out{r}.npz") as z:
            for i in range(2):
                np.testing.assert_allclose(z[f"g{i}"], want[i][r],
                                           rtol=1e-3, atol=1e-7)
                assert z[f"g{i}"].dtype == np.float32

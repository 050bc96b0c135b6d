"""The port's training slice vs the JAX package's, on the CPU.

The same weights (JAX init, converted by ``chainermn_tpu_torch.convert``)
and the same numpy tokens go through JAX's ``tp_transformer_lm_loss``
(under ``shard_map`` on a ``(1, 1)`` ``('data', 'model')`` mesh, the flash
kernels in Pallas interpret mode, the fused CE in its shard-map
emulation) and through the port's, whose kernels take their plain versions
for CPU tensors.  Tolerances, fp32: the loss to rtol 1e-5 and every
gradient to atol 2e-5 / rtol 1e-4 (the same math summed in another order,
through two layers' backward); three optimizer steps, losses to rtol 1e-5
and parameters to atol 1e-4 (the order differences compound over steps).
"""

from functools import partial

import jax
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import chainermn_tpu as mn
from chainermn_tpu.parallel import init_tp_transformer_lm as jax_init
from chainermn_tpu.parallel import make_hybrid_shard_map_step as jax_step
from chainermn_tpu.parallel import shard_pytree, state_specs_like
from chainermn_tpu.parallel import tp_transformer_lm_loss as jax_loss
from chainermn_tpu.parallel import transformer_lm_specs
from chainermn_tpu_torch.convert import flatten, from_jax, to_numpy
from chainermn_tpu_torch.parallel import (make_hybrid_shard_map_step,
                                          param_leaves,
                                          tp_transformer_lm_loss)

VOCAB, D, HEADS, LAYERS, SEQ, BATCH = 64, 32, 4, 2, 16, 2
HEAD_DIM = D // HEADS


def _mesh():
    return mn.make_nd_mesh(("data", "model"), (1, 1), jax.devices()[:1])


def _model(pos_impl, seed=0, n_kv_heads=None):
    jp = jax_init(jax.random.PRNGKey(seed), VOCAB, D, HEADS, LAYERS,
                  max_len=SEQ, pos_impl=pos_impl, n_kv_heads=n_kv_heads)
    host = jax.tree_util.tree_map(np.asarray, jp)
    return host, from_jax(host, device="cpu")


def _tokens(seed=1):
    return np.random.RandomState(seed).randint(
        0, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)


def _jax_value_and_grad(params, toks, attn_impl, ce_impl):
    lf = partial(jax_loss, head_dim=HEAD_DIM, axis_name="model",
                 attn_impl=attn_impl, ce_impl=ce_impl)
    specs = transformer_lm_specs(params, "model")
    fn = jax.jit(shard_map(
        lambda p, t: jax.value_and_grad(lf)(p, (t,)), mesh=_mesh(),
        in_specs=(specs, P()), out_specs=(P(), specs), check_vma=False))
    loss, grads = fn(params, toks)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _torch_value_and_grad(params, toks, attn_impl, ce_impl):
    leaves = param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = tp_transformer_lm_loss(
        params, (torch.tensor(toks),), head_dim=HEAD_DIM,
        attn_impl=attn_impl, ce_impl=ce_impl)
    grads = torch.autograd.grad(loss, leaves)
    names = list(flatten(params))
    return float(loss.detach()), {n: g.numpy() for n, g in zip(names, grads)}


@pytest.mark.parametrize("pos_impl", ["learned", "rope"])
@pytest.mark.parametrize("ce_impl", ["xla", "fused"])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_loss_and_grads_match_jax(attn_impl, ce_impl, pos_impl):
    host, params = _model(pos_impl)
    toks = _tokens()
    want_loss, want = _jax_value_and_grad(host, toks, attn_impl, ce_impl)
    got_loss, got = _torch_value_and_grad(params, toks, attn_impl, ce_impl)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    want_flat = flatten(want)
    assert got.keys() == want_flat.keys()
    for name, g in got.items():
        np.testing.assert_allclose(g, want_flat[name], atol=2e-5, rtol=1e-4,
                                   err_msg=name)


def test_gqa_flash_fused_grads_match_jax():
    """Grouped KV heads through the flash backward's fp32 group fold."""
    host, params = _model("rope", seed=3, n_kv_heads=2)
    toks = _tokens(4)
    want_loss, want = _jax_value_and_grad(host, toks, "flash", "fused")
    got_loss, got = _torch_value_and_grad(params, toks, "flash", "fused")
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    for name, w in flatten(want).items():
        np.testing.assert_allclose(got[name], w, atol=2e-5, rtol=1e-4,
                                   err_msg=name)


def test_flash_grads_reach_the_qkv_weights():
    """The flash path is differentiable end to end: every weight gets a
    nonzero gradient (the forward kernel's output used to carry no
    ``grad_fn`` on the card)."""
    _, params = _model("learned", seed=5)
    _, grads = _torch_value_and_grad(params, _tokens(6), "flash", "fused")
    for name, g in grads.items():
        assert np.abs(g).sum() > 0, name


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_three_steps_match_jax(opt_name):
    """``make_hybrid_shard_map_step``, three steps on the same batch:
    optax.sgd / optax.adam vs torch.optim.SGD / Adam."""
    host, params = _model("learned", seed=7)
    toks = _tokens(8)
    lr = 1e-2
    kw = dict(head_dim=HEAD_DIM, attn_impl="flash", ce_impl="fused")
    opt = optax.sgd(lr) if opt_name == "sgd" else optax.adam(lr)
    mesh = _mesh()
    specs = transformer_lm_specs(host, "model")
    jstep = jax_step(partial(jax_loss, axis_name="model", **kw), opt, mesh,
                     host, specs, donate=False)
    jp = shard_pytree(host, mesh, specs)
    st = shard_pytree(opt.init(host), mesh, state_specs_like(opt, host, specs))
    want = []
    for _ in range(3):
        jp, st, loss = jstep(jp, st, (toks,))
        want.append(float(loss))

    leaves = param_leaves(params)
    topt = (torch.optim.SGD(leaves, lr=lr) if opt_name == "sgd"
            else torch.optim.Adam(leaves, lr=lr))
    step = make_hybrid_shard_map_step(partial(tp_transformer_lm_loss, **kw),
                                      topt, params)
    batch = (torch.tensor(toks),)
    got = [float(step(params, batch)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    jflat = flatten(jax.tree_util.tree_map(np.asarray, jp))
    # The key bias shifts every score of a softmax row by the same amount,
    # so its exact gradient is zero and both packages hold only rounding
    # noise there; Adam scales that noise up to +-lr with an arbitrary
    # sign.  Its columns of bqkv are left out of the Adam comparison.
    k_cols = (np.arange(3 * D).reshape(HEADS, 3, HEAD_DIM)[:, 1] if
              opt_name == "adam" else np.zeros((0,), int)).ravel()
    for name, t in flatten(to_numpy(params)).items():
        w = jflat[name]
        if name.endswith("bqkv"):
            t, w = np.delete(t, k_cols), np.delete(w, k_cols)
        np.testing.assert_allclose(t, w, atol=1e-4, err_msg=name)


def test_step_rejects_an_optimizer_over_other_tensors():
    _, params = _model("learned")
    opt = torch.optim.SGD([torch.zeros(3, requires_grad=True)], lr=0.1)
    with pytest.raises(ValueError, match="param_leaves"):
        make_hybrid_shard_map_step(lambda p, b: 0, opt, params)


def test_bad_ce_impl_raises():
    _, params = _model("learned")
    with pytest.raises(ValueError, match="ce_impl"):
        tp_transformer_lm_loss(params, (torch.tensor(_tokens()),),
                               head_dim=HEAD_DIM, ce_impl="nope")


def test_bf16_loss_tracks_fp32():
    """bf16 weights through flash + fused CE: the loss within 2e-2 of the
    fp32 loss of the same (rounded) weights."""
    host, _ = _model("learned", seed=9)
    toks = (torch.tensor(_tokens(10)),)
    p16 = from_jax(host, device="cpu", dtype=torch.bfloat16)
    p32 = from_jax(to_numpy(p16), device="cpu")
    kw = dict(head_dim=HEAD_DIM, attn_impl="flash", ce_impl="fused")
    with torch.no_grad():
        l16 = float(tp_transformer_lm_loss(p16, toks, **kw))
        l32 = float(tp_transformer_lm_loss(p32, toks, **kw))
    np.testing.assert_allclose(l16, l32, rtol=2e-2)

"""The port's conv backward vs the JAX package's, on the CPU.

The same numpy inputs (from a seed) go through JAX's ``conv3x3_wgrad`` /
``conv3x3_dgrad`` (Pallas interpret mode, as ``tests/test_conv_backward.py``
runs them) or ``jax.vjp`` of ``_xla_conv``, and through the port's wrappers,
which take their plain versions for CPU tensors.  Tolerances: fp32 atol =
rtol = 1e-4 (the same sums in another order); bf16 inputs with fp32
accumulation, one bf16 rounding of the result apart: rtol 1e-2 (two bf16
ulps), atol 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops import conv_backward as jcb
from chainermn_tpu_torch.ops import conv_backward as tcb
from chainermn_tpu_torch.ops import (conv2d, conv3x3_dgrad, conv3x3_wgrad)

# JAX's own parity shapes (tests/test_conv_backward.py:31-36), then a
# non-multiple-of-8 plane (14 x 14 = 196 rows) and more images
SHAPES = [
    (2, 8, 8, 8, 16),
    (4, 6, 6, 16, 8),
    (1, 10, 8, 8, 8),
    (2, 7, 5, 8, 8),
    (2, 14, 14, 16, 24),
    (6, 5, 9, 8, 8),
]
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=1e-2, atol=1e-2)


def _inputs(n, h, w, ci, co, k=3, stride=1, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, ci).astype(np.float32)
    wt = rng.randn(k, k, ci, co).astype(np.float32)
    dy = rng.randn(n, -(-h // stride), -(-w // stride), co).astype(np.float32)
    return x, wt, dy


def _bf16(a):
    return (jnp.asarray(a, jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("n,h,w_,ci,co", SHAPES)
def test_wgrad_plain_matches_jax(n, h, w_, ci, co, k):
    x, _, dy = _inputs(n, h, w_, ci, co, k)
    want = jcb.conv3x3_wgrad(jnp.asarray(x), jnp.asarray(dy), 1, ksize=k,
                             interpret=True)
    got = conv3x3_wgrad(torch.from_numpy(x), torch.from_numpy(dy), 1, ksize=k)
    assert got.shape == (k, k, ci, co) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("n,h,w_,ci,co", SHAPES)
def test_dgrad_plain_matches_jax(n, h, w_, ci, co, k):
    x, wt, dy = _inputs(n, h, w_, ci, co, k)
    want = jcb.conv3x3_dgrad(jnp.asarray(dy), jnp.asarray(wt), x.shape, 1,
                             interpret=True)
    got = conv3x3_dgrad(torch.from_numpy(dy), torch.from_numpy(wt), x.shape, 1)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("n,h,w_,ci,co", [SHAPES[0], SHAPES[3], SHAPES[4]])
def test_bf16_inputs_accumulate_in_fp32(n, h, w_, ci, co):
    """bf16 in, fp32 sums, one rounding to bf16: against JAX's kernels on
    the same bf16 inputs, and both far closer to the fp32 result of the
    rounded inputs than a bf16 accumulation over 9·n·h·w terms would be."""
    x, wt, dy = _inputs(n, h, w_, ci, co, seed=3)
    (jx, tx), (jw, tw), (jdy, tdy) = _bf16(x), _bf16(wt), _bf16(dy)
    dw = conv3x3_wgrad(tx, tdy)
    dx = conv3x3_dgrad(tdy, tw, x.shape)
    assert dw.dtype == dx.dtype == torch.bfloat16
    jdw = jcb.conv3x3_wgrad(jx, jdy, 1, interpret=True)
    jdx = jcb.conv3x3_dgrad(jdy, jw, x.shape, 1, interpret=True)
    np.testing.assert_allclose(dw.float().numpy(),
                               np.asarray(jdw, np.float32), **BF16)
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx, np.float32), **BF16)
    exact_w = tcb.conv3x3_wgrad_plain(tx.float(), tdy.float())
    exact_x = tcb.conv3x3_dgrad_plain(tdy.float(), tw.float(), x.shape)
    np.testing.assert_allclose(dw.float().numpy(), exact_w.numpy(),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(dx.float().numpy(), exact_x.numpy(),
                               rtol=1e-2, atol=1e-2)


def _jax_vjp(x, wt, dy, stride):
    _, vjp = jax.vjp(lambda a, b: jcb._xla_conv(a, b, stride),
                     jnp.asarray(x), jnp.asarray(wt))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


@pytest.mark.parametrize("case", [
    # (n, h, w, ci, co, k, stride): eligible 3x3 and 1x1 on a >= 196 plane,
    # then the fallbacks: stride 2 (asymmetric SAME pad at an even plane,
    # symmetric at an odd one), a 7 x 7 plane, a 7 x 7 kernel
    (2, 14, 14, 8, 16, 3, 1),
    (1, 16, 13, 16, 8, 1, 1),
    (2, 14, 14, 8, 16, 3, 2),
    (2, 15, 15, 8, 8, 3, 2),
    (2, 16, 16, 8, 16, 1, 2),
    (2, 7, 7, 16, 8, 3, 1),
    (2, 16, 16, 3, 8, 7, 2),
])
def test_conv2d_gradients_match_jax_vjp(case):
    n, h, w_, ci, co, k, s = case
    x, wt, dy = _inputs(n, h, w_, ci, co, k, s, seed=7)
    want_y = np.asarray(jcb._xla_conv(jnp.asarray(x), jnp.asarray(wt), s))
    want_dx, want_dw = _jax_vjp(x, wt, dy, s)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(wt).requires_grad_()
    y = conv2d(tx, tw, s)
    assert y.is_contiguous() and y.shape == want_y.shape
    np.testing.assert_allclose(y.detach().numpy(), want_y, **F32)
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(dy))
    np.testing.assert_allclose(dx.numpy(), want_dx, **F32)
    np.testing.assert_allclose(dw.numpy(), want_dw, **F32)


def test_conv2d_backward_takes_the_wrappers_only_where_eligible(monkeypatch):
    calls = []
    real_w, real_d = tcb.conv3x3_wgrad, tcb.conv3x3_dgrad
    monkeypatch.setattr(tcb, "conv3x3_wgrad",
                        lambda *a, **k: calls.append("w") or real_w(*a, **k))
    monkeypatch.setattr(tcb, "conv3x3_dgrad",
                        lambda *a, **k: calls.append("d") or real_d(*a, **k))
    for h, s, k, want in ((14, 1, 3, ["d", "w"]), (14, 2, 3, []),
                          (7, 1, 3, []), (14, 1, 1, ["d", "w"])):
        calls.clear()
        x, wt, _ = _inputs(1, h, h, 8, 8, k, s)
        tx = torch.from_numpy(x).requires_grad_()
        conv2d(tx, torch.from_numpy(wt).requires_grad_(), s).sum().backward()
        assert calls == want, (h, s, k)


def test_same_pad_and_eligible_equal_jax():
    for h in range(1, 60):
        for k in (1, 3, 5, 7):
            for s in (1, 2, 3):
                assert tcb._same_pad(h, k, s) == jcb._same_pad(h, k, s)
    for h, w_ in ((7, 7), (14, 14), (13, 15), (14, 13), (56, 56), (28, 7)):
        for kshape in ((3, 3), (1, 1), (7, 7), (3, 1)):
            for s in (1, 2):
                xs, ws = (8, h, w_, 16), kshape + (16, 32)
                assert tcb._eligible(xs, ws, s) == jcb._eligible(xs, ws, s)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(1, 14, 14, 8)
    dy = torch.zeros(1, 14, 14, 8)
    with pytest.raises(ValueError, match="stride 1"):
        conv3x3_wgrad(x, dy, 2)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        conv3x3_wgrad(x.permute(0, 2, 1, 3), dy)
    with pytest.raises(ValueError, match="k in"):
        conv3x3_wgrad(x, dy, 1, ksize=5)
    with pytest.raises(ValueError, match="does not match"):
        conv3x3_dgrad(dy, torch.zeros(3, 3, 4, 8), x.shape)


def test_wgrad_splits_cover_every_pixel_step():
    for p in (1, 31, 32, 33, 196 * 2, 401408, 100352, 25088):
        for tiles, taps in ((1, 9), (16, 9), (4, 1), (64, 9)):
            per, splits = tcb._wgrad_splits(p, tiles, taps)
            steps = -(-p // 32)
            assert per * splits >= steps > per * (splits - 1)
            assert splits <= 65535

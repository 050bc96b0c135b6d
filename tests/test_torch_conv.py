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
from chainermn_tpu_torch.ops import _build
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


# ---------------------------------------------------------------------------
# the bf16 wgrad kernel's plan and schedule (csrc/conv_backward.cu runs only
# on the card): boxes of one image at the tap's shifted coordinates, zero
# off the plane, rows padded to the wgmma depth, the two consumers'
# alternate boxes summed, one fp32 slice per split, the slices summed in
# split order and rounded once
# ---------------------------------------------------------------------------

RESNET_SHAPES = [(56, 56, 64, 64), (28, 28, 128, 128), (14, 14, 256, 256)]
SMS = 132                       # the H100 SXM's streaming multiprocessors


def _geometry(p, n, h, w_):
    """What ``launch_wgrad_bf16`` derives from the plan: boxes per image
    (``nh`` x ``nw``), the box's pixel rows rounded up to the wgmma depth
    (``rows16``) and the boxes in all (``steps``)."""
    nh, nw = -(-h // p["box_h"]), -(-w_ // p["box_w"])
    return {"nh": nh, "nw": nw, "steps": n * nh * nw,
            "rows16": -(-(p["box_h"] * p["box_w"]) // 16) * 16}


@pytest.mark.parametrize("n,h,w_,ci,co,k", [
    (128, 56, 56, 64, 64, 3), (128, 28, 28, 128, 128, 3),
    (128, 14, 14, 256, 256, 3), (128, 56, 56, 64, 256, 1),
    (2, 7, 5, 8, 8, 3), (3, 9, 11, 12, 20, 3), (2, 15, 13, 36, 44, 1),
    (1, 300, 300, 8, 8, 3), (1, 1, 1, 8, 300, 1)])
def test_wgrad_plan_covers_every_pixel_once(n, h, w_, ci, co, k):
    p = tcb._wgrad_plan(n, h, w_, ci, co, k, SMS)
    g = _geometry(p, n, h, w_)
    assert p["ci_pad"] % 8 == 0 and 0 <= p["ci_pad"] - ci < 8
    assert p["co_pad"] % 8 == 0 and 0 <= p["co_pad"] - co < 8
    assert p["tile_n"] == min(t for t in (64, 128, 256)
                              if t >= min(p["co_pad"], 256))
    # the boxes tile each image exactly: no pixel twice, none left out
    assert (g["nh"] - 1) * p["box_h"] < h <= g["nh"] * p["box_h"]
    assert (g["nw"] - 1) * p["box_w"] < w_ <= g["nw"] * p["box_w"]
    assert g["rows16"] <= tcb._BOX_PIXELS[p["tile_n"]]
    assert p["per"] * p["splits"] >= g["steps"] > p["per"] * (p["splits"] - 1)
    tiles = k * k * -(-p["ci_pad"] // 64) * -(-p["co_pad"] // p["tile_n"])
    assert tiles * p["splits"] <= max(tiles, 2 * SMS)   # about two waves


def test_wgrad_plan_at_resnet50_shapes():
    """One co tile, 112 / 112 / 56-pixel boxes, about two waves."""
    got = [tcb._wgrad_plan(128, h, w_, ci, co, 3, SMS)
           for h, w_, ci, co in RESNET_SHAPES]
    assert [(p["tile_n"], p["box_h"], p["box_w"]) for p in got] == [
        (64, 2, 56), (128, 4, 28), (256, 4, 14)]
    assert [_geometry(p, 128, h, w_)["rows16"] for p, (h, w_, _, _)
            in zip(got, RESNET_SHAPES)] == [112, 112, 64]
    blocks = [9 * -(-ci // 64) * p["splits"]                  # one co tile
              for p, (_, _, ci, _) in zip(got, RESNET_SHAPES)]
    assert blocks == [261, 252, 252]


def _box(t, img, h0, w0, bh, bw, rows16):
    """A (box_h x box_w) box of image ``img`` at (h0, w0) as rows16 x C
    fp32 rows, zero off the plane and past the box."""
    n, h, w_, c = t.shape
    out = torch.zeros(bh, bw, c)
    hs, ws = slice(max(h0, 0), min(h0 + bh, h)), slice(max(w0, 0),
                                                      min(w0 + bw, w_))
    if hs.start < hs.stop and ws.start < ws.stop:
        out[hs.start - h0:hs.stop - h0, ws.start - w0:ws.stop - w0] = \
            t[img, hs, ws].float()
    flat = torch.zeros(rows16, c)
    flat[:bh * bw] = out.reshape(-1, c)
    return flat


def _emulate_wgrad(x, dy, k):
    n, h, w_, ci = x.shape
    co = dy.shape[-1]
    p = tcb._wgrad_plan(n, h, w_, ci, co, k, SMS)
    g = _geometry(p, n, h, w_)
    xp, dyp = _build.tma_operand(x, p["ci_pad"]), _build.tma_operand(dy,
                                                                p["co_pad"])
    pad = (k - 1) // 2
    ws = torch.zeros(p["splits"], k * k, p["ci_pad"], p["co_pad"])
    for split in range(p["splits"]):
        i0 = split * p["per"]
        boxes = range(i0, min(g["steps"], i0 + p["per"]))
        for tap in range(k * k):
            dh, dw = tap // k - pad, tap % k - pad
            part = [torch.zeros(p["ci_pad"], p["co_pad"]) for _ in range(2)]
            for kt, step in enumerate(boxes):        # consumers alternate
                r, wi = divmod(step, g["nw"])
                img, hi = divmod(r, g["nh"])
                h0, w0 = hi * p["box_h"], wi * p["box_w"]
                a = _box(xp, img, h0 + dh, w0 + dw, p["box_h"], p["box_w"],
                         g["rows16"])
                b = _box(dyp, img, h0, w0, p["box_h"], p["box_w"],
                         g["rows16"])
                part[kt % 2] += a.t() @ b
            ws[split, tap] = part[0] + part[1]
    dw_ = torch.zeros_like(ws[0])
    for split in range(p["splits"]):             # the reduce's fixed order
        dw_ += ws[split]
    return dw_.reshape(k, k, p["ci_pad"], p["co_pad"])[:, :, :ci, :co] \
        .to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w_,ci,co,k", [
    (1,) + RESNET_SHAPES[0] + (3,), (1,) + RESNET_SHAPES[1] + (3,),
    (1,) + RESNET_SHAPES[2] + (3,), (2, 14, 14, 16, 24, 1),
    (3, 9, 11, 12, 20, 3), (2, 15, 13, 36, 44, 1)])
def test_wgrad_schedule_matches_jax_and_plain(n, h, w_, ci, co, k, dtype):
    x, _, dy = _inputs(n, h, w_, ci, co, k, seed=11)
    tx, tdy = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    got = _emulate_wgrad(tx, tdy, k)
    assert got.shape == (k, k, ci, co) and got.dtype == dtype
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jcb.conv3x3_wgrad(jnp.asarray(tx.float().numpy(), jd),
                             jnp.asarray(tdy.float().numpy(), jd), 1,
                             ksize=k, interpret=True)
    tol = F32 if dtype == torch.float32 else BF16
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol["rtol"], atol=tol["atol"] * scale)
    ref = conv3x3_wgrad(tx, tdy, 1, ksize=k)       # the plain version
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                               rtol=tol["rtol"], atol=tol["atol"] * scale)


# ---------------------------------------------------------------------------
# the bf16 dgrad kernel's plan and schedule (csrc/conv_backward.cu runs only
# on the card): a box of dX pixels of one image and a ci tile a block, the
# dY box read at each tap's shifted coordinates (zero off the plane), the W
# panel of the tap (rows past Ci: the next tap's), one fp32 accumulator
# over taps x 64-channel Co panels, rows past the box and columns past Ci
# not stored, the pad channels dropped
# ---------------------------------------------------------------------------

DGRAD_SHAPES = [
    (128, 56, 56, 64, 64, 3), (128, 28, 28, 128, 128, 3),
    (128, 14, 14, 256, 256, 3), (128, 56, 56, 64, 256, 1),
    (2, 7, 5, 8, 8, 3), (3, 9, 11, 12, 20, 3), (2, 15, 13, 36, 44, 1),
    (1, 300, 300, 8, 8, 3), (1, 1, 1, 8, 300, 1), (4, 14, 14, 64, 64, 3),
    (1, 56, 56, 64, 64, 3), (2, 14, 14, 16, 24, 1), (1, 14, 14, 520, 8, 3)]


def _dgrad_geometry(p, n, h, w_):
    nh, nw = -(-h // p["box_h"]), -(-w_ // p["box_w"])
    return {"nh": nh, "nw": nw, "boxes": n * nh * nw,
            "ci_tiles": -(-p["ci_pad"] // p["tile_n"])}


@pytest.mark.parametrize("n,h,w_,ci,co,k", DGRAD_SHAPES)
def test_dgrad_plan_covers_every_pixel_once(n, h, w_, ci, co, k):
    p = tcb._dgrad_plan(n, h, w_, ci, co)
    g = _dgrad_geometry(p, n, h, w_)
    assert p["ci_pad"] % 8 == 0 and 0 <= p["ci_pad"] - ci < 8
    assert p["co_pad"] % 8 == 0 and 0 <= p["co_pad"] - co < 8
    assert p["tile_n"] == min(t for t in (64, 128, 256)
                              if t >= min(p["ci_pad"], 256))
    assert p["tile_m"] == (256 if p["tile_n"] <= 128 else 128)
    assert p["box_h"] * p["box_w"] <= p["tile_m"]
    assert 1 <= p["box_h"] <= 256 and 1 <= p["box_w"] <= 256
    # the boxes tile each image exactly: every pixel once
    seen = torch.zeros(g["nh"] * p["box_h"], g["nw"] * p["box_w"],
                       dtype=torch.int32)
    for r in range(g["nh"]):
        for c in range(g["nw"]):
            seen[r * p["box_h"]:(r + 1) * p["box_h"],
                 c * p["box_w"]:(c + 1) * p["box_w"]] += 1
    assert (seen == 1).all()
    assert (g["nh"] - 1) * p["box_h"] < h and (g["nw"] - 1) * p["box_w"] < w_
    assert p["rows_used"] == n * h * w_ / (g["boxes"] * p["tile_m"])


def test_dgrad_plan_at_resnet50_shapes():
    """One ci tile; 4 x 56 / 7 x 28 / 7 x 14 boxes: 224 of 256, 196 of 256
    and 98 of 128 rows used; the 256-row tile wherever the ci tile allows
    it, as each W panel then serves twice the pixels."""
    got = [tcb._dgrad_plan(128, h, w_, ci, co)
           for h, w_, ci, co in RESNET_SHAPES]
    assert [(p["tile_n"], p["tile_m"], p["box_h"], p["box_w"])
            for p in got] == [(64, 256, 4, 56), (128, 256, 7, 28),
                              (256, 128, 7, 14)]
    assert [p["rows_used"] for p in got] == [0.875, 0.765625, 0.765625]
    assert [_dgrad_geometry(p, 128, h, w_)["boxes"] for p, (h, w_, _, _)
            in zip(got, RESNET_SHAPES)] == [1792, 512, 256]


def test_dgrad_plan_reads_the_fewer_operand_rows():
    """At 28² x 128 the 128-row tile computes fewer rows (112 of 128 used)
    but reads 7 x (112 + 128) dY and W rows a k step per image against the
    256-row tile's 4 x (196 + 128)."""
    p = tcb._dgrad_plan(128, 28, 28, 128, 128)
    assert p["tile_m"] == 256 and 4 * (196 + 128) < 7 * (112 + 128)


def _emulate_dgrad(dy, w, xshape):
    n, h, w_, ci = xshape
    co, k = dy.shape[-1], w.shape[0]
    p = tcb._dgrad_plan(n, h, w_, ci, co)
    g = _dgrad_geometry(p, n, h, w_)
    cp, kc = p["ci_pad"], -(-p["co_pad"] // 64)
    # TMA's zero fill past Co in both operands: a whole last 64-co panel
    dyp = torch.zeros(n, h, w_, 64 * kc)
    dyp[..., :co] = dy.float()
    wm = torch.zeros(k * k * cp, 64 * kc)           # W as (k*k*Ci, Co)
    wm.view(k, k, cp, 64 * kc)[:, :, :ci, :co] = w.float()
    pad, tn, bh, bw = (k - 1) // 2, p["tile_n"], p["box_h"], p["box_w"]
    dx = torch.zeros(n, h, w_, cp)
    for box in range(g["boxes"]):
        r, wi = divmod(box, g["nw"])
        img, hi = divmod(r, g["nh"])
        h0, w0 = hi * bh, wi * bw
        for tile in range(g["ci_tiles"]):
            ci0 = tile * tn
            acc = torch.zeros(p["tile_m"], tn)
            for tap in range(k * k):
                dh, dw = tap // k - pad, tap % k - pad
                a = _box(dyp, img, h0 - dh, w0 - dw, bh, bw, p["tile_m"])
                b = torch.zeros(tn, 64 * kc)      # rows past the map: zeros
                rows = wm[tap * cp + ci0:tap * cp + ci0 + tn]
                b[:rows.shape[0]] = rows
                for c in range(kc):               # the 64-deep k steps
                    panel = slice(64 * c, 64 * c + 64)
                    acc += a[:, panel] @ b[:, panel].t()
            for i in range(bh * bw):              # rows past the box: unused
                y, x = h0 + i // bw, w0 + i % bw
                if y < h and x < w_:
                    ncol = min(tn, cp - ci0)
                    dx[img, y, x, ci0:ci0 + ncol] = acc[i, :ncol]
    return dx[..., :ci].to(dy.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w_,ci,co,k", [
    (1,) + RESNET_SHAPES[0] + (3,), (1,) + RESNET_SHAPES[1] + (3,),
    (1,) + RESNET_SHAPES[2] + (3,), (1, 14, 14, 520, 8, 3),
    (2, 14, 14, 16, 24, 1), (3, 9, 11, 12, 20, 3), (2, 15, 13, 36, 44, 1)])
def test_dgrad_schedule_matches_jax_and_plain(n, h, w_, ci, co, k, dtype):
    """The three ResNet-50 shapes at n = 1, three 256-wide ci tiles with a
    ragged last one, a 1x1 at 14² x 16 → 24 and channels off 8."""
    x, wt, dy = _inputs(n, h, w_, ci, co, k, seed=13)
    tw, tdy = torch.from_numpy(wt).to(dtype), torch.from_numpy(dy).to(dtype)
    got = _emulate_dgrad(tdy, tw, x.shape)
    assert got.shape == x.shape and got.dtype == dtype
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jcb.conv3x3_dgrad(jnp.asarray(tdy.float().numpy(), jd),
                             jnp.asarray(tw.float().numpy(), jd), x.shape, 1,
                             interpret=True)
    tol = F32 if dtype == torch.float32 else BF16
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol["rtol"], atol=tol["atol"] * scale)
    ref = conv3x3_dgrad(tdy, tw, x.shape)          # the plain version
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                               rtol=tol["rtol"], atol=tol["atol"] * scale)

"""Convolution backward for 3x3 / 1x1 stride-1 SAME convs: hand-written Hopper kernels and their plain versions.

Counterpart of ``chainermn_tpu/ops/conv_backward.py``.  Layouts are JAX's:
activations NHWC (contiguous ``(N, H, W, C)`` tensors; a ``channels_last``
``(N, C, H, W)`` tensor's ``permute(0, 2, 3, 1)`` is one, without a copy),
weights HWIO.

* ``conv3x3_wgrad(x (N,H,W,Ci), dy (N,H,W,Co), ksize=3|1)`` → ``dW (k,k,Ci,Co)``:
  fp32 sums rounded to ``x.dtype``;
* ``conv3x3_dgrad(dy, w (k,k,Ci,Co), xshape)`` → ``dX (N,H,W,Ci)``: fp32 sums
  over every tap rounded to ``dy.dtype``;
* ``conv2d(x, w, stride)``: a SAME conv (XLA's split of the padding, which
  is asymmetric for stride 2 at an even plane) whose forward is
  ``F.conv2d`` and whose backward runs the two kernels where
  :func:`_eligible` holds and ``F.conv2d``'s own backward elsewhere.

On a CUDA tensor the wrappers launch ``csrc/conv_backward.cu``
(``conv_wgrad``, ``conv_dgrad``); on a CPU tensor they take the plain
versions, the k·k-tap sum of shifted matmuls that the TPU kernels compute.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

_BM = _BN = 64          # the kernels' output tile
_BK = 32                # pixels per reduction step (wgrad)
_TARGET_BLOCKS = 528    # ~4 resident blocks on each of the H100's 132 SMs


def _same_pad(h: int, k: int, s: int) -> Tuple[int, int]:
    """XLA SAME padding (lo, hi) for one spatial dim."""
    out = -(-h // s)
    total = max((out - 1) * s + k - h, 0)
    return total // 2, total - total // 2


def _eligible(xshape, wshape, stride) -> bool:
    """The shapes whose backward runs the kernels: a 3x3 or 1x1 kernel,
    stride 1, a plane of at least 196 pixels (JAX's rule, shape only)."""
    kh, kw = wshape[:2]
    if (kh, kw) not in ((3, 3), (1, 1)) or stride != 1:
        return False
    return xshape[1] * xshape[2] >= 196


def _check_nhwc(t, what):
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous NHWC tensor (a "
                         f"channels_last tensor's permute(0, 2, 3, 1)), got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")


def _check_args(xshape, dyshape, k, stride):
    if stride != 1:
        raise ValueError("the conv backward kernels take stride 1 only")
    if k not in (1, 3):
        raise ValueError(f"the conv backward kernels take k in (1, 3), got {k}")
    if tuple(xshape[:3]) != tuple(dyshape[:3]):
        raise ValueError(f"x {tuple(xshape)} and dy {tuple(dyshape)} differ "
                         f"in (N, H, W)")


def _is_cuda(t, what):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, got {t.device}")
    return t.device.type == "cuda"


def _taps(k):
    return [(kh, kw) for kh in range(k) for kw in range(k)]


def conv3x3_wgrad_plain(x, dy, stride: int = 1, ksize: int = 3):
    """``dW[kh, kw] = Σ_p X[p + (dh, dw)]ᵀ dY[p]`` tap by tap in fp32, X
    rounded to dY's dtype first (JAX's cast before the dot)."""
    _check_args(x.shape, dy.shape, ksize, stride)
    n, h, w, ci = x.shape
    pad = (ksize - 1) // 2
    xp = F.pad(x.to(dy.dtype).float(), (0, 0, pad, pad, pad, pad))
    dyf = dy.float().reshape(-1, dy.shape[-1])
    out = torch.empty((ksize, ksize, ci, dy.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for kh, kw in _taps(ksize):
        xs = xp[:, kh:kh + h, kw:kw + w, :].reshape(-1, ci)
        out[kh, kw] = xs.t() @ dyf
    return out.to(x.dtype)


def conv3x3_dgrad_plain(dy, w, xshape, stride: int = 1):
    """``dX[p] = Σ_taps dY[p − (dh, dw)] W[kh, kw]ᵀ`` in fp32, dY rounded to
    W's dtype first (JAX's cast before the dot)."""
    k = w.shape[0]
    n, h, ww, ci = xshape
    if tuple(w.shape) != (k, k, ci, dy.shape[-1]):
        raise ValueError(f"w {tuple(w.shape)} is not ({k}, {k}, {ci}, "
                         f"{dy.shape[-1]})")
    _check_args(xshape, dy.shape, k, stride)
    pad = (k - 1) // 2
    dyp = F.pad(dy.to(w.dtype).float(), (0, 0, pad, pad, pad, pad))
    wf = w.float()
    acc = torch.zeros((n, h, ww, ci), dtype=torch.float32, device=dy.device)
    for kh, kw in _taps(k):
        # dY[h − dh] sits at row h − dh + pad = h + 2·pad − kh of the padding
        s_h, s_w = 2 * pad - kh, 2 * pad - kw
        acc += dyp[:, s_h:s_h + h, s_w:s_w + ww, :] @ wf[kh, kw].t()
    return acc.to(dy.dtype)


def _wgrad_splits(p, tiles, taps):
    """``(steps_per_split, splits)``: pixel steps of 32 per split, so that
    about ``_TARGET_BLOCKS`` blocks run and every split is non-empty."""
    steps = -(-p // _BK)
    want = max(1, min(steps, -(-_TARGET_BLOCKS // (tiles * taps))))
    per = -(-steps // want)
    return per, -(-steps // per)


def _wgrad_cuda(x, dy, k):
    if x.dtype != dy.dtype:
        raise ValueError(f"conv_wgrad takes x and dy of one dtype, got "
                         f"{x.dtype}, {dy.dtype}")
    code = _build.dtype_code(x.dtype)
    n, h, w, ci = x.shape
    co = dy.shape[-1]
    tiles = -(-ci // _BM) * -(-co // _BN)
    per, splits = _wgrad_splits(n * h * w, tiles, k * k)
    out = torch.empty((k, k, ci, co), dtype=x.dtype, device=x.device)
    work = torch.empty((splits, k * k, ci, co), dtype=torch.float32,
                       device=x.device)
    err = _build.library("conv_backward").conv_wgrad(
        x.data_ptr(), dy.data_ptr(), out.data_ptr(), work.data_ptr(), n, h, w,
        ci, co, k, per, splits, code, _build.stream_handle(x))
    _build.check(err, "conv_wgrad")
    return out


def _dgrad_cuda(dy, w, xshape):
    if w.dtype != dy.dtype:
        raise ValueError(f"conv_dgrad takes dy and w of one dtype, got "
                         f"{dy.dtype}, {w.dtype}")
    if not w.is_contiguous():
        raise ValueError("conv_dgrad needs a contiguous HWIO weight")
    code = _build.dtype_code(dy.dtype)
    n, h, ww, ci = xshape
    co, k = dy.shape[-1], w.shape[0]
    out = torch.empty((n, h, ww, ci), dtype=dy.dtype, device=dy.device)
    err = _build.library("conv_backward").conv_dgrad(
        dy.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, ww, ci, co, k, code,
        _build.stream_handle(dy))
    _build.check(err, "conv_dgrad")
    return out


def conv3x3_wgrad(x, dy, stride: int = 1, ksize: int = 3):
    """``dW (k, k, Ci, Co)`` in x's dtype for a k x k (k in {1, 3}) SAME
    stride-1 conv: the ``conv_wgrad`` kernel on CUDA, the plain version on
    the CPU."""
    _check_nhwc(x, "x")
    _check_nhwc(dy, "dy")
    _check_args(x.shape, dy.shape, ksize, stride)
    if not _is_cuda(x, "conv3x3_wgrad"):
        return conv3x3_wgrad_plain(x, dy, stride, ksize)
    out = _wgrad_cuda(x, dy, ksize)
    conv3x3_wgrad.launches += 1
    return out


def conv3x3_dgrad(dy, w, xshape, stride: int = 1):
    """``dX`` of shape ``xshape`` in dy's dtype for a k x k (k in {1, 3})
    SAME stride-1 conv: the ``conv_dgrad`` kernel on CUDA, the plain
    version on the CPU."""
    _check_nhwc(dy, "dy")
    xshape = tuple(xshape)
    if tuple(w.shape) != (w.shape[0], w.shape[0], xshape[3], dy.shape[-1]):
        raise ValueError(f"w {tuple(w.shape)} does not match x {xshape} and "
                         f"dy {tuple(dy.shape)}")
    _check_args(xshape, dy.shape, w.shape[0], stride)
    if not _is_cuda(dy, "conv3x3_dgrad"):
        return conv3x3_dgrad_plain(dy, w, xshape, stride)
    out = _dgrad_cuda(dy, w, xshape)
    conv3x3_dgrad.launches += 1
    return out


def _xla_conv_nchw(x, w, stride):
    """``F.conv2d`` with XLA's SAME padding on the ``(N, C, H, W)`` views:
    ``(y, x_fed, padding, crop)``, where ``x_fed`` is the tensor the conv
    read: ``F.pad``'s output where the split is asymmetric, and then
    ``crop`` is the (top, left) pad to take off its gradient."""
    kh, kw = w.shape[:2]
    (hl, hh), (wl, wh) = (_same_pad(x.shape[1], kh, stride),
                          _same_pad(x.shape[2], kw, stride))
    xn = x.permute(0, 3, 1, 2)
    padding, crop = (hl, wl), None
    if hl != hh or wl != wh:
        xn = F.pad(xn, (wl, wh, hl, hh))
        padding, crop = (0, 0), (hl, wl)
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), None, stride, padding)
    return y, xn, padding, crop


def _xla_conv(x, w, stride: int = 1):
    """SAME NHWC x HWIO conv through ``F.conv2d`` (cuDNN on the card),
    differentiated by autograd: the backward JAX's ``_xla_conv`` gets from
    XLA's transpose rule."""
    return _xla_conv_nchw(x, w, stride)[0].permute(0, 2, 3, 1)


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride):
        y, x_fed, padding, crop = _xla_conv_nchw(x, w, stride)
        ctx.stride, ctx.padding, ctx.crop = stride, padding, crop
        ctx.xshape = tuple(x.shape)
        ctx.save_for_backward(x_fed, w)
        return y.permute(0, 2, 3, 1).contiguous()

    @staticmethod
    def backward(ctx, dy):
        x_fed, w = ctx.saved_tensors
        s = ctx.stride
        if _eligible(ctx.xshape, w.shape, s):   # symmetric pads: x_fed is x
            x = x_fed.permute(0, 2, 3, 1)
            # a no-op for the gradient of a layer; materialises the
            # expanded one of a bare ``.sum()``
            dy = dy.contiguous()
            dx = conv3x3_dgrad(dy, w, ctx.xshape, s)
            dw = conv3x3_wgrad(x, dy, s, ksize=w.shape[0])
            return dx, dw.to(w.dtype), None
        # F.conv2d's own backward (and F.pad's, a crop)
        dxf, dwn, _ = torch.ops.aten.convolution_backward(
            dy.permute(0, 3, 1, 2), x_fed, w.permute(3, 2, 0, 1), None,
            [s, s], list(ctx.padding), [1, 1], False, [0, 0], 1,
            [True, True, False])
        if ctx.crop is not None:
            (hl, wl), (_, h, ww, _) = ctx.crop, ctx.xshape
            dxf = dxf[:, :, hl:hl + h, wl:wl + ww]
        return dxf.permute(0, 2, 3, 1), dwn.permute(2, 3, 1, 0), None


def conv2d(x, w, stride: int = 1):
    """SAME-padded NHWC x HWIO conv: ``F.conv2d`` forward; the backward runs
    ``conv3x3_dgrad`` and ``conv3x3_wgrad`` (kernels on the card) where
    :func:`_eligible` holds, ``F.conv2d``'s own backward elsewhere."""
    return _Conv2d.apply(x, w, stride)


conv3x3_wgrad.launches = 0
conv3x3_dgrad.launches = 0

"""ResNet family (v1.5) for the ImageNet data-parallel benchmark, in PyTorch.

Counterpart of ``chainermn_tpu/models/resnet.py``: the same blocks, widths,
parameter names and numerics.  Convs run in ``dtype`` (bf16 by default)
from fp32 parameters; BatchNorm statistics and the head stay fp32.
Activations are NHWC: contiguous ``(N, H, W, C)`` tensors, handed to
``F.conv2d`` and ``F.max_pool2d`` as their ``channels_last`` ``(N, C, H,
W)`` views, so no layer copies them into another layout.  Conv kernels are
HWIO as in flax.  Module and parameter names follow flax's variable tree
(``BottleneckBlock_3.Conv_1.kernel``, ``bn_init.mean``), so
:func:`chainermn_tpu_torch.convert.resnet_from_jax` maps one onto the
other key for key.

Three behaviours follow flax and not torch's own layers:

* SAME padding is XLA's split, asymmetric for a stride-2 conv on an even
  plane ((0, 1) at 56 x 56): ``ops.conv_backward._xla_conv``;
* :class:`BatchNorm` normalises in training with the biased batch
  variance ``E[x²] − E[x]²`` in fp32, clipped at 0, and moves the running
  statistics as ``0.9·ra + 0.1·batch`` with that biased variance;
* the head averages over H, W and runs its ``Dense`` in fp32.

``conv_impl="pallas"`` puts :class:`PallasConv` (``ops.conv2d``: the
``conv_wgrad`` / ``conv_dgrad`` kernels in its backward where eligible)
in place of every 3x3 conv of the blocks, as JAX's ``_conv3x3_factory``
does; 1x1 convs, the stem and the head are unchanged.  Only
``norm="bn"`` is ported.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import resolve_device
from ..ops.conv_backward import _xla_conv, conv2d

_NOT_PORTED = ("is not ported yet: see ROADMAP.md, queue A "
               "(the NF-ResNets, stalebn / affine norms and ViT)")


def _lecun_normal(shape, fan_in, gen):
    """flax's ``lecun_normal``: a normal truncated at ±2 std, scaled to
    variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=gen)
    return t * std


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False)``: a HWIO ``kernel`` in fp32, the conv
    in ``dtype``.  ``padding`` is ``"SAME"`` (XLA's split) or an int
    (symmetric, as the stem's explicit (3, 3))."""

    def __init__(self, cin, features, kernel=(3, 3), strides=1,
                 dtype=torch.bfloat16, padding="SAME", gen=None):
        super().__init__()
        kh, kw = kernel
        self.kernel = nn.Parameter(
            _lecun_normal((kh, kw, cin, features), kh * kw * cin, gen))
        self.strides, self.dtype, self.padding = strides, dtype, padding

    def _conv(self, x, w):
        return _xla_conv(x, w, self.strides)

    def forward(self, x):
        x, w = x.to(self.dtype), self.kernel.to(self.dtype)
        if self.padding == "SAME":
            return self._conv(x, w)
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
                     self.strides, self.padding)
        return y.permute(0, 2, 3, 1)


class PallasConv(Conv):
    """:class:`Conv` whose backward runs the hand-written conv kernels
    (``ops.conv2d``) where the shape is eligible; the same parameter."""

    def _conv(self, x, w):
        return conv2d(x, w, self.strides)


class _BatchNormTrain(torch.autograd.Function):
    """flax's training-mode BatchNorm over all axes but the last, with the
    closed-form gradient of its formula (JAX differentiates the same
    formula), saving only the input and the per-channel statistics."""

    @staticmethod
    def forward(ctx, x, scale, bias, epsilon, dtype):
        dims = tuple(range(x.dim() - 1))
        xf = x.float()
        mean = xf.mean(dims)
        var = torch.clamp(xf.square().mean(dims) - mean.square(), min=0.0)
        rstd = torch.rsqrt(var + epsilon)
        y = ((xf - mean) * (rstd * scale) + bias).to(dtype)
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, scale = ctx.saved_tensors
        dims = tuple(range(x.dim() - 1))
        n = x.numel() // x.shape[-1]
        g = dy.float()
        xhat = (x.float() - mean) * rstd
        dbias = g.sum(dims)
        dscale = (g * xhat).sum(dims)
        dx = (scale * rstd) * (g - dbias / n - xhat * (dscale / n))
        return dx.to(x.dtype), dscale, dbias, None, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` (momentum 0.9, epsilon 1e-5) over NHWC: fp32
    ``scale``/``bias`` parameters and ``mean``/``var`` running statistics.
    Training mode (``module.training``) normalises with the batch's biased
    statistics and moves the running ones in place; eval mode uses the
    running ones.  The output is in ``dtype``."""

    def __init__(self, c, momentum=0.9, epsilon=1e-5, dtype=torch.bfloat16,
                 scale_init=1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((c,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype

    def forward(self, x):
        if not self.training:
            mul = torch.rsqrt(self.var + self.epsilon) * self.scale
            return ((x.float() - self.mean) * mul + self.bias).to(self.dtype)
        y, mean, var = _BatchNormTrain.apply(x, self.scale, self.bias,
                                             self.epsilon, self.dtype)
        with torch.no_grad():
            m = self.momentum
            self.mean.mul_(m).add_(mean, alpha=1 - m)
            self.var.mul_(m).add_(var, alpha=1 - m)
        return y


def make_norm(norm: str, dtype):
    """The block norm layer: ``"bn"`` (flax BatchNorm parity).  JAX's
    ``"affine"`` and ``"stalebn"`` are not ported."""
    if norm == "bn":
        return partial(BatchNorm, momentum=0.9, epsilon=1e-5, dtype=dtype)
    if norm in ("affine", "stalebn"):
        raise NotImplementedError(f"norm {norm!r} {_NOT_PORTED}")
    raise ValueError(f"unknown norm {norm!r}")


def _conv3x3_factory(conv_impl: str, dtype):
    if conv_impl == "pallas":
        return partial(PallasConv, dtype=dtype)
    if conv_impl == "xla":
        return partial(Conv, dtype=dtype)
    raise ValueError(f"conv_impl must be 'xla' or 'pallas', got {conv_impl!r}")


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, filters, strides=1, dtype=torch.bfloat16,
                 norm="bn", conv_impl="xla", gen=None):
        super().__init__()
        bn = make_norm(norm, dtype)
        conv3 = _conv3x3_factory(conv_impl, dtype)
        self.Conv_0 = conv3(cin, filters, (3, 3), strides, gen=gen)
        self.BatchNorm_0 = bn(filters)
        self.Conv_1 = conv3(filters, filters, (3, 3), gen=gen)
        # zero-init the last BN scale: each block starts as the identity
        self.BatchNorm_1 = bn(filters, scale_init=0.0)
        self.proj = strides != 1 or cin != filters
        if self.proj:
            self.conv_proj = Conv(cin, filters, (1, 1), strides, dtype,
                                  gen=gen)
            self.norm_proj = bn(filters)

    def forward(self, x):
        residual = x
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if self.proj:
            residual = self.norm_proj(self.conv_proj(residual))
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin, filters, strides=1, dtype=torch.bfloat16,
                 norm="bn", conv_impl="xla", gen=None):
        super().__init__()
        bn = make_norm(norm, dtype)
        conv3 = _conv3x3_factory(conv_impl, dtype)
        self.Conv_0 = Conv(cin, filters, (1, 1), 1, dtype, gen=gen)
        self.BatchNorm_0 = bn(filters)
        # v1.5: the stride lives on the 3x3, not the 1x1
        self.Conv_1 = conv3(filters, filters, (3, 3), strides, gen=gen)
        self.BatchNorm_1 = bn(filters)
        self.Conv_2 = Conv(filters, filters * 4, (1, 1), 1, dtype, gen=gen)
        self.BatchNorm_2 = bn(filters * 4, scale_init=0.0)
        self.proj = strides != 1 or cin != filters * 4
        if self.proj:
            self.conv_proj = Conv(cin, filters * 4, (1, 1), strides, dtype,
                                  gen=gen)
            self.norm_proj = bn(filters * 4)

    def forward(self, x):
        residual = x
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if self.proj:
            residual = self.norm_proj(self.conv_proj(residual))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """``forward(x (N, H, W, C_in))`` → fp32 logits ``(N, num_classes)``,
    in training or eval mode as ``module.training`` says (JAX's
    ``train=`` argument).  Weights are random from ``seed``."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype=torch.bfloat16, stem_strides: int = 2,
                 norm: str = "bn", conv_impl: str = "xla",
                 in_channels: int = 3, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        self.dtype, self.stem_strides = dtype, stem_strides
        self.conv_init = Conv(in_channels, num_filters, (7, 7), stem_strides,
                              dtype, padding=3, gen=gen)
        self.bn_init = make_norm(norm, dtype)(num_filters)
        cin, i = num_filters, 0
        for stage, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = 2 if stage > 0 and j == 0 else 1
                filters = num_filters * 2 ** stage
                self.add_module(f"{block_cls.__name__}_{i}", block_cls(
                    cin, filters, strides, dtype, norm, conv_impl, gen=gen))
                cin, i = filters * block_cls.expansion, i + 1
        self.n_blocks = i
        self.block_name = block_cls.__name__
        self.Dense_0 = nn.Linear(cin, num_classes)
        with torch.no_grad():
            self.Dense_0.weight.copy_(
                _lecun_normal((cin, num_classes), cin, gen).t())
            self.Dense_0.bias.zero_()
        self.to(dev)

    def forward(self, x):
        x = F.relu(self.bn_init(self.conv_init(x.to(self.dtype))))
        if self.stem_strides == 2:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for i in range(self.n_blocks):
            x = getattr(self, f"{self.block_name}_{i}")(x)
        # head in fp32: jnp.mean of bf16 sums in fp32 and rounds to bf16
        return self.Dense_0(x.mean(dim=(1, 2)).float())


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3],
                    block_cls=BottleneckBlock)

ARCHS: dict = {
    "resnet18": ResNet18,
    "resnet34": ResNet34,
    "resnet50": ResNet50,
    "resnet101": ResNet101,
    "resnet152": ResNet152,
}

# the JAX registry's other archs, for the CLI's message
NOT_PORTED_ARCHS = ("nf_resnet50", "nf_resnet101", "nf_resnet152", "alex",
                    "alexnet", "googlenet", "vgg16", "vit_ti16", "vit_s16",
                    "vit_b16")

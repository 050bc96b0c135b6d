"""ResNet family (v1.5) and the NF-ResNets for the ImageNet data-parallel benchmark, in PyTorch.

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
does; 1x1 convs, the stem and the head are unchanged.  ``norm`` is
``"bn"``, ``"affine"`` (:class:`Affine`, no statistics) or ``"stalebn"``
(:class:`StaleBatchNorm`); the norm modules take flax's auto-names
(``StaleBatchNorm_0``, ``Affine_1``).

The NF-ResNets (:class:`NFResNet`, Brock et al. 2021) have no norm layer:
:class:`ScaledWSConv` standardises each conv's weight (biased variance
over (kh, kw, cin), ``rsqrt(var·fan_in + 1e-4)``, a learnable gain), and
each :class:`NFBottleneckBlock` adds ``alpha·skip_gain`` times its branch
to the shortcut.  With ``conv_impl="pallas"`` every SAME conv, 1x1 and
3x3, goes through ``ops.conv2d`` (JAX ``resnet.py:299-306``); the stem's
explicit (3, 3) padding never does.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import resolve_device
from ..ops.conv_backward import _xla_conv, conv2d


def _lecun_normal(shape, fan_in, gen):
    """flax's ``lecun_normal``: a normal truncated at ±2 std, scaled to
    variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=gen)
    return t * std


def _explicit_conv(x, w, strides, padding):
    """NHWC x HWIO conv with symmetric ``padding`` on each side."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
                 strides, padding)
    return y.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """flax ``nn.Conv``: a HWIO ``kernel`` in fp32 (and, with ``use_bias``,
    a zero-initialised ``bias``), the conv in ``dtype``.  ``padding`` is
    ``"SAME"`` (XLA's split) or an int (symmetric, as the stem's explicit
    (3, 3))."""

    def __init__(self, cin, features, kernel=(3, 3), strides=1,
                 dtype=torch.bfloat16, padding="SAME", gen=None,
                 use_bias=False):
        super().__init__()
        kh, kw = kernel
        self.kernel = nn.Parameter(
            _lecun_normal((kh, kw, cin, features), kh * kw * cin, gen))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.strides, self.dtype, self.padding = strides, dtype, padding

    def _conv(self, x, w):
        return _xla_conv(x, w, self.strides)

    def forward(self, x):
        x, w = x.to(self.dtype), self.kernel.to(self.dtype)
        if self.padding == "SAME":
            y = self._conv(x, w)
        else:
            y = _explicit_conv(x, w, self.strides, self.padding)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=dtype)`` as an ``nn.Linear`` (``weight`` (out,
    in), the transpose of flax's (in, out) ``kernel``; lecun_normal init,
    zero bias): the product in ``dtype``, then the bias added in
    ``dtype``."""

    def __init__(self, cin, features, dtype=torch.bfloat16, gen=None):
        super().__init__(cin, features)
        with torch.no_grad():
            self.weight.copy_(_lecun_normal((cin, features), cin, gen).t())
            self.bias.zero_()
        self.dtype = dtype

    def forward(self, x):
        return (F.linear(x.to(self.dtype), self.weight.to(self.dtype))
                + self.bias.to(self.dtype))


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


class Affine(nn.Module):
    """JAX's ``Affine``: a per-channel ``scale`` and ``bias`` (fp32) over
    the fp32 input, output in ``dtype``; no statistics."""

    def __init__(self, c, dtype=torch.bfloat16, scale_init=1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((c,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(c))
        self.dtype = dtype

    def forward(self, x):
        return (x.float() * self.scale + self.bias).to(self.dtype)


class StaleBatchNorm(nn.Module):
    """JAX's ``StaleBatchNorm``: training mode normalises with the PREVIOUS
    step's batch statistics (``last_mean`` / ``last_var``, constants of
    this step), then stores this batch's as the next step's and moves the
    EMA (``mean`` / ``var``, momentum 0.9).  The batch variance is
    ``E[x²] − E[x]²`` in fp32, not clipped.  Eval mode normalises with the
    EMA.  ``y = (x − m)·scale / sqrt(v + eps) + bias`` in fp32, output in
    ``dtype``."""

    def __init__(self, c, momentum=0.9, epsilon=1e-5, dtype=torch.bfloat16,
                 scale_init=1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((c,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(c))
        for name, fill in (("mean", 0.0), ("var", 1.0), ("last_mean", 0.0),
                           ("last_var", 1.0)):
            self.register_buffer(name, torch.full((c,), fill))
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype

    def forward(self, x):
        if self.training:
            m, v = self.last_mean.clone(), self.last_var.clone()
            with torch.no_grad():
                xf = x.float()
                dims = tuple(range(x.dim() - 1))
                bmean = xf.mean(dims)
                bvar = xf.square().mean(dims) - bmean.square()
                k = self.momentum
                self.mean.mul_(k).add_(bmean, alpha=1 - k)
                self.var.mul_(k).add_(bvar, alpha=1 - k)
                self.last_mean.copy_(bmean)
                self.last_var.copy_(bvar)
        else:
            m, v = self.mean, self.var
        inv = self.scale / torch.sqrt(v + self.epsilon)
        return ((x.float() - m) * inv + self.bias).to(self.dtype)


# each norm's flax auto-name prefix (the class name)
NORMS = {"bn": BatchNorm, "affine": Affine, "stalebn": StaleBatchNorm}


def make_norm(norm: str, dtype):
    """The block norm layer, ``cls(c, scale_init=...)``: ``"bn"`` (flax
    BatchNorm parity), ``"affine"`` (per-channel scale and shift) or
    ``"stalebn"`` (BatchNorm with one-step-stale statistics)."""
    if norm not in NORMS:
        raise ValueError(f"unknown norm {norm!r}")
    if norm == "affine":
        return partial(Affine, dtype=dtype)
    return partial(NORMS[norm], momentum=0.9, epsilon=1e-5, dtype=dtype)


def _conv3x3_factory(conv_impl: str, dtype):
    if conv_impl == "pallas":
        return partial(PallasConv, dtype=dtype)
    if conv_impl == "xla":
        return partial(Conv, dtype=dtype)
    raise ValueError(f"conv_impl must be 'xla' or 'pallas', got {conv_impl!r}")


class _Block(nn.Module):
    """The norm modules of a block take flax's auto-names by class
    (``BatchNorm_0``, ``StaleBatchNorm_1``, ``Affine_2``)."""

    def _set_norm(self, norm, dtype):
        self._bn, self._prefix, self._n_norms = make_norm(norm, dtype), \
            NORMS[norm].__name__, 0
        return self._bn

    def _add_norm(self, c, scale_init=1.0):
        self.add_module(f"{self._prefix}_{self._n_norms}",
                        self._bn(c, scale_init=scale_init))
        self._n_norms += 1

    def _norm(self, i, x):
        return getattr(self, f"{self._prefix}_{i}")(x)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, cin, filters, strides=1, dtype=torch.bfloat16,
                 norm="bn", conv_impl="xla", gen=None):
        super().__init__()
        bn = self._set_norm(norm, dtype)
        conv3 = _conv3x3_factory(conv_impl, dtype)
        self.Conv_0 = conv3(cin, filters, (3, 3), strides, gen=gen)
        self._add_norm(filters)
        self.Conv_1 = conv3(filters, filters, (3, 3), gen=gen)
        # zero-init the last norm scale: each block starts as the identity
        self._add_norm(filters, scale_init=0.0)
        self.proj = strides != 1 or cin != filters
        if self.proj:
            self.conv_proj = Conv(cin, filters, (1, 1), strides, dtype,
                                  gen=gen)
            self.norm_proj = bn(filters)

    def forward(self, x):
        residual = x
        y = F.relu(self._norm(0, self.Conv_0(x)))
        y = self._norm(1, self.Conv_1(y))
        if self.proj:
            residual = self.norm_proj(self.conv_proj(residual))
        return F.relu(residual + y)


class BottleneckBlock(_Block):
    expansion = 4

    def __init__(self, cin, filters, strides=1, dtype=torch.bfloat16,
                 norm="bn", conv_impl="xla", gen=None):
        super().__init__()
        bn = self._set_norm(norm, dtype)
        conv3 = _conv3x3_factory(conv_impl, dtype)
        self.Conv_0 = Conv(cin, filters, (1, 1), 1, dtype, gen=gen)
        self._add_norm(filters)
        # v1.5: the stride lives on the 3x3, not the 1x1
        self.Conv_1 = conv3(filters, filters, (3, 3), strides, gen=gen)
        self._add_norm(filters)
        self.Conv_2 = Conv(filters, filters * 4, (1, 1), 1, dtype, gen=gen)
        self._add_norm(filters * 4, scale_init=0.0)
        self.proj = strides != 1 or cin != filters * 4
        if self.proj:
            self.conv_proj = Conv(cin, filters * 4, (1, 1), strides, dtype,
                                  gen=gen)
            self.norm_proj = bn(filters * 4)

    def forward(self, x):
        residual = x
        y = F.relu(self._norm(0, self.Conv_0(x)))
        y = F.relu(self._norm(1, self.Conv_1(y)))
        y = self._norm(2, self.Conv_2(y))
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


# --- Normalizer-free ResNets (Brock et al. 2021) ---------------------------

GAMMA_RELU = 1.7139588594436646  # sqrt(2/(1-1/pi)): restores unit variance


class ScaledWSConv(nn.Module):
    """JAX's ``ScaledWSConv``: ``W_hat = gain·(W − mean)·rsqrt(var·fan_in +
    1e-4)`` with the mean and the biased variance per output channel over
    (kh, kw, cin), in fp32; the conv in ``dtype``.  ``kernel`` is HWIO
    (he_normal init), ``gain`` ones.  With ``conv_impl="pallas"`` a SAME
    conv goes through ``ops.conv2d`` (the kernels in its backward where
    eligible, 1x1 and 3x3); an explicit ``padding`` (the stem's 3) never
    does."""

    def __init__(self, cin, features, kernel=(3, 3), strides=1,
                 dtype=torch.bfloat16, padding="SAME", conv_impl="xla",
                 gen=None):
        super().__init__()
        kh, kw = kernel
        fan_in = kh * kw * cin
        # he_normal: lecun_normal's truncated normal at variance 2 / fan_in
        self.kernel = nn.Parameter(
            _lecun_normal((kh, kw, cin, features), fan_in, gen) * 2 ** 0.5)
        self.gain = nn.Parameter(torch.ones(features))
        self.strides, self.dtype, self.padding = strides, dtype, padding
        self.fan_in = fan_in
        if conv_impl not in ("xla", "pallas"):
            raise ValueError(f"conv_impl must be 'xla' or 'pallas', got "
                             f"{conv_impl!r}")
        self.conv_impl = conv_impl

    def standardized(self):
        """The fp32 standardised weight ``W_hat`` (HWIO)."""
        w = self.kernel
        mu = w.mean((0, 1, 2), keepdim=True)
        var = w.var((0, 1, 2), keepdim=True, correction=0)
        return (w - mu) * torch.rsqrt(var * self.fan_in + 1e-4) * self.gain

    def forward(self, x):
        x, w = x.to(self.dtype), self.standardized().to(self.dtype)
        if self.padding != "SAME":
            return _explicit_conv(x, w, self.strides, self.padding)
        if self.conv_impl == "pallas":
            return conv2d(x, w, self.strides)
        return _xla_conv(x, w, self.strides)


class NFBottleneckBlock(nn.Module):
    """Pre-activation normalizer-free bottleneck: ``shortcut +
    (alpha·skip_gain)·f(relu(x / beta)·gamma)``, ``skip_gain`` a zero-init
    fp32 scalar folded in fp32 and cast to ``dtype`` (the trunk stays in
    ``dtype``).  A transition block's shortcut is a 1x1 ``conv_shortcut``
    of the activated input."""

    expansion = 4

    def __init__(self, cin, filters, beta, strides=1, alpha=0.2,
                 dtype=torch.bfloat16, conv_impl="xla", gen=None):
        super().__init__()
        conv = partial(ScaledWSConv, dtype=dtype, conv_impl=conv_impl,
                       gen=gen)
        self.beta, self.alpha, self.dtype = beta, alpha, dtype
        self.transition = strides > 1 or cin != filters * 4
        if self.transition:
            self.conv_shortcut = conv(cin, filters * 4, (1, 1), strides)
        self.ScaledWSConv_0 = conv(cin, filters, (1, 1))
        self.ScaledWSConv_1 = conv(filters, filters, (3, 3), strides)
        self.ScaledWSConv_2 = conv(filters, filters * 4, (1, 1))
        self.skip_gain = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        def act(v):
            return F.relu(v) * GAMMA_RELU

        out = act(x / self.beta)
        shortcut = self.conv_shortcut(out) if self.transition else x
        y = act(self.ScaledWSConv_0(out))
        y = act(self.ScaledWSConv_1(y))
        y = self.ScaledWSConv_2(y)
        gain = (self.alpha * self.skip_gain).to(self.dtype)
        return shortcut + gain * y.to(self.dtype)


class NFResNet(nn.Module):
    """JAX's ``NFResNet`` (NF-ResNet-50/101/152): ``forward(x (N, H, W,
    C_in))`` → fp32 logits.  The expected variance starts at 1 after the
    stem, grows by ``alpha²`` a block and resets to ``1 + alpha²`` at a
    stage's first block; each block divides its input by its square root.
    No buffers: training and eval mode compute the same function."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, alpha: float = 0.2,
                 dtype=torch.bfloat16, stem_strides: int = 2,
                 conv_impl: str = "xla", in_channels: int = 3, seed: int = 0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        self.dtype, self.stem_strides = dtype, stem_strides
        self.conv_init = ScaledWSConv(in_channels, num_filters, (7, 7),
                                      stem_strides, dtype, padding=3,
                                      gen=gen)
        cin, i, expected_var = num_filters, 0, 1.0
        for stage, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = 2 if stage > 0 and j == 0 else 1
                filters = num_filters * 2 ** stage
                self.add_module(f"NFBottleneckBlock_{i}", NFBottleneckBlock(
                    cin, filters, expected_var ** 0.5, strides, alpha, dtype,
                    conv_impl, gen=gen))
                # a stage's first block resets the variance (its shortcut
                # reads the normalised input)
                expected_var = (1.0 if j == 0 else expected_var) + alpha ** 2
                cin, i = filters * 4, i + 1
        self.n_blocks = i
        self.Dense_0 = nn.Linear(cin, num_classes)
        with torch.no_grad():
            self.Dense_0.weight.copy_(
                _lecun_normal((cin, num_classes), cin, gen).t())
            self.Dense_0.bias.zero_()
        self.to(dev)

    def forward(self, x):
        x = F.relu(self.conv_init(x.to(self.dtype))) * GAMMA_RELU
        if self.stem_strides == 2:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(
                0, 2, 3, 1)
        for i in range(self.n_blocks):
            x = getattr(self, f"NFBottleneckBlock_{i}")(x)
        return self.Dense_0(x.mean(dim=(1, 2)).float())


NFResNet50 = partial(NFResNet, stage_sizes=[3, 4, 6, 3])
NFResNet101 = partial(NFResNet, stage_sizes=[3, 4, 23, 3])
NFResNet152 = partial(NFResNet, stage_sizes=[3, 8, 36, 3])


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
    "nf_resnet50": NFResNet50,
    "nf_resnet101": NFResNet101,
    "nf_resnet152": NFResNet152,
}

# the zoo beyond the ResNets, registered as JAX's registry does (imported
# here, at the bottom: convnets and vit import this module's layers)
from .convnets import AlexNet, GoogLeNet, VGG16  # noqa: E402
from .vit import ViT_B16, ViT_S16, ViT_Ti16  # noqa: E402

ARCHS.update({
    "alex": AlexNet,
    "alexnet": AlexNet,
    "googlenet": GoogLeNet,
    "vgg16": VGG16,
    "vit_ti16": ViT_Ti16,
    "vit_s16": ViT_S16,
    "vit_b16": ViT_B16,
})

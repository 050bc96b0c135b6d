"""Classic ImageNet convnets in PyTorch: AlexNet, VGG-16, GoogLeNet (Inception v1).

Counterpart of ``chainermn_tpu/models/convnets.py``: the same layers,
widths, flax parameter names (``Conv_3.kernel``, ``_Inception_2.BatchNorm_4
.mean``, ``Dense_1.weight`` for flax's ``Dense_1.kernel``) and numerics, so
:func:`chainermn_tpu_torch.convert.convnet_from_jax` maps one onto the
other key for key.  Activations are NHWC; convs run in ``dtype`` from fp32
parameters through XLA's SAME padding (``ops.conv_backward._xla_conv``),
BatchNorm is the port's flax twin (:class:`~.resnet.BatchNorm`), the last
``Dense`` runs in fp32.  ``forward(x (N, H, W, C))`` → fp32 logits, in
training or eval mode as ``module.training`` says.

Pooling follows flax's ``max_pool``: VALID unless told SAME, and SAME pads
with −inf at XLA's split, which is asymmetric for a stride-2 window on an
even plane (:func:`max_pool`).  The flatten before a ``Dense`` is in NHWC
order.  ``stem_strides == 1`` is JAX's small-input mode (fewer pools, the
stem unstrided).  ``dropout_rate`` (default 0) is kept, but its draws are
torch's, not JAX's.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import resolve_device
from ..ops.conv_backward import _same_pad
from .resnet import BatchNorm, Conv, Dense


def max_pool(x, window: int, stride: int, padding: str = "VALID"):
    """flax ``nn.max_pool`` over NHWC ``x``: a ``window`` x ``window`` max
    at ``stride``, with no padding (VALID) or XLA's SAME split padded with
    −inf."""
    xn = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        (hl, hh), (wl, wh) = (_same_pad(x.shape[1], window, stride),
                              _same_pad(x.shape[2], window, stride))
        xn = F.pad(xn, (wl, wh, hl, hh), value=float("-inf"))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'VALID' or 'SAME', got {padding!r}")
    return F.max_pool2d(xn, window, stride).permute(0, 2, 3, 1)


def _bn(c, dtype):
    return BatchNorm(c, momentum=0.9, epsilon=1e-5, dtype=dtype)


class _Net(nn.Module):
    """Shared construction: a seeded generator, flax-named ``Conv_i`` /
    ``BatchNorm_i`` pairs added in call order, the head's ``Dense_i``."""

    def _setup(self, dtype, dropout_rate, gen):
        self.dtype, self.dropout_rate, self._gen = dtype, dropout_rate, gen
        self._n_conv = self._n_dense = 0

    def _unit(self, cin, width, kernel, strides=1, use_bias=False):
        """Adds ``Conv_i`` and ``BatchNorm_i``; returns ``i``."""
        i = self._n_conv
        self.add_module(f"Conv_{i}", Conv(
            cin, width, (kernel, kernel), strides, self.dtype,
            gen=self._gen, use_bias=use_bias))
        self.add_module(f"BatchNorm_{i}", _bn(width, self.dtype))
        self._n_conv += 1
        return i

    def _dense(self, cin, features, dtype):
        self.add_module(f"Dense_{self._n_dense}",
                        Dense(cin, features, dtype, gen=self._gen))
        self._n_dense += 1

    def _apply_unit(self, i, x):
        return F.relu(getattr(self, f"BatchNorm_{i}")(
            getattr(self, f"Conv_{i}")(x)))

    def _drop(self, x):
        if self.dropout_rate > 0:
            return F.dropout(x, self.dropout_rate, self.training)
        return x

    def _head(self, x):
        """Flatten (NHWC order), ``Dense_0`` 4096 → relu → dropout →
        ``Dense_1`` 4096 → relu → dropout → ``Dense_2`` in fp32."""
        x = x.reshape(x.shape[0], -1)
        x = self._drop(F.relu(self.Dense_0(x)))
        x = self._drop(F.relu(self.Dense_1(x)))
        return self.Dense_2(x)


class AlexNet(_Net):
    """AlexNet (one-tower, BatchNorm in place of LRN): five convs with
    biases (11x11 stride 4 at the ImageNet stem, 3x3 in small-input mode),
    3x3 stride-2 VALID pools, and the 4096-wide head.  ``image_size``
    sizes the first ``Dense``."""

    def __init__(self, num_classes: int = 1000, stem_strides: int = 2,
                 dtype=torch.bfloat16, dropout_rate: float = 0.0,
                 image_size: int = 224, in_channels: int = 3, seed: int = 0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self._setup(dtype, dropout_rate,
                    torch.Generator().manual_seed(int(seed)))
        self.big = stem_strides > 1
        conv = partial(self._unit, use_bias=True)
        conv(in_channels, 64, 11 if self.big else 3, 4 if self.big else 1)
        conv(64, 192, 5)
        conv(192, 384, 3)
        conv(384, 256, 3)
        conv(256, 256, 3)
        side = -(-image_size // 4) if self.big else image_size
        for pooled in self._POOLED:
            side = self._pool_side(side) if pooled else side
        self._dense(side * side * 256, 4096, dtype)
        self._dense(4096, 4096, dtype)
        self._dense(4096, num_classes, torch.float32)
        self.to(dev)

    _POOLED = (True, True, False, False, True)     # after each conv

    def _pool(self, x):
        # small-input mode still downsamples while the plane exceeds 4
        if self.big:
            return max_pool(x, 3, 2)
        if min(x.shape[1:3]) > 4:
            return max_pool(x, 2, 2)
        return x

    def _pool_side(self, side):
        if self.big:
            return (side - 3) // 2 + 1
        return side // 2 if side > 4 else side

    def forward(self, x):
        x = x.to(self.dtype)
        for i, pooled in enumerate(self._POOLED):
            x = self._apply_unit(i, x)
            x = self._pool(x) if pooled else x
        return self._head(x)


class VGG16(_Net):
    """VGG-16 with BatchNorm (configuration D): bias-free 3x3 convs, a 2x2
    stride-2 pool after each stage (in small-input mode only while the
    plane exceeds 4), the 4096-wide head."""

    def __init__(self, num_classes: int = 1000, stem_strides: int = 2,
                 dtype=torch.bfloat16, dropout_rate: float = 0.0,
                 cfg: Sequence = ((64, 64), (128, 128), (256, 256, 256),
                                  (512, 512, 512), (512, 512, 512)),
                 image_size: int = 224, in_channels: int = 3, seed: int = 0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self._setup(dtype, dropout_rate,
                    torch.Generator().manual_seed(int(seed)))
        self.stem_strides, self.cfg = stem_strides, cfg
        cin, side = in_channels, image_size
        for widths in cfg:
            for w in widths:
                self._unit(cin, w, 3)
                cin = w
            if self._pools(side):
                side //= 2
        self._dense(side * side * cin, 4096, dtype)
        self._dense(4096, 4096, dtype)
        self._dense(4096, num_classes, torch.float32)
        self.to(dev)

    def _pools(self, side):
        return self.stem_strides > 1 or side > 4

    def forward(self, x):
        x, i = x.to(self.dtype), 0
        for widths in self.cfg:
            for _ in widths:
                x, i = self._apply_unit(i, x), i + 1
            if self._pools(min(x.shape[1:3])):
                x = max_pool(x, 2, 2)
        return self._head(x)


class _Inception(_Net):
    """Inception v1 block: 1x1 / 1x1 → 3x3 / 1x1 → 5x5 / 3x3 SAME pool →
    1x1 branches, each conv followed by BatchNorm and relu, concatenated
    on channels."""

    def __init__(self, cin, b1, b3r, b3, b5r, b5, bp, dtype, gen):
        super().__init__()
        self._setup(dtype, 0.0, gen)
        self._unit(cin, b1, 1)
        self._unit(cin, b3r, 1)
        self._unit(b3r, b3, 3)
        self._unit(cin, b5r, 1)
        self._unit(b5r, b5, 5)
        self._unit(cin, bp, 1)
        self.out_channels = b1 + b3 + b5 + bp

    def forward(self, x):
        u = self._apply_unit
        p1 = u(0, x)
        p3 = u(2, u(1, x))
        p5 = u(4, u(3, x))
        pp = u(5, max_pool(x, 3, 1, "SAME"))
        return torch.cat([p1, p3, p5, pp], dim=-1)


# (b1, b3r, b3, b5r, b5, bp) of blocks 3a-3b, 4a-4e, 5a-5b; a pool (at the
# ImageNet stem) before 4a and 5a
_INCEPTIONS = ((64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64),
               (192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64),
               (128, 128, 256, 24, 64, 64), (112, 144, 288, 32, 64, 64),
               (256, 160, 320, 32, 128, 128), (256, 160, 320, 32, 128, 128),
               (384, 192, 384, 48, 128, 128))
_POOL_BEFORE = (2, 7)


class GoogLeNet(_Net):
    """GoogLeNet / Inception v1 (BatchNorm form, no auxiliary heads): the
    7x7 / 1x1 / 3x3 stem, nine Inception blocks, 3x3 stride-2 SAME pools
    (at the ImageNet stem), the spatial mean and ``Dense_0`` in fp32."""

    def __init__(self, num_classes: int = 1000, stem_strides: int = 2,
                 dtype=torch.bfloat16, dropout_rate: float = 0.0,
                 in_channels: int = 3, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self._setup(dtype, dropout_rate,
                    torch.Generator().manual_seed(int(seed)))
        self.big = stem_strides > 1
        self._unit(in_channels, 64, 7, 2 if self.big else 1)
        self._unit(64, 64, 1)
        self._unit(64, 192, 3)
        cin = 192
        for i, widths in enumerate(_INCEPTIONS):
            block = _Inception(cin, *widths, dtype, self._gen)
            self.add_module(f"_Inception_{i}", block)
            cin = block.out_channels
        self._dense(cin, num_classes, torch.float32)
        self.to(dev)

    def _pool(self, x):
        return max_pool(x, 3, 2, "SAME") if self.big else x

    def forward(self, x):
        x = self._apply_unit(0, x.to(self.dtype))
        x = self._pool(x)
        x = self._apply_unit(2, self._apply_unit(1, x))
        x = self._pool(x)
        for i in range(len(_INCEPTIONS)):
            if i in _POOL_BEFORE:
                x = self._pool(x)
            x = getattr(self, f"_Inception_{i}")(x)
        x = self._drop(x.mean(dim=(1, 2)))
        return self.Dense_0(x.float())

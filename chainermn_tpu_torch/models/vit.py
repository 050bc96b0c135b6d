"""Vision Transformer (ViT-Ti/S/B at patch 16) in PyTorch.

Counterpart of ``chainermn_tpu/models/vit.py``: the same layers, flax
parameter names and layouts (``_Block_3._MHSA_0.qkv.kernel`` (D, 3, H, Dh),
``proj.kernel`` (H, Dh, D), ``pos_embed`` (1, S, D), ``cls`` (1, 1, D);
``Dense_i.weight`` is flax's ``Dense_i.kernel`` transposed), so
:func:`chainermn_tpu_torch.convert.vit_from_jax` maps one onto the other
key for key.  flax's defaults, which torch's own layers do not share:

* ``LayerNorm``: epsilon 1e-6, the fast variance ``E[x²] − E[x]²`` (clipped
  at 0) in fp32, output fp32;
* ``gelu`` is the tanh approximation;
* the patch embedding is a SAME conv with a bias, stride = patch;
* ``pos_embed`` is normal(0.02), ``cls`` zeros; dense kernels lecun_normal.

Attention (``attn_impl``): ``"flash"`` is ``ops.flash_attention`` (its
CUDA kernels on the card, ``p`` kept in fp32), ``"xla"`` the einsum path,
which rounds the softmax to ``dtype`` before the PV product, as JAX's
does; ``"auto"`` is ``ops.resolve_attn_impl``'s rule on the input's
device.  q, k and v come from three products with the slices of the
``qkv`` kernel, so each is a contiguous ``(B, S, H, Dh)`` tensor that the
kernels take without a copy.  Compute runs in ``dtype`` from fp32
parameters; the norms and the head are fp32.  No buffers.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import resolve_device
from ..ops.flash_attention import flash_attention, resolve_attn_impl
from .resnet import Conv, Dense, _lecun_normal


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)`` over the last axis."""

    def __init__(self, d, epsilon=1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.epsilon = epsilon

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0)
        return (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) \
            + self.bias


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral``'s parameters: ``kernel`` (lecun_normal over
    ``fan_in``) and a zero ``bias``."""

    def __init__(self, kernel_shape, bias_shape, fan_in, gen):
        super().__init__()
        self.kernel = nn.Parameter(_lecun_normal(kernel_shape, fan_in, gen))
        self.bias = nn.Parameter(torch.zeros(bias_shape))


class _MHSA(nn.Module):
    """Multi-head self-attention over ``(B, S, D)``."""

    def __init__(self, d, num_heads, dtype, attn_impl, gen):
        super().__init__()
        h, dh = num_heads, d // num_heads
        self.qkv = DenseGeneral((d, 3, h, dh), (3, h, dh), d, gen)
        self.proj = DenseGeneral((h, dh, d), (d,), h * dh, gen)
        self.h, self.dh, self.dtype, self.attn_impl = h, dh, dtype, attn_impl

    def forward(self, x):
        b, s, d = x.shape
        h, dh, dt = self.h, self.dh, self.dtype
        x, w, bias = (t.to(dt) for t in (x, self.qkv.kernel, self.qkv.bias))
        q, k, v = ((x @ w[:, i].reshape(d, h * dh) + bias[i].reshape(-1))
                   .view(b, s, h, dh) for i in range(3))
        if resolve_attn_impl(self.attn_impl, s, dh, x.device) == "flash":
            o = flash_attention(q, k, v)
        else:
            att = torch.einsum("bqhc,bkhc->bhqk", q, k) * dh ** -0.5
            att = torch.softmax(att.float(), -1).to(dt)
            o = torch.einsum("bhqk,bkhc->bqhc", att, v)
        return (o.reshape(b, s, h * dh) @ self.proj.kernel.to(dt).reshape(
            h * dh, d)) + self.proj.bias.to(dt)


class _Block(nn.Module):
    def __init__(self, d, num_heads, mlp_ratio, dtype, attn_impl, gen):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(d)
        self._MHSA_0 = _MHSA(d, num_heads, dtype, attn_impl, gen)
        self.LayerNorm_1 = LayerNorm(d)
        self.Dense_0 = Dense(d, d * mlp_ratio, dtype, gen=gen)
        self.Dense_1 = Dense(d * mlp_ratio, d, dtype, gen=gen)

    def forward(self, x):
        x = x + self._MHSA_0(self.LayerNorm_0(x))
        y = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(y)


class ViT(nn.Module):
    """ViT classifier (defaults ViT-S/16): ``forward(x (N, H, W, C))`` →
    fp32 logits from the CLS token.  ``image_size`` sizes ``pos_embed``
    (JAX's is set by the input at init); ``stem_strides`` is accepted for
    the zoo's interface and unused.  Training and eval mode compute the
    same function."""

    def __init__(self, num_classes: int = 1000, patch: int = 16,
                 d_model: int = 384, depth: int = 12, num_heads: int = 6,
                 dtype=torch.bfloat16, attn_impl: str = "auto",
                 stem_strides: int = 2, image_size: int = 224,
                 in_channels: int = 3, mlp_ratio: int = 4, seed: int = 0,
                 device="cuda"):
        super().__init__()
        del stem_strides
        if image_size < patch:
            raise ValueError(
                f"input {image_size}x{image_size} smaller than patch {patch}; "
                f"construct the model with a smaller patch=")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        self.dtype, self.d_model, self.depth = dtype, d_model, depth
        self.patch_embed = Conv(in_channels, d_model, (patch, patch), patch,
                                dtype, gen=gen, use_bias=True)
        side = -(-image_size // patch)             # SAME: ceil
        self.cls = nn.Parameter(torch.zeros(1, 1, d_model))
        pos = torch.empty(1, side * side + 1, d_model)
        nn.init.normal_(pos, std=0.02, generator=gen)
        self.pos_embed = nn.Parameter(pos)
        for i in range(depth):
            self.add_module(f"_Block_{i}", _Block(
                d_model, num_heads, mlp_ratio, dtype, attn_impl, gen))
        self.LayerNorm_0 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, num_classes, torch.float32, gen=gen)
        self.to(dev)

    def forward(self, x):
        b = x.shape[0]
        x = self.patch_embed(x).reshape(b, -1, self.d_model)
        if x.shape[1] + 1 != self.pos_embed.shape[1]:
            raise ValueError(f"{x.shape[1]} patches, but pos_embed holds "
                             f"{self.pos_embed.shape[1] - 1}: build the model "
                             f"with this image_size")
        cls = self.cls.expand(b, 1, self.d_model).to(x.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"_Block_{i}")(x)
        return self.Dense_0(self.LayerNorm_0(x)[:, 0])


ViT_S16 = partial(ViT, patch=16, d_model=384, depth=12, num_heads=6)
ViT_B16 = partial(ViT, patch=16, d_model=768, depth=12, num_heads=12)
ViT_Ti16 = partial(ViT, patch=16, d_model=192, depth=12, num_heads=3)

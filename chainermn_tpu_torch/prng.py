"""Threefry-2x32 keys and uniform draws, bit for bit as ``jax.random`` makes them.

The counterpart of the ``jax.random`` calls the decode path makes:
:func:`PRNGKey`, :func:`fold_in` and :func:`uniform`.  A key is JAX's raw
key data, two uint32 words: a numpy ``uint32`` array ``(..., 2)``, or an
int64 tensor ``(..., 2)`` holding values below ``2**32`` (torch's uint32
supports too few operations).  So a key made by JAX, turned into numpy,
is the same key here, and the draws are the same bits.

The generator is threefry-2x32 (20 rounds; key schedule ``[k0, k1, k0 ^
k1 ^ 0x1BD11BDA]``, rotations 13 15 26 6 / 17 29 16 24, a key injection
after every four rounds).  :func:`uniform` uses JAX's partitionable
counter layout (``jax_threefry_partitionable``): element ``i`` of the
flattened draw is threefry of the counter pair ``(i >> 32, i & M)`` and
its bits are the XOR of the two output words; ``bits >> 9 | 0x3F800000``
read as fp32, minus 1, is the float in ``[0, 1)``.

Plain tensor code on the key's device, vectorised over a leading batch of
keys; it is no TPU kernel of the JAX package (fusing it is a later item).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Union[np.ndarray, torch.Tensor]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter pair ``(x0, x1)`` under key ``(k0,
    k1)``; int64 tensors holding uint32 values, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def as_key(key: Key, device=None) -> torch.Tensor:
    """``key`` as an int64 tensor ``(..., 2)`` of uint32 words on
    ``device`` (the key's own device, or the CPU for numpy, by default)."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device if device is not None else key.device,
                      dtype=torch.int64) & _M
    arr = np.asarray(key).astype(np.uint32).astype(np.int64)
    return torch.as_tensor(arr, device=device)


def _like(out: torch.Tensor, key: Key) -> Key:
    """Return ``out`` in the kind of ``key``: numpy in, numpy out."""
    if isinstance(key, torch.Tensor):
        return out
    return out.cpu().numpy().astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s key data: ``[0, seed]`` for a seed
    in int32's range (JAX pads a 32-bit seed with a zero high word), the
    two halves of a wider seed otherwise."""
    seed = int(seed)
    hi = 0 if -2 ** 31 <= seed < 2 ** 31 else (seed >> 32) & _M
    return np.array([hi, seed & _M], np.uint32)


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in``: ``threefry2x32(key, (0, data))``.  ``key``
    may carry a leading batch ``(..., 2)``; ``data`` is an int or an
    integer tensor that broadcasts against that batch (taken mod 2**32,
    as JAX's ``uint32(data)`` takes it)."""
    k = as_key(key)
    d = (torch.as_tensor(data, device=k.device).to(torch.int64)) & _M
    o0, o1 = _threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    o0, o1 = torch.broadcast_tensors(o0, o1)
    return _like(torch.stack([o0, o1], dim=-1), key)


def _bits(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """32-bit random words (int64 tensor) of ``key (..., 2)`` for
    ``shape``: ``(..., *shape)``, each batch entry drawn with its own key
    exactly as ``jax.random.bits(key, shape)`` would."""
    k = as_key(key)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    idx = torch.arange(n, device=k.device, dtype=torch.int64)
    batch = k.shape[:-1]
    k0 = k[..., 0].reshape(*batch, 1)
    k1 = k[..., 1].reshape(*batch, 1)
    o0, o1 = _threefry2x32(k0, k1, idx >> 32, idx & _M)
    return (o0 ^ o1).reshape(*batch, *shape)


def uniform(key: Key, shape: Sequence[int],
            minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval)`` (``maxval`` 1),
    bit for bit: fp32 ``(..., *shape)`` on the key's device."""
    bits = _bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(1.0, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """The decode path's Gumbel noise: ``-log(-log(u))`` with ``u =
    uniform(key, shape, minval=1e-20)``."""
    return -torch.log(-torch.log(uniform(key, shape, 1e-20)))

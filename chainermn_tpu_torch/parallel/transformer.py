"""Transformer LM pieces used by decoding: layer norm, RoPE, QKV projection, init.

Counterpart of ``chainermn_tpu/parallel/transformer.py``.  Parameters are
the same nested dict as the JAX package's (``embed``, optional
``pos_embed``, ``blocks[i]`` with ``ln1_*``/``ln2_*``/``attn``/``mlp``,
``lnf_*``), holding torch tensors; ``convert.py`` maps one onto the other.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .._device import resolve_device
from .tensor_parallel import column_parallel_dense


def _layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm in fp32, cast back to x's dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_rope(x, positions, *, base: float = 10000.0):
    """Rotary position embedding over ``(B, S, H, head_dim)``.
    ``positions (S,)`` rotate every row alike; ``positions (B, S)`` rotate
    each row at its own positions (the serving tick)."""
    half = x.shape[-1] // 2
    if x.shape[-1] % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {x.shape[-1]}")
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None] * freqs                 # (.., S, half)
    if positions.dim() == 2:
        cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    else:
        cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _project_qkv(h, a, head_dim: int):
    """``q (B, S, H, hd)``, ``k, v (B, S, H_kv, hd)`` from either layout:
    the fused head-major ``wqkv`` (columns ``[head0: q|k|v, head1: …]``) or
    ``wq`` plus the kv-head-major ``wkv`` (GQA)."""
    b, s, _ = h.shape
    if "wq" in a:
        q = column_parallel_dense(h, a["wq"], a["bq"]).reshape(b, s, -1, head_dim)
        kv = column_parallel_dense(h, a["wkv"], a["bkv"])
        if kv.shape[-1] % (2 * head_dim):
            raise ValueError(f"wkv width {kv.shape[-1]} is not a whole number "
                             f"of KV heads (2*head_dim={2 * head_dim})")
        kv = kv.reshape(b, s, -1, 2, head_dim)
        return q, kv[..., 0, :], kv[..., 1, :]
    qkv = column_parallel_dense(h, a["wqkv"], a["bqkv"])
    qkv = qkv.reshape(b, s, -1, 3, head_dim)
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


def init_tp_transformer_lm(rng, vocab: int, d_model: int, n_heads: int,
                           n_layers: int, d_hidden: Optional[int] = None,
                           max_len: int = 512, dtype=torch.float32,
                           n_kv_heads: Optional[int] = None,
                           pos_impl: str = "learned",
                           device="cuda") -> Dict[str, Any]:
    """Random-init parameters with the JAX package's layout and scale rules
    (He-normal dense and embedding, ``0.02``-normal learned positions,
    zero biases, unit norms).  ``rng`` is a ``torch.Generator`` or an int
    seed; the draws match JAX's in distribution, not in bits."""
    if pos_impl not in ("learned", "rope"):
        raise ValueError(f"pos_impl must be 'learned' or 'rope', got {pos_impl!r}")
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} not divisible by n_heads {n_heads}")
    if n_kv_heads is not None and n_heads % n_kv_heads:
        raise ValueError(
            f"n_heads {n_heads} not a multiple of n_kv_heads {n_kv_heads}")
    dev = resolve_device(device)
    gen = rng
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(rng))
    gqa = n_kv_heads is not None and n_kv_heads != n_heads
    d_hidden = d_hidden or 4 * d_model
    head_dim = d_model // n_heads

    def normal(*shape, std):
        t = torch.randn(*shape, generator=gen, device=gen.device) * std
        return t.to(device=dev, dtype=dtype)

    def dense(n_in, n_out):
        return normal(n_in, n_out, std=(2.0 / n_in) ** 0.5)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=dev)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    embed = normal(vocab, d_model, std=(2.0 / d_model) ** 0.5)
    pos_embed = (normal(max_len, d_model, std=0.02) if pos_impl == "learned"
                 else None)
    blocks = []
    for _ in range(n_layers):
        if gqa:
            d_kv = n_kv_heads * head_dim
            wq = dense(d_model, d_model)
            wk = dense(d_model, d_kv).reshape(d_model, n_kv_heads, head_dim)
            wv = dense(d_model, d_kv).reshape(d_model, n_kv_heads, head_dim)
            attn = {"wq": wq, "bq": zeros(d_model),
                    "wkv": torch.stack([wk, wv], dim=2).reshape(d_model, 2 * d_kv),
                    "bkv": zeros(2 * d_kv)}
        else:
            wq, wk, wv = (dense(d_model, d_model).reshape(d_model, n_heads, head_dim)
                          for _ in range(3))
            attn = {"wqkv": torch.stack([wq, wk, wv], dim=2).reshape(
                        d_model, 3 * d_model),
                    "bqkv": zeros(3 * d_model)}
        attn["wo"] = dense(d_model, d_model)
        attn["bo"] = zeros(d_model)
        blocks.append({
            "ln1_scale": ones(d_model), "ln1_bias": zeros(d_model),
            "ln2_scale": ones(d_model), "ln2_bias": zeros(d_model),
            "attn": attn,
            "mlp": {"wi": dense(d_model, d_hidden), "bi": zeros(d_hidden),
                    "wo": dense(d_hidden, d_model), "bo": zeros(d_model)},
        })
    out = {"embed": embed, "blocks": blocks,
           "lnf_scale": ones(d_model), "lnf_bias": zeros(d_model)}
    if pos_embed is not None:
        out["pos_embed"] = pos_embed
    return out

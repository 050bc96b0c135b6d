"""Transformer LM at TP = 1: layer norm, RoPE, QKV projection, blocks, the loss, init.

Counterpart of ``chainermn_tpu/parallel/transformer.py``.  Parameters are
the same nested dict as the JAX package's (``embed``, optional
``pos_embed``, ``blocks[i]`` with ``ln1_*``/``ln2_*``/``attn``/``mlp``,
``lnf_*``), holding torch tensors; ``convert.py`` maps one onto the other.

The training path is :func:`tp_transformer_lm_loss` → autograd: attention
by the materialising ``"xla"`` path or the flash kernels (``ops.flash_attention``,
forward and fused backward), the LM loss by the materialising ``"xla"``
path or the fused cross-entropy kernels (``ops.fused_ce``).  The port runs
on one card, so the model axis has size 1 and every collective of the
vocab-parallel loss (``pmax``/``psum`` in ``tensor_parallel``) is a named
identity.  :func:`block_with` is the one pre-norm block body, shared with
``decode.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .._device import resolve_device
from ..ops.flash_attention import flash_attention, resolve_attn_impl
from ..ops.fused_ce import fused_cross_entropy
from .tensor_parallel import (column_parallel_dense, pmax, psum,
                              row_parallel_dense, tp_mlp,
                              vocab_parallel_embedding)


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


def attention_with(h, a, head_dim: int, attend, positions=None):
    """QKV projection, RoPE when ``positions`` is given, ``attend(q, k, v)
    -> (ctx (B, S, H, hd), extras)``, then the row-parallel output
    projection.  Returns ``(out (B, S, D), extras)``."""
    b, s, _ = h.shape
    q, k, v = _project_qkv(h, a, head_dim)
    if positions is not None:
        q = apply_rope(q, positions)
        k = apply_rope(k, positions)
    ctx, extras = attend(q, k, v)
    return row_parallel_dense(ctx.reshape(b, s, -1), a["wo"], a["bo"]), extras


def block_with(x, blk, attention):
    """Pre-norm transformer block: ``x + attention(LN1 x)``, then ``+ MLP(LN2
    x)``.  ``attention(h) -> (out, extras)``; returns ``(x, *extras)``."""
    h = _layer_norm(x, blk["ln1_scale"], blk["ln1_bias"])
    out, extras = attention(h)
    x = x + out
    h = _layer_norm(x, blk["ln2_scale"], blk["ln2_bias"])
    return (x + tp_mlp(h, blk["mlp"]),) + tuple(extras)


def _attend_local_heads(q, k, v, *, causal: bool, attn_impl: str,
                        head_dim: int):
    """Attention over ``q (B, S, H, hd)``, GQA-aware: the flash kernels
    (``"flash"``) or the materialising path (``"xla"``: fp32 scores,
    ``-1e30`` causal fill, softmax, ``p`` rounded to v's dtype)."""
    if attn_impl == "flash":
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal)
    h_local, s = q.shape[2], q.shape[1]
    if k.shape[2] != h_local:
        g = h_local // k.shape[2]
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / (head_dim ** 0.5)
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def tp_attention(x, params, *, head_dim: int, causal: bool = True,
                 attn_impl: str = "auto", positions=None):
    """Multi-head self-attention over ``x (B, S, D)``: fused head-major
    ``wqkv`` (or ``wq`` + ``wkv`` for GQA), then the output projection."""
    impl = resolve_attn_impl(attn_impl, x.shape[1], head_dim, x.device)

    def attend(q, k, v):
        return _attend_local_heads(q, k, v, causal=causal, attn_impl=impl,
                                   head_dim=head_dim), ()

    return attention_with(x, params, head_dim, attend, positions)[0]


def tp_block(x, params, *, head_dim: int, causal: bool = True,
             attn_impl: str = "auto", positions=None):
    """Pre-norm transformer block: LN→attn→residual, LN→MLP→residual."""
    return block_with(x, params, lambda h: (tp_attention(
        h, params["attn"], head_dim=head_dim, causal=causal,
        attn_impl=attn_impl, positions=positions), ()))[0]


def _vp_combine(m, l, picked):
    """The vocab-parallel combine of JAX's ``_fused_vp_nll``: shard-local
    stats, then the ``pmax`` and ``psum`` legs (identities at world 1)."""
    gm = pmax(m)
    lse = gm + torch.log(psum(l * torch.exp(m - gm)))
    return lse, psum(picked)        # the owner shard contributes; rest 0


# 'auto' takes the fused kernels once the materialised local logits would
# pass this many bytes (JAX's threshold, transformer.py _FUSED_CE_AUTO_BYTES).
_FUSED_CE_AUTO_BYTES = 8 << 30


def vocab_parallel_logits_loss(h, table, targets, *, ce_impl: str = "auto"):
    """Mean cross-entropy of ``h (B, S, D)`` against the (tied) table
    ``(V, D)`` at ``targets (B, S)``.  ``"xla"`` materialises the fp32
    logits; ``"fused"`` runs the fused-CE kernels; ``"auto"`` picks fused
    on a CUDA device once the logits would pass 8 GB with ``B·S`` and ``V``
    multiples of 8, xla otherwise."""
    vocab = table.shape[0]
    start = 0                        # this shard's first vocabulary id
    b, s, d = h.shape
    if ce_impl == "auto":
        big = b * s * vocab * 4 > _FUSED_CE_AUTO_BYTES
        aligned = (b * s) % 8 == 0 and vocab % 8 == 0
        ce_impl = "fused" if (big and h.is_cuda and aligned) else "xla"
    if ce_impl == "fused":
        local_t = (targets - start).reshape(-1)
        return fused_cross_entropy(h.reshape(b * s, d), table, local_t,
                                   combine=_vp_combine).mean()
    if ce_impl != "xla":
        raise ValueError(
            f"ce_impl must be 'auto', 'xla' or 'fused', got {ce_impl!r}")
    logits = torch.matmul(h.float(), table.float().t())          # (B, S, V)
    # the max shift is numerics only: no gradient flows through it
    m = pmax(logits.detach().amax(-1))
    sumexp = psum(torch.exp(logits - m[..., None]).sum(-1))
    local_t = (targets - start).long()
    in_range = (local_t >= 0) & (local_t < vocab)
    picked = logits.gather(-1, local_t.clamp(0, vocab - 1)[..., None])[..., 0]
    target_logit = psum(torch.where(in_range, picked,
                                    torch.zeros((), device=h.device)))
    return (m + torch.log(sumexp) - target_logit).mean()


def tp_transformer_lm_loss(params, batch, *, head_dim: int,
                           causal: bool = True, attn_impl: str = "auto",
                           ce_impl: str = "auto"):
    """Per-token mean NLL of the decoder-only LM.  ``batch``: ``(tokens
    (B, S+1),)`` — inputs ``[:, :-1]``, targets ``[:, 1:]``."""
    tokens = batch[0]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x = vocab_parallel_embedding(inputs, params["embed"])
    x = x * (params["embed"].shape[1] ** 0.5)
    positions = None
    if "pos_embed" in params:
        x = x + params["pos_embed"][: x.shape[1]][None]
    else:
        positions = torch.arange(x.shape[1], device=x.device)
    for blk in params["blocks"]:
        x = tp_block(x, blk, head_dim=head_dim, causal=causal,
                     attn_impl=attn_impl, positions=positions)
    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    return vocab_parallel_logits_loss(x, params["embed"], targets,
                                      ce_impl=ce_impl)


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

"""Tensor-parallel transformer LM: layer norm, RoPE, QKV projection, blocks, the sequence-parallel block, the vocab-parallel loss, init and specs.

Counterpart of ``chainermn_tpu/parallel/transformer.py``.  Parameters are
the same nested dict as the JAX package's (``embed``, optional
``pos_embed``, ``blocks[i]`` with ``ln1_*``/``ln2_*``/``attn``/``mlp``,
``lnf_*``), holding torch tensors; ``convert.py`` maps one onto the other
and :func:`transformer_lm_specs` says how each leaf is sharded over the
model axis (``convert.shard_from_jax`` cuts them so).

Megatron sharding over ``axis_name`` (see ``tensor_parallel``): QKV and
MLP-in column-parallel (heads: a contiguous ``1/P`` of the head-major
``wqkv`` / ``wkv`` columns is a whole set of heads), attention-out and
MLP-out row-parallel, the tied embedding vocab-parallel, norms and
positions replicated.  ``axis_name=None`` is the one-card path.

The training path is :func:`tp_transformer_lm_loss` → autograd: attention
by the materialising ``"xla"`` path or the flash kernels (``ops.flash_attention``,
forward and fused backward) over this rank's heads, the loss by the
materialising ``"xla"`` path or the fused cross-entropy kernels
(``ops.fused_ce``) over this rank's ``V/P`` vocabulary rows, combined
across the shards by a max and two sums.  :func:`block_with` is the one
pre-norm block body, shared with ``decode.py``.

The sequence-sharded LM (:func:`sp_block`, :func:`sp_transformer_lm_loss`)
keeps the same params replicated and shards the SEQUENCE over the axis:
attention by ``ring_attention`` or ``ulysses_attention``, the logits a
plain fp32 product and ``log_softmax`` over the whole vocabulary, as in
JAX.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..ops.flash_attention import flash_attention, resolve_attn_impl
from ..ops.fused_ce import fused_cross_entropy
from ._factory import P, model_axis
from .tensor_parallel import (axis_index, axis_size, column_parallel_dense,
                              copy_to_model, gather_seq_matmul,
                              matmul_f32, matmul_scatter_seq, pmax,
                              reduce_from_model, row_parallel_dense, tp_mlp,
                              tp_mlp_sp, vocab_parallel_embedding)


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


def _project_qkv(h, a, head_dim: int, axis_name=None):
    """This rank's ``q (B, S, H/P, hd)``, ``k, v (B, S, H_kv/P, hd)`` from
    either layout: the fused head-major ``wqkv`` (columns ``[head0: q|k|v,
    head1: …]``) or ``wq`` plus the kv-head-major ``wkv`` (GQA)."""
    b, s, _ = h.shape
    if "wq" in a:
        q = column_parallel_dense(h, a["wq"], a["bq"], axis_name=axis_name)
        q = q.reshape(b, s, -1, head_dim)
        kv = column_parallel_dense(h, a["wkv"], a["bkv"], axis_name=axis_name)
        if kv.shape[-1] % (2 * head_dim):
            raise ValueError(
                f"local wkv shard width {kv.shape[-1]} is not a whole "
                f"number of KV heads (2*head_dim={2 * head_dim}) — "
                f"n_kv_heads must be divisible by the model-axis size")
        kv = kv.reshape(b, s, -1, 2, head_dim)
        return q, kv[..., 0, :], kv[..., 1, :]
    qkv = column_parallel_dense(h, a["wqkv"], a["bqkv"], axis_name=axis_name)
    qkv = qkv.reshape(b, s, -1, 3, head_dim)
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


def attention_with(h, a, head_dim: int, attend, positions=None,
                   axis_name=None):
    """QKV projection, RoPE when ``positions`` is given, ``attend(q, k, v)
    -> (ctx (B, S, H/P, hd), extras)``, then the row-parallel output
    projection.  Returns ``(out (B, S, D), extras)``."""
    b, s, _ = h.shape
    q, k, v = _project_qkv(h, a, head_dim, axis_name)
    if positions is not None:
        q = apply_rope(q, positions)
        k = apply_rope(k, positions)
    ctx, extras = attend(q, k, v)
    return row_parallel_dense(ctx.reshape(b, s, -1), a["wo"], a["bo"],
                              axis_name=axis_name), extras


def block_with(x, blk, attention, axis_name=None):
    """Pre-norm transformer block: ``x + attention(LN1 x)``, then ``+ MLP(LN2
    x)``.  ``attention(h) -> (out, extras)``; returns ``(x, *extras)``."""
    h = _layer_norm(x, blk["ln1_scale"], blk["ln1_bias"])
    out, extras = attention(h)
    x = x + out
    h = _layer_norm(x, blk["ln2_scale"], blk["ln2_bias"])
    return (x + tp_mlp(h, blk["mlp"], axis_name=axis_name),) + tuple(extras)


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


def tp_attention(x, params, *, head_dim: int, axis_name=None,
                 causal: bool = True, attn_impl: str = "auto",
                 positions=None):
    """Multi-head self-attention over replicated ``x (B, S, D)`` with this
    rank's heads: fused head-major ``wqkv`` (or ``wq`` + ``wkv`` for GQA),
    then the row-parallel output projection (one sum over the model
    axis)."""
    impl = resolve_attn_impl(attn_impl, x.shape[1], head_dim, x.device)

    def attend(q, k, v):
        return _attend_local_heads(q, k, v, causal=causal, attn_impl=impl,
                                   head_dim=head_dim), ()

    return attention_with(x, params, head_dim, attend, positions,
                          axis_name)[0]


def tp_block(x, params, *, head_dim: int, axis_name=None,
             causal: bool = True, attn_impl: str = "auto", positions=None):
    """Pre-norm transformer block: LN→attn→residual, LN→MLP→residual."""
    return block_with(x, params, lambda h: (tp_attention(
        h, params["attn"], head_dim=head_dim, axis_name=axis_name,
        causal=causal, attn_impl=attn_impl, positions=positions), ()),
        axis_name)[0]


def tp_attention_sp(x, params, *, head_dim: int, axis_name,
                    causal: bool = True, attn_impl: str = "auto",
                    positions=None):
    """Megatron-SP attention over sequence-sharded ``x (B, S/P, D)``: the
    sequence gather rides the QKV projection's ring
    (``gather_seq_matmul``), attention runs over this rank's heads and the
    whole sequence, and the output projection's matmul-reduce-scatter
    returns this rank's rows.  ``positions`` are the global ``arange(S)``."""
    b, s_loc, _ = x.shape
    s = s_loc * axis_size(axis_name)
    impl = resolve_attn_impl(attn_impl, s, head_dim, x.device)
    if "wq" in params:
        q = gather_seq_matmul(x, params["wq"], params["bq"],
                              axis_name=axis_name).reshape(b, s, -1, head_dim)
        kv = gather_seq_matmul(x, params["wkv"], params["bkv"],
                               axis_name=axis_name)
        kv = kv.reshape(b, s, -1, 2, head_dim)
        k, v = kv[..., 0, :], kv[..., 1, :]
    else:
        qkv = gather_seq_matmul(x, params["wqkv"], params["bqkv"],
                                axis_name=axis_name)
        qkv = qkv.reshape(b, s, -1, 3, head_dim)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    if positions is not None:
        q = apply_rope(q, positions)
        k = apply_rope(k, positions)
    ctx = _attend_local_heads(q, k, v, causal=causal, attn_impl=impl,
                              head_dim=head_dim)
    return matmul_scatter_seq(ctx.reshape(b, s, -1), params["wo"],
                              params["bo"], axis_name=axis_name)


def tp_block_sp(x, params, *, head_dim: int, axis_name, causal: bool = True,
                attn_impl: str = "auto", positions=None):
    """Megatron-SP block over sequence-sharded ``x (B, S/P, D)``: the
    :func:`tp_block` params; LayerNorms and residuals on the local rows,
    the four collectives on the collective-matmul rings."""
    from .tensor_parallel import tp_mlp_sp

    def ln(x, name):
        # replicated params over this rank's rows: their gradients sum
        # over the model axis
        return _layer_norm(x, copy_to_model(params[f"{name}_scale"], axis_name),
                           copy_to_model(params[f"{name}_bias"], axis_name))

    h = ln(x, "ln1")
    x = x + tp_attention_sp(h, params["attn"], head_dim=head_dim,
                            axis_name=axis_name, causal=causal,
                            attn_impl=attn_impl, positions=positions)
    return x + tp_mlp_sp(ln(x, "ln2"), params["mlp"], axis_name=axis_name)


def sp_block(x, params, *, head_dim: int, axis_name, causal: bool = True,
             attn_impl: str = "auto", sp_impl: str = "ring",
             positions=None):
    """Transformer block with the SEQUENCE sharded over ``axis_name``:
    ``x (B, S/P, D)`` this rank's shard, ``params`` REPLICATED (the
    :func:`tp_block` layout, unsharded).  Attention runs over ``sp_impl``:
    ``"ring"`` (K/V rotate around the ring, any head count) or
    ``"ulysses"`` (two all-to-alls; ``n_heads % P == 0``); LayerNorms and
    the MLP act on the local positions.  ``positions``: this shard's
    GLOBAL positions (RoPE), or None."""
    from .ring_attention import ring_attention
    from .ulysses import ulysses_attention

    b, s_local, d = x.shape
    a = params["attn"]
    h = _layer_norm(x, params["ln1_scale"], params["ln1_bias"])
    # replicated params: the projection gives every head (GQA: fewer KV
    # heads ride the ring / the all-to-all)
    q, k, v = _project_qkv(h, a, head_dim)
    if positions is not None:
        # RoPE at GLOBAL positions, before K/V leave this rank
        q = apply_rope(q, positions)
        k = apply_rope(k, positions)
    if sp_impl == "ring":
        ctx = ring_attention(q, k, v, axis_name, causal=causal,
                             attn_impl=attn_impl)
    elif sp_impl == "ulysses":
        ctx = ulysses_attention(q, k, v, axis_name, causal=causal,
                                attn_impl=attn_impl)
    else:
        raise ValueError(
            f"sp_impl must be 'ring' or 'ulysses', got {sp_impl!r}")
    attn_out = matmul_f32(ctx.reshape(b, s_local, d), a["wo"]).to(x.dtype)
    x = x + attn_out + a["bo"]
    h = _layer_norm(x, params["ln2_scale"], params["ln2_bias"])
    mlp = params["mlp"]
    y = F.gelu(matmul_f32(h, mlp["wi"]).to(x.dtype) + mlp["bi"],
               approximate="tanh")
    y = matmul_f32(y, mlp["wo"]).to(x.dtype)
    return x + y + mlp["bo"]


def sp_transformer_lm_loss(params, batch, *, head_dim: int, axis_name,
                           causal: bool = True, attn_impl: str = "auto",
                           sp_impl: str = "ring"):
    """Per-token mean NLL of this rank's sequence shard.  ``batch``:
    ``(inputs (B, S/P), targets (B, S/P))``, the ``(B, S)`` tokens shifted
    globally BEFORE sharding over the sequence axis; params replicated.
    Mean the loss over the axis and the gradients like data parallelism
    (``make_hybrid_shard_map_step`` with ``data_axis=axis_name``)."""
    inputs, targets = batch
    s_local = inputs.shape[1]
    s_global = axis_size(axis_name) * s_local
    pos = axis_index(axis_name) * s_local + torch.arange(
        s_local, device=inputs.device)
    x = params["embed"][inputs.long()]
    x = x * (params["embed"].shape[1] ** 0.5)
    positions = None
    if "pos_embed" in params:
        max_len = params["pos_embed"].shape[0]
        if s_global > max_len:
            raise ValueError(
                f"global sequence {s_global} exceeds pos_embed max_len "
                f"{max_len}; re-init the model with max_len >= {s_global}")
        x = x + params["pos_embed"][pos][None]
    else:                       # RoPE: rotated inside attention
        positions = pos
    for blk in params["blocks"]:
        x = sp_block(x, blk, head_dim=head_dim, axis_name=axis_name,
                     causal=causal, attn_impl=attn_impl, sp_impl=sp_impl,
                     positions=positions)
    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    logits = matmul_f32(x, params["embed"].t())                # (B, S/P, V)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return nll.mean()


def _vp_combine(m, l, picked, axis_name=None):
    """The vocab-parallel combine of JAX's ``_fused_vp_nll``: shard-local
    stats, then a max and two sums over the model axis, in fp32."""
    gm = pmax(m, axis_name)
    lse = gm + torch.log(reduce_from_model(l * torch.exp(m - gm), axis_name))
    # the owner shard contributes the target logit; the rest 0
    return lse, reduce_from_model(picked, axis_name)


# 'auto' takes the fused kernels once the materialised local logits would
# pass this many bytes (JAX's threshold, transformer.py _FUSED_CE_AUTO_BYTES).
_FUSED_CE_AUTO_BYTES = 8 << 30


def vocab_parallel_logits_loss(h, table, targets, *, axis_name=None,
                               ce_impl: str = "auto"):
    """Mean cross-entropy of replicated ``h (B, S, D)`` against this rank's
    vocabulary shard ``table (V/P, D)`` of the tied embedding at global
    ``targets (B, S)``; the ``(B, S, V)`` logits never exist whole.
    ``"xla"`` materialises the local fp32 logits (the max shift on detached
    logits, ``sum exp`` and the owner shard's target logit summed over the
    model axis); ``"fused"`` runs the fused-CE kernels, whose backward sums
    ``dh`` over the model axis; ``"auto"`` picks fused on a CUDA device
    once the local logits would pass 8 GB with ``B·S`` and ``V/P``
    multiples of 8, xla otherwise."""
    vocab = table.shape[0]
    start = axis_index(axis_name) * vocab    # this shard's first id
    b, s, d = h.shape
    if ce_impl == "auto":
        big = b * s * vocab * 4 > _FUSED_CE_AUTO_BYTES
        aligned = (b * s) % 8 == 0 and vocab % 8 == 0
        ce_impl = "fused" if (big and h.is_cuda and aligned) else "xla"
    if ce_impl == "fused":
        local_t = (targets - start).reshape(-1)
        return fused_cross_entropy(h.reshape(b * s, d), table, local_t,
                                   combine=partial(_vp_combine,
                                                   axis_name=axis_name),
                                   dh_axis=model_axis(axis_name)).mean()
    if ce_impl != "xla":
        raise ValueError(
            f"ce_impl must be 'auto', 'xla' or 'fused', got {ce_impl!r}")
    logits = torch.matmul(copy_to_model(h, axis_name).float(),
                          table.float().t())               # (B, S, V/P)
    # the max shift is numerics only: no gradient flows through it
    m = pmax(logits.detach().amax(-1), axis_name)
    sumexp = reduce_from_model(torch.exp(logits - m[..., None]).sum(-1),
                               axis_name)
    local_t = (targets - start).long()
    in_range = (local_t >= 0) & (local_t < vocab)
    picked = logits.gather(-1, local_t.clamp(0, vocab - 1)[..., None])[..., 0]
    target_logit = reduce_from_model(
        torch.where(in_range, picked, torch.zeros((), device=h.device)),
        axis_name)
    return (m + torch.log(sumexp) - target_logit).mean()


def tp_transformer_lm_loss(params, batch, *, head_dim: int, axis_name=None,
                           causal: bool = True, attn_impl: str = "auto",
                           ce_impl: str = "auto"):
    """Per-token mean NLL of the decoder-only LM over this rank's batch
    rows (``make_hybrid_shard_map_step`` means it over the data axis).
    ``batch``: ``(tokens (B, S+1),)`` — inputs ``[:, :-1]``, targets
    ``[:, 1:]``."""
    tokens = batch[0]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x = vocab_parallel_embedding(inputs, params["embed"], axis_name=axis_name)
    x = x * (params["embed"].shape[1] ** 0.5)
    positions = None
    if "pos_embed" in params:
        x = x + params["pos_embed"][: x.shape[1]][None]
    else:
        positions = torch.arange(x.shape[1], device=x.device)
    for blk in params["blocks"]:
        x = tp_block(x, blk, head_dim=head_dim, axis_name=axis_name,
                     causal=causal, attn_impl=attn_impl, positions=positions)
    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    return vocab_parallel_logits_loss(x, params["embed"], targets,
                                      axis_name=axis_name, ce_impl=ce_impl)


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


def transformer_lm_specs(params, axis_name: str = "model"):
    """The :class:`~chainermn_tpu_torch.parallel._factory.PartitionSpec`
    of each leaf of :func:`init_tp_transformer_lm`'s tree: QKV / MLP-in
    column-sharded, attention-out / MLP-out row-sharded, the tied
    embedding vocab-sharded, norms and positions replicated."""
    ax = axis_name

    def block_specs(blk):
        if "wq" in blk["attn"]:          # GQA: separate q / fused kv
            attn = {"wq": P(None, ax), "bq": P(ax),
                    "wkv": P(None, ax), "bkv": P(ax),
                    "wo": P(ax, None), "bo": P()}
        else:
            attn = {"wqkv": P(None, ax), "bqkv": P(ax),
                    "wo": P(ax, None), "bo": P()}
        return {"ln1_scale": P(), "ln1_bias": P(),
                "ln2_scale": P(), "ln2_bias": P(), "attn": attn,
                "mlp": {"wi": P(None, ax), "bi": P(ax),
                        "wo": P(ax, None), "bo": P()}}

    out = {"embed": P(ax, None),
           "blocks": [block_specs(b) for b in params["blocks"]],
           "lnf_scale": P(), "lnf_bias": P()}
    if "pos_embed" in params:
        out["pos_embed"] = P()
    return out

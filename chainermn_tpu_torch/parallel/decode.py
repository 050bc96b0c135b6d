"""Autoregressive decoding with a KV cache for the transformer LM.

Counterpart of ``chainermn_tpu/parallel/decode.py``, greedy path: prefill
(the full prompt through the stack, caches written by the append kernel,
causal attention by the flash kernel) and the per-tick step (one token per
row, its K/V appended at the row's position, decode attention over the
row's own prefix).  ``lm_generate`` drives the same two steps in a plain
Python loop where JAX runs one ``lax.scan``.

The cache layout is the JAX package's flat ``(B, total, H_kv·head_dim)``.
The port runs on one card (TP = 1): the psum sites of the TP layers are
identities (``tensor_parallel.psum``) and the greedy pick's ``(pmax,
pmin)`` pair is :func:`_pmax` / :func:`_pmin` at world 1.

Not in this slice: sampling (``temperature > 0`` raises: JAX's threefry
Gumbel noise cannot be reproduced), the chunked fill (``s_q > 1`` at a
nonzero write position raises), GQA decode and beam search.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.decode_attention import decode_attend
from ..ops.flash_attention import flash_attention
from ..ops.kv_cache import cache_append
from .tensor_parallel import matmul_f32, vocab_parallel_embedding
from .transformer import _layer_norm, attention_with, block_with


def _check_greedy(temperature: float) -> None:
    if temperature > 0.0:
        raise NotImplementedError(
            "sampling (temperature > 0) is not ported yet: JAX's threefry "
            "Gumbel noise cannot be reproduced bit for bit")


def _pmax(x):
    """Cross-shard max of the greedy pick.  Identity at world 1."""
    return x


def _pmin(x):
    """Cross-shard min of the greedy pick's winners.  Identity at world 1."""
    return x


def _decoder_core(params, head_dim: int):
    """``(embed, attn_block, block_with, rope)`` — the incremental-decoding
    machinery shared by prefill and the tick."""
    d_model = params["embed"].shape[1]
    rope = "pos_embed" not in params

    def embed(tokens, positions):
        x = vocab_parallel_embedding(tokens, params["embed"])
        x = x * (d_model ** 0.5)
        if not rope:
            table = params["pos_embed"]
            # JAX's take fills out-of-range rows; torch raises (or device-
            # asserts on CUDA).  Only a free slot's drifting position goes
            # out of range, and its row's output is discarded, so the
            # lookup position is clamped.
            pe = table[positions.clamp(0, table.shape[0] - 1)]
            x = x + (pe if positions.dim() == 2 else pe[None])
        return x

    def attn_block(x, blk, k_cache, v_cache, positions, write_at, q_valid):
        """x (N, S, D) → block output; the caches are written IN PLACE at
        ``write_at`` (a Python int, or an int32 ``(N,)`` tensor for the
        serving tick).  ``s_q > 1`` is the prefill (``write_at == q_valid
        == 0``, causal flash attention over the prompt); ``s_q == 1`` is
        the decode tick, each row attending its own prefix
        ``[0, q_valid]``."""
        n = x.shape[0]

        def attend(q, k, v):
            s_q, hl, hkv = q.shape[1], q.shape[2], k.shape[2]
            cache_append(k_cache, v_cache, k.reshape(n, s_q, hkv * head_dim),
                         v.reshape(n, s_q, hkv * head_dim), write_at, axis=1)
            if s_q > 1:
                if not (isinstance(write_at, int) and write_at == 0
                        and isinstance(q_valid, int) and q_valid == 0):
                    raise NotImplementedError(
                        "chunked fill (s_q > 1 at a nonzero write position) "
                        "is not ported yet")
                ctx = flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=True)
                return ctx.to(x.dtype), (k_cache, v_cache)
            if hl != hkv:
                raise NotImplementedError(
                    "GQA decode (n_kv_heads < n_heads) is not ported yet")
            ctx = decode_attend(q.reshape(n, hl * head_dim), k_cache, v_cache,
                                q_valid, n_heads=hkv, head_dim=head_dim)
            return ctx.reshape(n, 1, hl, head_dim).to(x.dtype), (k_cache, v_cache)

        return block_with(x, blk, lambda h: attention_with(
            h, blk["attn"], head_dim, attend, positions if rope else None))

    return embed, attn_block, block_with, rope


def _check_length(params, total: int, rope: bool) -> None:
    if not rope and total > params["pos_embed"].shape[0]:
        raise ValueError(
            f"prompt + max_new_tokens = {total} exceeds the learned "
            f"pos_embed max_len {params['pos_embed'].shape[0]}; shorten the "
            f"generation or init the model with pos_impl='rope'")


def _kv_heads(params, head_dim: int) -> int:
    a = params["blocks"][0]["attn"]
    return (a["wkv"].shape[1] // (2 * head_dim) if "wkv" in a
            else a["bqkv"].shape[0] // (3 * head_dim))


def _prefill(params, embed, attn_block, prompt, total: int, head_dim: int):
    """The full prompt through the stack: ``(h_final, caches)`` with
    per-layer flat caches of length ``total`` (prompt written, tail
    zeros)."""
    b, s_p = prompt.shape
    n_kv = _kv_heads(params, head_dim)
    positions = torch.arange(s_p, device=prompt.device)
    x = embed(prompt, positions)
    caches = []
    for blk in params["blocks"]:
        kc = torch.zeros((b, total, n_kv * head_dim), dtype=x.dtype,
                         device=x.device)
        vc = torch.zeros_like(kc)
        x, kc, vc = attn_block(x, blk, kc, vc, positions, 0, 0)
        caches.append((kc, vc))
    return _layer_norm(x, params["lnf_scale"], params["lnf_bias"]), caches


def _greedy_token(table, h_last):
    """Greedy next token from ``h_last (N, D)`` against the embedding
    table, logits in fp32; ties go to the lowest index (``torch.argmax``
    returns the first maximum, as JAX's argmax does)."""
    logits = matmul_f32(h_last, table.t())
    best = _pmax(logits.max(-1).values)
    idx = logits.argmax(-1)
    winner = logits.gather(1, idx[:, None])[:, 0] == best
    return _pmin(torch.where(winner, idx, torch.full_like(idx, 2 ** 30))
                 ).to(torch.int32)


def _next_token(table, h_last, temps=None):
    """The serving tick's selection step, greedy only in this slice:
    ``temps`` (per-row temperatures) must all be ``<= 0``."""
    if temps is not None:
        _check_greedy(float(np.max(temps)))
    return _greedy_token(table, h_last)


def lm_prefill(params, prompt, total: int, *, head_dim: int):
    """Prefill ``prompt (B, S_p)``: returns ``(h (B, S_p, D), caches)``,
    ``h`` after the final layer norm and ``caches`` the per-layer flat
    ``(B, total, H_kv·head_dim)`` K/V pairs with the prompt at rows
    ``[0, S_p)``."""
    embed, attn_block, _, rope = _decoder_core(params, head_dim)
    _check_length(params, total, rope)
    return _prefill(params, embed, attn_block, prompt, total, head_dim)


def lm_decode_tick(params, tokens, caches, pos, *, head_dim: int):
    """One decode tick: consume ``tokens (N,)`` at ``pos`` (a Python int,
    or an int32 ``(N,)`` tensor on the caches' device), append each row's
    K/V in place and attend its prefix ``[0, pos]``.  Returns ``(h_last
    (N, D), caches)``."""
    embed, attn_block, _, _ = _decoder_core(params, head_dim)
    per_row = isinstance(pos, torch.Tensor)
    if per_row:
        positions = pos.long()[:, None]
    else:
        positions = torch.tensor([int(pos)], device=tokens.device)
    x = embed(tokens[:, None], positions)
    new_caches = []
    for blk, (kc, vc) in zip(params["blocks"], caches):
        x, kc, vc = attn_block(x, blk, kc, vc, positions, pos, pos)
        new_caches.append((kc, vc))
    h = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    return h[:, -1], new_caches


def lm_generate(params, prompt, *, head_dim: int, max_new_tokens: int,
                temperature: float = 0.0):
    """Greedy generation of ``max_new_tokens`` from ``prompt (B, S_p)``
    (int tensor on the params' device): prefill, then one tick per new
    token.  Returns ``(B, max_new_tokens) int32``."""
    _check_greedy(temperature)
    b, s_p = prompt.shape
    total = s_p + max_new_tokens
    h, caches = lm_prefill(params, prompt, total, head_dim=head_dim)
    token = _greedy_token(params["embed"], h[:, -1])
    out = [token]
    for i in range(1, max_new_tokens):
        h_last, caches = lm_decode_tick(params, token, caches, s_p + i - 1,
                                        head_dim=head_dim)
        token = _greedy_token(params["embed"], h_last)
        out.append(token)
    return torch.stack(out, dim=1)


def make_lm_generator(*, head_dim: int, max_new_tokens: int,
                      temperature: float = 0.0):
    """``fn(params, prompt) -> (B, max_new) int32`` tokens; the prompt
    (numpy or tensor) goes to the params' device."""
    _check_greedy(temperature)

    def apply(params, prompt):
        p = torch.as_tensor(np.asarray(prompt, np.int64),
                            device=params["embed"].device)
        with torch.inference_mode():
            return lm_generate(params, p, head_dim=head_dim,
                               max_new_tokens=max_new_tokens)

    return apply

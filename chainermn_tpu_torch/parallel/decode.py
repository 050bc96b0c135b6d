"""Autoregressive decoding with a KV cache for the transformer LM.

Counterpart of ``chainermn_tpu/parallel/decode.py``: prefill (the full
prompt through the stack, caches written by the append kernel, causal
attention by the flash kernel), the per-tick step (one token per row, its
K/V appended at the row's position, decode attention over the row's own
prefix: one decode-kernel launch that also writes the K/V row, or for GQA
the append kernel and then the beam kernel), greedy or sampled
next-token choice, and beam search.  ``lm_generate`` and the beam search
drive the ticks in a plain Python loop where JAX runs ``lax.scan``.

The cache layout is the JAX package's flat ``(B, total, H_kv·head_dim)``.
Tensor parallelism composes as in JAX: with ``axis_name`` naming the model
axis, each rank holds its shards (``transformer_lm_specs``), projects and
caches its ``H_kv/P`` heads, and the token choice runs on its ``V/P``
vocabulary rows: a ``(max, index)`` pmax / pmin pair for greedy and
sampled tokens, a pmax / psum log-sum-exp and an all-gather of each
shard's top K for the beam.  ``axis_name=None`` is the one-card path.

Sampling draws JAX's threefry Gumbel noise bit for bit (``prng.py``), so a
sampled generation is held token-exact against JAX like a greedy one.  The
chunked fill (``s_q > 1`` at a nonzero write position or valid length,
scalar or one per row) is JAX's grouped einsum fallback in plain torch:
JAX computes it outside any Pallas kernel; its K/V rows still go through
the append kernel.
"""

from __future__ import annotations

import contextlib
from functools import partial

import numpy as np
import torch

from .. import prng
from ..ops import collective as col
from ..ops.decode_attention import (beam_attend_parts, decode_append_attend,
                                    decode_attend_gqa, gqa_rows, gqa_unrows,
                                    merge_attend_parts)
from ..ops.flash_attention import flash_attention
from ..ops.kv_cache import cache_append
from ._factory import model_axis
from .tensor_parallel import (axis_index, axis_size, matmul_f32, pmax, pmin,
                              reduce_from_model, vocab_parallel_embedding)
from .transformer import _layer_norm, attention_with, block_with


def _decoder_core(params, head_dim: int, axis_name=None):
    """``(embed, attn_block, block_with, rope)`` — the incremental-decoding
    machinery shared by prefill and the tick, over this rank's shards."""
    d_model = params["embed"].shape[1]
    rope = "pos_embed" not in params

    def embed(tokens, positions):
        x = vocab_parallel_embedding(tokens, params["embed"],
                                     axis_name=axis_name)
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
        ``write_at + i`` for the i-th input position (``write_at`` a Python
        int, or an int32 ``(N,)`` tensor: one start per row).  ``s_q == 1``
        is the decode tick, each row writing its token's K/V at
        ``write_at`` and attending its own prefix ``[0, write_at]``, as
        JAX's tick does.  ``s_q > 1`` at ``write_at == q_valid == 0`` (two
        Python ints) is the prefill: causal flash attention over the
        prompt.  Any other ``s_q > 1`` is the chunked fill: query i
        attends the cache ``[0, q_valid + i + 1)`` (``q_valid`` an int, or
        an ``(N,)`` tensor when ``write_at`` is one), JAX's einsum
        fallback."""
        n = x.shape[0]
        per_row = isinstance(write_at, torch.Tensor) and write_at.dim() == 1

        def attend(q, k, v):
            s_q, hl, hkv = q.shape[1], q.shape[2], k.shape[2]
            if s_q == 1 and hl == hkv:
                # the MHA tick: append and attention in one decode-kernel
                # launch, q/k/v read in place from the QKV projection
                ctx = decode_append_attend(q, k, v, k_cache, v_cache,
                                           write_at, n_heads=hkv,
                                           head_dim=head_dim)
                return ctx.reshape(n, 1, hl, head_dim).to(x.dtype), (k_cache, v_cache)
            cache_append(k_cache, v_cache, k.reshape(n, s_q, hkv * head_dim),
                         v.reshape(n, s_q, hkv * head_dim), write_at, axis=1)
            if s_q > 1:
                if (isinstance(write_at, int) and write_at == 0
                        and isinstance(q_valid, int) and q_valid == 0):
                    ctx = flash_attention(q.contiguous(), k.contiguous(),
                                          v.contiguous(), causal=True)
                    return ctx.to(x.dtype), (k_cache, v_cache)
                ctx = _chunk_attend(q, k_cache, v_cache, q_valid, per_row,
                                    head_dim)
                return ctx.to(x.dtype), (k_cache, v_cache)
            # the GQA tick: the g query heads of a KV head are the beam
            # kernel's rows of the cache row
            ctx = decode_attend_gqa(q.reshape(n, hl * head_dim), k_cache,
                                    v_cache, write_at, n_q_heads=hl,
                                    n_kv_heads=hkv, head_dim=head_dim)
            return ctx.reshape(n, 1, hl, head_dim).to(x.dtype), (k_cache, v_cache)

        return block_with(x, blk, lambda h: attention_with(
            h, blk["attn"], head_dim, attend, positions if rope else None,
            axis_name), axis_name)

    return embed, attn_block, block_with, rope


def _chunk_attend(q, k_cache, v_cache, q_valid, per_row: bool,
                  head_dim: int):
    """The chunked fill's attention (JAX ``_decoder_core``'s grouped einsum
    fallback): ``q (N, s_q, H, hd)`` against the UN-expanded flat caches
    ``(N, total, H_kv·hd)``, query i seeing ``q_valid + i + 1`` entries
    (``q_valid[n] + i + 1`` per row when ``per_row``).  Scores and softmax
    in fp32, ``-1e30`` outside the valid prefix, ``p`` rounded to the
    cache's dtype before the context product (JAX's rounding), the context
    summed in fp32.  Returns ``(N, s_q, H, hd)`` in fp32."""
    n, s_q, hl, _ = q.shape
    total = k_cache.shape[1]
    hkv = k_cache.shape[2] // head_dim
    kc4 = k_cache.reshape(n, total, hkv, head_dim)
    vc4 = v_cache.reshape(n, total, hkv, head_dim)
    steps = torch.arange(s_q, device=q.device)
    qv = torch.as_tensor(q_valid, device=q.device).to(torch.int64)
    if per_row:
        valid = (qv[:, None] + steps[None] + 1)[:, None, None, :, None]
    else:
        valid = (qv + steps + 1)[None, None, None, :, None]
    q5 = q.reshape(n, s_q, hkv, hl // hkv, head_dim)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5.float(), kc4.float()) \
        / (head_dim ** 0.5)
    mask = torch.arange(total, device=q.device)[None, None, None, None, :] \
        < valid
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    ctx = torch.einsum("bhgqk,bkhd->bqhgd", p.to(vc4.dtype).float(),
                       vc4.float())
    return ctx.reshape(n, s_q, hl, head_dim)


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


def _pick(local_best, local_idx, axis_name=None):
    """The global argmax of per-shard ``(best, global index)`` pairs:
    ``pmax`` of the values, then ``pmin`` over the winners' indices, so an
    exact tie goes to the lowest index."""
    winner = local_best == pmax(local_best, axis_name)
    return pmin(torch.where(winner, local_idx,
                            torch.full_like(local_idx, 2 ** 30)),
                axis_name).to(torch.int32)


def _greedy_token(table, h_last, axis_name=None):
    """Greedy next token from ``h_last (N, D)`` against this rank's
    vocabulary shard ``table (V/P, D)``, logits in fp32; ties go to the
    lowest index (``torch.argmax`` returns the first maximum, as JAX's
    argmax does)."""
    logits = matmul_f32(h_last, table.t())
    start = axis_index(axis_name) * table.shape[0]
    return _pick(logits.max(-1).values, start + logits.argmax(-1), axis_name)


def _gumbel_rows(keys, step_pos, vocab_per: int, rank: int, device):
    """Per-row Gumbel noise ``(N, V/P)``: row ``n`` draws ``uniform(fold_in(
    fold_in(keys[n], step_pos[n]), rank), (1, V/P), minval=1e-20)`` (the
    model rank folded in last, as JAX does), the draw of ``lm_generate``'s
    B = 1 sampler at that position."""
    sp = torch.as_tensor(step_pos, device=device).to(torch.int64)
    k = prng.fold_in(prng.fold_in(prng.as_key(keys, device), sp), rank)
    return prng.gumbel(k, (1, vocab_per))[:, 0]


def _next_token(table, h_last, keys=None, temps=None, step_pos=None,
                axis_name=None):
    """Per-row greedy-or-sampled next token from ``h_last (N, D)``, the
    serving engine's selection step (JAX's ``_next_token``).

    ``keys (N, 2)`` holds each row's request key (numpy uint32 or an int64
    tensor), ``temps (N,)`` its temperature (``<= 0``: greedy; numpy or a
    tensor) and ``step_pos (N,)`` the position being generated.  A sampled
    row takes the argmax of ``logits / T + gumbel`` with the noise of
    :func:`_gumbel_rows`, so a request sampled through the serving pool is
    token-exact against ``lm_generate(rng=key)`` at B = 1; a greedy row is
    bit-identical to :func:`_greedy_token`.  With no sampled row (or no
    ``temps``) nothing is drawn, as JAX's ``lax.cond`` skips the draw."""
    logits = matmul_f32(h_last, table.t())
    rank = axis_index(axis_name)
    start = rank * table.shape[0]
    best, idx = logits.max(-1).values, start + logits.argmax(-1)
    if temps is not None and not isinstance(temps, torch.Tensor):
        temps = torch.from_numpy(np.asarray(temps, np.float32))
    if temps is None or not bool((temps > 0.0).any()):
        return _pick(best, idx, axis_name)
    t = temps.to(device=logits.device, dtype=torch.float32)
    sample = t > 0.0
    gum = _gumbel_rows(keys, step_pos, logits.shape[1], rank, logits.device)
    scored = logits / torch.where(sample, t, torch.ones_like(t))[:, None] + gum
    best = torch.where(sample, scored.max(-1).values, best)
    idx = torch.where(sample, start + scored.argmax(-1), idx)
    return _pick(best, idx, axis_name)


def _check_rng(temperature: float, rng) -> None:
    if temperature > 0.0 and rng is None:
        raise ValueError(
            "temperature > 0 samples tokens and needs an explicit rng: pass "
            "a key (prng.PRNGKey(...), or a JAX key as numpy); a silent "
            "default key would draw identical token sequences every call")


def lm_prefill(params, prompt, total: int, *, head_dim: int,
               axis_name=None):
    """Prefill ``prompt (B, S_p)``: returns ``(h (B, S_p, D), caches)``,
    ``h`` after the final layer norm and ``caches`` the per-layer flat
    ``(B, total, H_kv/P·head_dim)`` K/V pairs of this rank's heads with the
    prompt at rows ``[0, S_p)``."""
    embed, attn_block, _, rope = _decoder_core(params, head_dim, axis_name)
    _check_length(params, total, rope)
    return _prefill(params, embed, attn_block, prompt, total, head_dim)


def lm_decode_tick(params, tokens, caches, pos, *, head_dim: int,
                   axis_name=None):
    """One decode tick: consume ``tokens (N,)`` at ``pos`` (a Python int,
    or an int32 ``(N,)`` tensor on the caches' device), append each row's
    K/V in place and attend its prefix ``[0, pos]``.  Returns ``(h_last
    (N, D), caches)``."""
    embed, attn_block, _, _ = _decoder_core(params, head_dim, axis_name)
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


def lm_generate(params, prompt, rng=None, *, head_dim: int,
                max_new_tokens: int, temperature: float = 0.0,
                axis_name=None):
    """Generate ``max_new_tokens`` from ``prompt (B, S_p)`` (int tensor on
    the params' device), greedily or, with ``temperature > 0``, sampled
    with the key ``rng`` (required then: ``ValueError`` without it):
    prefill, then one tick per new token.  The sampler draws ONE ``(B,
    V/P)`` uniform per step and shard from ``fold_in(fold_in(rng,
    step_pos), rank)``, JAX's closed-batch layout (counters ``b·V/P +
    v``).  Returns ``(B, max_new_tokens) int32``."""
    _check_rng(temperature, rng)
    b, s_p = prompt.shape
    total = s_p + max_new_tokens
    table = params["embed"]
    key = None if temperature <= 0.0 else prng.as_key(rng, table.device)
    temp = torch.tensor(temperature, dtype=torch.float32, device=table.device)
    rank = axis_index(axis_name)
    start = rank * table.shape[0]

    def logits_next(h_last, step_pos: int):
        if key is None:
            return _greedy_token(table, h_last, axis_name)
        logits = matmul_f32(h_last, table.t())
        k = prng.fold_in(prng.fold_in(key, step_pos), rank)
        scored = logits / temp + prng.gumbel(k, tuple(logits.shape))
        return _pick(scored.max(-1).values, start + scored.argmax(-1),
                     axis_name)

    h, caches = lm_prefill(params, prompt, total, head_dim=head_dim,
                           axis_name=axis_name)
    token = logits_next(h[:, -1], s_p)
    out = [token]
    for i in range(1, max_new_tokens):
        h_last, caches = lm_decode_tick(params, token, caches, s_p + i - 1,
                                        head_dim=head_dim,
                                        axis_name=axis_name)
        token = logits_next(h_last, s_p + i)
        out.append(token)
    return torch.stack(out, dim=1)


def _prompt_on(params, prompt):
    return torch.as_tensor(np.asarray(prompt, np.int64),
                           device=params["embed"].device)


def _bound(mesh, fn):
    """``fn()`` under inference mode, with ``mesh`` bound when given."""
    with torch.inference_mode(), mesh or contextlib.nullcontext():
        return fn()


def make_lm_generator(mesh=None, axis_name: str = "model", *,
                      head_dim: int, max_new_tokens: int,
                      temperature: float = 0.0):
    """``fn(params, prompt[, rng]) -> (B, max_new) int32`` tokens; the
    prompt (numpy or tensor) goes to the params' device.  With a ``mesh``,
    ``params`` are this rank's shards (``transformer_lm_specs`` over
    ``axis_name``) and every rank of the model axis calls ``fn`` with the
    same prompt; without one they are whole.  With ``temperature > 0`` the
    ``rng`` key is required (``ValueError``)."""
    ax = None if mesh is None else axis_name

    def apply(params, prompt, rng=None):
        _check_rng(temperature, rng)
        return _bound(mesh, lambda: lm_generate(
            params, _prompt_on(params, prompt), rng, head_dim=head_dim,
            max_new_tokens=max_new_tokens, temperature=temperature,
            axis_name=ax))

    return apply


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

def _top_k(x, k: int):
    """``jax.lax.top_k`` along the last axis: the ``k`` largest, equal
    values in index order (a stable descending sort; ``torch.topk`` does
    not promise that order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _shard_logprobs(table, h_last, axis_name=None):
    """``(N, D)`` → this shard's log-probs ``(N, V/P)`` normalised across
    the vocab shards (``pmax``/``psum`` logsumexp), and its first id."""
    logits = matmul_f32(h_last, table.t())
    m = pmax(logits.max(-1).values, axis_name)
    z = reduce_from_model(torch.exp(logits - m[:, None]).sum(-1), axis_name)
    return (logits - (m + torch.log(z))[:, None],
            axis_index(axis_name) * table.shape[0])


def _global_topk(table, h_last, k: int, axis_name=None):
    """``(N, D)`` → ``(values (N, K), ids (N, K))``: each shard's top-K,
    all-gathered over the model axis, and the top-K of those."""
    logp, start = _shard_logprobs(table, h_last, axis_name)
    v_loc, i_loc = _top_k(logp, k)
    gv, gi = v_loc, i_loc + start
    axis = model_axis(axis_name)
    if axis is not None:
        gv = col.all_gather(gv, axis, axis=1, tiled=True)
        gi = col.all_gather(gi, axis, axis=1, tiled=True)
    v, pos = _top_k(gv, k)
    return v, gi.gather(1, pos)


def _merge_candidates(global_topk, h, scores, toks_buf, i: int, b: int,
                      k: int):
    """The beam bookkeeping both cache strategies share: top-K of the K·K
    candidate continuations, then the token history reordered by the
    winning parents.  Returns ``(tokens, scores, toks_buf, parent)``."""
    v_k, i_k = global_topk(h[:, -1])                             # (B·K, K)
    cand = scores[:, :, None] + v_k.reshape(b, k, k)
    scores, pos_flat = _top_k(cand.reshape(b, k * k), k)         # (B, K)
    parent = pos_flat // k
    tokens = i_k.reshape(b, k * k).gather(1, pos_flat).to(torch.int32)
    toks_buf = toks_buf.gather(1, parent[:, :, None].expand_as(toks_buf))
    toks_buf[:, :, i] = tokens
    return tokens, scores, toks_buf, parent


def _reorder(cache, parent, b: int, k: int):
    """The physical path's cache gather: beam row ``(b, s)`` takes the
    cache of its parent ``(b, parent[b, s])`` (a copy of the whole cache)."""
    rows = torch.arange(b, device=cache.device)[:, None]
    return cache.view(b, k, *cache.shape[1:])[rows, parent].reshape(
        cache.shape)


def lm_generate_beam(params, prompt, *, head_dim: int, max_new_tokens: int,
                     beam_size: int, lazy_reorder: bool = True,
                     attend_impl: str = "auto", axis_name=None):
    """Beam search with the KV cache: the highest-cumulative-log-prob
    continuation of each prompt among ``beam_size`` beams, fixed length.
    Returns ``(B, max_new_tokens) int32``, the best beam.

    ``lazy_reorder=True`` never moves a cache: the prompt's K/V is computed
    once at batch B and shared by every beam, each beam slot appends to
    its own time-major generated cache, and a ``(B, K, max_new)`` ancestry
    table (reordered by the parents instead of the caches) masks which
    slot wrote each past position of each beam.  ``lazy_reorder=False``
    gathers the ``(B·K, total)`` caches by parent every tick (the test
    oracle).  ``attend_impl``: ``"auto"`` and ``"kernel"`` attend through
    :func:`beam_attend_parts` (the beam kernel on a CUDA tensor, its plain
    version on a CPU tensor); ``"einsum"`` is the joint-softmax oracle."""
    if attend_impl not in ("auto", "kernel", "einsum"):
        raise ValueError(f"attend_impl must be auto|kernel|einsum, "
                         f"got {attend_impl!r}")
    b, s_p = prompt.shape
    k = beam_size
    total = s_p + max_new_tokens
    embed, attn_block, _, rope = _decoder_core(params, head_dim, axis_name)
    _check_length(params, total, rope)
    topk = partial(_global_topk, params["embed"], k=k, axis_name=axis_name)
    if lazy_reorder:
        return _beam_lazy(params, prompt, embed, attn_block, topk,
                          head_dim=head_dim, max_new_tokens=max_new_tokens,
                          beam_size=k, rope=rope,
                          use_kernel=attend_impl != "einsum",
                          axis_name=axis_name)

    h, caches = _prefill(params, embed, attn_block, prompt, total, head_dim)
    caches = [(kc.repeat_interleave(k, 0), vc.repeat_interleave(k, 0))
              for kc, vc in caches]
    scores, tokens = topk(h[:, -1])
    tokens = tokens.to(torch.int32)
    toks_buf = torch.zeros((b, k, max_new_tokens), dtype=torch.int32,
                           device=prompt.device)
    toks_buf[:, :, 0] = tokens
    for i in range(1, max_new_tokens):
        pos = s_p + i - 1
        positions = torch.tensor([pos], device=prompt.device)
        x = embed(tokens.reshape(b * k)[:, None], positions)
        new_caches = []
        for blk, (kc, vc) in zip(params["blocks"], caches):
            x, kc, vc = attn_block(x, blk, kc, vc, positions, pos, pos)
            new_caches.append((kc, vc))
        h = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
        tokens, scores, toks_buf, parent = _merge_candidates(
            topk, h, scores, toks_buf, i, b, k)
        caches = [(_reorder(kc, parent, b, k), _reorder(vc, parent, b, k))
                  for kc, vc in new_caches]
    # the top-K keeps the beams sorted by score: beam 0 is the best
    return toks_buf[:, 0].to(torch.int32)


def _beam_lazy(params, prompt, embed, attn_block, topk, *, head_dim: int,
               max_new_tokens: int, beam_size: int, rope: bool,
               use_kernel: bool, axis_name=None):
    """The ancestry-indexed beam body (see :func:`lm_generate_beam`)."""
    b, s_p = prompt.shape
    k = beam_size
    dev = prompt.device
    n_kv = _kv_heads(params, head_dim)
    # prefill at batch B into caches of the prompt's length: they are never
    # extended, generated tokens live in the per-slot caches
    h, pcaches = _prefill(params, embed, attn_block, prompt, s_p, head_dim)
    scores, tokens = topk(h[:, -1])
    tokens = tokens.to(torch.int32)
    toks_buf = torch.zeros((b, k, max_new_tokens), dtype=torch.int32,
                           device=dev)
    toks_buf[:, :, 0] = tokens
    # TIME-MAJOR flat generated caches: row t·k + slot; the rows written so
    # far are the prefix [0, i·k), read in place through a window view
    gen = [(torch.zeros((b, max_new_tokens * k, n_kv * head_dim),
                        dtype=pk.dtype, device=dev),
            torch.zeros((b, max_new_tokens * k, n_kv * head_dim),
                        dtype=pv.dtype, device=dev)) for pk, pv in pcaches]
    anc = torch.zeros((b, k, max_new_tokens), dtype=torch.int64, device=dev)
    slot_ids = torch.arange(k, device=dev)
    # query heads per KV head: the global ratio, n_kv being this rank's
    g = params["embed"].shape[1] // head_dim // (n_kv * axis_size(axis_name))

    def attend_with(i, pk, pv, gk, gv, amask, amask_rows):
        def attend(q, kk, vv):
            # this tick's K/V of all k slots: rows [(i-1)·k, i·k), one append
            cache_append(gk, gv, kk.reshape(b, k, n_kv * head_dim),
                         vv.reshape(b, k, n_kv * head_dim), (i - 1) * k,
                         pos_aligned=True)
            hl = q.shape[2]
            gk_w, gv_w = gk[:, :i * k], gv[:, :i * k]
            if use_kernel:
                # one pass over each segment (shared prompt; ancestry-masked
                # slots), merged by the flash combine
                qf = gqa_rows(q.reshape(b * k, hl * head_dim), n_kv, g,
                              head_dim)
                kw = dict(beams=k * g, n_heads=n_kv, head_dim=head_dim)
                ctx = merge_attend_parts(
                    [beam_attend_parts(qf, pk, pv, **kw),
                     beam_attend_parts(qf, gk_w, gv_w, amask_rows, **kw)],
                    n_kv, head_dim, q.dtype)
                ctx = gqa_unrows(ctx, n_kv, g, head_dim)
                return ctx.reshape(b * k, 1, hl, head_dim), ()
            return _lazy_einsum(q, pk, pv, gk_w, gv_w, amask, b, k, n_kv, g,
                                head_dim), ()
        return attend

    for i in range(1, max_new_tokens):
        pos = s_p + i - 1
        positions = torch.tensor([pos], device=dev)
        anc[:, :, i - 1] = slot_ids      # position i-1: each slot wrote it
        # ancestry over the live window t < i, in (b, beam, t, slot) order
        # to match the generated rows t·k + slot
        amask = anc[:, :, :i, None] == slot_ids
        amask_rows = amask.reshape(b, k, i * k)
        if g > 1:        # the g query heads of a beam share its mask row
            amask_rows = amask_rows.repeat_interleave(g, dim=1)
        x = embed(tokens.reshape(b * k)[:, None], positions)
        for blk, (pk, pv), (gk, gv) in zip(params["blocks"], pcaches, gen):
            attend = attend_with(i, pk, pv, gk, gv, amask, amask_rows)
            x = block_with(x, blk, lambda hh, a=blk["attn"], f=attend:
                           attention_with(hh, a, head_dim, f,
                                          positions if rope else None,
                                          axis_name), axis_name)[0]
        h = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
        tokens, scores, toks_buf, parent = _merge_candidates(
            topk, h, scores, toks_buf, i, b, k)
        # the parents reorder only the ancestry table, never the caches
        anc = anc.gather(1, parent[:, :, None].expand_as(anc))
    return toks_buf[:, 0].to(torch.int32)


def _lazy_einsum(q, pk, pv, gk_w, gv_w, amask, b, k, n_kv, g, head_dim):
    """The lazy tick's joint-softmax attention (JAX's einsum fallback):
    prompt scores against the shared cache, generated scores against every
    slot with the ancestry mask, one softmax over both, ``p`` rounded to
    the caches' dtype before the value products."""
    t = amask.shape[2]
    s_p = pk.shape[1]
    scale = head_dim ** 0.5
    q6 = q.float().reshape(b, k, n_kv, g, head_dim)
    pk4 = pk.float().reshape(b, s_p, n_kv, head_dim)
    pv4 = pv.float().reshape(b, s_p, n_kv, head_dim)
    gk5 = gk_w.float().reshape(b, t, k, n_kv, head_dim)
    gv5 = gv_w.float().reshape(b, t, k, n_kv, head_dim)
    sp = torch.einsum("bshgd,bthd->bshgt", q6, pk4) / scale
    sg = torch.einsum("bshgd,btlhd->bshgtl", q6, gk5) / scale
    sg = sg.masked_fill(~amask[:, :, None, None], -1e30)
    p = torch.softmax(torch.cat([sp, sg.reshape(b, k, n_kv, g, t * k)], -1),
                      dim=-1)
    p_p = p[..., :s_p].to(pv.dtype).float()
    p_g = p[..., s_p:].reshape(sg.shape).to(gv_w.dtype).float()
    ctx = (torch.einsum("bshgt,bthd->bshgd", p_p, pv4)
           + torch.einsum("bshgtl,btlhd->bshgd", p_g, gv5))
    return ctx.to(q.dtype).reshape(b * k, 1, n_kv * g, head_dim)


def make_lm_beam_generator(mesh=None, axis_name: str = "model", *,
                           head_dim: int, max_new_tokens: int,
                           beam_size: int, lazy_reorder: bool = True,
                           attend_impl: str = "auto"):
    """``fn(params, prompt) -> (B, max_new) int32``: the best beam of
    :func:`lm_generate_beam`; the prompt goes to the params' device.
    ``mesh`` and ``params`` as in :func:`make_lm_generator`."""
    ax = None if mesh is None else axis_name

    def apply(params, prompt):
        return _bound(mesh, lambda: lm_generate_beam(
            params, _prompt_on(params, prompt), head_dim=head_dim,
            max_new_tokens=max_new_tokens, beam_size=beam_size,
            lazy_reorder=lazy_reorder, attend_impl=attend_impl,
            axis_name=ax))

    return apply

"""Encoder–decoder seq2seq (the reference's translation workload), in PyTorch.

Counterpart of ``chainermn_tpu/models/seq2seq.py`` (reference:
``examples/seq2seq/seq2seq.py``, BASELINE config #3): embed → stacked-LSTM
encoder → stacked-LSTM decoder → projection, trained with teacher forcing
on right-padded pairs (PAD = 0 never enters the loss and never advances
the encoder's state).

Each LSTM layer is flax's ``OptimizedLSTMCell`` step by step: gates i, f,
g, o from input kernels without bias (``wi``, the four concatenated) plus
hidden kernels with bias (``wh``, ``bh``); ``c' = f·c + i·g``, ``h' =
o·tanh(c')``; the carry ``(c, h)`` starts at zero.  The encoder keeps
both c and h where the source is PAD (``m·new + (1−m)·old``) and its
embeddings are multiplied by the mask; the decoder has no mask.  The
stack runs layer by layer over the whole sequence (the same function as
JAX's step-major scan: layer ``i`` at step ``t`` reads only layer ``i``
at ``t − 1`` and layer ``i − 1`` at ``t``), so each layer's input
product is one matmul over every step.  ``dtype`` is the compute dtype;
the parameters stay fp32.  The recurrence is explicit rather than cuDNN's
``nn.LSTM``, whose packed sequences would treat a PAD inside a sequence
differently.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import resolve_device

PAD, BOS, EOS = 0, 1, 2
N_SPECIAL = 3


class _Embed(nn.Module):
    def __init__(self, vocab, units, gen):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.randn(vocab, units, generator=gen) / units ** 0.5)


class _LSTMCell(nn.Module):
    """One layer's parameters: ``wi`` (4H, in), ``wh`` (4H, H), ``bh``
    (4H), the rows in gate order i, f, g, o."""

    def __init__(self, n_in, hidden, gen):
        super().__init__()
        self.wi = nn.Parameter(torch.randn(4 * hidden, n_in, generator=gen)
                               / n_in ** 0.5)
        self.wh = nn.Parameter(torch.randn(4 * hidden, hidden, generator=gen)
                               / hidden ** 0.5)
        self.bh = nn.Parameter(torch.zeros(4 * hidden))


def _cell(gates_x, h, c, wh, bh):
    """One step: ``(c', h')`` from this step's input product."""
    i, f, g, o = (F.linear(h, wh, bh) + gates_x).chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return c_new, torch.sigmoid(o) * torch.tanh(c_new)


class _Stack(nn.Module):
    """Stacked LSTM layers ``lstm0`` … over a ``(B, T, units)`` sequence."""

    def __init__(self, units, hidden, n_layers, gen):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"lstm{i}", _LSTMCell(units if i == 0 else hidden,
                                                  hidden, gen))

    def forward(self, carry, xs, dtype, mask=None):
        """``(final carry, top layer's outputs (B, T, H))``; with ``mask``
        (B, T, 1) a PAD step keeps the layer's previous c and h."""
        new_carry = []
        for i in range(self.n_layers):
            cell = getattr(self, f"lstm{i}")
            gx = F.linear(xs, cell.wi.to(dtype))
            wh, bh = cell.wh.to(dtype), cell.bh.to(dtype)
            c, h = carry[i]
            outs = []
            for t in range(xs.shape[1]):
                c_new, h_new = _cell(gx[:, t], h, c, wh, bh)
                if mask is None:
                    c, h = c_new, h_new
                else:
                    m = mask[:, t]
                    c = torch.where(m, c_new, c)
                    h = torch.where(m, h_new, h)
                outs.append(h_new)
            new_carry.append((c, h))
            xs = torch.stack(outs, 1)
        return new_carry, xs


class Seq2seq(nn.Module):
    """Embed → LSTM encode → LSTM decode (teacher forcing) → logits.

    ``forward(src, tgt_in)`` gives fp32 per-position target logits; ``src``
    and ``tgt_in`` are integer ``(batch, time)`` tensors right-padded with
    PAD.  Parameter names follow flax's tree (``embed_x.embedding``,
    ``encoder.lstm0.wi`` for the four ``ii … io`` kernels, ``proj``), so
    :func:`chainermn_tpu_torch.convert.seq2seq_from_jax` maps one onto the
    other.  Initial weights come from ``seed``."""

    def __init__(self, n_source_vocab: int, n_target_vocab: int,
                 n_units: int = 512, n_layers: int = 3,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.n_layers, self.dtype = n_layers, dtype
        self.embed_x = _Embed(n_source_vocab, n_units, gen)
        self.embed_y = _Embed(n_target_vocab, n_units, gen)
        self.encoder = _Stack(n_units, n_units, n_layers, gen)
        self.decoder = _Stack(n_units, n_units, n_layers, gen)
        self.proj = nn.Linear(n_units, n_target_vocab)
        with torch.no_grad():
            self.proj.weight.copy_(torch.randn(
                n_target_vocab, n_units, generator=gen) / n_units ** 0.5)
            self.proj.bias.zero_()
        self.to(dev)

    def _embed(self, table, ids):
        return table.embedding.to(self.dtype)[ids.long()]

    def encode(self, src):
        """Each layer's final ``(c, h)`` at its sequence's last real token."""
        mask = (src != PAD)[..., None]
        emb = self._embed(self.embed_x, src) * mask.to(self.dtype)
        zeros = emb.new_zeros(emb.shape[0], emb.shape[2])
        carry = [(zeros, zeros)] * self.n_layers
        carry, _ = self.encoder(carry, emb, self.dtype, mask)
        return carry

    def _project(self, hs):
        return F.linear(hs, self.proj.weight.to(self.dtype),
                        self.proj.bias.to(self.dtype)).float()

    def forward(self, src, tgt_in):
        carry = self.encode(src)
        _, hs = self.decoder(carry, self._embed(self.embed_y, tgt_in),
                             self.dtype)
        return self._project(hs)

    @torch.no_grad()
    def translate(self, src, max_len: int = 32):
        """Greedy decoding, ``max_len`` steps, ``(batch, max_len)`` tokens:
        after EOS a row emits PAD."""
        carry = self.encode(src)
        tok = torch.full((src.shape[0],), BOS, dtype=torch.long,
                         device=src.device)
        done = torch.zeros(src.shape[0], dtype=torch.bool, device=src.device)
        out = []
        for _ in range(max_len):
            emb = self._embed(self.embed_y, tok[:, None])
            carry, h = self.decoder(carry, emb, self.dtype)
            nxt = self._project(h[:, 0]).argmax(-1)
            nxt = torch.where(done, torch.full_like(nxt, PAD), nxt)
            done = done | (nxt == EOS)
            out.append(nxt)
            tok = nxt
        return torch.stack(out, 1)


def masked_cross_entropy(logits, tgt_out):
    """Mean NLL over the non-PAD target positions."""
    logp = F.log_softmax(logits.float(), -1)
    nll = -logp.gather(-1, tgt_out.long()[..., None])[..., 0]
    mask = (tgt_out != PAD).to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp(min=1)


def token_accuracy(logits, tgt_out):
    mask = tgt_out != PAD
    hit = (logits.argmax(-1) == tgt_out.long()) & mask
    return hit.sum() / mask.sum().clamp(min=1)


def encode_pairs(pairs: Sequence[Tuple[Sequence[int], Sequence[int]]],
                 src_len: int, tgt_len: int):
    """Pad (source ids, target ids) pairs into int32 numpy arrays ``src
    (N, src_len)``, ``tgt_in (N, tgt_len)`` (BOS first) and ``tgt_out (N,
    tgt_len)`` (EOS after the target), truncating as the JAX package does."""
    n = len(pairs)
    src = np.full((n, src_len), PAD, np.int32)
    tgt_in = np.full((n, tgt_len), PAD, np.int32)
    tgt_out = np.full((n, tgt_len), PAD, np.int32)
    for i, (s, t) in enumerate(pairs):
        s = list(s)[:src_len]
        t = list(t)[: tgt_len - 1]
        src[i, : len(s)] = s
        tgt_in[i, 0] = BOS
        tgt_in[i, 1 : len(t) + 1] = t
        tgt_out[i, : len(t)] = t
        tgt_out[i, len(t)] = EOS
    return src, tgt_in, tgt_out


__all__ = ["BOS", "EOS", "N_SPECIAL", "PAD", "Seq2seq", "encode_pairs",
           "masked_cross_entropy", "token_accuracy"]

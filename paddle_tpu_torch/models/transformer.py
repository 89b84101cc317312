"""Transformer NMT (port of ``paddle_tpu/models/transformer.py``): an
encoder-decoder with sinusoidal positions, causal decoding, and greedy
and beam-search inference.

``TransformerNMT`` has the JAX model's attribute names, so its
``state_dict()`` keys equal the JAX model's one to one and
``load_numpy_state`` carries weights across by path (the positional
table ``pe`` is a non-persistent buffer in both). The decoder's
self-attention mask is ``nn.Transformer.generate_square_subsequent_mask``
made on the target's device each call, which attention runs as the
flash kernels' causal masking. ``loss`` follows
``FLAGS_fused_vocab_xent``: on (the default), the fused vocabulary
cross-entropy with ``out_proj``'s weight transposed to (V, H), as the
JAX code does; off, the materialised logits through ``F.cross_entropy``.
Padding (``pad_id``) is ignored in both. ``greedy_decode`` reads each
step's tokens on the host, as the JAX method does (it stops when every
sequence has emitted ``eos_id``); ``beam_search_decode`` recomputes the
causal decoder over a fixed (batch * beam, max_len) buffer each step
(``ops.beam_search``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import nn
from .._device import resolve_device
from ..framework.flags import get_flag
from ..nn import functional as F
from ..nn.layer import load_numpy_state
from ..ops import beam_search as _bs

__all__ = ["PositionalEncoding", "TransformerNMT", "load_numpy_state"]


class PositionalEncoding(nn.Layer):
    def __init__(self, d_model, max_len=1024, dropout=0.1, device=None):
        super().__init__()
        pe = np.zeros((max_len, d_model), np.float32)
        pos = np.arange(max_len)[:, None]
        div = np.exp(np.arange(0, d_model, 2)
                     * (-math.log(10000.0) / d_model))
        pe[:, 0::2] = np.sin(pos * div)
        pe[:, 1::2] = np.cos(pos * div)
        self.register_buffer("pe", torch.from_numpy(pe).to(
            resolve_device(device)), persistent=False)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        return self.dropout(F.add(x, self.pe[: x.shape[1]]))


class TransformerNMT(nn.Layer):
    """``device=None`` builds on CUDA (raises without a GPU);
    ``generator`` draws the random initial weights."""

    def __init__(self, src_vocab_size=32000, tgt_vocab_size=32000,
                 d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 max_len=1024, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = {"device": device, "generator": generator}
        self.d_model = d_model
        self.src_embed = nn.Embedding(src_vocab_size, d_model, **kw)
        self.tgt_embed = nn.Embedding(tgt_vocab_size, d_model, **kw)
        self.pos = PositionalEncoding(d_model, max_len, dropout, device)
        self.transformer = nn.Transformer(
            d_model, nhead, num_encoder_layers, num_decoder_layers,
            dim_feedforward, dropout, **kw)
        self.out_proj = nn.Linear(d_model, tgt_vocab_size, **kw)

    def _embed(self, table, ids):
        return self.pos(F.multiply(table(ids), math.sqrt(self.d_model)))

    def _decode_hidden(self, src, tgt, src_mask=None):
        """Everything up to (not including) the vocabulary projection,
        shared by ``forward`` and the fused loss."""
        tgt_mask = nn.Transformer.generate_square_subsequent_mask(
            tgt.shape[1], tgt.device)
        return self.transformer(self._embed(self.src_embed, src),
                                self._embed(self.tgt_embed, tgt),
                                src_mask=src_mask, tgt_mask=tgt_mask)

    def forward(self, src, tgt, src_mask=None):
        return self.out_proj(self._decode_hidden(src, tgt, src_mask))

    def loss(self, src, tgt_in, tgt_out, pad_id=0):
        if get_flag("fused_vocab_xent"):
            # the (B*T, V) logits never land in device memory; the fused
            # kernel takes W as (V, H)
            h = self._decode_hidden(src, tgt_in)
            return F.fused_linear_cross_entropy(
                h, self.out_proj.weight.t(), self.out_proj.bias, tgt_out,
                ignore_index=pad_id)
        return F.cross_entropy(self(src, tgt_in), tgt_out,
                               ignore_index=pad_id)

    def beam_search_decode(self, src, beam_size=4, bos_id=1, eos_id=2,
                           max_len=64, length_penalty=0.6):
        """Beam-search translation: encodes once, repeats the memory over
        the beams and reruns the causal decoder on the fixed token buffer
        each step. Returns (ids (batch, beam, max_len) int32, best beam
        first; scores (batch, beam), length-normalised log-probs)."""
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                memory = self.transformer.encoder(
                    self._embed(self.src_embed, src))
                mem = memory.repeat_interleave(beam_size, dim=0)
                tgt_mask = nn.Transformer.generate_square_subsequent_mask(
                    max_len, src.device)

                def logits_fn(ids_buf, t, _state):
                    out = self.transformer.decoder(
                        self._embed(self.tgt_embed, ids_buf), mem,
                        tgt_mask=tgt_mask)
                    return self.out_proj(out)[:, t]

                return _bs.beam_search_decode(
                    logits_fn, batch_size=src.shape[0], beam_size=beam_size,
                    max_len=max_len, bos_id=bos_id, eos_id=eos_id,
                    length_penalty=length_penalty, device=src.device)
        finally:
            if was_training:
                self.train()

    def greedy_decode(self, src, bos_id=1, eos_id=2, max_len=64):
        """Greedy translation, (batch, <= max_len) int64 ids starting with
        ``bos_id``; a sequence that emitted ``eos_id`` keeps emitting it."""
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                b = src.shape[0]
                ys = torch.full((b, 1), bos_id, dtype=torch.int64,
                                device=src.device)
                finished = np.zeros(b, bool)
                for _ in range(max_len - 1):
                    logits = self(src, ys)
                    nxt = logits[:, -1].argmax(-1).cpu().numpy()
                    nxt[finished] = eos_id
                    finished |= nxt == eos_id
                    ys = torch.cat([ys, torch.from_numpy(
                        nxt.astype(np.int64)).to(src.device)[:, None]],
                        dim=1)
                    if finished.all():
                        break
                return ys
        finally:
            if was_training:
                self.train()

"""Transformer encoder layers (port of the encoder half of
``paddle_tpu/nn/transformer.py``): ``MultiHeadAttention``,
``TransformerEncoderLayer``, ``TransformerEncoder``.

Attention runs through ``functional.scaled_dot_product_attention``
(the flash kernel) on (B, L, H, D); ``attn_mask``/``src_mask`` pass
through unchanged, and a key-padding mask ((B, Lk), (B, 1, Lk) or
(B, 1, 1, Lk), boolean or float) rides the kernel as a key bias. As in
the JAX package, the encoder layers' norms are ``LayerNorm(d_model)``
with the default epsilon 1e-5, and ``TransformerEncoder`` deep-copies
its first layer, so every layer starts from the same weights. The residual
sums are ``F.add`` (the JAX ``add`` op: bf16 under O2). Post-norm
layers only (BERT's); the pre-norm option, cross-attention key/value
widths, the decoder, the key/value cache and per-query masks are later
slices.

``MultiHeadAttention(is_causal=True)`` (GPT's blocks) follows the JAX
rule (``nn/transformer.py:60-75``): without a mask, causal attention
(which rides the ring under sequence parallelism); with one, the causal
constraint is folded into the mask, bottom-right aligned. For a
key-padding mask at Lq == Lk the fold is the kernel's own causal
masking beside the key bias, so the two ride the kernel as they are;
any other fold is a per-query mask, which raises ``NotImplementedError``
until slice 10.
"""
from __future__ import annotations

import copy

from . import functional as F
from ..ops.cuda.flash_attention import key_padding_view
from .common import Dropout, Linear
from .container import LayerList
from .layer import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]


class MultiHeadAttention(Layer):
    """q/k/v projections + scaled dot-product attention (B, L, H, D)."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, is_causal=False,
                 device=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.is_causal = is_causal
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        kw = {"device": device, "generator": generator}
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(embed_dim, embed_dim, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = query if value is None else value
        b, lq = query.shape[0], query.shape[1]
        lk = key.shape[1]
        q = self.q_proj(query).reshape(b, lq, self.num_heads, self.head_dim)
        k = self.k_proj(key).reshape(b, lk, self.num_heads, self.head_dim)
        v = self.v_proj(value).reshape(b, lk, self.num_heads, self.head_dim)
        if self.is_causal and attn_mask is not None and not (
                lq == lk and key_padding_view(attn_mask, b, lk) is not None):
            raise NotImplementedError(
                f"causal attention with a {tuple(attn_mask.shape)} mask at "
                f"Lq {lq}, Lk {lk} folds into a per-query mask, a later "
                f"port slice (slice 10, the decoder)")
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            is_causal=self.is_causal, training=self.training)
        return self.out_proj(out.reshape(b, lq, self.embed_dim))


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 device=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = {"device": device, "generator": generator}
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = activation

    def _act(self, x):
        return F.relu(x) if self.activation == "relu" else F.gelu(x)

    def forward(self, src, src_mask=None):
        src = self.norm1(F.add(src, self.dropout1(
            self.self_attn(src, src, src, src_mask))))
        ffn = self.linear2(self.dropout(self._act(self.linear1(src))))
        return self.norm2(F.add(src, self.dropout2(ffn)))


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] +
            [copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers

    def forward(self, src, src_mask=None):
        for layer in self.layers:
            src = layer(src, src_mask)
        return src

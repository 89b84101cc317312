"""Transformer layers (port of ``paddle_tpu/nn/transformer.py``):
``MultiHeadAttention`` (with its ``Cache`` and ``gen_cache``),
``TransformerEncoderLayer``, ``TransformerEncoder``,
``TransformerDecoderLayer``, ``TransformerDecoder`` and ``Transformer``
with its static ``generate_square_subsequent_mask``.

Attention runs through ``functional.scaled_dot_product_attention`` on
(B, L, H, D), which dispatches by the kind of mask: none, the
subsequent mask that ``generate_square_subsequent_mask`` makes (the
flash kernels' own causal masking, no bias), a key-padding mask
((B, Lk), (B, 1, Lk) or (B, 1, 1, Lk), boolean or float: a key bias in
the flash kernels), or any other (per-query) mask, which runs the
counted plain attention that the JAX package computes outside Pallas.
As in the JAX package, the layers' norms are ``LayerNorm(d_model)``
with the default epsilon 1e-5, ``normalize_before`` moves each norm in
front of its block (and ``Transformer`` then adds a final norm to the
encoder and the decoder), and ``TransformerEncoder``/``Decoder``
deep-copy their first layer, so every layer starts from the same
weights. The residual sums are ``F.add`` (the JAX ``add`` op: bf16
under O2).

``MultiHeadAttention(is_causal=True)`` (GPT's blocks) follows the JAX
rule (``nn/transformer.py:60-75``): without a mask, causal attention
(which rides the ring under sequence parallelism); with one, the causal
constraint is folded into the mask, bottom-right aligned. Two folds
keep their kernel: a key-padding mask at Lq == Lk (the kernel's causal
masking beside the key bias) and the subsequent mask (causal and
causal is causal). Any other fold is a per-query mask, built as the
JAX layer builds it.

``cache`` (a ``MultiHeadAttention.Cache`` of (B, T, H, D) keys and
values) is concatenated in front of this call's keys and values, as in
the JAX layer, and the layer then returns ``(out, new_cache)``;
``gen_cache`` gives an empty one (f32, on the key's device).
``kdim``/``vdim`` set the key and value projections' input widths,
``weight_attr``/``bias_attr`` reach every ``Linear``, and
``need_weights`` is stored only, as in the JAX layer.
"""
from __future__ import annotations

import copy

import torch

from .._device import resolve_device
from . import functional as F
from ..ops.cuda.flash_attention import key_padding_view
from .common import Dropout, Linear
from .container import LayerList
from .layer import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class MultiHeadAttention(Layer):
    """q/k/v projections + scaled dot-product attention (B, L, H, D)."""

    class Cache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, is_causal=False, device=None,
                 generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.is_causal = is_causal
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        kw = {"device": device, "generator": generator}
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr, **kw)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _fold_causal(self, attn_mask, b, lq, lk):
        """The mask and causal flag that ``is_causal`` with ``attn_mask``
        reaches attention as: the JAX fold, except where a kernel takes
        the two as they are."""
        if lq == lk and (F.is_subsequent_mask(attn_mask, lq, lk)
                         or key_padding_view(attn_mask, b, lk) is not None):
            return attn_mask, True
        causal = torch.ones((lq, lk), dtype=torch.bool,
                            device=attn_mask.device).tril(lk - lq)
        if attn_mask.dtype == torch.bool:
            return attn_mask & causal, False
        zero = torch.zeros((), dtype=attn_mask.dtype, device=attn_mask.device)
        return attn_mask + torch.where(causal, zero,
                                       torch.full_like(zero, -1e30)), False

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        b, lq = query.shape[0], query.shape[1]
        lk = key.shape[1]
        q = self.q_proj(query).reshape(b, lq, self.num_heads, self.head_dim)
        k = self.k_proj(key).reshape(b, lk, self.num_heads, self.head_dim)
        v = self.v_proj(value).reshape(b, lk, self.num_heads, self.head_dim)
        if cache is not None:
            k = torch.cat([cache.k, k], dim=1)
            v = torch.cat([cache.v, v], dim=1)
            cache = type(cache)(k, v)
        causal = self.is_causal
        if causal and attn_mask is not None:
            attn_mask, causal = self._fold_causal(attn_mask, b, lq,
                                                  k.shape[1])
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            is_causal=causal, training=self.training)
        out = self.out_proj(out.reshape(b, lq, self.embed_dim))
        if cache is not None:
            return out, cache
        return out

    def gen_cache(self, key, value=None, type=None):
        """An empty cache: (B, 0, H, D) f32 keys and values."""
        shape = (key.shape[0], 0, self.num_heads, self.head_dim)
        return MultiHeadAttention.Cache(
            torch.zeros(shape, device=key.device),
            torch.zeros(shape, device=key.device))


class _Block(Layer):
    """What the encoder and decoder layers share: the feed-forward
    block and the norm placement."""

    def _act(self, x):
        return F.relu(x) if self.activation == "relu" else F.gelu(x)

    def _ffn(self, x):
        return self.linear2(self.dropout(self._act(self.linear1(x))))

    def _pre(self, norm, x):
        return norm(x) if self.normalize_before else x

    def _post(self, norm, x):
        return x if self.normalize_before else norm(x)


class TransformerEncoderLayer(_Block):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 device=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = {"device": device, "generator": generator}
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = activation

    def forward(self, src, src_mask=None, cache=None):
        x = self._pre(self.norm1, src)
        if cache is None:
            x = self.self_attn(x, x, x, src_mask)
        else:
            x, cache = self.self_attn(x, x, x, src_mask, cache)
        src = self._post(self.norm1, F.add(src, self.dropout1(x)))
        x = self._ffn(self._pre(self.norm2, src))
        src = self._post(self.norm2, F.add(src, self.dropout2(x)))
        return src if cache is None else (src, cache)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] +
            [copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                src = layer(src, src_mask)
            else:
                src, c = layer(src, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            src = self.norm(src)
        return src if cache is None else (src, new_caches)


class TransformerDecoderLayer(_Block):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 device=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = {"device": device, "generator": generator}
        attn = {"weight_attr": weight_attr, "bias_attr": bias_attr, **kw}
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **attn)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **attn)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.norm3 = LayerNorm(d_model, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        x = self._pre(self.norm1, tgt)
        x = self.self_attn(x, x, x, tgt_mask)
        tgt = self._post(self.norm1, F.add(tgt, self.dropout1(x)))
        x = self._pre(self.norm2, tgt)
        x = self.cross_attn(x, memory, memory, memory_mask)
        tgt = self._post(self.norm2, F.add(tgt, self.dropout2(x)))
        x = self._ffn(self._pre(self.norm3, tgt))
        return self._post(self.norm3, F.add(tgt, self.dropout3(x)))


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] +
            [copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        for layer in self.layers:
            tgt = layer(tgt, memory, tgt_mask, memory_mask)
        if self.norm is not None:
            tgt = self.norm(tgt)
        return tgt


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, device=None,
                 generator=None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_norm = LayerNorm(d_model, **kw) if normalize_before else None
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_norm = LayerNorm(d_model, **kw) if normalize_before else None
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """(length, length) f32, 0 on and below the diagonal and -1e9
        above, on ``device`` (None: CUDA), tagged so that attention runs
        it as the kernels' causal masking without reading it (scores of
        -1e9 and the kernels' -inf give the same softmax: a causal row
        keeps its diagonal). An in-place change drops the tag."""
        dev = resolve_device(device)
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=dev).tril()
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return F.mark_subsequent_mask(
            torch.where(keep, zero, torch.full_like(zero, -1e9)))

"""BERT pretraining (port of ``paddle_tpu/models/bert.py``).

``BertForPretraining`` has the JAX model's attribute names, so its
``state_dict()`` keys equal the JAX model's one to one, and
:func:`load_numpy_state` carries weights across by name. Attention runs
through the flash kernel; the MLM loss through the fused vocabulary
cross-entropy with the tied decoder (``word_embeddings.weight``, (V, H)),
so that table gets gradient from both the lookup and the loss.
``attention_mask`` (a (B, 1, 1, L) or (B, L) key-padding mask, True =
attend) reaches every layer's attention, which runs the flash kernels'
masked form. The pooler reads ``seq[:, 0]`` and ``mlm_bias`` starts at
zero. The tensor sums (the embeddings, the logits' bias, ``mlm + nsp``)
go through ``F.add``, the JAX ``add`` op: under O2 the loss is bf16, as
in JAX. ``loss`` follows ``FLAGS_fused_vocab_xent``: on (the default),
the fused vocabulary cross-entropy; off, ``forward``'s materialised
logits through ``F.cross_entropy``, as the JAX model's A/B arm.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import nn
from .._device import resolve_device
from ..framework.flags import get_flag
from ..nn import functional as F
from ..nn.layer import load_numpy_state

__all__ = ["BertConfig", "BertEmbeddings", "BertModel", "BertForPretraining",
           "load_numpy_state"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30592
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny():
        return BertConfig(vocab_size=1024, hidden_size=128,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=256, max_position_embeddings=128)


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig, device=None, generator=None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            **kw)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size, **kw)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size, **kw)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_eps, **kw)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = self.word_embeddings(input_ids)
        emb = F.add(emb, self.position_embeddings(pos))
        if token_type_ids is not None:
            emb = F.add(emb, self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertModel(nn.Layer):
    def __init__(self, cfg: BertConfig = None, device=None, generator=None):
        super().__init__()
        cfg = cfg or BertConfig()
        kw = {"device": device, "generator": generator}
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg, **kw)
        enc_layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob, **kw)
        self.encoder = nn.TransformerEncoder(enc_layer,
                                             cfg.num_hidden_layers)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.pooler_act = nn.Tanh()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        emb = self.embeddings(input_ids, token_type_ids)
        seq = self.encoder(emb, attention_mask)
        pooled = self.pooler_act(self.pooler(seq[:, 0]))
        return seq, pooled


class BertForPretraining(nn.Layer):
    """MLM + NSP heads. ``device=None`` builds on CUDA (raises without
    a GPU); ``generator`` draws the random initial weights."""

    def __init__(self, cfg: BertConfig = None, device=None, generator=None):
        super().__init__()
        cfg = cfg or BertConfig()
        device = resolve_device(device)
        kw = {"device": device, "generator": generator}
        self.config = cfg
        self.bert = BertModel(cfg, **kw)
        self.mlm_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.mlm_norm = nn.LayerNorm(cfg.hidden_size,
                                     epsilon=cfg.layer_norm_eps, **kw)
        self.mlm_bias = self.create_parameter([cfg.vocab_size], is_bias=True,
                                              **kw)
        self.nsp = nn.Linear(cfg.hidden_size, 2, **kw)

    def _mlm_hidden(self, seq):
        return self.mlm_norm(F.gelu(self.mlm_transform(seq)))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self._mlm_hidden(seq)
        logits = F.add(F.matmul(
            h, self.bert.embeddings.word_embeddings.weight,
            transpose_y=True), self.mlm_bias)
        return logits, self.nsp(pooled)

    def loss(self, input_ids, token_type_ids, mlm_labels, nsp_labels,
             attention_mask=None, ignore_index=-100):
        """MLM (the fused vocabulary cross-entropy with the tied decoder,
        or the materialised logits with the flag off) + NSP."""
        if not get_flag("fused_vocab_xent"):
            logits, nsp_logits = self(input_ids, token_type_ids,
                                      attention_mask)
            mlm = F.cross_entropy(logits, mlm_labels,
                                  ignore_index=ignore_index)
            return F.add(mlm, F.cross_entropy(nsp_logits, nsp_labels))
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self._mlm_hidden(seq)
        mlm = F.fused_linear_cross_entropy(
            h, self.bert.embeddings.word_embeddings.weight, self.mlm_bias,
            mlm_labels, ignore_index=ignore_index)
        nsp = F.cross_entropy(self.nsp(pooled), nsp_labels)
        return F.add(mlm, nsp)

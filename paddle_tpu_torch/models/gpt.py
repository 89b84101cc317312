"""GPT-style decoder-only causal LM (port of
``paddle_tpu/models/gpt.py:21-131``): pre-LN blocks of causal
``MultiHeadAttention`` and a gelu MLP, the logits through the tied word
embedding. Attribute names are the JAX model's, so ``state_dict()`` keys
match it one to one and ``load_numpy_state`` carries weights across.
``generate`` and the key/value caches are a later slice.

Under an active ``parallel.sequence_parallel`` scope (what
``TrainStep(sequence_parallel=...)`` opens) each rank holds its
sequence shard of the ids, and the model does what the JAX package gets
from global arrays:

- positions are ``pos_offset + sp_index * L_local + arange(L_local)``;
- attention is ring attention (``nn.functional``);
- the loss's next-token shift crosses shard boundaries: each rank gets
  the first label of the next shard by a ``ppermute`` backwards, and the
  last rank drops its last position;
- the loss is the GLOBAL mean over the sequence (the sum over every
  rank's positions, by an all-reduce, over their count), and its
  gradient flows through this rank's sum only (``global / n + (local -
  local.detach()) / n``: the value of ``(local + (global - local)
  .detach()) / n``, the same on every rank to the bit), so the summed
  gradients of the ranks are the gradient of the one global loss.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import nn
from .._device import resolve_device
from ..nn import functional as F
from ..nn.layer import load_numpy_state
from ..parallel import collectives
from ..parallel.ring import active_sequence_parallel

__all__ = ["GPTConfig", "GPTBlock", "GPTModel", "GPTForCausalLM",
           "load_numpy_state"]


@dataclasses.dataclass
class GPTConfig:
    """GPT-2 small by default (vocab 50257, 12 layers, 12 x 64 heads,
    ffn 4 x 768, 1024 positions)."""
    vocab_size: int = 50257
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1

    def __post_init__(self):
        self.intermediate_size = self.intermediate_size \
            or 4 * self.hidden_size

    @staticmethod
    def base():
        return GPTConfig()

    @staticmethod
    def tiny():
        return GPTConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=4, max_position_embeddings=64,
                         hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)


class GPTBlock(nn.Layer):
    def __init__(self, cfg: GPTConfig, device=None, generator=None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.ln1 = nn.LayerNorm(cfg.hidden_size, **kw)
        self.self_attn = nn.MultiHeadAttention(
            cfg.hidden_size, cfg.num_attention_heads,
            dropout=cfg.attention_probs_dropout_prob, is_causal=True, **kw)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, **kw)
        self.linear1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.linear2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, x):
        x = x + self.dropout(self.self_attn(self.ln1(x)))
        h = self.linear2(F.gelu(self.linear1(self.ln2(x))))
        return x + self.dropout(h)


class GPTModel(nn.Layer):
    def __init__(self, cfg: GPTConfig, device=None, generator=None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.cfg = cfg
        self.word_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                           **kw)
        self.pos_embedding = nn.Embedding(cfg.max_position_embeddings,
                                          cfg.hidden_size, **kw)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)
        self.layers = nn.LayerList(
            [GPTBlock(cfg, **kw) for _ in range(cfg.num_hidden_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, **kw)

    def forward(self, input_ids, pos_offset=0):
        b, l = input_ids.shape
        sp = active_sequence_parallel()
        start, total = pos_offset, pos_offset + l
        if sp is not None:
            axis, _, _, mesh = sp
            start += mesh.axis_index(axis) * l
            total = pos_offset + l * mesh.axis_size(axis)
        if total > self.cfg.max_position_embeddings:
            raise ValueError(f"sequence length {total} exceeds "
                             f"max_position_embeddings "
                             f"{self.cfg.max_position_embeddings}")
        pos = torch.arange(start, start + l, device=input_ids.device)
        x = self.word_embedding(input_ids) + self.pos_embedding(pos)
        x = self.dropout(x)
        for blk in self.layers:
            x = blk(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Layer):
    """``device=None`` builds on CUDA (raises without a GPU);
    ``generator`` draws the random initial weights."""

    def __init__(self, cfg: GPTConfig = None, device=None, generator=None):
        super().__init__()
        cfg = cfg or GPTConfig()
        device = resolve_device(device)
        self.cfg = cfg
        self.gpt = GPTModel(cfg, device=device, generator=generator)

    def forward(self, input_ids, pos_offset=0):
        h = self.gpt(input_ids, pos_offset=pos_offset)
        return F.matmul(h, self.gpt.word_embedding.weight, transpose_y=True)

    def loss(self, input_ids, labels=None):
        """Next-token LM loss, the mean over every shifted position;
        ``labels`` default to ``input_ids``."""
        logits = self(input_ids)
        labels = input_ids if labels is None else labels
        v = logits.shape[-1]
        sp = active_sequence_parallel()
        if sp is None:
            return F.cross_entropy(logits[:, :-1].reshape(-1, v),
                                   labels[:, 1:].reshape(-1))
        axis, _, _, mesh = sp
        size, idx = mesh.axis_size(axis), mesh.axis_index(axis)
        nxt = collectives.ppermute(labels[:, :1], axis, -1, mesh)
        shifted = torch.cat([labels[:, 1:], nxt], dim=1)
        if idx == size - 1:
            logits, shifted = logits[:, :-1], shifted[:, :-1]
        n = shifted.numel()
        local = F.cross_entropy(logits.reshape(-1, v),
                                shifted.reshape(-1)) * n
        total = collectives.all_reduce(local.detach().clone(), [axis], mesh)
        count = labels.shape[0] * (labels.shape[1] * size - 1)
        # the value is total / count on every rank alike (x - x is 0
        # exactly); the gradient flows through this rank's sum
        return total / count + (local - local.detach()) / count

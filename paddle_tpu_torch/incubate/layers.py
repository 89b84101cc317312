"""Contrib layers (port of ``paddle_tpu/incubate/layers.py``):
``fused_embedding_seq_pool``. The other layers of that module
(``shuffle_batch``, ``partial_concat``, ``partial_sum``, ``batch_fc``,
the sparse-embedding facade) are a later port slice.
"""
from __future__ import annotations

import torch

from .._device import resolve_device
from ..framework.random import default_generator
from ..nn import functional as F

__all__ = ["fused_embedding_seq_pool"]

def _table(size, device, generator):
    """A fresh f32 (V, D) table, normal x 0.01, drawn from ``generator``
    (None: the device's global generator) on ``device`` (None: CUDA)."""
    device = resolve_device(device)
    gen = generator if generator is not None else default_generator(device)
    return torch.nn.Parameter(torch.randn(tuple(size), generator=gen,
                                          device=device) * 0.01)


def fused_embedding_seq_pool(input, size, is_sparse=False, padding_idx=None,
                             combiner="sum", param_attr=None,
                             dtype="float32", weight=None, lengths=None,
                             device=None, generator=None):
    """Embedding lookup + sequence pool in one step (contrib nn.py:471
    fused_embedding_seq_pool_op). ``input`` (N, L) ids -> (N, D); with
    ``weight`` omitted a fresh (``size``) table is created on ``device``
    from ``generator`` and the result is ``(pooled, weight)``.

    The branches are the JAX layer's. A negative ``padding_idx`` counts
    from ``size[0]``. ``combiner="sum"`` without ``lengths`` runs the
    fused embedding bag kernel: padding ids are dropped first, then the
    other negative ids are wrapped as ``jnp.take`` wraps them. ``lengths``
    or ``combiner="mean"``/``"avg"`` take the unfused path
    (``F.embedding`` then a sum over L, positions at or past ``lengths``
    zeroed), where mean divides by ``lengths`` or, without them, by L,
    padding positions included, unlike ``F.fused_embedding_seq_pool``'s
    mean over valid ids. ``is_sparse``, ``param_attr`` and ``dtype`` are
    accepted and unused, as in the JAX layer (a created table is f32)."""
    created = weight is None
    if created:
        weight = _table(size, device, generator)
    V = int(weight.shape[0])
    if padding_idx is not None and padding_idx < 0:
        padding_idx = V + int(padding_idx)
    if lengths is None and combiner == "sum":
        ids = input
        if padding_idx is not None:
            ids = torch.where(ids == padding_idx, -V - 1, ids)
        ids = torch.where((ids < 0) & (ids >= -V), ids + V, ids)
        out = F.fused_embedding_seq_pool(weight, ids, combiner="sum")
        return (out, weight) if created else out
    if combiner not in ("sum", "mean", "avg"):
        raise ValueError(f"unsupported combiner {combiner}")
    emb = F.embedding(input, weight, padding_idx=padding_idx)   # (N, L, D)
    L = input.shape[1]
    if lengths is not None:
        step = torch.arange(L, device=input.device).unsqueeze(0)
        keep = (step < lengths.unsqueeze(1)).unsqueeze(2).to(emb.dtype)
        emb = emb * keep
        denom = torch.clamp(lengths, min=1).unsqueeze(1).to(emb.dtype)
    else:
        denom = float(L)
    out = emb.sum(dim=1)
    if combiner != "sum":
        out = out / denom
    return (out, weight) if created else out

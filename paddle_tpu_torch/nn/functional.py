"""The functional ops BERT reaches.

Port of the matching part of ``paddle_tpu/nn/functional.py``. Layouts
follow the JAX package, not PyTorch's habits: ``linear``'s W is
(in, out) and ``y = x @ W + b`` (the reference fc/mul op); attention
takes (B, L, H, D); ``fused_linear_cross_entropy``'s W is (V, H), the
embedding layout. Each op passes its inputs through
``amp.maybe_cast_inputs`` under the JAX op name, so ``auto_cast`` casts
the same ops as in the JAX package (``linear``/``matmul`` down,
``layer_norm``/``softmax_with_cross_entropy`` up, the rest untouched).

Attention and the MLM head's loss are the kernels' entry points
(``ops/cuda/flash_attention.py``, ``ops/cuda/fused_xent.py``): on CUDA
tensors they launch the hand-written kernels, on CPU tensors the plain
versions. Dropout draws its mask from the active step's device
generator (``framework.random``); attention dropout hands the kernel a
64-bit seed drawn from the step's host generator.
"""
from __future__ import annotations

import torch

from ..amp import maybe_cast_inputs
from ..framework.random import current_rng
from ..ops.cuda import flash_attention as _fa
from ..ops.cuda import fused_xent as _fx

__all__ = ["linear", "matmul", "embedding", "dropout", "gelu", "tanh",
           "layer_norm", "cross_entropy", "scaled_dot_product_attention",
           "fused_linear_cross_entropy"]


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with weight (in_features, out_features)."""
    if x.dim() < 1 or weight.dim() != 2 or x.shape[-1] != weight.shape[0]:
        raise ValueError(
            f"linear: input features {tuple(x.shape)}[-1] must match "
            f"weight rows {tuple(weight.shape)}: W is (in_features, "
            f"out_features) in this framework (reference fc/mul op)")
    x, weight, bias = maybe_cast_inputs("linear", [x, weight, bias])
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def matmul(x, y, transpose_x=False, transpose_y=False):
    x, y = maybe_cast_inputs("matmul", [x, y])
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def embedding(x, weight):
    if x.is_floating_point():
        raise ValueError(f"embedding: ids must be an integer tensor, got "
                         f"{x.dtype}")
    (weight,) = maybe_cast_inputs("embedding_fn", [weight])
    return torch.nn.functional.embedding(x.long(), weight)


def dropout(x, p=0.5, training=True):
    """Zero each element with probability ``p`` and divide the kept ones
    by 1 - p (``upscale_in_train``); the mask comes from the active
    step's device generator."""
    if not training or p == 0.0:
        return x
    (x,) = maybe_cast_inputs("dropout", [x])
    keep = torch.rand(x.shape, generator=current_rng(x.device).generator,
                      device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def gelu(x):
    """The exact (erf) gelu."""
    (x,) = maybe_cast_inputs("gelu", [x])
    return torch.nn.functional.gelu(x)


def tanh(x):
    (x,) = maybe_cast_inputs("tanh", [x])
    return torch.tanh(x)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    x, weight, bias = maybe_cast_inputs("layer_norm", [x, weight, bias])
    return torch.nn.functional.layer_norm(x, tuple(normalized_shape),
                                          weight, bias, epsilon)


def cross_entropy(input, label, ignore_index=-100):
    """Mean hard-label softmax cross-entropy over the last axis: the sum
    over rows whose label is not ``ignore_index`` divided by their count
    (at least 1), as in the JAX package."""
    (input,) = maybe_cast_inputs("softmax_with_cross_entropy", [input])
    if not input.is_floating_point() or label.is_floating_point():
        raise ValueError("cross_entropy: float logits and integer labels")
    if label.dim() == input.dim():
        label = label.squeeze(-1)
    logp = torch.log_softmax(input, dim=-1)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    loss = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    return loss.sum() / valid.sum().to(loss.dtype).clamp(min=1.0)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """Attention over (B, L, H, D) tensors through the flash kernel,
    with dropout inside the kernel while training."""
    if attn_mask is not None:
        raise NotImplementedError(
            "attention masks are a later port slice: the flash kernel's "
            "key-padding bias is not ported yet")
    query, key, value = maybe_cast_inputs("sdpa", [query, key, value])
    p = float(dropout_p) if training else 0.0
    seed = current_rng(query.device).next_seed() if p > 0.0 else 0
    return _fa.flash_attention(query, key, value, causal=is_causal,
                               dropout_p=p, seed=seed)


def fused_linear_cross_entropy(h, weight, bias, label, ignore_index=-100):
    """Mean softmax cross-entropy of ``h @ weight.T + bias`` without
    materialising the (rows, vocab) logits; weight is (V, H)."""
    h, weight, bias = maybe_cast_inputs("fused_linear_cross_entropy",
                                        [h, weight, bias])
    return _fx.fused_linear_cross_entropy(h, weight, bias, label,
                                          ignore_index=ignore_index)

"""Per-token-row int8 codec for KV pages (``paddle_tpu/ps/codec.py``
``jnp_encode_kv_rows`` / ``jnp_decode_kv_rows``) on torch tensors.

One symmetric f32 scale per TOKEN ROW (the blocked int8 layout with
block = one row's ``H * D`` elements): ``scale = amax / 127``,
``q = clip(round_half_even(x / scale), -127, 127)``, with an all-zero
row kept at scale 0. ``torch.round`` rounds half to even, like
``jnp.rint``, so the payload and scales match the JAX encoder bit for
bit (the division by 127 is an exact f32 division on both sides when
the JAX encoder runs eagerly; under ``jax.jit`` XLA multiplies by
``1/127`` instead, and the scales can differ in the last bit).
"""
from __future__ import annotations

import torch

__all__ = ["encode_kv_rows", "decode_kv_rows"]


def encode_kv_rows(x: torch.Tensor):
    """``x`` (..., H, D) -> (int8 payload (..., H, D), f32 scales (...,))."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=(-2, -1))
    # a 0-dim divisor on the same device: PyTorch's CUDA division by a
    # Python scalar multiplies by its reciprocal, which is not amax/127
    scale = amax / torch.full((), 127.0, device=xf.device)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None, None]), -127, 127)
    return q.to(torch.int8), scale


def decode_kv_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Dequant twin of :func:`encode_kv_rows`: int8 (..., H, D) x
    per-row scales (...,) -> f32."""
    return q.to(torch.float32) * scale.to(torch.float32)[..., None, None]

"""Wire codecs (port of part of ``paddle_tpu/ps/codec.py``): the closed
forms of the quantized collectives' wire bytes (``QUANT_BLOCK``,
``CODEC_IDS``, ``encoded_nbytes``, ``ring_nbytes``, copied from
``codec.py:30-72``) and the per-token-row int8 codec for KV pages
(``jnp_encode_kv_rows`` / ``jnp_decode_kv_rows``) on torch tensors. The
numpy wire encoders ``np_encode`` / ``np_decode`` (the parameter
server's data plane) are a later port slice.

Layouts: ``f32`` raw float32 (id 0); ``bf16`` the round-to-nearest-even
upper half of each float32 (id 1); ``int8`` one float32 scale (max-abs
/ 127) per ``QUANT_BLOCK`` elements followed by the int8 payload (id 2).

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

__all__ = ["QUANT_BLOCK", "CODEC_IDS", "CODEC_NAMES", "encoded_nbytes",
           "ring_nbytes", "encode_kv_rows", "decode_kv_rows"]

#: elements covered by one f32 scale in the blocked int8 encoding
QUANT_BLOCK = 512

#: wire/codec ids (0 keeps a zero-filled codec byte meaning "plain f32")
CODEC_IDS = {"f32": 0, "bf16": 1, "int8": 2}
CODEC_NAMES = {v: k for k, v in CODEC_IDS.items()}


def _nblocks(n: int, block: int = QUANT_BLOCK) -> int:
    return -(-int(n) // int(block))


def encoded_nbytes(n_elems: int, codec: str,
                   block: int = QUANT_BLOCK) -> int:
    """Wire bytes of ``n_elems`` f32 values under ``codec``: payload
    plus per-block scales."""
    n = int(n_elems)
    if codec == "int8":
        return n + 4 * _nblocks(n, block)
    if codec == "bf16":
        return 2 * n
    if codec == "f32":
        return 4 * n
    raise ValueError(f"unknown codec {codec!r}")


def ring_nbytes(n_elems: int, group: int, codec: str,
                block: int = QUANT_BLOCK) -> int:
    """Per-rank wire bytes of a ring all-reduce of ``n_elems`` over
    ``group`` ranks: the reduce-scatter and the all-gather each move
    ``(g-1)/g`` of the encoded payload."""
    g = max(1, int(group))
    if g <= 1:
        return 0
    return int(2 * (g - 1) * encoded_nbytes(n_elems, codec, block) // g)


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

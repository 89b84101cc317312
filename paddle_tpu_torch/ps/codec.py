"""Wire codecs (port of ``paddle_tpu/ps/codec.py``): the closed forms
of the quantized wire bytes (``QUANT_BLOCK``, ``CODEC_IDS``,
``encoded_nbytes``, ``ring_nbytes``), the numpy wire encoders
``np_encode`` / ``np_decode`` / ``codec_name`` that the KV page frames
(``serving/disagg.py``) and the host KV tier ship, and the per-token-row
int8 codec for KV pages (``jnp_encode_kv_rows`` / ``jnp_decode_kv_rows``
there) on torch tensors. The numpy half is a copy: same bytes for the
same input, bit for bit.

Layouts (little-endian): ``f32`` raw float32 (id 0); ``bf16`` the
round-to-nearest-even upper half of each float32 (id 1); ``int8`` one
float32 scale (max-abs / 127) per ``QUANT_BLOCK`` elements, the final
block zero-padded, followed by the int8 payload (id 2).

One symmetric f32 scale per TOKEN ROW (the blocked int8 layout with
block = one row's ``H * D`` elements): ``scale = amax / 127``,
``q = clip(round_half_even(x / scale), -127, 127)``, with an all-zero
row kept at scale 0. ``torch.round`` rounds half to even, like
``jnp.rint`` and ``np.rint``, so the payload and scales match the JAX
encoder bit for bit (the division by 127 is an exact f32 division on
both sides when the JAX encoder runs eagerly; under ``jax.jit`` XLA
multiplies by ``1/127`` instead, and the scales can differ in the last
bit).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["QUANT_BLOCK", "CODEC_IDS", "CODEC_NAMES", "codec_name",
           "encoded_nbytes", "ring_nbytes", "np_encode", "np_decode",
           "encode_kv_rows", "decode_kv_rows"]

#: elements covered by one f32 scale in the blocked int8 encoding
QUANT_BLOCK = 512

#: wire/codec ids (0 keeps a zero-filled codec byte meaning "plain f32")
CODEC_IDS = {"f32": 0, "bf16": 1, "int8": 2}
CODEC_NAMES = {v: k for k, v in CODEC_IDS.items()}


def codec_name(codec_id: int) -> str:
    name = CODEC_NAMES.get(int(codec_id))
    if name is None:
        raise ValueError(f"unknown wire codec id {codec_id}")
    return name


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


def np_encode(values: np.ndarray, codec: str,
              block: int = QUANT_BLOCK) -> bytes:
    """Encode a float32 array for the wire; the byte count is exactly
    ``encoded_nbytes(values.size, codec)``."""
    vals = np.ascontiguousarray(values, np.float32).reshape(-1)
    if codec == "f32":
        return vals.tobytes()
    if codec == "bf16":
        # f32's upper 16 bits, round-to-nearest-even
        u = vals.view(np.uint32)
        rounded = (u.astype(np.uint64) + 0x7FFF + ((u >> 16) & 1)) >> 16
        return rounded.astype(np.uint16).tobytes()
    if codec != "int8":
        raise ValueError(f"unknown codec {codec!r}")
    n = vals.size
    nb = _nblocks(n, block)
    padded = np.zeros(nb * block, np.float32)
    padded[:n] = vals
    xb = padded.reshape(nb, block)
    amax = np.max(np.abs(xb), axis=1)
    scale = (amax / 127.0).astype(np.float32)
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.rint(xb / safe[:, None]), -127, 127).astype(np.int8)
    return scale.tobytes() + q.reshape(-1)[:n].tobytes()


def np_decode(raw: bytes, n_elems: int, codec: str,
              block: int = QUANT_BLOCK) -> np.ndarray:
    """Decode :func:`np_encode` output back to a 1-D float32 array."""
    n = int(n_elems)
    if codec == "f32":
        return np.frombuffer(raw, np.float32, count=n).copy()
    if codec == "bf16":
        u = np.frombuffer(raw, np.uint16, count=n).astype(np.uint32)
        return (u << 16).view(np.float32).copy()
    if codec != "int8":
        raise ValueError(f"unknown codec {codec!r}")
    nb = _nblocks(n, block)
    scale = np.frombuffer(raw, np.float32, count=nb)
    q = np.frombuffer(raw, np.int8, count=n, offset=4 * nb)
    padded = np.zeros(nb * block, np.float32)
    padded[:n] = q.astype(np.float32)
    out = (padded.reshape(nb, block) * scale[:, None]).reshape(-1)
    return out[:n].astype(np.float32)


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

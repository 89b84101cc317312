"""Ragged paged attention for decode steps: the plain PyTorch versions,
the CUDA kernel wrappers, and the page-write scatters.

Port of ``paddle_tpu/ops/pallas/paged_attention.py``. Layout, as there:

- ``q``          (B, H, D) f32    one query token per sequence
- ``k_pages``    (P, S, H, D)     the pool: P pages of S tokens each
- ``v_pages``    (P, S, H, D)     (f32, or int8 with scales)
- ``page_table`` (B, T) int32     page ids per sequence, -1 = unused
- ``seq_lens``   (B,) int32       live tokens per sequence (ragged)
- ``k_scales`` / ``v_scales`` (P, S) f32, int8 pools only

Routing is by device, with no fallback: a CUDA tensor launches the
kernel in ``csrc/paged_attention.cu`` (and counts the launch) or
raises; a CPU tensor takes the plain version, which is what the tests
use. A ``-1`` table entry inside the live length reads page 0, as the
JAX paths do. ``seq_len == 0`` is outside the contract: the kernel
returns zeros there, the plain version (like the JAX gather path) the
mean of the gathered V rows.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...ps.codec import encode_kv_rows
from . import _build, counters

__all__ = ["paged_attention", "paged_write", "paged_prefill_write",
           "paged_write_quant", "paged_prefill_write_quant"]

_NEG_INF = -1e30
_MAX_D = 256
_P = ctypes.c_void_p
_I = ctypes.c_int


# ---------------------------------------------------------------------------
# plain versions (the JAX gather paths, _xla_paged_attention(_quant))
# ---------------------------------------------------------------------------
def _gather_attend(q, k, v, seq_lens):
    """Attend (B, H, D) queries over gathered (B, K, H, D) keys/values,
    masking positions >= seq_lens."""
    B, H, D = q.shape
    K = k.shape[1]
    s = torch.einsum("bhd,bkhd->bhk", q.to(torch.float32), k) \
        / math.sqrt(D)
    pos = torch.arange(K, device=q.device, dtype=torch.int32)
    live = pos[None, None, :] < seq_lens.to(torch.int32)[:, None, None]
    s = torch.where(live, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, v).to(q.dtype)


def _plain_paged_attention(q, k_pages, v_pages, page_table, seq_lens):
    B, H, D = q.shape
    S = k_pages.shape[1]
    T = page_table.shape[1]
    safe = page_table.long().clamp(min=0)
    k = k_pages[safe].reshape(B, T * S, H, D).to(torch.float32)
    v = v_pages[safe].reshape(B, T * S, H, D).to(torch.float32)
    return _gather_attend(q, k, v, seq_lens)


def _plain_paged_attention_quant(q, k_pages, v_pages, k_scales, v_scales,
                                 page_table, seq_lens):
    B, H, D = q.shape
    S = k_pages.shape[1]
    T = page_table.shape[1]
    safe = page_table.long().clamp(min=0)
    ks = k_scales[safe].reshape(B, T * S)
    vs = v_scales[safe].reshape(B, T * S)
    k = k_pages[safe].reshape(B, T * S, H, D).to(torch.float32)
    v = v_pages[safe].reshape(B, T * S, H, D).to(torch.float32)
    k = k * ks[..., None, None]
    v = v * vs[..., None, None]
    return _gather_attend(q, k, v, seq_lens)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------
def _check_inputs(q, k_pages, v_pages, page_table, seq_lens, pool_dtype):
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"paged_attention wants q (B,H,D) and pools "
                         f"(P,S,H,D), got {tuple(q.shape)} and "
                         f"{tuple(k_pages.shape)}")
    B, H, D = q.shape
    P, S, Hp, Dp = k_pages.shape
    if (Hp, Dp) != (H, D) or v_pages.shape != k_pages.shape:
        raise ValueError(f"pool shape {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if D > _MAX_D:
        raise ValueError(f"the paged attention kernel takes head_dim <= "
                         f"{_MAX_D}, got {D}")
    if q.dtype != torch.float32:
        raise TypeError(f"the paged attention kernel takes f32 queries, "
                        f"got {q.dtype}")
    if k_pages.dtype != pool_dtype or v_pages.dtype != pool_dtype:
        raise TypeError(f"the kernel wants {pool_dtype} pools, got "
                        f"{k_pages.dtype}/{v_pages.dtype}")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or seq_lens.shape != (B,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / seq_lens "
                         f"{tuple(seq_lens.shape)} do not match batch {B}")
    for name, t in (("page_table", page_table), ("seq_lens", seq_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    dev = q.device
    for t in (k_pages, v_pages, page_table, seq_lens):
        if t.device != dev:
            raise ValueError(f"paged_attention inputs span devices "
                             f"{dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("paged_attention inputs must be contiguous")
    if not q.is_contiguous():
        raise ValueError("paged_attention inputs must be contiguous")
    return B, H, D, S, page_table.shape[1]


def _cuda_paged_attention(q, k_pages, v_pages, page_table, seq_lens):
    B, H, D, S, T = _check_inputs(q, k_pages, v_pages, page_table,
                                  seq_lens, torch.float32)
    fn = _build.entry("paged_attention", "paged_attention_f32",
                      [_P] * 6 + [_I] * 5 + [ctypes.c_float, _P])
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
             B, H, D, S, T, 1.0 / math.sqrt(D),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("paged_attention", err, "paged_attention_f32")
    counters.bump("paged_attention")
    return out


def _cuda_paged_attention_quant(q, k_pages, v_pages, k_scales, v_scales,
                                page_table, seq_lens):
    B, H, D, S, T = _check_inputs(q, k_pages, v_pages, page_table,
                                  seq_lens, torch.int8)
    P = k_pages.shape[0]
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        if t.shape != (P, S) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 ({P}, {S}) "
                             f"on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    fn = _build.entry("paged_attention", "paged_attention_int8",
                      [_P] * 8 + [_I] * 5 + [ctypes.c_float, _P])
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             k_scales.data_ptr(), v_scales.data_ptr(),
             page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
             B, H, D, S, T, 1.0 / math.sqrt(D),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("paged_attention", err, "paged_attention_int8")
    counters.bump("paged_attention_quant")
    return out


def paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                    k_scales=None, v_scales=None):
    """Decode-step attention over the paged KV pool -> (B, H, D).

    On a CUDA tensor this launches the hand-written kernel (int8 pools
    when ``k_scales``/``v_scales`` are given) or raises; on a CPU tensor
    it runs the plain gather version."""
    quant = k_scales is not None
    if q.is_cuda:
        if quant:
            return _cuda_paged_attention_quant(q, k_pages, v_pages,
                                               k_scales, v_scales,
                                               page_table, seq_lens)
        return _cuda_paged_attention(q, k_pages, v_pages, page_table,
                                     seq_lens)
    if q.device.type != "cpu":
        raise ValueError(f"paged_attention runs on cuda or cpu, got "
                         f"{q.device}")
    if quant:
        return _plain_paged_attention_quant(q, k_pages, v_pages, k_scales,
                                            v_scales, page_table, seq_lens)
    return _plain_paged_attention(q, k_pages, v_pages, page_table,
                                  seq_lens)


# ---------------------------------------------------------------------------
# page writes: decode-step single-token scatter + prefill bulk scatter.
# Unlike the functional JAX versions, these update the pools IN PLACE.
# ---------------------------------------------------------------------------
def _slots(page_table, positions, S, active):
    """(page, offset) per sequence for a write at ``positions``;
    inactive lanes and -1 entries route at the trash page 0."""
    idx = (positions.long() // S)[:, None]
    pidx = torch.gather(page_table.long(), 1, idx)[:, 0].clamp(min=0)
    if active is not None:
        pidx = torch.where(active, pidx, torch.zeros_like(pidx))
    return pidx, positions.long() % S


def paged_write(k_pages, v_pages, page_table, positions, new_k, new_v,
                active=None):
    """Scatter ONE new token's K/V per sequence into its page slot,
    IN PLACE. ``positions`` (B,) is the absolute write position; the
    owning page is ``page_table[b, positions[b] // S]``. Inactive batch
    slots (and -1 table entries) write to the reserved trash page 0,
    which no live page table points at."""
    pidx, off = _slots(page_table, positions, k_pages.shape[1], active)
    k_pages[pidx, off] = new_k.to(k_pages.dtype)
    v_pages[pidx, off] = new_v.to(v_pages.dtype)


def paged_prefill_write(k_pages, v_pages, page_ids, new_k, new_v):
    """Scatter one prefilled prompt's K/V into its pages, IN PLACE.
    ``page_ids`` (n,) names the pages; ``new_k``/``new_v`` are
    (n * S, H, D), the prompt padded to whole pages."""
    n = page_ids.shape[0]
    S = k_pages.shape[1]
    H, D = new_k.shape[-2], new_k.shape[-1]
    ids = page_ids.long()
    k_pages[ids] = new_k.reshape(n, S, H, D).to(k_pages.dtype)
    v_pages[ids] = new_v.reshape(n, S, H, D).to(v_pages.dtype)


def paged_write_quant(k_pages, v_pages, k_scales, v_scales, page_table,
                      positions, new_k, new_v, active=None):
    """int8-pool twin of :func:`paged_write`, IN PLACE: each token row
    is encoded (one f32 scale per row, ``ps.codec.encode_kv_rows``) and
    the payload and scale land in the slot the page table names."""
    pidx, off = _slots(page_table, positions, k_pages.shape[1], active)
    qk, sk = encode_kv_rows(new_k)
    qv, sv = encode_kv_rows(new_v)
    k_pages[pidx, off] = qk
    v_pages[pidx, off] = qv
    k_scales[pidx, off] = sk
    v_scales[pidx, off] = sv


def paged_prefill_write_quant(k_pages, v_pages, k_scales, v_scales,
                              page_ids, new_k, new_v):
    """int8-pool twin of :func:`paged_prefill_write`, IN PLACE: the
    (n * S, H, D) prompt K/V is row-encoded and scattered as whole
    pages, scales as (n, S)."""
    n = page_ids.shape[0]
    S = k_pages.shape[1]
    H, D = new_k.shape[-2], new_k.shape[-1]
    ids = page_ids.long()
    qk, sk = encode_kv_rows(new_k)
    qv, sv = encode_kv_rows(new_v)
    k_pages[ids] = qk.reshape(n, S, H, D)
    v_pages[ids] = qv.reshape(n, S, H, D)
    k_scales[ids] = sk.reshape(n, S)
    v_scales[ids] = sv.reshape(n, S)

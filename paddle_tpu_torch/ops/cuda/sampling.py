"""Fused token sampling for the decode engine: the plain PyTorch
version, the CUDA kernel wrapper, and :func:`fused_sample`.

Port of ``paddle_tpu/ops/pallas/sampling.py``. The Gumbel noise is made
OUTSIDE (the engine draws it from a seeded host RNG per tick) and passed
in, so the kernel and the plain version are the same function of
(logits, noise) and a seeded run replays token for token. Sampling is
the Gumbel-max trick: ``argmax(logits/T + g)`` draws from
``softmax(logits/T)``; masking (top-k / top-p) before the argmax draws
from the truncated, renormalised distribution.

One division rule, shared by the kernel and the plain version:
``x = logits * (1/T)`` with ``1/T`` rounded to f32 once. That is what
XLA computes for ``logits / T`` under ``jax.jit``, where the JAX
engine's decode step runs; the plain version multiplies by a 0-dim f32
tensor on the logits' device, and the kernel uses round-to-nearest
multiply and add intrinsics, so the two agree bit for bit on the card.

Routing is by device, with no fallback: a CUDA tensor launches the
kernel (and counts the launch) or raises; a CPU tensor takes the plain
version. ``top_p < 1`` has no kernel (the JAX package routes it to XLA
as well): it runs the plain sort+cumsum path on any device and counts
``fused_sample.top_p_plain``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, counters

__all__ = ["fused_sample"]

_NEG_INF = -1e30


def _inv_temperature(temperature: float) -> np.float32:
    """1/T as XLA folds it: an f32 division of the f32-rounded T."""
    return np.float32(1.0) / np.float32(temperature)


def _plain_sample(logits, noise, temperature, top_k, top_p):
    """The reference (``_xla_sample`` under jit)."""
    inv_t = torch.full((), float(_inv_temperature(temperature)),
                       dtype=torch.float32, device=logits.device)
    x = logits.to(torch.float32) * inv_t
    V = x.shape[-1]
    if top_k and top_k < V:
        # the k-th largest value counting duplicates (lax.top_k's rule)
        kth = torch.sort(x, dim=-1, descending=True).values[..., top_k - 1]
        x = torch.where(x < kth[..., None], torch.full_like(x, _NEG_INF), x)
    if top_p < 1.0:
        srt = torch.sort(x, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        # smallest set whose mass reaches top_p: keep a token while the
        # mass BEFORE it is still short (the head token always stays)
        keep = (csum - probs) < top_p
        thresh = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                             ).amin(dim=-1)
        x = torch.where(x < thresh[..., None],
                        torch.full_like(x, _NEG_INF), x)
    y = x + noise.to(torch.float32)
    return torch.argmax(y, dim=-1).to(torch.int32)


def _cuda_sample(logits, noise, temperature, top_k):
    if logits.dim() != 2 or noise.shape != logits.shape:
        raise ValueError(f"fused_sample wants logits and noise (B, V), got "
                         f"{tuple(logits.shape)} and {tuple(noise.shape)}")
    for name, t in (("logits", logits), ("noise", noise)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != logits.device:
            raise ValueError(f"{name} must be contiguous f32 on "
                             f"{logits.device}, got {t.dtype} on {t.device}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    B, V = logits.shape
    fn = _build.entry("sampling", "fused_sample_f32",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    out = torch.empty((B,), dtype=torch.int32, device=logits.device)
    err = fn(logits.data_ptr(), noise.data_ptr(), out.data_ptr(), B, V,
             float(_inv_temperature(temperature)), int(top_k),
             torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check("sampling", err, "fused_sample_f32")
    counters.bump("fused_sample")
    return out


def fused_sample(logits, noise, temperature: float, top_k: int = 0,
                 top_p: float = 1.0):
    """Draw one token per row from ``softmax(logits/temperature)``
    truncated by top-k/top-p, using caller-supplied Gumbel ``noise``
    (same shape as ``logits``). ``temperature <= 0`` is a plain greedy
    argmax (noise ignored). Returns int32 token ids (B,)."""
    if float(temperature) <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if float(top_p) < 1.0:
        counters.bump("fused_sample.top_p_plain")
        return _plain_sample(logits, noise, temperature, top_k, top_p)
    if logits.is_cuda:
        return _cuda_sample(logits, noise, temperature, int(top_k))
    if logits.device.type != "cpu":
        raise ValueError(f"fused_sample runs on cuda or cpu, got "
                         f"{logits.device}")
    return _plain_sample(logits, noise, temperature, int(top_k), 1.0)

"""Fused linear + vocabulary cross-entropy: the plain PyTorch versions,
the CUDA kernel wrappers, and :func:`fused_linear_cross_entropy`.

Port of ``paddle_tpu/ops/pallas/fused_xent.py``: the mean softmax
cross-entropy of ``h @ w.T + bias`` against integer labels, where w is
(V, H) (the tied embedding table of BERT's MLM head). The forward
kernel streams vocab tiles with an online log-sum-exp and returns the
per-row ``lse`` and label logit ``ll``; the backward kernels recompute
the logit tiles from ``lse`` and produce dh (row tiles looping over the
vocabulary) and dW, db (vocab tiles looping over rows). The logits
never reach device memory. Inputs and outputs are f32.

The kernels (``csrc/fused_xent.cu``) run every product on the tensor
cores as three bf16 terms, hi*hi + hi*lo + lo*hi, with f32
accumulation: hi is the bf16 rounding of an f32 value and lo that of the
remainder, 16 significant bits together. That keeps lse, the label
logit, dh, dW and db within 1e-4 of their largest value of the plain f32
version, where one bf16 term a product would not
(``tests/test_torch_xent_rounding.py``). Each entry point first splits
h and W into bf16 hi and lo arrays in a scratch tensor of 2 (N + V) H
bf16 that the wrapper allocates for the call (144 MB at BERT's head).
Their bound is the tensor cores' bf16 rate over three terms: 2.33 ms for
the forward and 9.34 ms for the backward's four products at 16384 x 768
x 30592.

As in the JAX ``_fused_xent_sums`` custom vjp, the differentiable piece
is the SUM over valid rows of ``lse - ll``; the mean is ``sum /
max(count, 1)`` outside the kernels, so autograd supplies the
``1/count``. Ignored rows (``label == ignore_index``) go through the
kernels with label -1 (the hit test never matches) and g = 0. Rows
need no padding: the kernels mask their own ragged edges (the JAX
wrapper pads rows to a multiple of 256).

Routing is by device, with no fallback: CUDA tensors launch the kernels
(counting ``fused_xent_fwd`` once a forward call and ``fused_xent_bwd``
once a backward call, whatever the kernels a call launches) or raise;
CPU tensors take the plain version. The JAX package's block-size and
VMEM eligibility rules were TPU tuning; the kernels take any N >= 1 and
V >= 1 and H a multiple of 16 from 16 to 1024 (a thread-block cluster
of at most four CTAs, each owning 256 columns of H).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, counters

__all__ = ["fused_linear_cross_entropy", "fused_xent_fwd", "fused_xent_bwd"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_MAX_H = 1024      # four CTAs of a cluster, 256 columns of H each


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _logits(h, w, bias):
    return torch.matmul(h, w.t()) + bias


def _hits(labels, V):
    """(row has a class in [0, V), that class clamped into range)"""
    hit = (labels >= 0) & (labels < V)
    return hit, labels.long().clamp(0, V - 1)[:, None]


def _plain_fwd(h, w, bias, labels):
    logits = _logits(h, w, bias)
    lse = torch.logsumexp(logits, dim=-1)
    hit, idx = _hits(labels, w.shape[0])
    picked = logits.gather(1, idx)[:, 0]
    ll = torch.where(hit, picked, torch.zeros_like(picked))
    return lse, ll


def _plain_bwd(h, w, bias, labels, lse, g):
    p = torch.exp(_logits(h, w, bias) - lse[:, None])
    hit, idx = _hits(labels, w.shape[0])
    p = p.scatter_add(1, idx, -hit.to(p.dtype)[:, None])
    p = p * g[:, None]
    return torch.matmul(p, w), torch.matmul(p.t(), h), p.sum(dim=0)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------
def _check(h, w, bias, labels):
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"fused xent wants h (N, H) and w (V, H), got "
                         f"{tuple(h.shape)} and {tuple(w.shape)}")
    N, H = h.shape
    V = w.shape[0]
    if H < 16 or H % 16 or H > _MAX_H:
        raise ValueError(f"the fused xent kernels take H a multiple of 16 "
                         f"from 16 to {_MAX_H}, got {H}")
    if N < 1 or V < 1:
        raise ValueError(f"the fused xent kernels take N >= 1 and V >= 1, "
                         f"got N {N} and V {V}")
    if bias.shape != (V,) or labels.shape != (N,):
        raise ValueError(f"bias {tuple(bias.shape)} / labels "
                         f"{tuple(labels.shape)} do not match ({N}, {V})")
    for name, t in (("h", h), ("w", w), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"the fused xent kernels take f32, {name} is "
                            f"{t.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {labels.dtype}")
    for t in (h, w, bias, labels):
        if t.device != h.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("fused xent inputs must be contiguous, 16-byte "
                             "aligned and on one device")
    return N, H, V


def _scratch(h, N, H, V):
    """The kernels' operands as bf16 hi and lo arrays, hi(h), lo(h),
    hi(W), lo(W): 2 (N + V) H bf16, written by the call's split pass.
    It goes back to the caching allocator when the call returns; a later
    allocation on the stream runs after the call's kernels."""
    return torch.empty(2 * (N + V) * H, dtype=torch.bfloat16,
                       device=h.device)


def _cuda_fwd(h, w, bias, labels):
    N, H, V = _check(h, w, bias, labels)
    fn = _build.entry("fused_xent", "fused_xent_fwd",
                      [_P] * 7 + [_I] * 3 + [_P])
    lse = torch.empty((N,), dtype=torch.float32, device=h.device)
    ll = torch.empty_like(lse)
    scratch = _scratch(h, N, H, V)
    err = fn(h.data_ptr(), w.data_ptr(), bias.data_ptr(), labels.data_ptr(),
             lse.data_ptr(), ll.data_ptr(), scratch.data_ptr(), N, H, V,
             torch.cuda.current_stream(h.device).cuda_stream)
    _build.check("fused_xent", err, "fused_xent_fwd")
    counters.bump("fused_xent_fwd")
    return lse, ll


def _cuda_bwd(h, w, bias, labels, lse, g):
    N, H, V = _check(h, w, bias, labels)
    for name, t in (("lse", lse), ("g", g)):
        if t.shape != (N,) or t.dtype != torch.float32 \
                or t.device != h.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 ({N},)")
    fn = _build.entry("fused_xent", "fused_xent_bwd",
                      [_P] * 10 + [_I] * 3 + [_P])
    dh, dw = torch.empty_like(h), torch.empty_like(w)
    db = torch.empty_like(bias)
    scratch = _scratch(h, N, H, V)
    err = fn(h.data_ptr(), w.data_ptr(), bias.data_ptr(), labels.data_ptr(),
             lse.data_ptr(), g.data_ptr(), dh.data_ptr(), dw.data_ptr(),
             db.data_ptr(), scratch.data_ptr(), N, H, V,
             torch.cuda.current_stream(h.device).cuda_stream)
    _build.check("fused_xent", err, "fused_xent_bwd")
    counters.bump("fused_xent_bwd")
    return dh, dw, db


def _route(t):
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"fused xent runs on cuda or cpu, got {t.device}")
    return False


def fused_xent_fwd(h, w, bias, labels):
    """(lse, label logit), each (N,) f32; ``labels`` int32 with -1 for
    rows that match no class."""
    if _route(h):
        return _cuda_fwd(h, w, bias, labels)
    return _plain_fwd(h, w, bias, labels)


def fused_xent_bwd(h, w, bias, labels, lse, g):
    """(dh, dW, db) of ``sum_n g[n] * (lse[n] - ll[n])``."""
    if _route(h):
        return _cuda_bwd(h, w, bias, labels, lse, g)
    return _plain_bwd(h, w, bias, labels, lse, g)


class _FusedXentSums(torch.autograd.Function):
    """sum over valid rows of lse - label logit (the JAX sum-form vjp)."""

    @staticmethod
    def forward(ctx, h, w, bias, labels):
        lse, ll = fused_xent_fwd(h, w, bias, labels)
        valid = labels >= 0
        ctx.save_for_backward(h, w, bias, labels, lse)
        return torch.where(valid, lse - ll, torch.zeros_like(lse)).sum()

    @staticmethod
    def backward(ctx, ds):
        h, w, bias, labels, lse = ctx.saved_tensors
        g = torch.where(labels >= 0, ds.to(torch.float32).expand_as(lse),
                        torch.zeros_like(lse)).contiguous()
        dh, dw, db = fused_xent_bwd(h, w, bias, labels, lse, g)
        return dh, dw, db, None


def fused_linear_cross_entropy(h, w, bias, labels, ignore_index=-100):
    """Mean softmax cross-entropy of ``h @ w.T + bias`` against
    ``labels`` over the rows whose label is not ``ignore_index``.
    h: (..., H) f32; w: (V, H); bias: (V,); labels: (...,) int."""
    hd = h.shape[-1]
    h2 = h.reshape(-1, hd).contiguous()
    lab = labels.reshape(-1)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.full_like(lab, -1)).to(torch.int32)
    s = _FusedXentSums.apply(h2, w.contiguous(), bias.contiguous(),
                             safe.contiguous())
    count = valid.sum().to(torch.float32).clamp(min=1.0)
    return s / count

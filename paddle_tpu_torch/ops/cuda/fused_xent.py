"""Fused linear + vocabulary cross-entropy: the plain PyTorch versions,
the CUDA kernel wrappers, and :func:`fused_linear_cross_entropy`.

Port of ``paddle_tpu/ops/pallas/fused_xent.py``: the mean softmax
cross-entropy of ``h @ w.T + bias`` against integer labels, where w is
(V, H) (the tied embedding table of BERT's MLM head). The forward
kernel streams vocab tiles with an online log-sum-exp and returns the
per-row ``lse`` and label logit ``ll``; the backward kernels recompute
the logit tiles from ``lse`` and produce dh (row tiles looping over the
vocabulary) and dW, db (vocab tiles looping over rows). The logits
never reach device memory. Two forms: f32 inputs and outputs, and the
2-byte forms over bf16 or f16 h, W and bias (what ``amp.auto_cast(level=
"O2")`` hands the MLM head): lse and the label logit f32, dh, dW and db
in the inputs' type, as the JAX kernel returns them.

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

The 2-byte forms (``fused_xent_{fwd,bwd}_{bf16,f16}`` in the same
source) read h and W as they are, with no split and no scratch: one bf16
or f16 tensor-core term a product with f32 accumulation (S = h W^T is
exact products summed in f32). They are kernels of their own, two
warpgroups a CTA fed by a TMA ring that one thread keeps filled. The
forward takes 128-row tiles of h against 256-row tiles of W with an
online log-sum-exp, no cluster (H is only contracted), one CTA a row
tile walking the whole vocabulary. The backward keeps the cluster split
of H (dh and dW have H as an output axis), 128 rows a CTA, and exchanges
the partial logits and P' between the cluster's CTAs by asynchronous
stores into each other's shared memory, completing on the receiver's
mbarriers, with no cluster barrier in the loop. P' is rounded to the
input type once, scaled by a power of two into f16's range (dW's scale
is one for the launch, from the largest |g|), and dh, dW, db are rounded
once from their f32 accumulators. Their plain versions upcast h, W and
bias to f32, compute the f32 plain version's arithmetic, and round dh,
dW and db to the inputs' type (the JAX kernel's own upcast-each-tile
arithmetic). Bounds at BERT's head, one term a product at 989 TFLOP/s:
0.778 ms forward, 3.114 ms backward (four products; 2.335 ms for three).
Each type counts apart: ``fused_xent_fwd_bf16`` / ``_bwd_bf16`` /
``_fwd_f16`` / ``_bwd_f16``.

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

__all__ = ["fused_linear_cross_entropy", "fused_xent_fwd", "fused_xent_bwd",
           "TWO_BYTE"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_MAX_H = 1024      # four CTAs of a cluster, 256 columns of H each
#: the 2-byte forms' entry-point and counter suffix of each input type
TWO_BYTE = {torch.bfloat16: "bf16", torch.float16: "f16"}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _logits(h, w, bias):
    return torch.matmul(h, w.t()) + bias


def _hits(labels, V):
    """(row has a class in [0, V), that class clamped into range)"""
    hit = (labels >= 0) & (labels < V)
    return hit, labels.long().clamp(0, V - 1)[:, None]


def _f32(*ts):
    return [t.to(torch.float32) for t in ts]


def _plain_fwd(h, w, bias, labels):
    """(lse, label logit), f32, from h, W, bias upcast to f32."""
    h, w, bias = _f32(h, w, bias)
    logits = _logits(h, w, bias)
    lse = torch.logsumexp(logits, dim=-1)
    hit, idx = _hits(labels, w.shape[0])
    picked = logits.gather(1, idx)[:, 0]
    ll = torch.where(hit, picked, torch.zeros_like(picked))
    return lse, ll


def _plain_bwd(h, w, bias, labels, lse, g):
    """(dh, dW, db) in f32, and rounded to h's, W's and bias's types
    when those are 2-byte."""
    types = (h.dtype, w.dtype, bias.dtype)
    h, w, bias = _f32(h, w, bias)
    p = torch.exp(_logits(h, w, bias) - lse[:, None])
    hit, idx = _hits(labels, w.shape[0])
    p = p.scatter_add(1, idx, -hit.to(p.dtype)[:, None])
    p = p * g[:, None]
    outs = (torch.matmul(p, w), torch.matmul(p.t(), h), p.sum(dim=0))
    return tuple(o.to(t) for o, t in zip(outs, types))


def _term_norms(h, w, bias, labels, lse, g):
    """For checks of the 2-byte kernels: per element of dh and of dW,
    the 2-norm of the terms it sums, |P' W| over the vocabulary for dh
    and |P'^T h| over the rows for dW, with P' = (P - onehot) g; per
    element of db the 1-norm of its terms |P'| over the rows. The
    kernels round each P' of dh and dW to the inputs' type once
    (relative error at most its unit roundoff u), so such an element's
    f32 sum moves from the plain version's by about u times its 2-norm
    (the errors' signs vary), and by at most u times it where a few
    terms dominate; db sums P' in f32, so it moves by f32's rounding of
    its 1-norm."""
    h, w, bias = _f32(h, w, bias)
    p = torch.exp(_logits(h, w, bias) - lse[:, None])
    hit, idx = _hits(labels, w.shape[0])
    p = p.scatter_add(1, idx, -hit.to(p.dtype)[:, None])
    p = (p * g[:, None]).abs_()
    l1 = p.sum(dim=0)
    p = p.square_()
    return (torch.matmul(p, w.square()).sqrt_(),
            torch.matmul(p.t(), h.square()).sqrt_(), l1)


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
    if h.dtype != torch.float32 and h.dtype not in TWO_BYTE:
        raise TypeError(f"the fused xent kernels take f32, bf16 or f16, "
                        f"h is {h.dtype}")
    for name, t in (("w", w), ("bias", bias)):
        if t.dtype != h.dtype:
            raise TypeError(f"the fused xent kernels take h, w and bias of "
                            f"one type: h is {h.dtype}, {name} {t.dtype}")
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
    if h.dtype in TWO_BYTE:
        return _cuda_fwd_2byte(h, w, bias, labels, N, H, V)
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


def _cuda_fwd_2byte(h, w, bias, labels, N, H, V):
    kind = TWO_BYTE[h.dtype]
    fn = _build.entry("fused_xent", "fused_xent_fwd_" + kind,
                      [_P] * 6 + [_I] * 3 + [_P])
    lse = torch.empty((N,), dtype=torch.float32, device=h.device)
    ll = torch.empty_like(lse)
    err = fn(h.data_ptr(), w.data_ptr(), bias.data_ptr(), labels.data_ptr(),
             lse.data_ptr(), ll.data_ptr(), N, H, V,
             torch.cuda.current_stream(h.device).cuda_stream)
    _build.check("fused_xent", err, "fused_xent_fwd_" + kind)
    counters.bump("fused_xent_fwd_" + kind)
    return lse, ll


def _cuda_bwd_2byte(h, w, bias, labels, lse, g, N, H, V):
    kind = TWO_BYTE[h.dtype]
    fn = _build.entry("fused_xent", "fused_xent_bwd_" + kind,
                      [_P] * 9 + [_I] * 3 + [_P])
    dh, dw = torch.empty_like(h), torch.empty_like(w)
    db = torch.empty_like(bias)
    err = fn(h.data_ptr(), w.data_ptr(), bias.data_ptr(), labels.data_ptr(),
             lse.data_ptr(), g.data_ptr(), dh.data_ptr(), dw.data_ptr(),
             db.data_ptr(), N, H, V,
             torch.cuda.current_stream(h.device).cuda_stream)
    _build.check("fused_xent", err, "fused_xent_bwd_" + kind)
    counters.bump("fused_xent_bwd_" + kind)
    return dh, dw, db


def _cuda_bwd(h, w, bias, labels, lse, g):
    N, H, V = _check(h, w, bias, labels)
    for name, t in (("lse", lse), ("g", g)):
        if t.shape != (N,) or t.dtype != torch.float32 \
                or t.device != h.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 ({N},)")
    if h.dtype in TWO_BYTE:
        return _cuda_bwd_2byte(h, w, bias, labels, lse, g, N, H, V)
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
    h: (..., H); w: (V, H); bias: (V,), all f32 or all of one 2-byte
    type; labels: (...,) int. The loss is f32."""
    hd = h.shape[-1]
    h2 = h.reshape(-1, hd).contiguous()
    lab = labels.reshape(-1)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.full_like(lab, -1)).to(torch.int32)
    s = _FusedXentSums.apply(h2, w.contiguous(), bias.contiguous(),
                             safe.contiguous())
    count = valid.sum().to(torch.float32).clamp(min=1.0)
    return s / count

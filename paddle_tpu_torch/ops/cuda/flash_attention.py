"""Flash attention with in-kernel dropout: the plain PyTorch versions,
the CUDA kernel wrappers, and the autograd function behind
:func:`flash_attention` and :func:`flash_attention_short`.

Port of ``paddle_tpu/ops/pallas/flash_attention.py``: the streaming
kernels (``_fwd_call`` with ``_flash_fwd_kernel``, ``_bwd_call`` with
the dq and dk/dv kernels; ``csrc/flash_attention.cu``) and the
short-sequence kernels (``_flash_attention_core_short_fwd`` and
``_flash_attention_core_short_bwd``; ``csrc/flash_short.cu``), which
give one block a whole (batch, head), take a direct softmax over the
row and compute dq, dk and dv in one backward launch. Every kernel takes
head widths 64, 128, 192 and 256, the widths JAX's Pallas gates admit
(at 192 and 256 the backward kernels split the columns of dK, dV and,
in the short form, dQ between blocks, and the f32 forms load some
operand tiles in turn: ``csrc/flash_attention.cu``'s header). The short
forms take Lq == Lk, 128 <= L <= 512, L % 128 == 0 (:func:`short_ok`);
they
compute the same function as the streaming ones, so both share one
plain version. Layout is the JAX package's: q, k, v and out are (B, L, H, D);
the kernels index that layout directly (no head merge). Scores use the
scaled query ``q * (1/sqrt(D))``; the forward also returns the per-row
log-sum-exp ``lse`` (B*H, Lq) in f32, which the backward uses to
recompute the probabilities (delta = rowsum(dO * O) is computed in the
dq pass). Inputs are f32, bf16 or f16 (the plain version computes in
f32, or f64 when given f64, for gradient checks, and returns the input
type, as the JAX kernel computes in f32 and writes ``q.dtype``). Every
kernel has an f16 form (AMP O1 fp16): the streaming forward and its
saved-output and external-lse backward (``csrc/flash_attention.cu``),
the short forward and backward (``csrc/flash_short.cu``), dS lifted by
a power of two before its f16 rounding in each backward. The 2-byte
(bf16 and f16) forms run on tensor cores, the short backward as one
thread-block cluster a (batch, head) with dQ summed in distributed
shared memory in a fixed order: 2-byte operands, f32 accumulators, m,
l, lse, delta, P and dS in f32 until they become operands of a
product, P and dS then entering as two terms of the type (hi + lo)
except P into dV (one). The f32 forms (the parity route held to 1e-4,
which TF32 cannot meet) compute in f32 FMA.

Dropout (rate p) is generated inside the kernels by Philox4x32-10 keyed
by the 64-bit ``seed`` and counted by element coordinates: counter
``(g, row, b*H + h, 0)`` with ``g = (col // 64) * 16 + col % 16``, word
``(col // 16) % 4`` (one kernel thread's four columns ``c, c+16, c+32,
c+48`` share one call). An element is kept
where its 32 bits are ``>= uint32(p * 2**32)``, as ``_keep_mask`` keeps
them. The mask is therefore a function of (seed, b*H + h, row, col)
only, not of tile sizes, so the forward and both backward kernels
regenerate the same mask, and :func:`philox_keep_mask` (int64 tensor
arithmetic) gives the same bits on any device. As in the TPU kernel,
the normaliser l sums the undropped probabilities and only the value
accumulation sees the mask, scaled by 1/(1-p). The bits differ from the
TPU PRNG's (see ``framework/random.py``).

Key masks (the masked form of the streaming kernels, ``masked=True``
in the JAX package): an optional ``bias`` (B, Lk) f32 is added to the
f32 scores before the softmax and again when the backward recomputes
the probabilities. :func:`kv_mask_bias` makes it from a boolean
key-padding mask with the finite -1e30 of ``_kv_mask_bias``, so a row
whose every key is masked gives the mean of V, as the JAX paths do. The
bias rides with dropout and causal masking (the JAX package sends a
mask with dropout to XLA; the math is the same) and gets no gradient.
Columns past Lk and above the diagonal score -inf, so a causal row
whose every allowed key is masked averages V over its allowed keys.
The short kernels take no bias.

The external-lse backward (:func:`flash_attention_bwd_ext`, the form
``_bwd_call`` takes in ``parallel/ring.py``'s ``_ring_flash_bwd``):
(dq, dk, dv) of one kv block from the caller's ``lse`` and ``delta``
(B*H, Lq) f32 of the whole sequence, with no saved output and no
dropout; it launches the same two kernels with the dq pass reading
delta instead of computing it, and counts ``flash_attention_ext_bwd``
(``flash_attention_ext_bwd_f16`` over f16).

Routing is by device, with no fallback: CUDA tensors launch the kernels
(counting ``flash_attention_fwd`` per forward and
``flash_attention_bwd`` per backward pair of launches,
``flash_attention_masked_fwd`` / ``flash_attention_masked_bwd`` for
the same launches with a bias, ``flash_attention_short_fwd`` /
``flash_attention_short_bwd`` per launch of the short forms, each with
the suffix ``_f16`` for the f16 forms (f32 and bf16 share the
unsuffixed counts)) or raise;
CPU tensors take the plain version. The JAX package's dispatch floors
(seq >= 256, the TPU autotune of the short forms) were TPU tuning: on
CUDA, attention always launches a kernel, and ``nn.functional`` picks
the short or the streaming one by ``FLAGS_flash_short_seq``,
:func:`short_ok` and the mask.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, counters

__all__ = ["flash_attention", "flash_attention_short", "short_ok",
           "flash_attention_bwd_ext", "key_padding_view", "kv_mask_bias",
           "kv_tile_visits", "philox_keep_mask", "keep_threshold",
           "per_query_attention"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_HEAD_DIMS = (64, 128, 192, 256)
_SHORT_MIN, _SHORT_MAX = 128, 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NEG_INF = -1e30             # the JAX package's finite mask value
_TILE = 64                   # the kernels' q and kv tile rows

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Philox4x32-10 in int64 tensor arithmetic (values held in [0, 2**32))
# ---------------------------------------------------------------------------
def _mulhilo(a: int, b):
    """(hi, lo) 32-bit halves of a * b for a constant a < 2**32 and a
    tensor b in [0, 2**32), without overflowing int64."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _U32


def _philox4x32_10(c0, c1, c2, c3, seed: int):
    k0, k1 = seed & _U32, (seed >> 32) & _U32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(p: float) -> int:
    """uint32 threshold of ``_keep_mask``: keep where bits >= it."""
    return min(int(p * (1 << 32)), (1 << 32) - 1)


def philox_keep_mask(seed: int, bh: int, lq: int, lk: int, p: float,
                     device="cpu"):
    """Keep mask (bh, lq, lk) bool of dropout rate ``p``: the kernels'
    bits, from int64 tensor ops."""
    ng = (lk + 63) // 64 * 16
    c0 = torch.arange(ng, dtype=torch.int64, device=device).view(1, 1, ng)
    c1 = torch.arange(lq, dtype=torch.int64, device=device).view(1, lq, 1)
    c2 = torch.arange(bh, dtype=torch.int64, device=device).view(bh, 1, 1)
    shape = (bh, lq, ng)
    c0, c1, c2 = c0.expand(shape), c1.expand(shape), c2.expand(shape)
    c3 = torch.zeros(shape, dtype=torch.int64, device=device)
    words = torch.stack(_philox4x32_10(c0, c1, c2, c3, int(seed)), dim=-1)
    col = torch.arange(lk, device=device)
    bits = words[:, :, (col // 64) * 16 + col % 16, (col // 16) % 4]
    return bits >= keep_threshold(p)


def key_padding_view(mask, batch, kv_len):
    """The (B, Lk) view of a mask of shape (B, Lk), (B, 1, Lk) or
    (B, 1, 1, Lk) (the unit axes dropped as ``_kv_mask_bias`` drops
    them), or None for any other shape (a per-query mask)."""
    m = mask
    while m.dim() > 2 and m.shape[1] == 1:
        m = m[:, 0]
    if m.dim() != 2 or tuple(m.shape) != (batch, kv_len):
        return None
    return m


def kv_mask_bias(mask, batch, kv_len):
    """``_kv_mask_bias``: a boolean key-padding mask (True = attend) of
    a :func:`key_padding_view` shape as an additive (B, Lk) f32 bias, 0
    or -1e30; None for any other mask (a float mask, a per-query one)."""
    m = key_padding_view(mask, batch, kv_len) \
        if mask.dtype == torch.bool else None
    if m is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=m.device)
    return torch.where(m, zero, torch.full_like(zero, _NEG_INF))


def kv_tile_visits(batch, lq, lk, causal, bias=None):
    """The 64-key tiles the bf16 forward's block of each 64-row q tile
    visits: (batch, ceil(lq / 64), ceil(lk / 64)) bool. The rule of
    ``csrc/flash_common.cuh`` ``scan_live_tiles``: causal blocks stop at
    the diagonal's tile; with a (batch, lk) key ``bias``, a tile whose
    every value is <= -1e30 is dead, and the block skips dead tiles when
    every row of its q tile keeps a live allowed key (not causal: the
    batch entry has a live key; causal: its first live key is at or
    before the q tile's first row). Skipping then changes no bit: a
    dead tile's exp underflows to 0 after the first live tile, and the
    first live tile's rescale (alpha = 0) wipes one visited before it.
    Otherwise every tile is visited."""
    nq, nk = -(-lq // _TILE), -(-lk // _TILE)
    q0 = torch.arange(nq) * _TILE
    kt = torch.arange(nk)
    last = torch.minimum(q0 // _TILE + 1, torch.tensor(nk)) if causal \
        else torch.full((nq,), nk)
    visits = (kt[None, :] < last[:, None]).expand(batch, nq, nk)
    if bias is None:
        return visits.clone()
    live = bias.detach().to("cpu", torch.float32) > _NEG_INF   # (B, lk)
    tiles = torch.nn.functional.pad(live, (0, nk * _TILE - lk))
    live_tile = tiles.view(batch, nk, _TILE).any(-1)
    first = torch.where(live.any(-1), live.float().argmax(-1),
                        torch.tensor(lk))
    skip = first[:, None] <= q0[None, :] if causal \
        else (first < lk)[:, None].expand(batch, nq)
    return visits & ~(skip[:, :, None] & ~live_tile[:, None, :])


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _compute_dtype(t):
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _heads(x, ct):
    """(B, L, H, D) -> (B*H, L, D) in the compute type."""
    B, L, H, D = x.shape
    return x.to(ct).permute(0, 2, 1, 3).reshape(B * H, L, D)


def _scores(qm, km, scale, causal, bias=None):
    s = torch.matmul(qm * scale, km.transpose(1, 2))
    if bias is not None:
        bh, lq, lk = s.shape
        s = (s.view(bias.shape[0], bh // bias.shape[0], lq, lk)
             + bias.to(s.dtype)[:, None, None, :]).view(bh, lq, lk)
    if causal:
        lq, lk = s.shape[1], s.shape[2]
        row = torch.arange(lq, device=s.device).view(lq, 1)
        col = torch.arange(lk, device=s.device).view(1, lk)
        s = s.masked_fill(col > row, float("-inf"))
    return s


def _plain_fwd(q, k, v, causal, dropout_p, seed, bias=None):
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    ct = _compute_dtype(q)
    scale = 1.0 / math.sqrt(D)
    qm, km, vm = _heads(q, ct), _heads(k, ct), _heads(v, ct)
    s = _scores(qm, km, scale, causal, bias)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l)).squeeze(-1)
    prob = e / l
    if dropout_p > 0.0:
        keep = philox_keep_mask(seed, B * H, Lq, Lk, dropout_p, q.device)
        prob = torch.where(keep, prob * (1.0 / (1.0 - dropout_p)),
                           torch.zeros_like(prob))
    out = torch.matmul(prob, vm)
    out = out.reshape(B, H, Lq, D).permute(0, 2, 1, 3).to(q.dtype)
    return out.contiguous(), lse.to(torch.float32)


def _plain_bwd(q, k, v, out, lse, dout, causal, dropout_p, seed, bias=None):
    ct = _compute_dtype(q)
    D = q.shape[3]
    scale = 1.0 / math.sqrt(D)
    qm, km, vm = _heads(q, ct), _heads(k, ct), _heads(v, ct)
    om, dom = _heads(out, ct), _heads(dout, ct)
    delta = (dom * om).sum(dim=-1, keepdim=True)
    return _plain_grads(q, k, v, qm, km, vm, dom, lse, delta, scale, causal,
                        dropout_p, seed, bias)


def _plain_bwd_ext(q, k, v, dout, lse, delta, causal, bias=None):
    """The external-lse backward: (dq, dk, dv) of this kv block from the
    caller's lse and delta (B*H, Lq) of the whole sequence."""
    ct = _compute_dtype(q)
    scale = 1.0 / math.sqrt(q.shape[3])
    qm, km, vm = _heads(q, ct), _heads(k, ct), _heads(v, ct)
    dom = _heads(dout, ct)
    return _plain_grads(q, k, v, qm, km, vm, dom, lse,
                        delta.to(ct).unsqueeze(-1), scale, causal, 0.0, 0,
                        bias)


def _plain_grads(q, k, v, qm, km, vm, dom, lse, delta, scale, causal,
                 dropout_p, seed, bias):
    """dq, dk, dv from the recomputed P = exp(S - lse) and delta
    (B*H, Lq, 1), both backward forms' arithmetic."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    ct = qm.dtype
    s = _scores(qm, km, scale, causal, bias)
    prob = torch.exp(s - lse.to(ct).unsqueeze(-1))
    dp = torch.matmul(dom, vm.transpose(1, 2))
    if dropout_p > 0.0:
        keep = philox_keep_mask(seed, B * H, Lq, Lk, dropout_p, q.device)
        inv = 1.0 / (1.0 - dropout_p)
        zero = torch.zeros_like(dp)
        dp = torch.where(keep, dp * inv, zero)
        pd = torch.where(keep, prob * inv, zero)
    else:
        pd = prob
    dv = torch.matmul(pd.transpose(1, 2), dom)
    ds = prob * (dp - delta)
    dq = torch.matmul(ds, km) * scale
    dk = torch.matmul(ds.transpose(1, 2), qm * scale)

    def back(x, L, like):
        return x.reshape(B, H, L, D).permute(0, 2, 1, 3).to(like.dtype) \
            .contiguous()

    return back(dq, Lq, q), back(dk, Lk, k), back(dv, Lk, v)


def _term_norms(q, k, v, out, lse, dout, causal, dropout_p, seed,
                bias=None):
    """For checks of the 2-byte kernels: per element of out, dq, dk and
    dv, the 2-norm of the terms it sums (|P' V| over the keys for out,
    scale |dS K| for dq, scale |dS^T Q| for dk, |P'^T dO| for dv; P' the
    dropped probabilities, dS = P (dP' - delta)), in f32 from the
    inputs' values, the given ``out`` and ``lse``. A kernel that rounds
    each P' or dS to its 2-byte type once moves such an element from the
    plain version's f32 value by about the unit roundoff times this
    norm. Then, for dq and dk, the terms' sums that the f32 rounding of
    dP and delta reaches: scale P (|dP'| + |delta|)'s 1-norms times |K|
    (dq) or |Q| (dk), where dP's is sum |dO V| (dropped and scaled) and
    delta's sum |dO out|. Where dS cancels (a row whose only live key
    gives dP' = delta up to out's rounding) it is the rounding noise of
    those f32 sums, which two summation orders give differently; a few
    D f32 unit roundoffs of these sums bound it. Returns (out, dq, dk,
    dv) norms and (dq, dk) sums, each in its tensor's (B, L, H, D)."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    qm, km, vm, om, dom = (_heads(x.float(), torch.float32)
                           for x in (q, k, v, out, dout))
    s = _scores(qm, km, scale, causal, bias)
    prob = torch.exp(s - lse.float().unsqueeze(-1))
    dp = torch.matmul(dom, vm.transpose(1, 2))
    dp_abs = torch.matmul(dom.abs(), vm.abs().transpose(1, 2))
    if dropout_p > 0.0:
        keep = philox_keep_mask(seed, B * H, Lq, Lk, dropout_p, q.device)
        inv = 1.0 / (1.0 - dropout_p)
        zero = torch.zeros_like(prob)
        pd = torch.where(keep, prob * inv, zero)
        dp = torch.where(keep, dp * inv, zero)
        dp_abs = torch.where(keep, dp_abs * inv, zero)
    else:
        pd = prob
    delta = (dom * om).sum(-1, keepdim=True)
    ds = prob * (dp - delta)
    sums = prob * (dp_abs + (dom * om).abs().sum(-1, keepdim=True))
    pd2, ds2 = pd.square(), ds.square()

    def back(x, L):
        return x.reshape(B, H, L, D).permute(0, 2, 1, 3)

    def norm(x, L):
        return back(x.sqrt_(), L)

    return ((norm(torch.matmul(pd2, vm.square()), Lq),
             norm(torch.matmul(ds2, km.square()), Lq) * scale,
             norm(torch.matmul(ds2.transpose(1, 2), qm.square()), Lk) * scale,
             norm(torch.matmul(pd2.transpose(1, 2), dom.square()), Lk)),
            (back(torch.matmul(sums, km.abs()), Lq) * scale,
             back(torch.matmul(sums.transpose(1, 2), qm.abs()), Lk) * scale))


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------
def _check(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q (B, Lq, H, D) and k, v "
                         f"(B, Lk, H, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Lq, H, D = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"the flash attention kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash attention kernel takes f32, bf16 or "
                        f"f16 q/k/v of one type, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if causal and k.shape[1] != Lq:
        raise ValueError("causal flash attention needs Lq == Lk")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("flash_attention inputs must be contiguous, "
                             "16-byte aligned and on one device")
    return B, Lq, k.shape[1], H, D


def _lib(name, D):
    """The kernel library of ``name`` that holds head width D: 192 and
    256 build as a library of their own (``_build.VARIANTS``)."""
    return name + "_wide" if D > 128 else name


def _counter(name, q):
    """The launch count of ``name``: f16 launches apart."""
    return name + "_f16" if q.dtype == torch.float16 else name


def _check_bias(bias, q, B, Lk):
    """The kernels' key-mask pointer: 0 (none) or a contiguous f32
    (B, Lk) on q's device."""
    if bias is None:
        return 0
    if bias.shape != (B, Lk) or bias.dtype != torch.float32 \
            or bias.device != q.device or not bias.is_contiguous():
        raise ValueError(f"flash attention's key mask must be a contiguous "
                         f"f32 ({B}, {Lk}) on {q.device}, got "
                         f"{bias.dtype} {tuple(bias.shape)} on {bias.device}")
    return bias.data_ptr()


def _dropout_args(dropout_p, seed):
    """(keep threshold, 1/(1-p), seed's low and high words) as the
    kernels take them; p = 0 is threshold 0 and scale 1 (no dropout)."""
    seed = int(seed) & ((1 << 64) - 1)
    lo, hi = seed & _U32, seed >> 32
    if dropout_p > 0.0:
        return keep_threshold(dropout_p), 1.0 / (1.0 - dropout_p), lo, hi
    return 0, 1.0, lo, hi


def _cuda_fwd(q, k, v, causal, dropout_p, seed, bias=None):
    B, Lq, Lk, H, D = _check(q, k, v, causal)
    bias_ptr = _check_bias(bias, q, B, Lk)
    fn = _build.entry(_lib("flash_attention", D), "flash_attention_fwd",
                      [_P] * 6 + [_I] * 7 + [_F, _U, _F, _U, _U, _P])
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Lq), dtype=torch.float32, device=q.device)
    thr, inv, lo, hi = _dropout_args(dropout_p, seed)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), bias_ptr, B, Lq, Lk, H, D, int(bool(causal)),
             _DTYPES[q.dtype], 1.0 / math.sqrt(D), thr, inv, lo, hi,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_lib("flash_attention", D), err, "flash_attention_fwd")
    counters.bump(_counter("flash_attention_fwd" if bias is None
                           else "flash_attention_masked_fwd", q))
    return out, lse


def _check_saved(q, out, lse, dout):
    B, Lq, H, _ = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype \
                or t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"flash attention backward: {name} must be a "
                             f"contiguous, 16-byte aligned {q.dtype} "
                             f"{tuple(q.shape)}")
    if lse.shape != (B * H, Lq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 ({B * H}, {Lq})")


def _cuda_bwd(q, k, v, out, lse, dout, causal, dropout_p, seed, bias=None):
    B, Lq, Lk, H, D = _check(q, k, v, causal)
    _check_saved(q, out, lse, dout)
    bias_ptr = _check_bias(bias, q, B, Lk)
    fn = _build.entry(_lib("flash_attention", D), "flash_attention_bwd",
                      [_P] * 11 + [_I] * 7 + [_F, _U, _F, _U, _U, _P])
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    delta = torch.empty((B * H, Lq), dtype=torch.float32, device=q.device)
    thr, inv, lo, hi = _dropout_args(dropout_p, seed)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bias_ptr,
             B, Lq, Lk, H, D, int(bool(causal)), _DTYPES[q.dtype],
             1.0 / math.sqrt(D), thr, inv, lo, hi,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_lib("flash_attention", D), err, "flash_attention_bwd")
    counters.bump(_counter("flash_attention_bwd" if bias is None
                           else "flash_attention_masked_bwd", q))
    return dq, dk, dv


def _check_ext(q, dout, lse, delta):
    B, Lq, H, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or dout.device != q.device or not dout.is_contiguous() \
            or dout.data_ptr() % 16:
        raise ValueError(f"flash attention backward: dout must be a "
                         f"contiguous, 16-byte aligned {q.dtype} "
                         f"{tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B * H, Lq) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 "
                             f"({B * H}, {Lq}) on {q.device}")


def _cuda_bwd_ext(q, k, v, dout, lse, delta, causal, bias=None):
    B, Lq, Lk, H, D = _check(q, k, v, causal)
    _check_ext(q, dout, lse, delta)
    bias_ptr = _check_bias(bias, q, B, Lk)
    fn = _build.entry(_lib("flash_attention", D), "flash_attention_bwd_ext",
                      [_P] * 10 + [_I] * 7 + [_F, _P])
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), bias_ptr, B, Lq, Lk, H, D, int(bool(causal)),
             _DTYPES[q.dtype], 1.0 / math.sqrt(D),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_lib("flash_attention", D), err, "flash_attention_bwd_ext")
    counters.bump(_counter("flash_attention_ext_bwd", q))
    return dq, dk, dv


def short_ok(q, k, causal=False):
    """Whether the short-sequence kernels take this shape: Lq == Lk,
    128 <= L <= 512, L % 128 == 0 and head_dim 64, 128, 192 or 256.
    This is the JAX ``_short_ok`` rule without its ``b*h < 2**15``
    bound, which
    guards the TPU's packing of a dropout seed into one int32 word; the
    port's Philox counter holds the full (b*H + h, row, column)
    coordinates, so it has no such limit. ``causal`` is taken either
    way."""
    if q.dim() != 4 or k.dim() != 4:
        return False
    L, D = q.shape[1], q.shape[3]
    return (k.shape[1] == L and _SHORT_MIN <= L <= _SHORT_MAX
            and L % 128 == 0 and D in _HEAD_DIMS)


def _no_bias(bias):
    if bias is not None:
        raise ValueError("the short flash kernels take no key mask: masked "
                         "attention runs the streaming kernels")


def _check_short(q, k, v, causal):
    dims = _check(q, k, v, causal)
    if not short_ok(q, k, causal):
        raise ValueError(f"the short flash kernels take Lq == Lk, "
                         f"{_SHORT_MIN} <= L <= {_SHORT_MAX}, L % 128 == 0; "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")
    return dims


def _cuda_short_fwd(q, k, v, causal, dropout_p, seed):
    B, L, _, H, D = _check_short(q, k, v, causal)
    fn = _build.entry(_lib("flash_short", D), "flash_short_fwd",
                      [_P] * 5 + [_I] * 6 + [_F, _U, _F, _U, _U, _P])
    out = torch.empty_like(q)
    lse = torch.empty((B * H, L), dtype=torch.float32, device=q.device)
    thr, inv, lo, hi = _dropout_args(dropout_p, seed)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), B, L, H, D, int(bool(causal)),
             _DTYPES[q.dtype], 1.0 / math.sqrt(D), thr, inv, lo, hi,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_lib("flash_short", D), err, "flash_short_fwd")
    counters.bump(_counter("flash_attention_short_fwd", q))
    return out, lse


def _cuda_short_bwd(q, k, v, out, lse, dout, causal, dropout_p, seed):
    B, L, _, H, D = _check_short(q, k, v, causal)
    _check_saved(q, out, lse, dout)
    fn = _build.entry(_lib("flash_short", D), "flash_short_bwd",
                      [_P] * 10 + [_I] * 6 + [_F, _U, _F, _U, _U, _P])
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    # the dQ scratch of the f32 form and of the 2-byte forms at D > 128
    # (their dQ sums); at D <= 128 the 2-byte forms sum dQ in their
    # clusters' shared memory
    dq_acc = torch.empty((B * H, L, D), dtype=torch.float32,
                         device=q.device) \
        if q.dtype == torch.float32 or D > 128 else None
    thr, inv, lo, hi = _dropout_args(dropout_p, seed)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(),
             None if dq_acc is None else dq_acc.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, L, H, D,
             int(bool(causal)), _DTYPES[q.dtype], 1.0 / math.sqrt(D), thr,
             inv, lo, hi, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_lib("flash_short", D), err, "flash_short_bwd")
    counters.bump(_counter("flash_attention_short_bwd", q))
    return dq, dk, dv


def _route(t):
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{t.device}")
    return False


def flash_attention_fwd(q, k, v, causal=False, dropout_p=0.0, seed=0,
                        bias=None):
    """(out (B, Lq, H, D), lse (B*H, Lq) f32): the kernel on CUDA, the
    plain version on the CPU; ``bias`` is an optional (B, Lk) f32 key
    mask."""
    if _route(q):
        return _cuda_fwd(q, k, v, causal, dropout_p, seed, bias)
    return _plain_fwd(q, k, v, causal, dropout_p, seed, bias)


def flash_attention_bwd(q, k, v, out, lse, dout, causal=False,
                        dropout_p=0.0, seed=0, bias=None):
    """(dq, dk, dv) from the saved forward and an external ``lse``."""
    if _route(q):
        return _cuda_bwd(q, k, v, out, lse, dout, causal, dropout_p, seed,
                         bias)
    return _plain_bwd(q, k, v, out, lse, dout, causal, dropout_p, seed,
                      bias)


def flash_attention_bwd_ext(q, k, v, dout, lse, delta, causal=False,
                            bias=None):
    """(dq, dk, dv) of one kv block ``k``, ``v`` from the caller's
    ``lse`` and ``delta`` = rowsum(dO * O) ((B*H, Lq) f32) of the whole
    sequence, with an optional (B, Lk) f32 key mask ``bias``; no
    dropout. The kernel on CUDA, the plain version on the CPU."""
    if _route(q):
        return _cuda_bwd_ext(q, k, v, dout, lse, delta, causal, bias)
    return _plain_bwd_ext(q, k, v, dout, lse, delta, causal, bias)


def flash_attention_short_fwd(q, k, v, causal=False, dropout_p=0.0,
                              seed=0, bias=None):
    """The short-sequence forward: (out, lse) as
    :func:`flash_attention_fwd`, for shapes :func:`short_ok` takes and
    no key mask (``bias`` must be None)."""
    _no_bias(bias)
    if _route(q):
        return _cuda_short_fwd(q, k, v, causal, dropout_p, seed)
    _check_short(q, k, v, causal)
    return _plain_fwd(q, k, v, causal, dropout_p, seed)


def flash_attention_short_bwd(q, k, v, out, lse, dout, causal=False,
                              dropout_p=0.0, seed=0, bias=None):
    """The short-sequence backward: (dq, dk, dv) in one launch."""
    _no_bias(bias)
    if _route(q):
        return _cuda_short_bwd(q, k, v, out, lse, dout, causal, dropout_p,
                               seed)
    _check_short(q, k, v, causal)
    return _plain_bwd(q, k, v, out, lse, dout, causal, dropout_p, seed)


def attention_route(q_shape, k_shape, causal=False) -> str:
    """``"kernel"`` or ``"plain"``: how attention of these (B, L, H, D)
    shapes is computed, by the JAX package's own route. JAX runs the
    Pallas kernel only where ``_pallas_ok`` (``paddle_tpu/ops/pallas/
    flash_attention.py:759-772``) admits the shape and computes every
    other one outside a kernel (``_xla_attention``); the port does the
    same where the reason is the head width (D % 64 != 0 or D > 256:
    the kernels take 64, 128, 192 and 256) or causal masking with Lq !=
    Lk, which no kernel of either package takes. JAX's sequence-length
    floor and modulus are not copied: the port's kernels take every
    length (BERT's 128 keeps its kernel)."""
    D, Lq, Lk = q_shape[-1], q_shape[1], k_shape[1]
    if D not in _HEAD_DIMS or (causal and Lq != Lk):
        return "plain"
    return "kernel"


def per_query_attention(q, k, v, mask, causal=False, dropout_p=0.0, seed=0):
    """Attention under a per-query mask, in plain PyTorch on q's device
    and counted ``attention_per_query_plain`` (one a call): what the JAX
    package computes outside Pallas for such a mask (``_xla_attention``,
    ``flash_attention.py:32-62``): f32 scores of the (B, L, H, D)
    inputs scaled by 1/sqrt(D), -1e30 above the bottom-right-aligned
    diagonal when ``causal``, then ``mask`` (broadcast against (B, H,
    Lq, Lk): boolean, True = attend, else -1e30; or float, added), the
    f32 softmax rounded to q's type, and P V in q's type. Dropout keeps
    the flash kernels' Philox bits (``philox_keep_mask``), not JAX's.
    Differentiable in q, k, v and a float mask. No kernel takes such a
    mask: ``nn.functional`` sends only masks of this kind here, by their
    kind, never as a fallback."""
    counters.bump("attention_per_query_plain")
    return _plain_attention(q, k, v, mask, causal, dropout_p, seed)


def plain_attention(q, k, v, causal=False, dropout_p=0.0, seed=0,
                    bias=None):
    """Attention of a shape :func:`attention_route` sends outside the
    kernels (a head width the kernels lack, causal with Lq != Lk), with
    the optional (B, Lk) f32 key mask ``bias``: the computation of
    :func:`per_query_attention`, counted ``attention_plain`` (one a
    call), on any device. The flash wrapper's signature, so
    ``nn.functional`` calls either by the route."""
    counters.bump("attention_plain")
    mask = None if bias is None else bias[:, None, None, :]
    return _plain_attention(q, k, v, mask, causal, dropout_p, seed)


def _plain_attention(q, k, v, mask, causal, dropout_p, seed):
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) \
        / math.sqrt(D)
    neg = torch.full((), _NEG_INF, dtype=s.dtype, device=s.device)
    if causal:
        keep = torch.ones((Lq, Lk), dtype=torch.bool,
                          device=s.device).tril(Lk - Lq)
        s = torch.where(keep, s, neg)
    if mask is None:
        pass
    elif mask.dtype == torch.bool:
        s = torch.where(mask, s, neg)
    else:
        s = s + mask.to(s.dtype)
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = philox_keep_mask(seed, B * H, Lq, Lk, dropout_p,
                                q.device).view(B, H, Lq, Lk)
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs))
    return torch.matmul(probs, vh).permute(0, 2, 1, 3)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, causal, dropout_p, seed, short):
        fwd = flash_attention_short_fwd if short else flash_attention_fwd
        out, lse = fwd(q, k, v, causal, dropout_p, seed, bias)
        ctx.save_for_backward(q, k, v, out, lse, bias)
        ctx.args = (causal, dropout_p, seed)
        ctx.short = short
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, bias = ctx.saved_tensors
        bwd = flash_attention_short_bwd if ctx.short else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, dout.contiguous(), *ctx.args,
                         bias)
        return dq, dk, dv, None, None, None, None, None


def _contiguous_bias(bias):
    return None if bias is None else bias.detach().contiguous()


def flash_attention(q, k, v, causal=False, dropout_p=0.0, seed=0,
                    bias=None):
    """softmax(q k^T / sqrt(D) + bias) v over (B, L, H, D) tensors, with
    an optional (B, Lk) f32 key mask ``bias`` (see :func:`kv_mask_bias`),
    causal masking and in-kernel dropout keyed by ``seed``;
    differentiable in q, k and v (the bias gets no gradient)."""
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), _contiguous_bias(bias),
                                 bool(causal), float(dropout_p), int(seed),
                                 False)


def flash_attention_short(q, k, v, causal=False, dropout_p=0.0, seed=0,
                          bias=None):
    """:func:`flash_attention` through the short-sequence kernels (one
    block a head, one backward launch); raises for a shape
    :func:`short_ok` refuses or a key mask. Same dropout mask as the
    streaming kernels for the same seed."""
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), _contiguous_bias(bias),
                                 bool(causal), float(dropout_p), int(seed),
                                 True)

"""The fused embedding bag: the plain PyTorch version, the CUDA kernel
wrapper, and the autograd function behind :func:`fused_embedding_bag`.

Port of ``paddle_tpu/ops/pallas/fused_embedding.py``: the forward is
``_bag_pallas`` (``csrc/fused_embedding.cu``), defined by ``_xla_bag``.
For each bag (a row of ``ids``, (B, S)) it gathers rows of ``table``
(V, D), drops ids < 0, sums in f32 whatever the table's type, pools by
the valid count (``sum``; ``mean`` divides by max(count, 1); ``sqrtn``
by its square root) and casts the (B, D) result to the table's type.
An id >= V reads row V - 1 and counts, as ``_xla_bag``'s clamped gather
does. The backward is ``_bag_bwd``: the pooled gradient divided as the
forward divided, scattered with ``index_add_`` into a zero table. It
drops ids < 0 and, as both JAX backward forms do, ids >= V.

The kernel has two forms, chosen by the inputs
(``csrc/fused_embedding.cu``). Where an f32 table has rows of 1 KB or
more and is larger than half the L2, and the bags fill the card, it
sweeps the table through L2 in row order: each CTA holds a run of bags'
f32 accumulators in shared memory and adds every bag's rows in ascending
row order, so the CTAs walk up the table together and a row's later
reads find it in L2. Elsewhere one block takes each bag. The plain
version adds a bag's rows in position order; all sum in f32, so they
agree to a tolerance, not bit for bit.

Routing is by device, with no fallback: a CUDA table launches the
kernel (counting ``fused_embedding_bag``) or raises; a CPU table takes
the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, counters

__all__ = ["fused_embedding_bag", "COMBINERS"]

COMBINERS = ("sum", "mean", "sqrtn")
_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_IDS = {torch.int32: 0, torch.int64: 1}


def _check_combiner(combiner):
    if combiner not in COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}")


def _plain_bag(table, ids, combiner):
    """``_xla_bag`` with the Pallas kernel's f32 sum: (B, D) in the
    table's type (f64 sums for an f64 table, for gradient checks)."""
    _check_combiner(combiner)
    ct = torch.float64 if table.dtype == torch.float64 else torch.float32
    valid = ids >= 0
    rows = table[ids.clamp(0, table.shape[0] - 1).long()].to(ct)
    out = torch.where(valid.unsqueeze(-1), rows, 0.0).sum(dim=1)
    if combiner != "sum":
        cnt = valid.sum(dim=1, keepdim=True).to(ct).clamp(min=1.0)
        out = out / (cnt if combiner == "mean" else torch.sqrt(cnt))
    return out.to(table.dtype)


def _cuda_bag(table, ids, combiner):
    _check_combiner(combiner)
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"fused_embedding_bag wants table (V, D) and ids "
                         f"(B, S), got {tuple(table.shape)} and "
                         f"{tuple(ids.shape)}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"the embedding bag kernel takes an f32 or bf16 "
                        f"table, got {table.dtype}")
    if ids.dtype not in _IDS:
        raise TypeError(f"the embedding bag kernel takes int32 or int64 "
                        f"ids, got {ids.dtype}")
    if ids.device != table.device or not table.is_contiguous() \
            or not ids.is_contiguous():
        raise ValueError("fused_embedding_bag: table and ids must be "
                         "contiguous and on one device")
    (V, D), (B, S) = table.shape, ids.shape
    if min(V, D, B, S) < 1 or V >= 1 << 31 or S >= 1 << 31:
        raise ValueError(f"fused_embedding_bag takes V, D, B, S >= 1 and "
                         f"V, S < 2**31, got table {tuple(table.shape)}, "
                         f"ids {tuple(ids.shape)}")
    fn = _build.entry("fused_embedding", "fused_embedding_bag",
                      [_P] * 3 + [_I] * 7 + [_P])
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    err = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), B, S, V, D,
             _DTYPES[table.dtype], _IDS[ids.dtype],
             COMBINERS.index(combiner),
             torch.cuda.current_stream(table.device).cuda_stream)
    _build.check("fused_embedding", err, "fused_embedding_bag")
    counters.bump("fused_embedding_bag")
    return out


def bag_forward(table, ids, combiner="sum"):
    """The pooled (B, D) forward: the kernel on CUDA, the plain version
    on the CPU."""
    if table.is_cuda:
        return _cuda_bag(table, ids, combiner)
    if table.device.type != "cpu":
        raise ValueError(f"fused_embedding_bag runs on cuda or cpu, got "
                         f"{table.device}")
    return _plain_bag(table, ids, combiner)


def _bag_bwd(g, ids, combiner, num_rows):
    """``_bag_bwd``: d table (num_rows, D) of the pooled gradient ``g``."""
    valid = ids >= 0
    if combiner != "sum":
        cnt = valid.sum(dim=1).to(g.dtype).clamp(min=1.0)
        g = g / (cnt if combiner == "mean" else torch.sqrt(cnt))[:, None]
    keep = valid & (ids < num_rows)
    safe = torch.where(keep, ids, torch.zeros_like(ids)).reshape(-1).long()
    rows = torch.where(keep.unsqueeze(-1), g.unsqueeze(1), 0.0)
    d = torch.zeros((num_rows, g.shape[-1]), dtype=g.dtype, device=g.device)
    return d.index_add_(0, safe, rows.reshape(-1, g.shape[-1]))


class _Bag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, combiner):
        ctx.save_for_backward(ids)
        ctx.combiner = combiner
        ctx.num_rows = table.shape[0]
        return bag_forward(table, ids, combiner)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return _bag_bwd(g, ids, ctx.combiner, ctx.num_rows), None, None


def fused_embedding_bag(table, ids, combiner="sum"):
    """Pooled bag-of-ids embedding (B, D) of ``table`` (V, D) over
    ``ids`` (B, S), ids < 0 ignored; differentiable in the table."""
    return _Bag.apply(table.contiguous(), ids.contiguous(), combiner)

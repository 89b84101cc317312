"""The collectives of the sequence- and data-parallel training path over
mesh axes (the part of ``paddle_tpu/parallel/collectives.py`` and of
``lax.ppermute`` / ``lax.psum`` / ``lax.all_gather`` that path uses).

Every collective of the path goes through this module. Where the JAX
package emits an XLA collective inside one program, each rank here
calls ``torch.distributed`` on the axis's process group
(``Mesh.group``):

- :func:`ppermute`, the ring neighbour exchange: ``batch_isend_irecv``
  of every tensor at once;
- :func:`all_reduce` (``psum``) over one or more axes, in place;
- :func:`all_gather` over an axis, concatenated along a dimension;
- :func:`all_reduce_grads`, the gradient all-reduce in flat buckets.

Gloo takes CUDA tensors in its all-reduce and all-gather but not in
send/recv. So a CUDA tensor's point-to-point exchange on a gloo group
is staged through pinned host buffers: copied out, sent and received
on the host, copied back. The choice is made by the group's backend
(only :func:`ppermute` stages), never by a caught error; on NCCL
the same calls take the device tensors as they are (that leg needs one
GPU a rank and is not run on a one-card machine). Staged bytes (both
directions) are counted as ``gloo_staged_bytes`` in
``ops/cuda/counters.py``; each call runs under a
``torch.profiler.record_function`` span named ``collectives.<op>``, so
a profiled step shows the time spent in the exchange.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.cuda import counters
from .mesh import Mesh, get_mesh

__all__ = ["ppermute", "all_reduce", "all_gather", "all_reduce_grads",
           "STAGED_BYTES"]

STAGED_BYTES = "gloo_staged_bytes"
_BUCKET_BYTES = 128 << 20


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        raise RuntimeError("no mesh: create one with parallel.create_mesh")
    return mesh


def ppermute(xs, axis: str, shift: int = 1, mesh: Optional[Mesh] = None):
    """Send each tensor of ``xs`` (a tensor or a sequence of them) to the
    rank ``shift`` places further along ``axis`` (cyclically) and return
    what the rank ``shift`` places back sent: the ``lax.ppermute`` with
    ``perm = [(i, (i + shift) % n)]``. A size-1 axis returns ``xs``."""
    mesh = _mesh(mesh)
    single = torch.is_tensor(xs)
    xs = [xs] if single else list(xs)
    n = mesh.axis_size(axis)
    if n == 1:
        return xs[0] if single else xs
    i, ranks, group = mesh.axis_index(axis), mesh.ranks(axis), \
        mesh.group(axis)
    dst, src = ranks[(i + shift) % n], ranks[(i - shift) % n]
    with torch.profiler.record_function("collectives.ppermute"):
        xs = [x.contiguous() for x in xs]
        # gloo's send/recv takes no CUDA tensor (its all-reduce and
        # all-gather do): stage through pinned host buffers
        staged = xs[0].is_cuda and dist.get_backend(group) == "gloo"
        if staged:
            send = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    for x in xs]
            for h, x in zip(send, xs):
                h.copy_(x, non_blocking=True)
            torch.cuda.current_stream(xs[0].device).synchronize()
            recv = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    for x in xs]
        else:
            send, recv = xs, [torch.empty_like(x) for x in xs]
        ops = [dist.P2POp(dist.isend, t, dst, group) for t in send] + \
            [dist.P2POp(dist.irecv, t, src, group) for t in recv]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if staged:
            out = [h.to(x.device, non_blocking=True)
                   for h, x in zip(recv, xs)]
            counters.bump(STAGED_BYTES,
                          2 * sum(x.numel() * x.element_size() for x in xs))
        else:
            out = recv
    return out[0] if single else out


def all_reduce(t: torch.Tensor, axes: Sequence[str],
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum ``t`` in place over the mesh ``axes`` (``lax.psum``), one
    axis group after another; returns ``t``."""
    mesh = _mesh(mesh)
    with torch.profiler.record_function("collectives.all_reduce"):
        for axis in axes:
            if mesh.axis_size(axis) > 1:
                dist.all_reduce(t, group=mesh.group(axis))
    return t


def all_gather(t: torch.Tensor, axis: str, dim: int,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The shards of ``t`` over ``axis``, concatenated along ``dim`` in
    axis order (``lax.all_gather(..., tiled=True)``)."""
    mesh = _mesh(mesh)
    n = mesh.axis_size(axis)
    if n == 1:
        return t
    with torch.profiler.record_function("collectives.all_gather"):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def _buckets(grads: List[torch.Tensor], limit: int):
    bucket, size = [], 0
    for g in grads:
        nbytes = g.numel() * g.element_size()
        if bucket and (size + nbytes > limit
                       or g.dtype != bucket[0].dtype):
            yield bucket
            bucket, size = [], 0
        bucket.append(g)
        size += nbytes
    if bucket:
        yield bucket


def all_reduce_grads(params: Iterable[torch.Tensor], axes: Sequence[str],
                     mesh: Optional[Mesh] = None, divide: int = 1) -> None:
    """Sum the gradients of ``params`` over ``axes`` and divide them by
    ``divide``: each bucket of up to 128 MiB (one dtype) is flattened
    into one buffer, all-reduced once and copied back. Parameters
    without a gradient are skipped (every rank runs the same model, so
    the set agrees)."""
    mesh = _mesh(mesh)
    axes = [a for a in axes if mesh.axis_size(a) > 1]
    if not axes:
        return
    grads = [p.grad for p in params if p.grad is not None]
    for bucket in _buckets(grads, _BUCKET_BYTES):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        all_reduce(flat, axes, mesh)
        if divide != 1:
            flat.div_(divide)
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))

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
- :func:`all_reduce_grads`, the gradient all-reduce in flat buckets;
- the quantized ring of the data-parallel static step (port of
  ``paddle_tpu/parallel/collectives.py:65-336``): the codec
  :func:`quant_encode` / :func:`quant_decode`, :func:`allreduce_start`
  (the reduce-scatter half) and :func:`allreduce_done` (the all-gather
  half), :func:`reduce_scatter`, and :func:`ring_all_gather`, which ports
  JAX's ring ``all_gather(chunk, axis_name, codec=)`` (this module's
  :func:`all_gather` is ``lax.all_gather``, the one ring attention
  uses). The ring is the JAX package's: g - 1 hops of :func:`ppermute`
  to the +1 neighbour, every hop's payload encoded (per-block int8,
  bf16, or raw f32) and every sum accumulated in f32; rank ``idx`` ends
  holding the reduced chunk ``(idx + 1) % g`` of the padded flat
  buffer. The all-gather half encodes that chunk once and forwards the
  encoded bytes unchanged, so every rank decodes the same bytes and
  holds the same result bit for bit. gloo has no reduce-scatter, and the
  ring over ``ppermute`` is the JAX design anyway, so none of this goes
  through ``dist.reduce_scatter``. The closed forms of the wire bytes
  (:func:`padded_len`, :func:`reduce_scatter_nbytes`,
  :func:`all_gather_nbytes`, and ``encoded_nbytes`` / ``ring_nbytes``
  from ``ps/codec.py``) are the executor's counters.

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

from typing import Iterable, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.cuda import counters
from ..ps.codec import QUANT_BLOCK, encoded_nbytes, ring_nbytes
from .mesh import Mesh, get_mesh

__all__ = ["ppermute", "all_reduce", "all_gather", "all_reduce_grads",
           "STAGED_BYTES", "QUANT_BLOCK", "encoded_nbytes", "ring_nbytes",
           "padded_len", "reduce_scatter_nbytes", "all_gather_nbytes",
           "quant_encode", "quant_decode", "allreduce_start",
           "allreduce_done", "reduce_scatter", "ring_all_gather"]

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
               mesh: Optional[Mesh] = None, op: str = "sum") -> torch.Tensor:
    """Sum ``t`` in place over the mesh ``axes`` (``lax.psum``; ``op=
    "max"``: ``lax.pmax``), one axis group after another; returns
    ``t``."""
    mesh = _mesh(mesh)
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    with torch.profiler.record_function("collectives.all_reduce"):
        for axis in axes:
            if mesh.axis_size(axis) > 1:
                dist.all_reduce(t, op=red, group=mesh.group(axis))
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


# ---------------------------------------------------------------------------
# the quantized ring (the data-parallel static step's gradient reduction)
# ---------------------------------------------------------------------------
def padded_len(n_elems: int, group: int, block: int = QUANT_BLOCK) -> int:
    """Flat length a bucket is padded to: a multiple of ``group *
    block``, so every ring chunk is whole scale blocks."""
    unit = max(1, int(group)) * int(block)
    return -(-int(n_elems) // unit) * unit


def reduce_scatter_nbytes(n_elems: int, group: int, codec: str,
                          block: int = QUANT_BLOCK) -> int:
    """Per-rank wire bytes of the ring's reduce-scatter half: half of
    ``ring_nbytes`` (floor)."""
    if max(1, int(group)) <= 1:
        return 0
    return ring_nbytes(n_elems, group, codec, block) // 2


def all_gather_nbytes(n_elems: int, group: int, codec: str,
                      block: int = QUANT_BLOCK) -> int:
    """Per-rank wire bytes of the ring's all-gather half; the two halves
    sum to ``ring_nbytes`` exactly (this one carries the remainder)."""
    if max(1, int(group)) <= 1:
        return 0
    full = ring_nbytes(n_elems, group, codec, block)
    return full - full // 2


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-dim f32 tensor on ``like``'s device: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which is
    not the division JAX does."""
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def quant_encode(x: torch.Tensor, codec: str, block: int = QUANT_BLOCK):
    """Encode a flat f32 vector (for int8 a multiple of ``block`` long):
    ``(payload, scales)``, ``scales`` None for f32 and bf16. int8: one
    max-abs / 127 scale per block, ``torch.round`` (half to even, as
    ``jnp.rint``), clamped to +-127; an all-zero block has scale 0 and
    encodes exact zeros."""
    if codec == "f32":
        return x.to(torch.float32), None
    if codec == "bf16":
        return x.to(torch.bfloat16), None
    if codec != "int8":
        raise ValueError(f"unknown codec {codec!r} (expected f32|bf16|int8)")
    xb = x.to(torch.float32).reshape(-1, block)
    amax = xb.abs().amax(dim=1, keepdim=True)
    scale = amax / _scalar(127.0, xb)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xb / safe), -127, 127).to(torch.int8)
    return q.reshape(-1), scale.reshape(-1)


def quant_decode(payload: torch.Tensor, scales: Optional[torch.Tensor],
                 codec: str, block: int = QUANT_BLOCK) -> torch.Tensor:
    """The f32 values of an encoded payload (a multiply only: the loss
    is in :func:`quant_encode`'s rounding)."""
    if codec in ("f32", "bf16"):
        return payload.to(torch.float32)
    qb = payload.reshape(-1, block).to(torch.float32)
    return (qb * scales.reshape(-1, 1)).reshape(-1)


def _hop(q, sc, axis, mesh):
    """One ring hop of an encoded payload to the +1 neighbour along
    ``axis``. bf16 travels as its int16 bits."""
    bf16 = q.dtype == torch.bfloat16
    xs = [q.view(torch.int16) if bf16 else q]
    if sc is not None:
        xs.append(sc)
    out = ppermute(xs, axis, 1, mesh)
    q = out[0].view(torch.bfloat16) if bf16 else out[0]
    return q, (out[1] if sc is not None else None)


class RingCarry(NamedTuple):
    """What :func:`allreduce_start` hands :func:`allreduce_done`: this
    rank's reduced f32 chunk and how to finish."""
    mine: torch.Tensor
    shape: tuple
    dtype: torch.dtype
    codec: str
    block: int
    axis: str
    group: int
    mesh: Mesh


def allreduce_start(x: torch.Tensor, axis: str, *, codec: str = "int8",
                    block: int = QUANT_BLOCK,
                    mesh: Optional[Mesh] = None) -> RingCarry:
    """The reduce-scatter half of the quantized ring all-reduce of this
    rank's contribution ``x`` (any shape) over ``axis``. At hop s every
    rank sends its f32 partial sum of chunk ``(idx - s) % g``, encoded,
    to rank idx + 1, decodes what arrives and adds its own contribution
    to the next chunk in f32; after g - 1 hops rank idx holds the
    reduced chunk ``(idx + 1) % g``."""
    mesh = _mesh(mesh)
    g = mesh.axis_size(axis)
    shape, dtype = tuple(x.shape), x.dtype
    total = padded_len(x.numel(), g, block)
    flat = x.reshape(-1).to(torch.float32)
    if flat.numel() != total:
        flat = torch.cat([flat, flat.new_zeros(total - flat.numel())])
    flat = flat.reshape(g, total // g)
    if g == 1:
        return RingCarry(flat[0], shape, dtype, codec, block, axis, g, mesh)
    idx = mesh.axis_index(axis)
    with torch.profiler.record_function("collectives.ring_reduce_scatter"):
        acc = flat.new_zeros(total // g)
        for s in range(g - 1):
            q, sc = quant_encode(acc + flat[(idx - s) % g], codec, block)
            q, sc = _hop(q, sc, axis, mesh)
            acc = quant_decode(q, sc, codec, block)
        mine = acc + flat[(idx + 1) % g]
    return RingCarry(mine, shape, dtype, codec, block, axis, g, mesh)


def allreduce_done(carry: RingCarry, avg: bool = False) -> torch.Tensor:
    """The all-gather half completing :func:`allreduce_start`: the
    reduced chunk is encoded ONCE and circulated g - 1 hops; every rank
    decodes the same payload (its own chunk included), so every rank
    returns the same values bit for bit, in ``x``'s shape and dtype.
    ``avg=True`` divides by g after the decode."""
    mine, shape, dtype, codec, block, axis, g, mesh = carry
    if g == 1:
        out = mine
    else:
        idx = mesh.axis_index(axis)
        with torch.profiler.record_function("collectives.ring_all_gather"):
            q, sc = quant_encode(mine, codec, block)
            out = mine.new_empty(g, mine.numel())
            out[(idx + 1) % g] = quant_decode(q, sc, codec, block)
            for s in range(g - 1):
                q, sc = _hop(q, sc, axis, mesh)
                # after s + 1 hops the payload is rank idx - s - 1's,
                # whose reduced chunk is (idx - s) % g
                out[(idx - s) % g] = quant_decode(q, sc, codec, block)
        out = out.reshape(-1)
    if avg:
        out = out / _scalar(g, out)
    n = 1
    for d in shape:
        n *= d
    return out[:n].reshape(shape).to(dtype)


def reduce_scatter(x: torch.Tensor, axis: str, *, codec: str = "int8",
                   avg: bool = False, block: int = QUANT_BLOCK,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The flat f32 reduced chunk this rank owns, ``(idx + 1) % g`` of
    the padded flat buffer (``padded_len(x.numel(), g) // g`` long),
    accumulated in f32 with the wire encoded by ``codec``.
    ``ring_all_gather(reduce_scatter(x))`` under one codec is bit for bit
    the ring all-reduce; the ZeRO step feeds the optimizer this
    UN-quantized chunk. ``avg=True`` divides it by g."""
    carry = allreduce_start(x, axis, codec=codec, block=block, mesh=mesh)
    mine = carry.mine
    if avg:
        mine = mine / _scalar(carry.group, mine)
    return mine


def ring_all_gather(chunk: torch.Tensor, axis: str, *, codec: str = "f32",
                    block: int = QUANT_BLOCK,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The ring all-gather half (JAX's ``collectives.all_gather(chunk,
    axis_name, codec=)``): ``chunk`` is this rank's owned chunk under
    the ring placement (rank idx owns chunk ``(idx + 1) % g``); returns
    the flat ``(g * chunk.numel(),)`` f32 buffer in chunk order, the
    same bits on every rank. The default raw f32 moves the ZeRO step's
    updated parameters exactly."""
    mesh = _mesh(mesh)
    g = mesh.axis_size(axis)
    flat = chunk.reshape(-1).to(torch.float32)
    return allreduce_done(RingCarry(flat, (flat.numel() * g,),
                                    torch.float32, codec, block, axis, g,
                                    mesh))

"""Sequence (context) parallelism by ring attention (port of
``paddle_tpu/parallel/ring.py:94-565``, the flash-ring path).

The sequence axis of q, k and v is cut over a mesh axis: each rank
keeps its query block and the key/value blocks travel around the ring
(``collectives.ppermute``). Per arriving block the forward runs the
flash forward kernel (K1a, causal on the diagonal block) and merges the
normalised block outputs by their log-sum-exp in f32 (``logaddexp``,
lse seeded at the finite -1e30); the last block is folded after the
loop, so the forward makes size - 1 rotations. The backward computes
delta = rowsum(dO * O) once from the merged output and re-walks the
ring with the external-lse backward kernel (K1b's form that takes the
GLOBAL lse and delta, ``flash_attention_bwd_ext``): P = exp(S - lse)
is then the true probability, so each block's dq, dk, dv is an exact
share; dq accumulates in f32 at home, while each block's dk and dv
accumulators (f32) travel with the block and arrive home after a full
circle. The last step rotates only dk and dv (k and v are not needed
after it, which JAX's loop rotates anyway).

Differences from the JAX package, each forced by one process per rank:

- the branch of ``_ring_branch`` (skip the block, take it whole, take
  the causal diagonal) is decided on the host from the rank and the
  step, where JAX switches on traced values. Under a key-padding mask a
  block with no live key is skipped; its liveness over the whole ring is
  one all-gather and one host read, made once a step (cached in the
  ``sequence_parallel`` scope by the mask object) rather than a device
  read per block and layer;
- there is no einsum walk: on CUDA every block launches the kernels or
  raises, on the CPU it runs their plain versions;
- ``ring_attention`` takes the same global tensors on every rank, runs
  this rank's shard and all-gathers the result, so it is global in and
  global out like JAX's; its gradient is global too (each rank's shard
  gradient all-gathered). Under a ``sequence_parallel`` scope
  ``scaled_dot_product_attention`` calls :func:`ring_attention_local`
  instead, because each rank's q, k and v are already its shards (JAX
  calls ``ring_attention`` there: its arrays are global under GSPMD);
- Ulysses (all-to-all) waits for a later slice: gloo, the backend of
  ranks that share one card, has no CUDA all-to-all.

The walk is written once (``_walk_fwd``, ``_walk_bwd``) over a hop
step: across ranks the hop is ``ppermute``; :func:`ring_attention_chunks`
(no JAX counterpart, not exported) runs every rank's walk in one
process with a roll of the per-rank chunks as the hop, which holds the
ring's own code on one card against the one-launch kernels.
"""
from __future__ import annotations

import warnings
from contextlib import contextmanager
from typing import Optional

import torch

from ..ops.cuda.flash_attention import (flash_attention,
                                        flash_attention_bwd_ext,
                                        flash_attention_fwd, kv_mask_bias)
from .collectives import all_gather, ppermute
from .mesh import Mesh, get_mesh

__all__ = ["ring_attention", "ring_attention_local", "sequence_parallel",
           "active_sequence_parallel"]

_NEG_INF = -1e30
_LIVE = -1e29        # a key is live where its bias is above this


def _ring_branch(origin: int, idx: int, is_causal: bool, live) -> int:
    """0 = skip, 1 = full block, 2 = diagonal (in-block causal mask).
    With equal shards, block ``origin`` is entirely before the local q
    block iff origin < idx and entirely after iff origin > idx (skipped
    under causal); a block with no live key is skipped outright."""
    if live is not None and not live[origin]:
        return 0
    if not is_causal:
        return 1
    return 0 if origin > idx else (2 if origin == idx else 1)


def _rows(w, B, H):
    """(B*H, L) -> (B, L, H, 1), to weight (B, L, H, D) rows."""
    return w.view(B, H, w.shape[1]).permute(0, 2, 1).unsqueeze(-1)


def _fwd_block(q, kc, vc, bc, branch, acc, lse):
    """One block's K1a and the logsumexp merge into (acc, lse), f32."""
    B, _, H, _ = q.shape
    out_b, lse_b = flash_attention_fwd(q, kc, vc, branch == 2, 0.0, 0, bc)
    new = torch.logaddexp(lse, lse_b)
    acc = acc * _rows(torch.exp(lse - new), B, H) \
        + out_b.float() * _rows(torch.exp(lse_b - new), B, H)
    return acc, new


def _delta(dout, out):
    """rowsum(dO * O) in f32 as (B*H, L)."""
    B, L, H, _ = dout.shape
    d = (dout.float() * out.float()).sum(-1)
    return d.permute(0, 2, 1).reshape(B * H, L).contiguous()


def _init(q):
    B, L, H, _ = q.shape
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full((B * H, L), _NEG_INF, dtype=torch.float32,
                       device=q.device))


def _walk_fwd(qs, ks, vs, bs, idxs, size, is_causal, live, rotate):
    """The ring's forward for the ranks ``idxs`` this process holds (one
    entry of each list a rank): per step every held rank merges the
    block it holds, then ``rotate`` moves the k/v/bias blocks one hop.
    Returns each rank's (out in q's dtype, lse)."""
    state = [_init(q) for q in qs]
    for s in range(size):
        for j, idx in enumerate(idxs):
            branch = _ring_branch((idx - s) % size, idx, is_causal, live)
            if branch:
                state[j] = _fwd_block(qs[j], ks[j], vs[j], bs[j], branch,
                                      *state[j])
        if s < size - 1:         # the last block is folded without a hop
            ks, vs, bs = rotate(ks, vs, bs)
    return [acc.to(q.dtype) for q, (acc, _) in zip(qs, state)], \
        [lse for _, lse in state]


def _walk_bwd(qs, ks, vs, bs, dos, lses, deltas, idxs, size, is_causal,
              live, rotate):
    """The ring's backward for the held ranks: one external-lse K1b per
    live block; dq accumulates at home, dk and dv (f32) travel with
    their block and arrive home after a full circle (the last step
    rotates only them). Returns each rank's f32 (dq, dk, dv) lists."""
    f32 = lambda x: torch.zeros(x.shape, dtype=torch.float32,  # noqa
                                device=x.device)
    dq, dk, dv = [f32(q) for q in qs], [f32(k) for k in ks], \
        [f32(v) for v in vs]
    for s in range(size):
        for j, idx in enumerate(idxs):
            branch = _ring_branch((idx - s) % size, idx, is_causal, live)
            if branch:
                dqb, dkb, dvb = flash_attention_bwd_ext(
                    qs[j], ks[j], vs[j], dos[j], lses[j], deltas[j],
                    branch == 2, bs[j])
                dq[j] += dqb.float()
                dk[j] += dkb.float()
                dv[j] += dvb.float()
        if s < size - 1:
            dk, dv, ks, vs, bs = rotate(dk, dv, ks, vs, bs)
        else:
            dk, dv = rotate(dk, dv)
    return dq, dk, dv


def _hop(axis, mesh):
    """The multi-process ``rotate``: this rank's one entry of each list
    goes to the next rank of ``axis`` (``ppermute`` by +1; None passes
    through)."""
    def rotate(*lists):
        xs = [l[0] for l in lists]
        moving = [x for x in xs if x is not None]
        moved = iter(ppermute(moving, axis, 1, mesh))
        return tuple([None if x is None else next(moved)] for x in xs)
    return rotate


def _roll(*lists):
    """The one-process ``rotate``: every rank's entry moves to the next
    rank's slot, as one ``ppermute`` by +1 moves them across ranks."""
    return tuple(list(l[-1:]) + list(l[:-1]) for l in lists)


class _RingFlash(torch.autograd.Function):
    """``_ring_flash``: q, k, v (B, L_local, H, D) shards of this rank;
    ``bias`` an optional (B, L_local) f32 key mask that rides with its
    k/v block; ``live`` the per-origin block liveness (None: all)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, axis, mesh, is_causal, live):
        size, idx = mesh.axis_size(axis), mesh.axis_index(axis)
        (out,), (lse,) = _walk_fwd([q], [k], [v], [bias], [idx], size,
                                   is_causal, live, _hop(axis, mesh))
        ctx.save_for_backward(q, k, v, out, lse, bias)
        ctx.ring = (axis, mesh, is_causal, live)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, bias = ctx.saved_tensors
        axis, mesh, is_causal, live = ctx.ring
        size, idx = mesh.axis_size(axis), mesh.axis_index(axis)
        dout = dout.contiguous()
        (dq,), (dk,), (dv,) = _walk_bwd(
            [q], [k], [v], [bias], [dout], [lse], [_delta(dout, out)], [idx],
            size, is_causal, live, _hop(axis, mesh))
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


# ---------------------------------------------------------------------------
# the sequence-parallel scope
# ---------------------------------------------------------------------------
_SP_STATE = {"axis": None, "impl": "ring", "batch_axis": "dp", "mesh": None,
             "live": None}


@contextmanager
def sequence_parallel(seq_axis: str = "sp", impl: str = "ring",
                      batch_axis: str = "dp", mesh: Optional[Mesh] = None):
    """Within this scope ``scaled_dot_product_attention`` runs ring
    attention over ``seq_axis`` of ``mesh`` (default: the global mesh),
    treating its q, k, v as this rank's sequence shards. ``TrainStep(
    sequence_parallel=...)`` opens it around each step. Block liveness
    under a key mask is cached for the scope's life (one step)."""
    if impl != "ring":
        raise NotImplementedError(
            f"sequence parallelism impl {impl!r}: Ulysses (all-to-all) is "
            f"a later port slice (gloo has no CUDA all-to-all); 'ring' is "
            f"ported")
    prev = dict(_SP_STATE)
    _SP_STATE.update(axis=seq_axis, impl=impl, batch_axis=batch_axis,
                     mesh=mesh, live={})
    try:
        yield
    finally:
        _SP_STATE.update(prev)


def active_sequence_parallel():
    """(axis, impl, batch_axis, mesh) inside a ``sequence_parallel``
    scope whose mesh has the axis at size > 1, else None."""
    axis = _SP_STATE["axis"]
    if axis is None:
        return None
    mesh = _SP_STATE["mesh"] or get_mesh()
    if mesh is None or mesh.axis_size(axis) <= 1:
        return None
    return axis, _SP_STATE["impl"], _SP_STATE["batch_axis"], mesh


def _liveness(bias, key, axis, mesh):
    """Per-origin liveness of the ring's blocks under ``bias``: one
    all-gather of this block's "any live key" and one host read, cached
    by ``key`` (the mask object) in the active scope."""
    cache = _SP_STATE["live"]
    if cache is not None and id(key) in cache:
        return cache[id(key)][1]
    mine = (bias > _LIVE).any().to(torch.float32).reshape(1)
    live = [bool(x) for x in all_gather(mine, axis, 0, mesh).tolist()]
    if cache is not None:
        cache[id(key)] = (key, live)   # holds key, so its id stays unique
    return live


def _ring_local(q, k, v, axis, is_causal, bias, mesh, key=None):
    """The ring over this rank's shards with a (B, L_local) f32 bias or
    None; ``key`` names the mask for the liveness cache."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"ring attention needs equal q and kv shards, got "
                         f"{q.shape[1]} and {k.shape[1]}")
    live = None if bias is None else _liveness(
        bias, bias if key is None else key, axis, mesh)
    return _RingFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            bias, axis, mesh, bool(is_causal), live)


def ring_attention_local(q, k, v, axis_name: str, is_causal: bool = False,
                         axis_size: Optional[int] = None, kv_mask=None,
                         mesh: Optional[Mesh] = None):
    """Ring attention over ``axis_name`` for this rank's shards q, k, v
    (B, L_local, H, D); returns the local output block. ``kv_mask``: an
    optional (B, L_local) bool key-padding shard (True = attend) that
    rides the ring with its k/v block. ``axis_size``, when given, must be
    the mesh's. Differentiable in q, k and v."""
    mesh = mesh if mesh is not None else get_mesh()
    size = mesh.axis_size(axis_name) if mesh is not None else 1
    if axis_size is not None and axis_size != size:
        raise ValueError(f"axis {axis_name!r} has size {size} on the mesh, "
                         f"not {axis_size}")
    bias = None if kv_mask is None else kv_mask_bias(
        kv_mask, q.shape[0], k.shape[1])
    if size == 1:
        return flash_attention(q, k, v, causal=is_causal, bias=bias)
    return _ring_local(q, k, v, axis_name, is_causal, bias, mesh,
                       key=kv_mask)


# ---------------------------------------------------------------------------
# global in, global out
# ---------------------------------------------------------------------------
def _fallback(reason):
    warnings.warn(f"sequence-parallel attention fell back to the local "
                  f"path: {reason}", RuntimeWarning, stacklevel=3)


class _Shard(torch.autograd.Function):
    """This rank's shard of a global tensor along (dim, axis) pairs; the
    gradient is all-gathered back to the global shape."""

    @staticmethod
    def forward(ctx, x, mesh, cuts):
        ctx.mesh, ctx.cuts = mesh, cuts
        return _narrow(x, mesh, cuts)

    @staticmethod
    def backward(ctx, g):
        for dim, axis in reversed(ctx.cuts):
            g = all_gather(g.contiguous(), axis, dim, ctx.mesh)
        return g, None, None


class _Gather(torch.autograd.Function):
    """The global tensor from every rank's shard; the gradient of a loss
    every rank holds alike is this rank's shard of it."""

    @staticmethod
    def forward(ctx, x, mesh, cuts):
        ctx.mesh, ctx.cuts = mesh, cuts
        for dim, axis in reversed(cuts):
            x = all_gather(x.contiguous(), axis, dim, mesh)
        return x

    @staticmethod
    def backward(ctx, g):
        return _narrow(g, ctx.mesh, ctx.cuts).contiguous(), None, None


def _narrow(x, mesh, cuts):
    for dim, axis in cuts:
        n = x.shape[dim] // mesh.axis_size(axis)
        x = x.narrow(dim, mesh.axis_index(axis) * n, n)
    return x


def ring_attention(q, k, v, *, mesh: Optional[Mesh] = None,
                   seq_axis: str = "sp", batch_axis: str = "dp",
                   is_causal: bool = False, kv_mask=None):
    """Context-parallel attention over ``seq_axis`` of ``mesh``: q, k, v
    (B, L, H, D) are the global tensors, alike on every rank; each rank
    runs its sequence shard (and batch shard over ``batch_axis`` where
    the mesh has it and B divides) through the ring, and the result is
    all-gathered: (B, L, H, D) on every rank. ``kv_mask``: an optional
    (B, L) bool key-padding mask (True = attend). A missing or size-1
    axis runs the local kernel with the JAX package's warning."""
    mesh = mesh if mesh is not None else get_mesh()
    size = mesh.axis_size(seq_axis) if mesh is not None else 1
    if size <= 1:
        _fallback(f"axis {seq_axis!r} has size 1" if mesh is not None
                  else f"no mesh axis {seq_axis!r}")
        bias = None if kv_mask is None else kv_mask_bias(
            kv_mask, q.shape[0], k.shape[1])
        return flash_attention(q, k, v, causal=is_causal, bias=bias)
    b, lq = q.shape[0], q.shape[1]
    if lq % size or k.shape[1] % size:
        raise ValueError(f"sequence lengths ({lq}, {k.shape[1]}) are not "
                         f"divisible by {seq_axis}={size}")
    cuts = []
    if batch_axis in mesh.axis_names and batch_axis != seq_axis \
            and b % mesh.axis_size(batch_axis) == 0:
        cuts.append((0, batch_axis))
    cuts.append((1, seq_axis))
    cuts = tuple(cuts)
    qs, ks, vs = (_Shard.apply(x, mesh, cuts) for x in (q, k, v))
    ms = None if kv_mask is None else _narrow(kv_mask, mesh, cuts)
    out = ring_attention_local(qs, ks, vs, seq_axis, is_causal,
                               kv_mask=ms, mesh=mesh)
    return _Gather.apply(out, mesh, cuts)


# ---------------------------------------------------------------------------
# the ring in one process
# ---------------------------------------------------------------------------
class _ChunkRing(torch.autograd.Function):
    """Every rank's walk of the ring in one process: ``_RingFlash``'s walk
    over all n ranks' chunks, with ``_roll`` as the hop."""

    @staticmethod
    def forward(ctx, q, k, v, bias, n, is_causal):
        chunk = lambda x: [c.contiguous() for c in x.chunk(n, 1)]  # noqa
        bs = [None] * n if bias is None else chunk(bias)
        live = None if bias is None else \
            [bool((b > _LIVE).any()) for b in bs]
        outs, lses = _walk_fwd(chunk(q), chunk(k), chunk(v), bs,
                               list(range(n)), n, is_causal, live, _roll)
        ctx.save_for_backward(q, k, v, bias, *outs, *lses)
        ctx.args = (n, is_causal, live)
        return torch.cat(outs, 1)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, *saved = ctx.saved_tensors
        n, is_causal, live = ctx.args
        outs, lses = saved[:n], saved[n:]
        chunk = lambda x: [c.contiguous() for c in x.chunk(n, 1)]  # noqa
        dos = chunk(dout)
        bs = [None] * n if bias is None else chunk(bias)
        dq, dk, dv = _walk_bwd(
            chunk(q), chunk(k), chunk(v), bs, dos, lses,
            [_delta(d, o) for d, o in zip(dos, outs)], list(range(n)), n,
            is_causal, live, _roll)
        cat = lambda xs, like: torch.cat(xs, 1).to(like.dtype)  # noqa
        return cat(dq, q), cat(dk, k), cat(dv, v), None, None, None


def ring_attention_chunks(q, k, v, chunks: int, is_causal: bool = False,
                          kv_mask=None, bias=None):
    """Ring attention's arithmetic in one process: q, k, v (B, L, H, D)
    cut into ``chunks`` sequence chunks, each query chunk walking the
    ring of kv chunks (per-block K1a + logsumexp merge; external-lse
    K1b per block in the backward). ``kv_mask`` (B, L) bool or ``bias``
    (B, L) f32 is an optional key mask. Differentiable in q, k, v."""
    if kv_mask is not None:
        bias = kv_mask_bias(kv_mask, q.shape[0], k.shape[1])
    if q.shape[1] != k.shape[1] or q.shape[1] % chunks:
        raise ValueError(f"ring_attention_chunks needs Lq == Lk divisible "
                         f"by {chunks}, got {q.shape[1]}, {k.shape[1]}")
    return _ChunkRing.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            None if bias is None else bias.contiguous(),
                            int(chunks), bool(is_causal))

"""Search and sort ops (port of ``paddle_tpu/ops/search.py``). Sorts are
stable; ``argmax``/``argmin`` without an axis index the flattened
tensor; index outputs are int64. ``gather_tree``, ``edit_distance`` and
``ctc_greedy_decoder`` are host loops in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..framework.op import primitive
from ..framework.tensor import entry
from ..framework.random import generator_for
from ._util import as_t

__all__ = ["argmax", "argmin", "argsort", "sort", "top_k", "topk",
           "searchsorted", "kthvalue", "mode", "bincount", "histogram",
           "bucketize", "sampling_id", "gather_tree", "edit_distance",
           "ctc_greedy_decoder"]


@primitive("arg_max")
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    x = as_t(x)
    if axis is None:
        out = torch.argmax(x.reshape(-1))
    else:
        out = torch.argmax(x, dim=axis, keepdim=keepdim)
    return out.to(dtype_mod.to_torch(dtype))


@primitive("arg_min")
def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    x = as_t(x)
    if axis is None:
        out = torch.argmin(x.reshape(-1))
    else:
        out = torch.argmin(x, dim=axis, keepdim=keepdim)
    return out.to(dtype_mod.to_torch(dtype))


@primitive("argsort")
def argsort(x, axis=-1, descending=False, name=None):
    x = as_t(x)
    return torch.argsort(-x if descending else x, dim=axis, stable=True)


@primitive("sort")
def sort(x, axis=-1, descending=False, name=None):
    out = torch.sort(as_t(x), dim=axis, stable=True).values
    return torch.flip(out, [axis]) if descending else out


@entry
def top_k(x, k=1, axis=None, largest=True, sorted=True, name=None):
    return topk(x, k=k, axis=axis, largest=largest, sorted=sorted)


@primitive("top_k")
def topk(x, k=1, axis=None, largest=True, sorted=True, name=None):
    x = as_t(x)
    axis = -1 if axis is None else axis
    # lax.top_k: the k largest, ties to the lower index; stable argsort of
    # the negated values gives that order
    moved = torch.movedim(x, axis, -1)
    key = -moved if largest else moved
    idx = torch.argsort(key, dim=-1, stable=True)[..., :k]
    vals = torch.gather(moved, -1, idx)
    return torch.movedim(vals, -1, axis), torch.movedim(idx, -1, axis)


@primitive("searchsorted")
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    seq, v = as_t(sorted_sequence), as_t(values)
    return torch.searchsorted(seq, v.to(seq.dtype), right=right,
                              out_int32=out_int32)


@primitive("kthvalue")
def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    x = as_t(x)
    order = torch.argsort(x, dim=axis, stable=True)
    idx = torch.select(order, axis, k - 1)
    vals = torch.select(torch.sort(x, dim=axis, stable=True).values, axis,
                        k - 1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


@primitive("mode")
def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest among equally
    frequent ones) and the index, in stable sorted order, of the first
    element of its run, as the JAX op computes it."""
    x = as_t(x)
    axis = axis % x.dim()
    moved = torch.movedim(x, axis, -1)
    srt, order = torch.sort(moved, dim=-1, stable=True)
    n = srt.shape[-1]
    runs = torch.cat([torch.ones_like(srt[..., :1], dtype=torch.bool),
                      srt[..., 1:] != srt[..., :-1]], dim=-1)
    run_id = torch.cumsum(runs.to(torch.int64), dim=-1)
    counts = torch.zeros(*run_id.shape[:-1], n + 1, dtype=torch.int64,
                         device=x.device).scatter_add_(
        -1, run_id, torch.ones_like(run_id))
    per = torch.gather(counts, -1, run_id)
    best = torch.argmax(per, dim=-1, keepdim=True)
    vals = torch.gather(srt, -1, best)[..., 0]
    pos = torch.gather(order, -1, best)[..., 0]
    if keepdim:
        vals = torch.movedim(vals.unsqueeze(-1), -1, axis)
        pos = torch.movedim(pos.unsqueeze(-1), -1, axis)
    return vals, pos


@primitive("bincount")
def bincount(x, weights=None, minlength=0, name=None):
    x = as_t(x)
    return torch.bincount(x, weights=None if weights is None
                          else as_t(weights), minlength=minlength)


@primitive("histogram")
def histogram(input, bins=100, min=0, max=0, name=None):
    x = as_t(input).to(torch.float32)
    if min == 0 and max == 0:
        lo, hi = float(torch.amin(x)), float(torch.amax(x))
    else:
        lo, hi = float(min), float(max)
    # jnp.histogram: bins of equal width, the last closed on the right
    edges = torch.linspace(lo, hi, bins + 1, device=x.device)
    idx = torch.searchsorted(edges, x, right=True) - 1
    idx = torch.where(x == edges[-1], torch.full_like(idx, bins - 1), idx)
    ok = (idx >= 0) & (idx < bins)
    # float32 counts, as jnp.histogram gives them
    return torch.zeros(bins, dtype=torch.float32, device=x.device).index_add_(
        0, idx[ok], torch.ones_like(idx[ok], dtype=torch.float32))


@primitive("bucketize", nondiff=("sorted_sequence",))
def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    x = as_t(x)
    seq = as_t(sorted_sequence, x)
    return torch.searchsorted(seq, x.to(seq.dtype).contiguous(),
                              right=right, out_int32=out_int32)


@entry
def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64", name=None):
    probs = as_t(x)
    gen = torch.Generator(device=probs.device).manual_seed(int(seed)) \
        if seed else generator_for(probs.device)
    ids = torch.multinomial(torch.clamp_min(probs, 1e-20), 1,
                            generator=gen)[:, 0]
    return ids.to(torch.int32 if dtype == "int32" else torch.int64)


@entry
def gather_tree(ids, parents, name=None):
    t = as_t(ids)
    arr, par = t.cpu().numpy(), as_t(parents).cpu().numpy()
    T, b, k = arr.shape
    out = np.empty_like(arr)
    out[T - 1] = arr[T - 1]
    beam_idx = np.tile(np.arange(k), (b, 1))
    for i in range(T - 2, -1, -1):
        rows = np.arange(b)[:, None]
        beam_idx = par[i + 1][rows, beam_idx]
        out[i] = arr[i][rows, beam_idx]
    return torch.from_numpy(out).to(t.device)


@entry
def edit_distance(input, label, input_length=None, label_length=None,
                  normalized=True, ignored_tokens=None, name=None):
    t = as_t(input)
    hyp, ref = t.cpu().numpy(), as_t(label).cpu().numpy()
    b = hyp.shape[0]
    hl = (as_t(input_length).cpu().numpy().ravel() if input_length
          is not None else np.full(b, hyp.shape[1]))
    rl = (as_t(label_length).cpu().numpy().ravel() if label_length
          is not None else np.full(b, ref.shape[1]))
    ignored = set(ignored_tokens or ())
    out = np.zeros((b, 1), np.float32)
    for i in range(b):
        h = [v for v in hyp[i, :hl[i]].tolist() if v not in ignored]
        r = [v for v in ref[i, :rl[i]].tolist() if v not in ignored]
        m, n = len(h), len(r)
        dp = np.arange(n + 1, dtype=np.int64)
        for xi in range(1, m + 1):
            prev = dp.copy()
            dp[0] = xi
            for yi in range(1, n + 1):
                cost = 0 if h[xi - 1] == r[yi - 1] else 1
                dp[yi] = min(prev[yi] + 1, dp[yi - 1] + 1,
                             prev[yi - 1] + cost)
        d = float(dp[n])
        if normalized:
            d = d / (n if n > 1 else 1)
        out[i, 0] = d
    return (torch.from_numpy(out).to(t.device),
            torch.tensor(b, dtype=torch.int64, device=t.device))


@entry
def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0,
                       name=None):
    t = as_t(input)
    probs = t.detach().float().cpu().numpy()
    b, T = probs.shape[0], probs.shape[1]
    lens = (as_t(input_length).cpu().numpy().ravel() if input_length
            is not None else np.full(b, T))
    seqs = []
    for i in range(b):
        path = probs[i, :lens[i]].argmax(-1)
        seqs.append([int(v) for j, v in enumerate(path)
                     if v != blank and (j == 0 or v != path[j - 1])])
    maxlen = max((len(s) for s in seqs), default=0)
    out = np.full((b, maxlen if maxlen > 1 else 1), padding_value, np.int64)
    out_len = np.zeros(b, np.int64)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
        out_len[i] = len(s)
    return (torch.from_numpy(out).to(t.device),
            torch.from_numpy(out_len).to(t.device))

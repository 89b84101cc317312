"""Beam search decoding (port of ``paddle_tpu/ops/beam_search.py``).

One fixed-shape step over a (batch, beam) lattice: top-k over
beam * vocab, EOS freezing by masked scores, a back-gather of the
parents; the loop is a Python ``for`` over the steps, as in the JAX
package, with one host read a step (whether every beam has finished).
The token buffer and the scores live on ``device`` (the model's), so
each step's ids reach ``logits_fn`` where its model is. Token ids and
parent indices are int32, scores f32, as in JAX.

Ties: ``torch.topk`` and ``jax.lax.top_k`` both keep the lower index
among equal scores here (``torch.topk`` over a CPU or CUDA tensor is
not documented to be stable, so a tie at the beam's cut may pick
another beam than JAX; the scores are the same).
"""
from __future__ import annotations

from typing import Callable

import torch

from ._util import device_of

__all__ = ["NEG_INF", "beam_search_step", "beam_search_decode"]

NEG_INF = -1e9


def beam_search_step(pre_scores, log_probs, finished, beam_size, end_id):
    """One beam-search expansion (reference math/beam_search.cc).

    pre_scores (batch, beam) cumulative log-probs of the live beams;
    log_probs (batch, beam, vocab) next-token log-probs; finished
    (batch, beam) bool. Returns (scores, token_ids, parent_idx,
    finished), each (batch, beam); ids and parents int32. A finished
    beam is frozen: its only continuation is ``end_id`` with zero added
    score."""
    batch, beam, vocab = log_probs.shape
    eos_onehot = torch.where(
        torch.arange(vocab, device=log_probs.device) == end_id,
        torch.zeros((), device=log_probs.device),
        torch.full((), NEG_INF, device=log_probs.device))
    log_probs = torch.where(finished[:, :, None], eos_onehot[None, None, :],
                            log_probs)
    total = pre_scores[:, :, None] + log_probs
    flat = total.reshape(batch, beam * vocab)
    scores, flat_idx = torch.topk(flat, beam_size, dim=1)
    parent_idx = (flat_idx // vocab).to(torch.int32)
    token_ids = (flat_idx % vocab).to(torch.int32)
    was_finished = torch.gather(finished, 1, parent_idx.long())
    return scores, token_ids, parent_idx, was_finished | (token_ids == end_id)


def _gather_beams(arr, parent_idx):
    """Reorder a (batch, beam, ...) tensor by per-batch parent indices."""
    idx = parent_idx.long().reshape(parent_idx.shape
                                    + (1,) * (arr.dim() - 2))
    return torch.gather(arr, 1, idx.expand(idx.shape[:2] + arr.shape[2:]))


def _take_rows(state, parent_flat):
    if isinstance(state, torch.Tensor):
        return state.index_select(0, parent_flat.long())
    if isinstance(state, (list, tuple)):
        return type(state)(_take_rows(s, parent_flat) for s in state)
    if isinstance(state, dict):
        return {k: _take_rows(v, parent_flat) for k, v in state.items()}
    return state


def beam_search_decode(logits_fn: Callable, batch_size: int,
                       beam_size: int = 4, max_len: int = 64,
                       bos_id: int = 1, eos_id: int = 2,
                       length_penalty: float = 0.6, state=None,
                       gather_state_fn=None):
    """:func:`_beam_search` on the device of ``state``'s first tensor,
    else the default device (``set_device``): the JAX signature."""
    return _beam_search(logits_fn, batch_size, beam_size, max_len, bos_id,
                        eos_id, length_penalty, state, gather_state_fn,
                        device=device_of(state))


def _beam_search(logits_fn: Callable, batch_size: int,
                 beam_size: int = 4, max_len: int = 64,
                 bos_id: int = 1, eos_id: int = 2,
                 length_penalty: float = 0.6, state=None,
                 gather_state_fn=None, device=None):
    """The full beam-search loop.

    ``logits_fn(ids_buf, t, state)`` returns the next-token logits
    (batch*beam, vocab) for position t, or (logits, new_state);
    ``ids_buf`` is (batch*beam, max_len) int32 on ``device`` (None: the
    CPU), positions past t holding ``eos_id`` (a causal decoder must
    ignore them). ``state``
    is an optional tree (tensors, lists, tuples, dicts) of per-beam
    tensors with a leading batch*beam dimension, reordered by
    ``gather_state_fn(state, parent_flat)`` (default: ``index_select``
    on dimension 0). ``length_penalty`` is the GNMT alpha: the final
    score is logp / ((5 + len) / 6) ** alpha.

    Returns (ids, scores): ids (batch, beam, max_len) int32, best beam
    first, and the length-normalised scores (batch, beam)."""
    bk = batch_size * beam_size
    ids_buf = torch.full((bk, max_len), eos_id, dtype=torch.int32,
                         device=device)
    ids_buf[:, 0] = bos_id
    # only beam 0 of each entry is live at t = 0 (the beams start equal)
    pre_scores = torch.tensor([0.0] + [NEG_INF] * (beam_size - 1),
                              dtype=torch.float32,
                              device=device).repeat(batch_size, 1)
    finished = torch.zeros((batch_size, beam_size), dtype=torch.bool,
                           device=device)
    if gather_state_fn is None:
        gather_state_fn = _take_rows
    for t in range(max_len - 1):
        out = logits_fn(ids_buf, t, state)
        logits, state = out if isinstance(out, tuple) else (out, state)
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        vocab = log_probs.shape[-1]
        scores, tok, parent, finished = beam_search_step(
            pre_scores, log_probs.reshape(batch_size, beam_size, vocab),
            finished, beam_size, eos_id)
        parent_flat = (parent + torch.arange(
            batch_size, dtype=torch.int32, device=parent.device)[:, None]
            * beam_size).reshape(bk)
        ids_buf = ids_buf.index_select(0, parent_flat.long())
        ids_buf[:, t + 1] = tok.reshape(bk)
        if state is not None:
            state = gather_state_fn(state, parent_flat)
        pre_scores = scores
        if bool(finished.all()):
            break
    ids3 = ids_buf.reshape(batch_size, beam_size, max_len)
    lengths = torch.cumprod((ids3 != eos_id).float()[:, :, 1:],
                            dim=-1).sum(dim=-1) + 1.0
    if length_penalty:
        norm = ((5.0 + lengths) / 6.0) ** length_penalty
    else:
        norm = torch.ones_like(lengths)
    final = pre_scores / norm
    order = torch.argsort(-final, dim=1, stable=True)
    return _gather_beams(ids3, order), torch.gather(final, 1, order)

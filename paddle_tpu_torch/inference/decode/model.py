"""Decoder-only transformer for the decode engine: params as a dict of
tensors, a dense prefill forward, and a paged single-token decode
forward.

Port of ``paddle_tpu/inference/decode/model.py`` (pre-RMSNorm blocks,
learned positional embeddings, relu FFN, greedy head). Three forwards
share the same math:

- :func:`dense_forward` — full causal attention over a token matrix;
  the oracle every paged path is held against
  (:func:`reference_generate` drives it token by token).
- :func:`prefill_forward` — dense_forward plus the per-layer K/V it
  produced, for scattering into the page pool.
- :func:`decode_forward` — ONE token per sequence: writes its K/V into
  the page pool IN PLACE (``paged_write``) and attends through the
  paged attention kernel over the page table. No length padding. It can
  also give the next positions on the device, which the engine's async
  tick chains from one tick to the next.
- :func:`spec_decode_forward` — the speculative verify step: K+1 token
  columns a sequence, flattened into B·(K+1) ragged rows that share
  their sequence's page table, through the same kernels.

The large products (qkv, out, ffn, head) and prefill's dense attention
stay plain ``torch.matmul``/einsum, as the JAX package left them to XLA.
A float32 model runs them in full f32: :func:`init_decode_params` and
:func:`params_from_numpy` turn TF32 off for matmuls and cuDNN.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..._device import resolve_device
from ...ops.cuda.paged_attention import (paged_attention, paged_write,
                                         paged_write_quant)

__all__ = ["DecodeModelConfig", "init_decode_params", "params_from_numpy",
           "dense_forward", "prefill_forward", "decode_forward",
           "spec_decode_forward", "reference_generate"]


class DecodeModelConfig:
    """Shapes of the decode model. ``hidden = n_heads * head_dim``."""

    def __init__(self, vocab_size: int = 64, n_layers: int = 2,
                 n_heads: int = 4, head_dim: int = 8, ffn_dim: int = 64,
                 max_context: int = 128):
        self.vocab_size = int(vocab_size)
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self.ffn_dim = int(ffn_dim)
        self.max_context = int(max_context)

    @property
    def hidden(self) -> int:
        return self.n_heads * self.head_dim

    def to_dict(self) -> dict:
        return {"vocab_size": self.vocab_size, "n_layers": self.n_layers,
                "n_heads": self.n_heads, "head_dim": self.head_dim,
                "ffn_dim": self.ffn_dim, "max_context": self.max_context}


def _full_f32() -> None:
    """f32 products in full f32, never TF32 (about three digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def init_decode_params(cfg: DecodeModelConfig, seed: int = 0,
                       device=None) -> Dict[str, torch.Tensor]:
    """Deterministic random f32 params made on ``device`` (default: the
    card) from a ``torch.Generator`` seeded with ``seed``, so a full-width
    model initialises in seconds. The scales follow the JAX package's
    init; the numbers do not (carry JAX params over with
    :func:`params_from_numpy`)."""
    dev = resolve_device(device)
    _full_f32()
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    E, F, V = cfg.hidden, cfg.ffn_dim, cfg.vocab_size

    def w(*shape, scale=None):
        s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * s

    p: Dict[str, torch.Tensor] = {
        "tok_emb": w(V, E, scale=0.5),
        "pos_emb": w(cfg.max_context, E, scale=0.1),
        "lnf": torch.ones((E,), device=dev),
        "head": w(E, V),
    }
    for i in range(cfg.n_layers):
        p[f"l{i}.ln1"] = torch.ones((E,), device=dev)
        p[f"l{i}.wq"] = w(E, E)
        p[f"l{i}.wk"] = w(E, E)
        p[f"l{i}.wv"] = w(E, E)
        p[f"l{i}.wo"] = w(E, E)
        p[f"l{i}.ln2"] = torch.ones((E,), device=dev)
        p[f"l{i}.w1"] = w(E, F)
        p[f"l{i}.w2"] = w(F, E)
    return p


def params_from_numpy(np_params, device=None) -> Dict[str, torch.Tensor]:
    """Carry params keyed as the JAX package keys them (``tok_emb``,
    ``l{i}.wq``, ...; numpy arrays, anything ``np.asarray`` takes, or
    tensors) onto ``device`` (default: the card) as f32 tensors."""
    dev = resolve_device(device)
    _full_f32()
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.tensor(np.asarray(v, np.float32))
                ).to(dev, torch.float32)
            for k, v in np_params.items()}


def _rms(x, scale):
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * scale / torch.sqrt(var + 1e-6)


def _split_heads(x, n_heads, head_dim):
    return x.reshape(x.shape[:-1] + (n_heads, head_dim))


def _forward_layers(cfg: DecodeModelConfig, params, h, attn_fn,
                    write_fn=None):
    """Shared block loop: ``attn_fn(i, q, k, v) -> attn out`` supplies
    the attention data path (dense vs paged); ``write_fn(i, k, v)``
    (paged decode) persists the new K/V before attention runs."""
    H, D = cfg.n_heads, cfg.head_dim
    for i in range(cfg.n_layers):
        x = _rms(h, params[f"l{i}.ln1"])
        q = _split_heads(x @ params[f"l{i}.wq"], H, D)
        k = _split_heads(x @ params[f"l{i}.wk"], H, D)
        v = _split_heads(x @ params[f"l{i}.wv"], H, D)
        if write_fn is not None:
            write_fn(i, k, v)
        attn = attn_fn(i, q, k, v)
        h = h + attn.reshape(attn.shape[:-2] + (cfg.hidden,)) \
            @ params[f"l{i}.wo"]
        x = _rms(h, params[f"l{i}.ln2"])
        h = h + torch.relu(x @ params[f"l{i}.w1"]) @ params[f"l{i}.w2"]
    return _rms(h, params["lnf"]) @ params["head"]


def dense_forward(cfg: DecodeModelConfig, params, tokens,
                  collect_kv: bool = False):
    """Full causal forward over ``tokens`` (B, L) -> logits (B, L, V);
    with ``collect_kv`` also the per-layer K/V stacks
    (n_layers, B, L, H, D) for prefill page writes."""
    B, L = tokens.shape
    D = cfg.head_dim
    tokens = tokens.long()
    h = params["tok_emb"][tokens] + params["pos_emb"][:L][None, :, :]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=h.device))
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []

    def attn(i, q, k, v):
        if collect_kv:
            ks.append(k)
            vs.append(v)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
        s = torch.where(causal[None, None], s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    logits = _forward_layers(cfg, params, h, attn)
    if collect_kv:
        return logits, torch.stack(ks), torch.stack(vs)
    return logits


def prefill_forward(cfg: DecodeModelConfig, params, tokens, lens,
                    return_logits: bool = False):
    """Prefill a padded prompt batch (B, Lp): the next greedy token per
    row (logits at position ``lens-1``, or those raw logits with
    ``return_logits``, for sampling) plus the per-layer K/V stacks to
    scatter into pages. Pad positions are causal-masked: they never
    influence positions < lens."""
    logits, ks, vs = dense_forward(cfg, params, tokens, collect_kv=True)
    idx = torch.clamp(lens.long() - 1, 0, tokens.shape[1] - 1)
    last = logits[torch.arange(logits.shape[0], device=logits.device), idx]
    if return_logits:
        return last, ks, vs
    return torch.argmax(last, dim=-1).to(torch.int32), ks, vs


def _paged_fns(k_pages, v_pages, k_scales, v_scales, page_table,
               positions, attend_lens, active):
    """The (write, attend) pair of a paged forward: ``write(i, k, v)``
    puts each row's new K/V at ``positions`` IN PLACE, ``attend(i, q, k,
    v)`` runs the paged attention kernel over ``attend_lens`` tokens."""
    quant = k_scales is not None

    def write(i, k, v):
        if quant:
            paged_write_quant(k_pages[i], v_pages[i], k_scales[i],
                              v_scales[i], page_table, positions, k, v,
                              active)
        else:
            paged_write(k_pages[i], v_pages[i], page_table, positions, k,
                        v, active)

    def attn(i, q, k, v):
        return paged_attention(
            q.contiguous(), k_pages[i], v_pages[i], page_table, attend_lens,
            k_scales=k_scales[i] if quant else None,
            v_scales=v_scales[i] if quant else None)

    return write, attn


def decode_forward(cfg: DecodeModelConfig, params, tokens, positions,
                   k_pages, v_pages, page_table, seq_lens, active,
                   k_scales=None, v_scales=None,
                   return_logits: bool = False,
                   return_next_positions: bool = False):
    """One ragged decode step at fixed max-batch: write each sequence's
    new K/V into its page slot (IN PLACE on the pools), attend over its
    live pages plus the token just written, and return the next greedy
    token (B,) int32, or with ``return_logits`` the raw logits (B, V).
    With ``return_next_positions`` it returns ``(out, positions + 1)``:
    the next step's positions, made on the device (the reference step's
    trailing output), so a tick can chain them without an upload.

    ``tokens``/``positions``/``seq_lens``/``active`` are (B,);
    ``k_pages``/``v_pages`` are the stacked (n_layers, P, S, H, D)
    pools (f32, bf16 or f16: writes round to the pool's dtype). With
    ``k_scales``/``v_scales`` (n_layers, P, S) the pools are int8:
    writes row-encode and attention dequantises in the kernel."""
    maxp = cfg.max_context - 1
    h = params["tok_emb"][tokens.long()] \
        + params["pos_emb"][torch.clamp(positions.long(), 0, maxp)]
    write, attn = _paged_fns(k_pages, v_pages, k_scales, v_scales,
                             page_table, positions, seq_lens + 1, active)
    logits = _forward_layers(cfg, params, h, attn, write_fn=write)
    out = logits if return_logits \
        else torch.argmax(logits, dim=-1).to(torch.int32)
    if return_next_positions:
        return out, positions + 1
    return out


def spec_decode_forward(cfg: DecodeModelConfig, params, tokens, positions,
                        k_pages, v_pages, page_table, seq_lens, active,
                        k_scales=None, v_scales=None):
    """Speculative verify step: score K+1 token columns a slot in ONE
    ragged step. ``tokens`` (B, K+1) is [next_token, d_1..d_K], the
    committed next token and the proposer's drafts; column j's K/V is
    written at ``positions + j`` and its query attends over
    ``positions + j + 1`` tokens (write, then attend: each draft sees
    exactly the tokens before it, causal by the ragged lengths). The
    (B, K+1) grid is flattened into B·(K+1) rows that share their slot's
    page table, through the same write and attention kernels as
    :func:`decode_forward`. Returns the greedy argmax a column (B, K+1)
    int32: g_0 is the next token; g_j verifies d_j (accepted while d_j ==
    g_{j-1}), so the accepted prefix is what token-by-token greedy
    decode would emit.

    ``active`` (B, K+1): column 0 live a slot, draft columns live only
    where a draft was proposed (dead columns write to the trash page 0
    and their outputs are ignored). ``seq_lens`` is unused (the lengths
    follow from the positions), as in the reference."""
    del seq_lens
    B, K1 = tokens.shape
    cols = torch.arange(K1, dtype=torch.int32, device=tokens.device)
    pos = positions.to(torch.int32)[:, None] + cols[None, :]
    maxp = cfg.max_context - 1
    h = params["tok_emb"][tokens.long()] \
        + params["pos_emb"][torch.clamp(pos.long(), 0, maxp)]
    h = h.reshape(B * K1, cfg.hidden)
    flat_pos = pos.reshape(-1)
    T = page_table.shape[1]
    flat_table = page_table[:, None, :].expand(B, K1, T).reshape(B * K1, T)
    write, attn = _paged_fns(k_pages, v_pages, k_scales, v_scales,
                             flat_table, flat_pos, flat_pos + 1,
                             active.reshape(-1))
    logits = _forward_layers(cfg, params, h, attn, write_fn=write)
    return torch.argmax(logits, dim=-1).to(torch.int32).reshape(B, K1)


@torch.no_grad()
def reference_generate(cfg: DecodeModelConfig, params, prompt,
                       max_new_tokens: int,
                       eos_id: Optional[int] = None) -> List[int]:
    """Greedy oracle: full dense recompute per emitted token (no KV
    cache, no paging, no batching) on the params' device — the output
    every engine configuration is held against."""
    dev = params["tok_emb"].device
    tokens = [int(t) for t in prompt]
    for _ in range(int(max_new_tokens)):
        logits = dense_forward(
            cfg, params, torch.tensor([tokens], dtype=torch.long,
                                      device=dev))
        nxt = int(torch.argmax(logits[0, -1]))
        tokens.append(nxt)
        if eos_id is not None and nxt == eos_id:
            break
    return tokens[len(prompt):]

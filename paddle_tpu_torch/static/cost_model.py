"""Analytic step costs (port of the part of ``paddle_tpu/static/
cost_model.py`` the decode engine uses: :func:`paged_decode_cost`, the
source of its ``step_model_flops`` / ``step_hbm_bytes`` / ``mfu`` /
``arith_intensity`` gauges). The Program cost report is a later port
slice. Stdlib only, like the reference function: the same inputs give
the same numbers."""
from __future__ import annotations

from typing import Dict, Sequence

from ..ps.codec import encoded_nbytes

__all__ = ["paged_decode_cost"]


def paged_decode_cost(config, live_lens: Sequence[int], page_size: int,
                      itemsize: int = 4,
                      kv_codec: str = "off") -> Dict[str, float]:
    """Analytic cost of ONE ragged paged decode step. Attention bytes
    count the GATHERED LIVE PAGES of each sequence (``ceil(len /
    page_size) * page_size`` positions), never the whole pool.

    ``config`` carries the model dims (n_layers, n_heads, head_dim,
    ffn_dim, vocab_size); ``live_lens`` is the attended context length
    of each live slot this step.

    FLOPs (matmul-class only, the MFU numerator): per live token the
    qkv and out projections (8E²), the ffn pair (4EF) and the vocabulary
    head (2EV), plus per layer the two attention products over the live
    context (4·E·ctx). Bytes: the weights once a step, the live K/V
    pages read, the new token's K/V written and the logits.

    With ``kv_codec="int8"`` the K/V page bytes are the ENCODED cost,
    ``encoded_nbytes(E, "int8", block=E)`` a token row (int8 payload
    and one f32 scale); params and logits stay at ``itemsize``."""
    L = int(config.n_layers)
    H = int(config.n_heads)
    D = int(config.head_dim)
    E = H * D
    F = int(config.ffn_dim)
    V = int(config.vocab_size)
    n = len(live_lens)
    if kv_codec == "int8":
        kv_row_bytes = encoded_nbytes(E, "int8", block=E)
    else:
        kv_row_bytes = E * itemsize
    flops = 0
    page_tokens = 0
    for ln in live_lens:
        flops += L * (8 * E * E + 4 * E * F + 4 * E * int(ln)) \
            + 2 * E * V
        page_tokens += -(-int(ln) // int(page_size)) * int(page_size)
    param_bytes = (L * (4 * E * E + 2 * E * F) + 2 * V * E) * itemsize
    hbm = (param_bytes
           + 2 * L * page_tokens * kv_row_bytes     # live K+V pages read
           + 2 * L * n * kv_row_bytes               # new K+V written
           + n * V * itemsize)                      # logits out
    return {"model_flops": int(flops), "hbm_bytes": int(hbm),
            "arith_intensity": flops / hbm if hbm else 0.0,
            "live_slots": n, "live_page_tokens": int(page_tokens),
            "kv_codec": kv_codec,
            "kv_row_bytes": int(kv_row_bytes)}

"""Draft proposers for speculative decoding (model-free); a copy of
``paddle_tpu/inference/decode/spec.py``.

Speculative decoding splits a decode step into PROPOSE (cheap, host)
and VERIFY (one ragged step scoring all k candidates,
``model.spec_decode_forward``). The contract for a proposer is one
method::

    propose(context: Sequence[int], k: int) -> List[int]

returning UP TO ``k`` draft tokens expected to follow ``context``
(prompt + everything generated so far). Fewer (or zero) drafts are
always legal — the engine masks unfilled columns; correctness never
depends on draft quality because the verify step accepts only the
prefix that matches what greedy decode would have emitted anyway.

:class:`NgramProposer` is the classic prompt-lookup scheme ("Accelerating
LLM Inference with Staged Speculative Decoding" lineage):
find the most recent earlier occurrence of the context's tail n-gram
and propose the tokens that followed it, trying n from ``max_n`` down
to 1. No second model, no extra memory beyond the token list — the win
shows up whenever generation repeats structure (code, templates,
retrieval-stuffed prompts, greedy cycles).
"""
from __future__ import annotations

from typing import List, Sequence

__all__ = ["NgramProposer"]


class NgramProposer:
    """Prompt-lookup drafts: match the longest tail n-gram
    (``max_n`` down to 1) against the rest of the context and propose
    the continuation of its MOST RECENT earlier occurrence."""

    def __init__(self, max_n: int = 3):
        if max_n < 1:
            raise ValueError(f"max_n must be >= 1, got {max_n}")
        self.max_n = int(max_n)

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        ctx = list(context)
        L = len(ctx)
        if k <= 0 or L < 2:
            return []
        # byte-range vocabularies search at C speed: a prior occurrence
        # of the tail n-gram whose match ends before the final token is
        # exactly bytes.rfind(tail) bounded to b[:L-1]
        if 0 <= min(ctx) and max(ctx) < 256:
            b = bytes(ctx)
            for n in range(min(self.max_n, L - 1), 0, -1):
                start = b.rfind(b[L - n:], 0, L - 1)
                if start >= 0:
                    return ctx[start + n:start + n + int(k)]
            return []
        for n in range(min(self.max_n, L - 1), 0, -1):
            tail = ctx[L - n:]
            # scan right-to-left for the latest PRIOR occurrence; the
            # match may overlap the tail itself (periodic contexts)
            for start in range(L - n - 1, -1, -1):
                if ctx[start:start + n] == tail:
                    out = ctx[start + n:start + n + int(k)]
                    if out:
                        return out
        return []

"""Launch counts of the port's CUDA kernels.

One plain integer per kernel, bumped by its wrapper exactly where it
launches the kernel and nowhere else, so a run can show that its main
path went through the kernels. There is no second path to count: a
CUDA tensor launches the kernel or raises. Three routes have no kernel
and a count of their own, since the JAX package computes them in XLA
too: ``fused_sample.top_p_plain`` (nucleus sampling, the plain
sort+cumsum path on any device), ``attention_per_query_plain``
(attention under a per-query mask, ``flash_attention.
per_query_attention``, one a call) and ``attention_plain`` (attention
of a shape no kernel takes, a head width other than 64, 128, 192 or
256 or causal masking with Lq != Lk, ``flash_attention.plain_attention``, one
a call), each reached by an explicit dispatch on what the call asks
for.

Beside the launches live the data-parallel static step's plan verdicts,
the JAX package's dispatch counters (``paddle_tpu/ops/pallas/
counters.py``): ``quant_allreduce.quant`` / ``quant_allreduce.xla`` and
``zero.zero`` / ``zero.xla``, one per plan built, a refusal with its
reason (:func:`refuse`, :func:`reasons`). These are the JAX package's API
(an ineligible ZeRO request runs the replicated step), not kernel
fallbacks.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, List

__all__ = ["bump", "get", "snapshot", "reset", "refuse", "reasons"]

_COUNTS: collections.Counter = collections.Counter()
_REASONS: Dict[str, List[str]] = collections.defaultdict(list)
_LOCK = threading.Lock()


def bump(name: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[name] += n


def get(name: str) -> int:
    with _LOCK:
        return _COUNTS[name]


def snapshot() -> Dict[str, int]:
    with _LOCK:
        return dict(_COUNTS)


def refuse(name: str, reason: str) -> None:
    """Count ``name`` (a ``<plan>.xla`` verdict) and keep its reason."""
    with _LOCK:
        _COUNTS[name] += 1
        _REASONS[name].append(reason)


def reasons(name: str) -> List[str]:
    """The reasons :func:`refuse` recorded under ``name``, oldest
    first."""
    with _LOCK:
        return list(_REASONS.get(name, ()))


def reset() -> None:
    with _LOCK:
        _COUNTS.clear()
        _REASONS.clear()

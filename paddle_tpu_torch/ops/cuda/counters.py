"""Launch counts of the port's CUDA kernels.

One plain integer per kernel, bumped by its wrapper exactly where it
launches the kernel and nowhere else, so a run can show that its main
path went through the kernels. There is no second path to count: a
CUDA tensor launches the kernel or raises. The one exception with its
own count is ``fused_sample.top_p_plain``: nucleus sampling has no
kernel (the JAX package routes it to XLA too) and runs the plain
sort+cumsum path on any device.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict

__all__ = ["bump", "get", "snapshot", "reset"]

_COUNTS: collections.Counter = collections.Counter()
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


def reset() -> None:
    with _LOCK:
        _COUNTS.clear()

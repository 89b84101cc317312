"""Global flag registry (port of ``paddle_tpu/framework/flags.py``).

A typed in-process registry, seeded from ``FLAGS_*`` environment
variables and settable with :func:`set_flags`, as ``fluid.set_flags`` /
``fluid.get_flags``. It defines only the flags the port reads:

- ``flash_short_seq`` (default False): route mask-free attention whose
  shape fits the short-sequence kernels (Lq == Lk, 128 <= L <= 512,
  L % 128 == 0) to them instead of the streaming flash kernel. The JAX
  flag's doc says 128 <= seq <= 256, but its code admits 512
  (``_SHORT_SEQ_MAX``); the port follows the code.
- ``fused_vocab_xent`` (default True): the models' vocabulary losses
  (BERT's MLM head, the Transformer NMT's) take the fused linear +
  cross-entropy kernel; False materialises the logits and runs
  ``F.cross_entropy`` (the JAX flag's A/B arm, ``paddle_tpu/ops/pallas/
  fused_xent.py:31``).
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

__all__ = ["define_flag", "get_flag", "get_flags", "set_flags",
           "all_flags"]

_lock = threading.Lock()
_registry: Dict[str, Any] = {}
_docs: Dict[str, str] = {}


def define_flag(name: str, default, doc: str = ""):
    with _lock:
        if name in _registry:
            return
        env = os.environ.get(f"FLAGS_{name}")
        value = default
        if env is not None:
            if isinstance(default, bool):
                value = env.lower() in ("1", "true", "yes", "on")
            elif isinstance(default, int):
                value = int(env)
            elif isinstance(default, float):
                value = float(env)
            else:
                value = env
        _registry[name] = value
        _docs[name] = doc


def get_flags(names):
    if isinstance(names, str):
        names = [names]
    return {n: _registry[n] for n in names}


def get_flag(name: str):
    return _registry[name]


def set_flags(flags: Dict[str, Any]):
    with _lock:
        for name, value in flags.items():
            if name not in _registry:
                raise KeyError(f"Flag {name!r} is not defined")
            _registry[name] = value


def all_flags():
    return dict(_registry)


define_flag("flash_short_seq", False,
            "Route mask-free attention with Lq == Lk, 128 <= L <= 512 and "
            "L % 128 == 0 to the short-sequence kernels (direct softmax "
            "per head, one backward launch) instead of the streaming "
            "flash kernel")
define_flag("fused_vocab_xent", True,
            "Route large-vocab linear+cross-entropy heads (BERT MLM, the "
            "NMT's output projection) through the fused kernel; False "
            "materialises the logits and runs F.cross_entropy")

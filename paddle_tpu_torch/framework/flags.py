"""Global flag registry (port of ``paddle_tpu/framework/flags.py``).

A typed in-process registry, seeded from ``FLAGS_*`` environment
variables and settable with :func:`set_flags`, as ``fluid.set_flags`` /
``fluid.get_flags``. It defines every flag of the JAX package. The port
reads these:

- ``check_nan_inf`` (default False): every op of the op library
  (``framework.op.primitive``) scans its floating outputs and raises
  ``FloatingPointError`` naming the op on a NaN or Inf (the JAX
  ``op.py`` scan);
- ``sp_mask_fallback`` (default False): JAX's replicated fallback for a
  query-dependent mask under sequence parallelism. The port does not
  copy that fallback (ROADMAP queue 1 item 4): setting the flag true
  raises ``NotImplementedError``;
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

The rest are stored for parity and change nothing: ``prng_impl``
(PyTorch's Philox generators are the port's only kind),
``benchmark``, ``eager_delete_tensor_gb``, ``paddle_num_threads``,
``use_pinned_memory``, ``fraction_of_gpu_memory_to_use``,
``init_allocated_mem``, ``cudnn_deterministic``, ``max_inplace_grad_add``,
``tracer_profile_fname``, ``sp_fallback_warn``, and those the JAX
package defines beside its kernels: ``log_pallas_fallback`` (the port
has no fallback to log), ``flash_autotune``, ``sample_autotune``,
``fused_opt_autotune``, ``paged_autotune`` (the port routes by shape,
never by a timed verdict) and ``ring_flash`` (the port's ring always
runs the flash kernels).
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
            if name == "sp_mask_fallback" and value:
                raise NotImplementedError(
                    "FLAGS_sp_mask_fallback: the replicated attention "
                    "fallback for query-dependent masks under sequence "
                    "parallelism is not ported (ROADMAP queue 1 item 4); "
                    "pass is_causal=True plus a (B, L) key-padding mask")
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
define_flag("check_nan_inf", False,
            "Scan op outputs for NaN/Inf and raise naming the op")
define_flag("prng_impl", "auto",
            "Stored for parity: the port's generators are PyTorch's")
define_flag("benchmark", False, "Stored for parity")
define_flag("eager_delete_tensor_gb", 0.0, "Stored for parity")
define_flag("paddle_num_threads", 1, "Stored for parity")
define_flag("use_pinned_memory", True, "Stored for parity")
define_flag("fraction_of_gpu_memory_to_use", 0.92, "Stored for parity")
define_flag("init_allocated_mem", False, "Stored for parity")
define_flag("cudnn_deterministic", False, "Stored for parity")
define_flag("max_inplace_grad_add", 0, "Stored for parity")
define_flag("tracer_profile_fname", "", "Stored for parity")
define_flag("sp_fallback_warn", True, "Stored for parity")
define_flag("sp_mask_fallback", False,
            "The replicated fallback is not ported: true raises")
define_flag("log_pallas_fallback", False, "Stored for parity")
define_flag("flash_autotune", True, "Stored for parity")
define_flag("sample_autotune", True, "Stored for parity")
define_flag("fused_opt_autotune", True, "Stored for parity")
define_flag("paged_autotune", True, "Stored for parity")
define_flag("ring_flash", True, "Stored for parity")

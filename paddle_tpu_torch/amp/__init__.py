"""Automatic mixed precision: ``auto_cast`` and the cast rule the port's
functional ops consult.

Port of ``paddle_tpu/amp/__init__.py``. The lists are the JAX package's
own ``WHITE_LIST`` and ``BLACK_LIST`` (copied), not ``torch.autocast``'s:
under O1 a white-listed op (``linear``, ``matmul``, ...) casts its
floating inputs to the low-precision type and a black-listed one
(``layer_norm``, ``softmax_with_cross_entropy``, ...) casts bf16/f16
inputs up to f32; every other op runs in the types it is given. So in
BERT attention receives bf16 q/k/v (from bf16 projections) and the MLM
head's ``fused_linear_cross_entropy`` receives f32 h and W (h comes out
of the f32 layer norm). Each functional op passes its inputs through
:func:`maybe_cast_inputs` under the JAX op name.

Levels O0 (off) and O1 are ported. O2, ``GradScaler`` and ``decorate``
(master weights) are left for a later slice: under O2 the JAX package
casts every non-black op, including tensor arithmetic the port does not
route through a hook.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["WHITE_LIST", "BLACK_LIST", "auto_cast", "maybe_cast_inputs"]

_state = threading.local()

# ops whose inputs are cast down under autocast (reference fp16_lists.py
# white_list)
WHITE_LIST = {"matmul", "conv1d", "conv2d", "conv3d", "linear", "bmm", "mv",
              "einsum"}
# numerically sensitive ops stay f32 (reference black_list)
BLACK_LIST = {"softmax_with_cross_entropy", "softmax", "log_softmax",
              "layer_norm", "reduce_mean", "reduce_sum", "exp", "log",
              "norm", "p_norm", "logsumexp"}

_LOW = (torch.bfloat16, torch.float16)


class auto_cast:
    """``with amp.auto_cast(level="O1", dtype="bfloat16"):`` white-listed
    ops run in the low-precision type, black-listed ones in f32."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        if level not in ("O0", "O1"):
            raise NotImplementedError(
                f"auto_cast level {level!r}: the port has O0 and O1; O2 "
                f"(with decorate and master weights) is a later slice")
        self.level = level if enable else "O0"
        self.dtype = torch.bfloat16 if str(dtype) in ("bfloat16", "bf16") \
            else torch.float16
        self.white = set(custom_white_list or ()) | WHITE_LIST
        self.black = set(custom_black_list or ()) | BLACK_LIST

    def __enter__(self):
        self._prev = (getattr(_state, "level", "O0"),
                      getattr(_state, "dtype", torch.bfloat16),
                      getattr(_state, "white", WHITE_LIST),
                      getattr(_state, "black", BLACK_LIST))
        _state.level = self.level
        _state.dtype = self.dtype
        _state.white = self.white
        _state.black = self.black
        return self

    def __exit__(self, *exc):
        (_state.level, _state.dtype, _state.white,
         _state.black) = self._prev
        return False


def maybe_cast_inputs(op_name: str, tensors):
    """The inputs of op ``op_name`` as it runs under the active
    ``auto_cast`` (the JAX op bridge's white/black-list rule); ``None``
    and non-floating tensors pass unchanged."""
    if getattr(_state, "level", "O0") == "O0":
        return list(tensors)
    if op_name in getattr(_state, "white", WHITE_LIST):
        dt = getattr(_state, "dtype", torch.bfloat16)
        return [t.to(dt) if isinstance(t, torch.Tensor)
                and t.is_floating_point() else t for t in tensors]
    if op_name in getattr(_state, "black", BLACK_LIST):
        return [t.to(torch.float32) if isinstance(t, torch.Tensor)
                and t.dtype in _LOW else t for t in tensors]
    return list(tensors)

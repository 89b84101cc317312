"""Dtype names, the default dtype and their torch dtypes.

Port of ``paddle_tpu/framework/dtype.py``: the paddle-style string
aliases, :func:`convert_dtype` (any alias, numpy or torch dtype to a
numpy dtype; bfloat16, which numpy lacks, stays the string
``"bfloat16"``), :func:`dtype_name` (the canonical name the static IR
stores, such as ``"float32"``), :func:`to_torch` (the torch dtype of a
name), the default float dtype, and the dtype objects the top level
exports.

The exported dtype objects are torch's (``paddle_tpu_torch.float32 is
torch.float32``), so ``x.dtype == paddle.float32`` holds for the port's
``Tensor`` as for paddle's; the JAX package exports numpy/jnp dtypes,
which is what its ``Tensor.dtype`` gives. Compare the two by
:func:`dtype_name`.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_dtype", "dtype_name", "to_torch", "set_default_dtype",
           "get_default_dtype", "default_torch_dtype", "is_floating",
           "is_integer", "is_inexact", "bool_", "uint8", "int8", "int16",
           "int32", "int64", "float16", "bfloat16", "float32", "float64",
           "complex64", "complex128"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_ALIASES = {
    "bool": np.bool_,
    "uint8": np.uint8,
    "int8": np.int8,
    "int16": np.int16,
    "int32": np.int32,
    "int64": np.int64,
    "float16": np.float16,
    "fp16": np.float16,
    "float32": np.float32,
    "fp32": np.float32,
    "float64": np.float64,
    "fp64": np.float64,
    "complex64": np.complex64,
    "complex128": np.complex128,
}

_TORCH = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_FROM_TORCH = {v: k for k, v in _TORCH.items()}

_DEFAULT = ["float32"]


def convert_dtype(dtype):
    """A string alias, numpy or torch dtype as a numpy dtype (bfloat16,
    which numpy lacks, stays the string ``"bfloat16"``)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        dtype = _FROM_TORCH[dtype]
    if isinstance(dtype, str):
        if dtype in ("bfloat16", "bf16"):
            return "bfloat16"
        if dtype not in _ALIASES:
            raise TypeError(f"Unsupported dtype string: {dtype!r}")
        return np.dtype(_ALIASES[dtype])
    if getattr(dtype, "__name__", None) == "bfloat16" or \
            str(dtype) == "bfloat16":
        return "bfloat16"
    return np.dtype(dtype)


def dtype_name(dtype) -> str:
    """The IR's name of ``dtype`` (``"float32"``, ``"int64"``, ...)."""
    if isinstance(dtype, torch.dtype):
        return _FROM_TORCH[dtype]
    if dtype in ("bfloat16", "bf16") or str(dtype) == "bfloat16":
        return "bfloat16"
    return np.dtype(dtype).name


def to_torch(dtype) -> torch.dtype:
    """The torch dtype of an IR dtype name or any dtype
    :func:`convert_dtype` takes."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH[dtype_name(convert_dtype(dtype))]


def set_default_dtype(dtype):
    """The dtype of floats made from Python numbers (``to_tensor(1.5)``,
    ``zeros`` without a dtype, ...)."""
    _DEFAULT[0] = dtype_name(convert_dtype(dtype))


def get_default_dtype():
    """The default float dtype as the JAX package gives it: a numpy
    dtype (the string ``"bfloat16"`` for bfloat16)."""
    return convert_dtype(_DEFAULT[0])


def default_torch_dtype() -> torch.dtype:
    return _TORCH[_DEFAULT[0]]


def is_floating(dtype) -> bool:
    return to_torch(dtype).is_floating_point


def is_integer(dtype) -> bool:
    t = to_torch(dtype)
    return not t.is_floating_point and not t.is_complex and t != torch.bool


def is_inexact(dtype) -> bool:
    t = to_torch(dtype)
    return t.is_floating_point or t.is_complex

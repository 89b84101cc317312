"""Dtype names of the static IR and their torch dtypes.

Port of the part of ``paddle_tpu/framework/dtype.py`` the static graph
needs: the paddle-style string aliases, :func:`convert_dtype` (any
alias, numpy or torch dtype to a numpy dtype) and :func:`dtype_name`
(the canonical name the IR stores, such as ``"float32"``), plus
:func:`to_torch`, the torch dtype for a name.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_dtype", "dtype_name", "to_torch"]

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
    return np.dtype(dtype)


def dtype_name(dtype) -> str:
    """The IR's name of ``dtype`` (``"float32"``, ``"int64"``, ...)."""
    if isinstance(dtype, torch.dtype):
        return _FROM_TORCH[dtype]
    if dtype in ("bfloat16", "bf16"):
        return "bfloat16"
    return np.dtype(dtype).name


def to_torch(dtype) -> torch.dtype:
    """The torch dtype of an IR dtype name or any dtype
    :func:`convert_dtype` takes."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH[dtype_name(convert_dtype(dtype))]

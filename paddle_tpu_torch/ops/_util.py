"""Helpers of the op library: Python values as tensors beside a tensor
operand, shapes, axes and dtypes in the JAX package's conventions."""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..framework import dtype as dtype_mod
from ..framework.tensor import _as_plain

__all__ = ["as_t", "pair", "shape_of", "axes", "tdtype", "device_of",
           "float_of"]


def device_of(*xs):
    """The device of the first tensor among ``xs`` (through lists,
    tuples and dicts), else the default."""
    stack = list(xs)
    while stack:
        x = stack.pop(0)
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, dict):
            stack[:0] = x.values()
        elif isinstance(x, (list, tuple)):
            stack[:0] = x
    return resolve_device(None)


def as_t(x, like=None, dtype=None):
    """``x`` as a tensor: a tensor as it is (cast to ``dtype`` when
    given), a Python number next to ``like`` in the type a JAX weak
    scalar would take (``torch.result_type``), anything else by
    ``to_tensor``'s rule on ``like``'s device."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype_mod.to_torch(dtype))
    if x is None:
        return None
    dev = device_of(like)
    if dtype is not None:
        return _as_plain(x, dtype, dev)
    if isinstance(like, torch.Tensor) and isinstance(
            x, (bool, int, float, complex)):
        return torch.tensor(x, dtype=torch.result_type(like, x), device=dev)
    return _as_plain(x, None, dev)


def pair(x, y):
    """Both operands of a binary op as tensors, a Python scalar taking
    the weak type beside the other."""
    if isinstance(x, torch.Tensor):
        return x, as_t(y, x)
    if isinstance(y, torch.Tensor):
        return as_t(x, y), y
    x = as_t(x)
    return x, as_t(y, x)


def shape_of(shape):
    """A shape (int, list/tuple of ints or 0-d tensors, or a tensor) as
    a tuple of ints."""
    if isinstance(shape, torch.Tensor):
        return tuple(int(v) for v in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def axes(axis):
    """None, an int or a list of ints as None, an int or a tuple."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def tdtype(dtype):
    return None if dtype is None else dtype_mod.to_torch(dtype)


def float_of(x):
    """``x`` in a floating type (the default dtype for an integer or
    boolean tensor, as JAX's true division and means give)."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(dtype_mod.default_torch_dtype())

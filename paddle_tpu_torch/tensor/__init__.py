"""The ``paddle.tensor`` namespace (port of ``paddle_tpu/tensor``): the
op library re-exported, ``save``/``load``/``to_tensor``, and the v1.8
spellings that only lived here (``reduce_*``, ``elementwise_floordiv``
and ``elementwise_sum``/``sums``, ``mul``, ``numel``, ``t``,
``standard_normal``, ``shuffle``, ``addcmul``, ``chunksqueeze``)."""
from __future__ import annotations

import numpy as np
import torch

from .. import ops as _ops
from ..framework.random import generator_for
from ..framework.tensor import entry
from ..ops._util import as_t, axes

__all__ = ["addcmul", "elementwise_floordiv", "elementwise_sum", "sums",
           "mul", "numel", "reduce_sum", "reduce_mean", "reduce_max",
           "reduce_min", "reduce_prod", "reduce_all", "reduce_any", "t",
           "standard_normal", "shuffle", "chunksqueeze"]


@entry
def addcmul(input, tensor1, tensor2, value=1.0, name=None):
    """input + value * tensor1 * tensor2."""
    return as_t(input) + value * as_t(tensor1) * as_t(tensor2)


@entry
def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return torch.floor_divide(*_ops._util.pair(x, y))


@entry
def elementwise_sum(inputs, name=None):
    out = as_t(inputs[0])
    for t in inputs[1:]:
        out = out + as_t(t)
    return out


sums = elementwise_sum


@entry
def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    """mul_op: x and y flattened to 2-D at their ``num_col_dims``,
    multiplied, reshaped to x.shape[:x_num_col_dims] +
    y.shape[y_num_col_dims:]."""
    xv, yv = as_t(x), as_t(y)
    xs = xv.reshape(int(np.prod(xv.shape[:x_num_col_dims])), -1)
    ys = yv.reshape(int(np.prod(yv.shape[:y_num_col_dims])), -1)
    return (xs @ ys).reshape(*xv.shape[:x_num_col_dims],
                             *yv.shape[y_num_col_dims:])


@entry
def numel(x, name=None):
    x = as_t(x)
    return torch.tensor(x.numel(), device=x.device)


def _dims(x, dim):
    a = axes(dim)
    if a is None:
        return tuple(range(x.dim()))
    return a if isinstance(a, tuple) else (a,)


@entry
def reduce_sum(x, dim=None, keep_dim=False, name=None):
    x = as_t(x)
    return torch.sum(x, dim=_dims(x, dim), keepdim=keep_dim)


@entry
def reduce_mean(x, dim=None, keep_dim=False, name=None):
    return _ops.mean(x, axis=dim, keepdim=keep_dim)


@entry
def reduce_max(x, dim=None, keep_dim=False, name=None):
    return _ops.max(x, axis=dim, keepdim=keep_dim)


@entry
def reduce_min(x, dim=None, keep_dim=False, name=None):
    return _ops.min(x, axis=dim, keepdim=keep_dim)


@entry
def reduce_prod(x, dim=None, keep_dim=False, name=None):
    return _ops.prod(x, axis=dim, keepdim=keep_dim)


@entry
def reduce_all(x, dim=None, keep_dim=False, name=None):
    return _ops.all(x, axis=dim, keepdim=keep_dim)


@entry
def reduce_any(x, dim=None, keep_dim=False, name=None):
    return _ops.any(x, axis=dim, keepdim=keep_dim)


@entry
def t(input, name=None):
    """Transpose of a tensor of rank <= 2."""
    v = as_t(input)
    if v.dim() > 2:
        raise ValueError("t() expects a tensor of rank <= 2")
    return v.t() if v.dim() == 2 else v


@entry
def standard_normal(shape, dtype="float32", name=None):
    return _ops.randn(shape, dtype=dtype)


@entry
def shuffle(x, name=None):
    """A random permutation of the rows (the device's generator)."""
    v = as_t(x)
    perm = torch.randperm(v.shape[0], device=v.device,
                          generator=generator_for(v.device))
    return v[perm]


chunksqueeze = _ops.chunk


def _register():
    import sys

    mod = sys.modules[__name__]
    for n in dir(_ops):
        if not n.startswith("_") and not hasattr(mod, n) and callable(
                getattr(_ops, n)):
            setattr(mod, n, getattr(_ops, n))
    from .. import load, save, to_tensor

    mod.save, mod.load, mod.to_tensor = save, load, to_tensor


_register()

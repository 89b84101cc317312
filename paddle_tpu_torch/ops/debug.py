"""Debug and host-callback ops (port of ``paddle_tpu/ops/debug.py``):
``Print``, ``Assert`` and ``py_func``. Eager PyTorch runs Python
between ops, so each is a plain host call (the JAX package needs XLA
host callbacks to run them inside a compiled step); ``py_func`` with a
``backward_func`` is a ``torch.autograd.Function`` whose passes run the
user's functions on numpy copies.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..framework.tensor import entry, user_scope
from ._util import as_t

__all__ = ["Print", "Assert", "py_func"]


def _np(t):
    t = torch.Tensor.detach(as_t(t)).cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both", name=None):
    """Print the tensor's value; returns ``input`` unchanged."""
    arr = _np(input)
    if message:
        print(message, arr)
    else:
        print(arr)
    return input


def Assert(cond, data: Optional[Sequence] = None, summarize=20, name=None):
    """Raise ``AssertionError`` (with the first ``summarize`` values of
    each ``data`` tensor) unless every element of ``cond`` is true."""
    if not bool(np.all(_np(cond))):
        parts = ", ".join(str(_np(d)[:summarize]) for d in (data or ()))
        raise AssertionError(
            f"paddle_tpu_torch.Assert failed{(': ' + parts) if parts else ''}")
    return cond


def _template(o):
    """(shape, torch dtype) of an output template: a tensor or any
    object with ``shape`` and ``dtype``."""
    return tuple(o.shape), dtype_mod.to_torch(
        o.dtype if not isinstance(o.dtype, np.dtype) else o.dtype.name)


class _PyFunc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, func, backward_func, shapes, device, *xs):
        ctx.backward_func = backward_func
        ctx.shapes_in = [(tuple(x.shape), x.dtype) for x in xs]
        ctx.device = device
        ctx.save_for_backward(*xs)
        with user_scope():
            res = func(*[_np(x) for x in xs])
        res = res if isinstance(res, (list, tuple)) else [res]
        return tuple(torch.as_tensor(np.asarray(r)).reshape(s).to(
            device=device, dtype=dt) for r, (s, dt) in zip(res, shapes))

    @staticmethod
    def backward(ctx, *gs):
        xs = ctx.saved_tensors
        with user_scope():
            res = ctx.backward_func(*[_np(x) for x in xs],
                                    *[_np(g) for g in gs])
        res = res if isinstance(res, (list, tuple)) else [res]
        grads = tuple(torch.as_tensor(np.asarray(r)).reshape(s).to(
            device=ctx.device, dtype=dt)
            for r, (s, dt) in zip(res, ctx.shapes_in))
        return (None, None, None, None, *grads)


@entry
def py_func(func: Callable, x, out, backward_func: Optional[Callable] = None,
            skip_vars_in_backward_input=None, name=None):
    """Run ``func`` on numpy copies of ``x`` (a tensor or a list of
    them); ``out`` (a template tensor or a list of them) gives the
    outputs' shapes and dtypes. ``backward_func(*inputs, *output_grads)``
    gives the inputs' gradients."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    xs = [as_t(v) for v in xs]
    outs = out if isinstance(out, (list, tuple)) else [out]
    shapes = [_template(o) for o in outs]
    device = xs[0].device if xs else torch.device("cpu")
    single = not isinstance(out, (list, tuple))
    if backward_func is None:
        with user_scope():
            res = func(*[_np(v) for v in xs])
        res = res if isinstance(res, (list, tuple)) else [res]
        res = tuple(torch.as_tensor(np.asarray(r)).reshape(s).to(
            device=device, dtype=dt) for r, (s, dt) in zip(res, shapes))
    else:
        res = _PyFunc.apply(func, backward_func, shapes, device, *xs)
    return res[0] if single else list(res)

"""The op bridge: a torch function -> an op of the library.

Port of ``paddle_tpu/framework/op.py``. The JAX decorator records a
VJP on its tape; here PyTorch's autograd records the graph, so
:func:`primitive` records nothing. An op is an entry of the port
(``framework.tensor.entry``): called from a user's code it runs the
function as the port's code, casts
its tensor inputs by the active ``amp.auto_cast`` under the op's name
(the JAX bridge's rule), detaches the ``nondiff`` arguments, scans the
floating outputs for NaN/Inf when ``FLAGS_check_nan_inf`` is on
(raising ``FloatingPointError`` naming the op, ``op.py:104-121``) and
returns its tensors as every entry does. Called from the port's own
code it is the bare function. Every op registers in :data:`OP_REGISTRY`, the
list the tests walk.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict

import torch

from . import flags
from .tensor import entry

__all__ = ["primitive", "OP_REGISTRY"]

OP_REGISTRY: Dict[str, Callable] = {}


def _cast_args(op_name, args, kwargs):
    """``args``/``kwargs`` with their tensors (one level into lists)
    cast as ``amp.maybe_cast_inputs(op_name, ...)`` says."""
    from ..amp import maybe_cast_inputs

    def cast(v):
        if isinstance(v, torch.Tensor):
            return maybe_cast_inputs(op_name, [v])[0]
        if isinstance(v, (list, tuple)) and any(
                isinstance(x, torch.Tensor) for x in v):
            return type(v)(maybe_cast_inputs(op_name, list(v)))
        return v

    return [cast(a) for a in args], {k: cast(v) for k, v in kwargs.items()}


def _detach_args(sig, nondiff, args, kwargs):
    bound = sig.bind(*args, **kwargs)
    for k in nondiff:
        v = bound.arguments.get(k)
        if isinstance(v, torch.Tensor):
            bound.arguments[k] = v.detach()
        elif isinstance(v, (list, tuple)):
            bound.arguments[k] = type(v)(
                x.detach() if isinstance(x, torch.Tensor) else x for x in v)
    return bound.args, bound.kwargs


def _check_nan_inf(op_name, out):
    leaves = out if isinstance(out, (list, tuple)) else [out]
    for leaf in leaves:
        if isinstance(leaf, (list, tuple)):
            _check_nan_inf(op_name, leaf)
        elif isinstance(leaf, torch.Tensor) and (
                leaf.is_floating_point() or leaf.is_complex()):
            if not bool(torch.isfinite(leaf.detach()).all()):
                raise FloatingPointError(
                    f"Operator {op_name} output contains NaN/Inf")


def primitive(name=None, nondiff=()):
    """Register ``fn`` (a function of torch tensors) as op ``name`` (its
    own name by default), an :func:`~.tensor.entry` of the port;
    ``nondiff`` names arguments that never get a gradient."""

    def deco(fn):
        op_name = name or fn.__name__
        sig = inspect.signature(fn) if nondiff else None

        def outer(*args, **kwargs):
            from ..amp import amp_enabled

            if amp_enabled():
                args, kwargs = _cast_args(op_name, args, kwargs)
            if nondiff:
                args, kwargs = _detach_args(sig, nondiff, args, kwargs)
            out = fn(*args, **kwargs)
            if flags.get_flag("check_nan_inf"):
                _check_nan_inf(op_name, out)
            return out

        wrapper = entry(fn, outer)
        wrapper.op_name = op_name
        OP_REGISTRY[op_name] = wrapper
        return wrapper

    return deco

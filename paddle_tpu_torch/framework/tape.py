"""Grad mode and ``backward`` (port of ``paddle_tpu/framework/tape.py``).

The JAX package records each eager op's VJP on a tape of its own and
walks it in reverse; here PyTorch's autograd records the graph, so the
tape engine has no counterpart. What remains is the JAX module's API
over torch's: :class:`no_grad`, :class:`enable_grad`,
:func:`grad_enabled` and :func:`backward`.
"""
from __future__ import annotations

import functools

import torch

from .tensor import entry, unwrap

__all__ = ["no_grad", "enable_grad", "grad_enabled", "backward"]


def grad_enabled() -> bool:
    return torch.is_grad_enabled()


class _GradMode:
    _enabled = True

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self._enabled)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with type(self)():
                return fn(*a, **k)

        return wrapper


class no_grad(_GradMode):
    """Context manager / decorator: no graph is recorded inside
    (``paddle.no_grad``)."""

    _enabled = False


class enable_grad(_GradMode):
    """Context manager / decorator: the graph is recorded inside."""

    _enabled = True


@entry
def backward(tensor, grad=None, retain_graph: bool = False):
    """Accumulate the gradient of ``tensor`` (seeded by ``grad``, ones by
    default, whatever the shape) into the ``.grad`` of every leaf that
    needs one. A tensor that needs no gradient is left alone, as in the
    JAX package."""
    if not tensor.requires_grad:
        return
    g = unwrap(grad)
    if g is None:
        g = torch.ones_like(unwrap(tensor))
    elif not isinstance(g, torch.Tensor):
        g = torch.as_tensor(g, dtype=tensor.dtype, device=tensor.device)
    torch.Tensor.backward(tensor, g, retain_graph=bool(retain_graph))

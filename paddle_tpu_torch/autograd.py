"""``paddle.grad``, ``backward`` and ``PyLayer`` over torch autograd.

Port of ``paddle_tpu/autograd.py``. :func:`grad` never touches
``.grad``; it follows the JAX function's contract:

- ``retain_graph=None`` keeps the graph (JAX's default), and
  ``create_graph=True`` records the backward, so the gradients are
  differentiable again (a double gradient is torch autograd's own);
- an input that no output depends on gets zeros, or None with
  ``allow_unused=True``;
- ``grad_outputs`` seed the outputs (ones where None);
- ``no_grad_vars`` are stop points: no cotangent flows into or through
  them (a hook on each turns its incoming gradient into zeros for the
  call), and such an input's gradient is zeros.

:class:`PyLayer` is a ``torch.autograd.Function`` made per subclass,
its ``forward`` and ``backward`` run as a user's code (``Tensor``
semantics), with :class:`PyLayerContext`'s ``save_for_backward`` /
``saved_tensor`` over the function's own saved tensors.
"""
from __future__ import annotations

import torch

from .framework.tensor import Tensor, entry, unwrap, user_scope, wrap
from .framework.tape import no_grad, enable_grad  # noqa: F401

__all__ = ["grad", "backward", "PyLayer", "PyLayerContext", "Tensor"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


@entry
def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """The gradients of ``outputs`` with respect to ``inputs`` (a list,
    one per input; ``.grad`` is left alone)."""
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    seeds = [None] * len(outputs) if grad_outputs is None \
        else _as_list(grad_outputs)
    retain = True if retain_graph is None else bool(retain_graph)
    outs, gs = [], []
    for o, g in zip(outputs, seeds):
        if not o.requires_grad:
            continue
        outs.append(o)
        gs.append(torch.ones_like(unwrap(o)) if g is None else
                  unwrap(g) if isinstance(g, torch.Tensor)
                  else torch.as_tensor(g, dtype=o.dtype, device=o.device))
    ng = list(no_grad_vars or [])
    ng_ids = {id(t) for t in ng}
    hooks = [t.register_hook(torch.zeros_like) for t in ng
             if t.requires_grad]
    try:
        live = [i for i, t in enumerate(inputs)
                if t.requires_grad and id(t) not in ng_ids]
        res = [None] * len(inputs)
        if outs and live:
            got = torch.autograd.grad(
                outs, [inputs[i] for i in live], gs,
                retain_graph=retain or create_graph,
                create_graph=create_graph, allow_unused=True)
            for i, g in zip(live, got):
                res[i] = g
    finally:
        for h in hooks:
            h.remove()
    if not allow_unused:
        res = [torch.zeros_like(unwrap(t)) if r is None else r
               for r, t in zip(res, inputs)]
    return res


def backward(tensors, grad_tensors=None, retain_graph=False):
    """``t.backward(g, retain_graph)`` for each tensor (and seed)."""
    tensors = _as_list(tensors)
    grad_tensors = [None] * len(tensors) if grad_tensors is None \
        else _as_list(grad_tensors)
    for t, g in zip(tensors, grad_tensors):
        from .framework.tape import backward as _backward

        _backward(t, g, retain_graph)


class PyLayerContext:
    """The ``ctx`` of a :class:`PyLayer`: ``save_for_backward(*tensors)``
    in ``forward``, ``saved_tensor`` in ``backward``."""

    def __init__(self):
        self._saved = []
        self._fn_ctx = None

    def save_for_backward(self, *tensors):
        self._saved = list(tensors)
        if self._fn_ctx is not None:
            self._fn_ctx.save_for_backward(*[
                t for t in tensors if isinstance(t, torch.Tensor)])

    @property
    def saved_tensor(self):
        if self._fn_ctx is not None and self._fn_ctx.saved_tensors:
            it = iter(self._fn_ctx.saved_tensors)
            return [wrap(next(it)) if isinstance(t, torch.Tensor) else t
                    for t in self._saved]
        return self._saved


def _function_of(cls):
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(fctx, kwargs, *args):
            ctx = PyLayerContext()
            ctx._fn_ctx = fctx
            fctx.pylayer_ctx = ctx
            with user_scope():
                out = cls.forward(ctx, *wrap(args), **kwargs)
            fctx.tensor_pos = [i for i, a in enumerate(args)
                               if isinstance(a, torch.Tensor)]
            fctx.grad_pos = [i for i in fctx.tensor_pos
                             if args[i].requires_grad]
            fctx.n_args = len(args)
            if not isinstance(out, (tuple, list)):
                return unwrap(out) if isinstance(out, torch.Tensor) else out
            return tuple(unwrap(o) if isinstance(o, torch.Tensor)
                         else o for o in out)

        @staticmethod
        def backward(fctx, *grads):
            with user_scope():
                gin = cls.backward(fctx.pylayer_ctx, *wrap(grads))
            gin = list(gin) if isinstance(gin, (tuple, list)) else [gin]
            # one gradient per tensor argument, or per argument that
            # needs one (the JAX package's convention)
            pos = fctx.tensor_pos if len(gin) == len(fctx.tensor_pos) \
                else fctx.grad_pos
            full = [None] * fctx.n_args
            for i, g in zip(pos, gin):
                full[i] = unwrap(g) if isinstance(g, torch.Tensor) else g
            return (None, *full)

    _Fn.__name__ = cls.__name__ + "Function"
    cls._torch_function = _Fn
    return _Fn


class PyLayer:
    """A custom op with a user ``forward(ctx, *args)`` and
    ``backward(ctx, *grads)`` (one gradient per tensor argument of
    ``forward``, None for the others). ``apply`` records it on the
    graph; its backward is differentiable when it uses differentiable
    ops (a double gradient through ``create_graph``)."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return wrap(_function_of(cls).apply(kwargs, *args))

"""Operators and paddle methods on the port's ``Tensor``.

Port of ``paddle_tpu/framework/math_op_patch.py``: the dunders
(``:23-51``) dispatch to the op library, so ``a + b``, ``a % b`` (the
divisor's sign), ``a & b`` (logical), ``a == b`` (elementwise) take the
JAX ops' semantics and give ``Tensor``s, and the method table
(``:57-73``) makes ``t.sum(axis)``, ``t.split(n)``, ``t.max(axis)``,
``t.transpose(perm)`` ... the ops of the same names. They are installed
on the port's ``Tensor`` only, never on ``torch.Tensor``, and each is
``torch.Tensor``'s own method while the port's code runs
(``framework.tensor``'s depth), so PyTorch semantics hold there.
"""
from __future__ import annotations

import torch

from .tensor import Tensor, _dual

__all__ = ["DUNDERS", "METHODS"]

DUNDERS = {
    "__add__": ("add", False), "__radd__": ("add", True),
    "__sub__": ("subtract", False), "__rsub__": ("subtract", True),
    "__mul__": ("multiply", False), "__rmul__": ("multiply", True),
    "__truediv__": ("divide", False), "__rtruediv__": ("divide", True),
    "__floordiv__": ("floor_divide", False),
    "__rfloordiv__": ("floor_divide", True),
    "__mod__": ("mod", False), "__rmod__": ("mod", True),
    "__pow__": ("pow", False), "__rpow__": ("pow", True),
    "__matmul__": ("matmul", False), "__rmatmul__": ("matmul", True),
    "__eq__": ("equal", False), "__ne__": ("not_equal", False),
    "__lt__": ("less_than", False), "__le__": ("less_equal", False),
    "__gt__": ("greater_than", False), "__ge__": ("greater_equal", False),
    "__and__": ("logical_and", False), "__or__": ("logical_or", False),
    "__xor__": ("logical_xor", False),
}
UNARY_DUNDERS = {"__neg__": "neg", "__abs__": "abs",
                 "__invert__": "logical_not"}

METHODS = [
    "add", "subtract", "multiply", "divide", "pow", "matmul", "mod",
    "maximum", "minimum", "exp", "log", "log2", "log10", "sqrt", "rsqrt",
    "abs", "ceil", "floor", "round", "cos", "sin", "tan", "tanh",
    "sigmoid", "square", "sign", "reciprocal", "erf", "neg", "clip",
    "sum", "mean", "max", "min", "prod", "any", "all", "std", "var",
    "logsumexp", "cumsum", "cumprod", "argmax", "argmin", "argsort",
    "sort", "topk", "reshape", "transpose", "flatten", "squeeze",
    "unsqueeze", "split", "chunk", "tile", "expand", "expand_as",
    "broadcast_to", "gather", "gather_nd", "scatter", "index_select",
    "roll", "flip", "norm", "dist", "dot", "cross", "bmm", "mm",
    "cholesky", "inverse", "isnan", "isinf", "isfinite", "equal",
    "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_not",
    "allclose", "equal_all", "isclose", "where", "masked_fill",
    "unbind", "kron", "trace", "diagonal", "take_along_axis",
    "put_along_axis", "scale", "stanh", "unique",
]


def _install():
    from .. import ops

    def binop(fn, swap):
        def method(self, other):
            return fn(other, self) if swap else fn(self, other)

        return method

    def unop(fn):
        def method(self):
            return fn(self)

        return method

    for dunder, (name, swap) in DUNDERS.items():
        setattr(Tensor, dunder, _dual(dunder, binop(getattr(ops, name),
                                                     swap)))
    for dunder, name in UNARY_DUNDERS.items():
        setattr(Tensor, dunder, _dual(dunder, unop(getattr(ops, name))))
    Tensor.__hash__ = torch.Tensor.__hash__

    for m in METHODS:
        fn = getattr(ops, m)
        setattr(Tensor, m, _dual(
            m, (lambda f: lambda self, *a, **k: f(self, *a, **k))(fn)))


_install()

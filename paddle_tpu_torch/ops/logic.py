"""Comparison and logical ops (port of ``paddle_tpu/ops/logic.py``).
The logical ops take any type and treat nonzero as True, as ``jnp``'s
do."""
from __future__ import annotations

import torch

from ..framework.op import primitive
from ..framework.tensor import entry
from ._util import as_t, pair

__all__ = ["equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal", "logical_and", "logical_or", "logical_xor",
           "logical_not", "isclose", "allclose", "equal_all", "is_empty"]


@primitive("equal")
def equal(x, y, name=None):
    return torch.eq(*pair(x, y))


@primitive("not_equal")
def not_equal(x, y, name=None):
    return torch.ne(*pair(x, y))


@primitive("less_than")
def less_than(x, y, name=None):
    return torch.lt(*pair(x, y))


@primitive("less_equal")
def less_equal(x, y, name=None):
    return torch.le(*pair(x, y))


@primitive("greater_than")
def greater_than(x, y, name=None):
    return torch.gt(*pair(x, y))


@primitive("greater_equal")
def greater_equal(x, y, name=None):
    return torch.ge(*pair(x, y))


@primitive("logical_and")
def logical_and(x, y, out=None, name=None):
    return torch.logical_and(*pair(x, y))


@primitive("logical_or")
def logical_or(x, y, out=None, name=None):
    return torch.logical_or(*pair(x, y))


@primitive("logical_xor")
def logical_xor(x, y, out=None, name=None):
    return torch.logical_xor(*pair(x, y))


@primitive("logical_not")
def logical_not(x, out=None, name=None):
    return torch.logical_not(as_t(x))


@primitive("isclose")
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = pair(x, y)
    return torch.isclose(x, y.to(x.dtype), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


@entry
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = pair(x, y)
    return torch.tensor(bool(torch.allclose(x, y.to(x.dtype), rtol=rtol,
                                            atol=atol, equal_nan=equal_nan)),
                        device=x.device)


@entry
def equal_all(x, y, name=None):
    a, b = pair(x, y)
    if a.shape != b.shape:
        return torch.tensor(False, device=a.device)
    return torch.all(a == b)


@entry
def is_empty(x, name=None):
    x = as_t(x)
    return torch.tensor(x.numel() == 0, device=x.device)

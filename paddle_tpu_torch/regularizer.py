"""Weight-decay regularizers: ``L2Decay`` and ``L1Decay``.

Port of ``paddle_tpu/regularizer.py``. A regularizer contributes the
gradient term ``coeff * p`` (L2) or ``coeff * sign(p)`` (L1) in the
parameter's type, ``coeff`` rounded to it first (``jnp.asarray(coeff,
p.dtype)``); the static optimizers append that term to each gradient as
program ops (``static/optimizer.py``), the dygraph optimizers add it to
each gradient before the update (``optimizer/optimizer.py``), and
``__call__`` applies it to a tensor.
"""
from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L2Decay", "L1Decay",
           "L2DecayRegularizer", "L1DecayRegularizer", "in_type"]


def in_type(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: PyTorch then
    multiplies a tensor of that type by it in f32 and rounds once, as
    the JAX package's product of two values of that type does."""
    return float(torch.tensor(float(value), dtype=dtype).item())


class WeightDecayRegularizer:
    """Base class: contributes an additive gradient term."""

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def grad_term(self, p):
        raise NotImplementedError

    def __call__(self, grad, param):
        return grad + self.grad_term(param)

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self.coeff})"


class L2Decay(WeightDecayRegularizer):
    """loss += coeff/2 * ||p||^2, i.e. grad += coeff * p."""

    def grad_term(self, p):
        return p * in_type(self.coeff, p.dtype)


class L1Decay(WeightDecayRegularizer):
    """loss += coeff * ||p||_1, i.e. grad += coeff * sign(p)."""

    def grad_term(self, p):
        return torch.sign(p) * in_type(self.coeff, p.dtype)


L2DecayRegularizer = L2Decay
L1DecayRegularizer = L1Decay

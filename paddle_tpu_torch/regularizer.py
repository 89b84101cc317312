"""Weight-decay regularizers: ``L2Decay`` and ``L1Decay``.

Port of ``paddle_tpu/regularizer.py``. A regularizer contributes the
gradient term ``coeff * p`` (L2) or ``coeff * sign(p)`` (L1); the static
optimizers append that term to each gradient as program ops
(``static/optimizer.py``), and ``__call__`` applies it to a tensor.
"""
from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L2Decay", "L1Decay",
           "L2DecayRegularizer", "L1DecayRegularizer"]


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
        return self.coeff * p


class L1Decay(WeightDecayRegularizer):
    """loss += coeff * ||p||_1, i.e. grad += coeff * sign(p)."""

    def grad_term(self, p):
        return self.coeff * torch.sign(p)


L2DecayRegularizer = L2Decay
L1DecayRegularizer = L1Decay

"""Optimizers: ``Optimizer``, ``Momentum``, ``Adam`` and ``AdamW``.

Port of the dygraph path of ``paddle_tpu/optimizer/optimizer.py``
(``apply_gradients_fn`` with ``_fused_or_rule``): the step t starts at
1; Adam is the dygraph form ``p - lr*(m/c1) / (sqrt(v/c2) + eps)`` with
``c1 = 1 - b1**t`` and ``c2 = 1 - b2**t`` in f32
(``ops/pallas/fused_optimizer.py:586-595``); AdamW then applies the
decoupled decay ``p2 - lr*wd*p`` with the OLD p (``optimizer.py:133``).
Momentum (``optimizer.py:286-304``) keeps a ``velocity`` that starts
at zero: ``v2 = mu*v + g``, ``p2 = p - lr*v2``, or with Nesterov
``p - lr*(g + mu*v2)``. A float ``weight_decay`` on ``Momentum`` or
plain ``Adam`` is the coupled L2 term ``g + wd*p``, as the JAX package's
``L2Decay`` folds it.

The whole update is one ``ops.cuda.fused_optimizer`` call
(``fused_adam_`` or ``fused_momentum_``) over every parameter that has a
gradient: one kernel launch on CUDA, the plain version on the CPU.
Parameters and optimizer state are updated IN PLACE (the JAX update is
functional). Gradient clipping, regularizer objects,
``multi_precision`` master weights and the ``lr.py`` schedulers are
later slices.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ops.cuda.fused_optimizer import fused_adam_, fused_momentum_

__all__ = ["Optimizer", "Momentum", "Adam", "AdamW"]


class Optimizer:
    DECOUPLED_WD = False
    SLOTS = ()          # per-parameter state, zeros like the parameter

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is a later port slice")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers (lr.py) are a later port slice; "
                "pass a float")
        if weight_decay is not None and \
                not isinstance(weight_decay, (int, float)):
            raise NotImplementedError(
                "regularizer objects are a later port slice; pass a float "
                "weight_decay")
        self._learning_rate = float(learning_rate)
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._l2_coeff = float(weight_decay or 0.0)
        self._step_count = 0
        self._slots: Dict[int, dict] = {}
        self._kernel_cache: dict = {}

    def _params(self):
        if self._parameter_list is None:
            raise ValueError("Optimizer constructed without parameters; "
                             "pass parameters=model.parameters()")
        return [p for p in self._parameter_list if p.requires_grad]

    def get_lr(self) -> float:
        return self._learning_rate

    def clear_grad(self) -> None:
        """Drop the gradients (the next backward allocates fresh ones)."""
        for p in self._params():
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter that has a gradient."""
        live = [p for p in self._params() if p.grad is not None]
        if live:
            self._apply(live, [p.grad for p in live], self._step_count + 1)
        self._step_count += 1

    def _slot(self, p):
        s = self._slots.get(id(p))
        if s is None:
            s = self._slots[id(p)] = {k: torch.zeros_like(p)
                                      for k in self.SLOTS}
        return s

    def _coupled_grads(self, params, grads):
        """``g + wd*p`` for a float ``weight_decay`` (coupled L2)."""
        if self._l2_coeff and not self.DECOUPLED_WD:
            return [g + self._l2_coeff * p for g, p in zip(grads, params)]
        return grads

    def _apply(self, params, grads, t):
        raise NotImplementedError


class Momentum(Optimizer):
    SLOTS = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = bool(use_nesterov)

    def _apply(self, params, grads, t):
        slots = [self._slot(p) for p in params]
        fused_momentum_([p.detach() for p in params],
                        self._coupled_grads(params, grads),
                        [s["velocity"] for s in slots], lr=self.get_lr(),
                        momentum=self._momentum, nesterov=self._nesterov,
                        cache=self._kernel_cache)


class Adam(Optimizer):
    SLOTS = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _apply(self, params, grads, t):
        slots = [self._slot(p) for p in params]
        fused_adam_([p.detach() for p in params],
                    self._coupled_grads(params, grads),
                    [s["moment1"] for s in slots],
                    [s["moment2"] for s in slots],
                    lr=self.get_lr(), beta1=self._beta1, beta2=self._beta2,
                    eps=self._eps, step=t,
                    weight_decay=self._l2_coeff if self.DECOUPLED_WD else 0.0,
                    cache=self._kernel_cache)


class AdamW(Adam):
    DECOUPLED_WD = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip)

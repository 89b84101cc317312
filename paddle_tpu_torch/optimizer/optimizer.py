"""Optimizers: ``Optimizer``, ``SGD``, ``Momentum``, ``Adam``, ``AdamW``
and ``Lamb``.

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
``L2Decay`` folds it. SGD (``optimizer.py:281``) is ``p - lr*g``; its
coupled L2 term goes into the kernel, ``p - lr*(g + wd*p)``, rounded as
the JAX package's ``g + wd*p`` followed by the update.
Lamb (``optimizer.py:463-487``, the dygraph form of
``fused_try_rule``) keeps moment1/moment2 from zero and updates
``p - (lr*trust)*r`` with ``r = m_hat/(sqrt(v_hat) + eps) + wd*p`` and
``trust = |p|/|r|`` (1 where either norm is 0). Like the JAX rule, Lamb
decays EVERY parameter: ``exclude_from_weight_decay_fn`` is stored and
not applied.

``learning_rate`` is a float or an ``lr.LRScheduler``; ``get_lr()``
reads the scheduler's value, which the caller advances with
``scheduler.step()``. The value reaches the kernel as a host f32
argument each step (no host-to-device copy). ``grad_clip`` (an
``nn.clip`` object) clips the gradients first, then the coupled L2 term
is added (by the SGD kernel itself), in the order of
``apply_gradients_fn`` (``:102-104``).

The whole update is one ``ops.cuda.fused_optimizer`` call
(``fused_sgd_``, ``fused_momentum_``, ``fused_adam_`` or
``fused_lamb_``) over every parameter that has a gradient: one kernel
launch on CUDA (Lamb: two, phase 1 with its per-tensor norms, then the
apply), the plain version on the CPU. Parameters and optimizer state are updated IN
PLACE (the JAX update is functional). Regularizer objects and
``multi_precision`` master weights are later slices.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..nn.clip import ClipGradBase
from ..ops.cuda.fused_optimizer import (fused_adam_, fused_lamb_,
                                        fused_momentum_, fused_sgd_)
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Lamb"]


class Optimizer:
    DECOUPLED_WD = False
    SLOTS = ()          # per-parameter state, zeros like the parameter

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if grad_clip is not None and not isinstance(grad_clip,
                                                    ClipGradBase):
            raise TypeError(f"grad_clip must be an nn.clip object "
                            f"(ClipGradByGlobalNorm, ...), got "
                            f"{type(grad_clip).__name__}")
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"lr.LRScheduler, got "
                            f"{type(learning_rate).__name__}")
        if weight_decay is not None and \
                not isinstance(weight_decay, (int, float)):
            raise NotImplementedError(
                "regularizer objects are a later port slice; pass a float "
                "weight_decay")
        self._learning_rate = learning_rate \
            if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        self._grad_clip = grad_clip
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
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
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

    def _clipped(self, grads):
        """The gradients clipped by ``grad_clip`` (as they are without
        one)."""
        if self._grad_clip is not None:
            return self._grad_clip.apply_pytree(grads)
        return grads

    def _grads(self, params, grads):
        """The gradients the rule sees: clipped by ``grad_clip``, then
        ``g + wd*p`` for a float ``weight_decay`` (coupled L2)."""
        grads = self._clipped(grads)
        if self._l2_coeff and not self.DECOUPLED_WD:
            return [g + self._l2_coeff * p for g, p in zip(grads, params)]
        return grads

    def _apply(self, params, grads, t):
        raise NotImplementedError


class SGD(Optimizer):
    def _apply(self, params, grads, t):
        # the coupled L2 term is the kernel's: no g + wd*p tensors here;
        # on the card, what the last step's launches covered is kept
        self._last_launch = fused_sgd_(
            [p.detach() for p in params], self._clipped(grads),
            lr=self.get_lr(), weight_decay=self._l2_coeff)


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
                        self._grads(params, grads),
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
                    self._grads(params, grads),
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


class Lamb(Optimizer):
    SLOTS = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        # stored and not applied, as in the JAX rule (optimizer.py:471,
        # :483 decays every parameter)
        self._exclude_fn = exclude_from_weight_decay_fn
        # the trust-ratio numerator r of each parameter: f32 scratch the
        # kernels overwrite every step (not optimizer state)
        self._trust_r: Dict[int, torch.Tensor] = {}

    def _scratch(self, p):
        r = self._trust_r.get(id(p))
        if r is None:
            r = self._trust_r[id(p)] = torch.empty_like(p)
        return r

    def _apply(self, params, grads, t):
        slots = [self._slot(p) for p in params]
        fused_lamb_([p.detach() for p in params], self._grads(params, grads),
                    [s["moment1"] for s in slots],
                    [s["moment2"] for s in slots],
                    [self._scratch(p) for p in params], lr=self.get_lr(),
                    beta1=self._beta1, beta2=self._beta2, eps=self._eps,
                    weight_decay=self._lamb_wd, step=t,
                    cache=self._kernel_cache)

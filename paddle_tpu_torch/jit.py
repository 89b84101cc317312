"""``TrainStep``: forward, backward and optimizer update in one call.

Port of ``paddle_tpu/jit.py`` ``TrainStep`` (``:180``) for one device.
The JAX step is one compiled XLA program; here each call runs the three
phases eagerly on the model's device (CUDA launches are asynchronous,
so nothing waits for the card unless the caller reads the loss). The
model is kept in train mode. Dropout draws from a
:class:`framework.random.StepRNG` seeded by ``fold_in(seed, step)``,
the counterpart of ``jax.random.fold_in(make_key(seed), step)``
(``jit.py:300``), with ``step`` the optimizer's step count before the
update (0 on the first call). Its bits differ from JAX's. No
``torch.compile``; the ``mesh``, ZeRO and sequence-parallel arguments
are later slices.
"""
from __future__ import annotations

from typing import Callable

import torch

from .framework.random import StepRNG, fold_in, rng_scope

__all__ = ["TrainStep"]


class TrainStep:
    """``loss_fn(model, *batch)`` returns a scalar loss; each call
    trains one step and returns the detached loss."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 seed: int = 0):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._seed = int(seed)

    def __call__(self, *batch):
        model = self.model
        model.train()
        device = next(model.parameters()).device
        rng = StepRNG(fold_in(self._seed, self.optimizer._step_count),
                      device)
        self.optimizer.clear_grad()
        with rng_scope(rng):
            loss = self.loss_fn(model, *batch)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

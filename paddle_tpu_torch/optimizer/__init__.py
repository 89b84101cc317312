"""Optimizers of the port: ``Momentum`` over the fused Momentum kernel,
``Adam`` and ``AdamW`` over the fused Adam kernel
(``optimizer.optimizer``)."""
from .optimizer import Adam, AdamW, Momentum, Optimizer

__all__ = ["Optimizer", "Momentum", "Adam", "AdamW"]

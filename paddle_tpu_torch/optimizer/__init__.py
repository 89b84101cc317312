"""Optimizers of the port: ``Adam`` and ``AdamW`` over the fused Adam
kernel (``optimizer.optimizer``)."""
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Optimizer", "Adam", "AdamW"]

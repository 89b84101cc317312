"""Optimizers of the port (``optimizer.optimizer``): ``SGD``,
``Momentum``, ``Adam``, ``AdamW`` and ``Lamb``, each over its fused
kernel, and the learning-rate schedulers (``optimizer.lr``)."""
from . import lr
from .optimizer import SGD, Adam, AdamW, Lamb, Momentum, Optimizer

# reference-API aliases (paddle_tpu/optimizer/__init__.py)
SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdamOptimizer = Adam
LambOptimizer = Lamb

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Lamb", "lr",
           "SGDOptimizer", "MomentumOptimizer", "AdamOptimizer",
           "LambOptimizer"]

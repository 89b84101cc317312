"""Optimizers of the port (``optimizer.optimizer``): ``SGD``,
``Momentum``, ``Adam``, ``AdamW`` and ``Lamb``, each over its fused
kernel; ``Adamax``, ``Adagrad``, ``DecayedAdagrad``, ``Adadelta``,
``RMSProp``, ``Ftrl``, ``LarsMomentum`` and ``Dpsgd`` in tensor
operations; the meta-optimizers (``optimizer.meta``); and the
learning-rate schedulers (``optimizer.lr``)."""
from . import lr
from .meta import (EMA, DGCMomentum, GradientMergeOptimizer,
                   LocalSGDOptimizer, LookAhead, ModelAverage,
                   PipelineOptimizer, RecomputeOptimizer, recompute)
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        DecayedAdagrad, Dpsgd, Ftrl, Lamb, LarsMomentum,
                        Momentum, Optimizer, RMSProp)

# reference-API aliases (paddle_tpu/optimizer/__init__.py)
SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdamOptimizer = Adam
LambOptimizer = Lamb
AdamaxOptimizer = Adamax
AdagradOptimizer = Adagrad
DecayedAdagradOptimizer = DecayedAdagrad
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
FtrlOptimizer = Ftrl
LarsMomentumOptimizer = LarsMomentum
DpsgdOptimizer = Dpsgd
DGCMomentumOptimizer = DGCMomentum
LookaheadOptimizer = LookAhead
ExponentialMovingAverage = EMA

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Lamb",
           "Adamax", "Adagrad", "DecayedAdagrad", "Adadelta", "RMSProp",
           "Ftrl", "LarsMomentum", "Dpsgd", "GradientMergeOptimizer",
           "recompute", "RecomputeOptimizer", "LookAhead",
           "LocalSGDOptimizer", "DGCMomentum", "EMA", "ModelAverage",
           "PipelineOptimizer", "lr", "SGDOptimizer", "MomentumOptimizer",
           "AdamOptimizer", "LambOptimizer", "AdamaxOptimizer",
           "AdagradOptimizer", "DecayedAdagradOptimizer",
           "AdadeltaOptimizer", "RMSPropOptimizer", "FtrlOptimizer",
           "LarsMomentumOptimizer", "DpsgdOptimizer",
           "DGCMomentumOptimizer", "LookaheadOptimizer",
           "ExponentialMovingAverage"]

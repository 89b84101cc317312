"""``LayerList`` (port of ``paddle_tpu/nn/container.py``): sublayers
named ``0``, ``1``, ... as in the JAX package's state-dict keys."""
from __future__ import annotations

import torch

__all__ = ["LayerList"]


class LayerList(torch.nn.ModuleList):
    pass

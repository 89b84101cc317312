"""``LayerList`` and ``Sequential`` (port of
``paddle_tpu/nn/container.py``): sublayers named ``0``, ``1``, ... (or
by the keys of an ``OrderedDict``), as in the JAX package's state-dict
keys."""
from __future__ import annotations

import torch

__all__ = ["LayerList", "Sequential"]


class LayerList(torch.nn.ModuleList):
    pass


class Sequential(torch.nn.Sequential):
    pass

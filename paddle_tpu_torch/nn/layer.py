"""``Layer``: the port's module base, a :class:`torch.nn.Module` with the
JAX package's ``create_parameter``.

Port of the part of ``paddle_tpu/nn/layer.py`` BERT needs. Attribute
names follow the JAX layers, so ``state_dict()`` keys match the JAX
model's one to one (parameters of a layer first, then its sublayers',
as both frameworks walk them). Parameters are f32 and created on the
layer's device (``device=None`` means CUDA, via ``resolve_device``)
from an explicit :class:`torch.Generator` (default: the global
generator of that device, ``framework.random.seed``).
"""
from __future__ import annotations

import torch

from .._device import resolve_device
from ..framework.random import default_generator
from . import initializer as I

__all__ = ["Layer"]


class Layer(torch.nn.Module):
    """Module base. A layer with parameters takes ``device`` and
    ``generator`` in its constructor and hands them to
    :meth:`create_parameter`; neither is kept on the layer."""

    def create_parameter(self, shape, is_bias=False,
                         default_initializer=None, device=None,
                         generator=None):
        """A trainable f32 parameter on ``device`` (None: CUDA):
        ``default_initializer``, else zeros for a bias and
        Xavier-uniform otherwise (the JAX defaults), drawn from
        ``generator`` (None: the device's global generator)."""
        init = default_initializer or (I.Constant(0.0) if is_bias
                                       else I.XavierUniform())
        device = resolve_device(device)
        gen = generator if generator is not None \
            else default_generator(device)
        return torch.nn.Parameter(init(shape, device, gen))

"""``Layer``: the port's module base, a :class:`torch.nn.Module` with the
JAX package's ``create_parameter``; and :func:`load_numpy_state`, which
carries a JAX model's ``state_dict()`` (parameters and buffers) into a
port model by name.

Port of the part of ``paddle_tpu/nn/layer.py`` BERT needs. Attribute
names follow the JAX layers, so ``state_dict()`` keys match the JAX
model's one to one (parameters of a layer first, then its sublayers',
as both frameworks walk them). Parameters are f32 and created on the
layer's device (``device=None`` means CUDA, via ``resolve_device``)
from an explicit :class:`torch.Generator` (default: the global
generator of that device, ``framework.random.seed``).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..framework.random import default_generator
from . import initializer as I

__all__ = ["Layer", "load_numpy_state"]


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


def load_numpy_state(model: torch.nn.Module, state) -> None:
    """Copy ``{name: np.ndarray}`` (e.g. the JAX model's ``state_dict()``
    as numpy, parameters and buffers) into ``model`` by name. Raises on
    a missing key, an extra key or a shape mismatch; values are cast to
    each tensor's dtype."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"load_numpy_state: missing {missing[:8]}, extra "
                       f"{extra[:8]} ({len(missing)} missing, {len(extra)} "
                       f"extra)")
    for name, t in own.items():
        arr = np.asarray(state[name])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"load_numpy_state: {name} has shape "
                             f"{tuple(arr.shape)}, the model wants "
                             f"{tuple(t.shape)}")
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(torch.from_numpy(np.array(state[name])))

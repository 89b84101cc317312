"""Parameter initializers the port's layers default to.

Port of the part of ``paddle_tpu/nn/initializer.py`` that
``Layer.create_parameter`` reaches: ``Constant`` (biases, norm scales),
``XavierUniform`` (linear and embedding weights), ``KaimingUniform``
(convolution weights) and ``Uniform`` (convolution biases). Each is a
callable ``init(shape, device, generator) -> Tensor`` that draws from
an explicit :class:`torch.Generator`; the values differ from the JAX
package's (another generator), so parity tests copy weights across
(``models.bert.load_numpy_state``).
"""
from __future__ import annotations

import math

import torch

__all__ = ["Initializer", "Constant", "Uniform", "XavierUniform",
           "KaimingUniform", "fans"]


def fans(shape):
    """(fan_in, fan_out) as the JAX package computes them; a 2-D weight
    is (in, out)."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    """Base class: ``init(shape, device, generator) -> Tensor`` (a
    ``ParamAttr`` takes one as its ``initializer``)."""

    def __call__(self, shape, device, generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = float(value)

    def __call__(self, shape, device, generator=None):
        return torch.full(tuple(shape), self.value, dtype=torch.float32,
                          device=device)


class Uniform(Initializer):
    """U(low, high)."""

    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = float(low), float(high)

    def __call__(self, shape, device, generator=None):
        out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
        return out.uniform_(self.low, self.high, generator=generator)


class XavierUniform(Initializer):
    """U(-limit, limit), limit = gain * sqrt(6 / (fan_in + fan_out))."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, device, generator=None):
        fi, fo = fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
        return out.uniform_(-limit, limit, generator=generator)


class KaimingUniform(Initializer):
    """U(-limit, limit), limit = gain * sqrt(3 / fan_in) with the leaky
    ReLU gain sqrt(2 / (1 + negative_slope**2))."""

    def __init__(self, fan_in=None, negative_slope=0.0):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def __call__(self, shape, device, generator=None):
        fi = self.fan_in or fans(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, device, generator)

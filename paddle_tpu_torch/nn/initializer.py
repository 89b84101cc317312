"""Parameter initializers BERT's layers default to.

Port of the part of ``paddle_tpu/nn/initializer.py`` that
``Layer.create_parameter`` reaches for BERT: ``Constant`` (biases, norm
scales) and ``XavierUniform`` (linear and embedding weights). Each is a
callable ``init(shape, device, generator) -> Tensor`` that draws from
an explicit :class:`torch.Generator`; the values differ from the JAX
package's (another generator), so parity tests copy weights across
(``models.bert.load_numpy_state``).
"""
from __future__ import annotations

import math

import torch

__all__ = ["Constant", "XavierUniform", "fans"]


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


class Constant:
    def __init__(self, value=0.0):
        self.value = float(value)

    def __call__(self, shape, device, generator=None):
        return torch.full(tuple(shape), self.value, dtype=torch.float32,
                          device=device)


class XavierUniform:
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

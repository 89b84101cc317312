"""Initializer specs for static parameters.

Port of ``paddle_tpu/static/initializer.py``: an initializer resolves
to ``(op_type, attrs)``, the startup-program op that
``LayerHelper.create_parameter`` appends (``fill_constant``,
``uniform_random``, ``gaussian_random``, ``truncated_gaussian_random``
or ``assign_value``), with the JAX package's op types and attrs.
"""
from __future__ import annotations

import math


class Initializer:
    def resolve(self, shape, dtype, fan_hint):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def resolve(self, shape, dtype, fan_hint):
        return "fill_constant", {"shape": list(shape), "dtype": dtype,
                                 "value": float(self.value)}


class Normal(Initializer):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale

    def resolve(self, shape, dtype, fan_hint):
        return "gaussian_random", {"shape": list(shape), "dtype": dtype,
                                   "mean": self.loc, "std": self.scale}


class TruncatedNormal(Initializer):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale

    def resolve(self, shape, dtype, fan_hint):
        return "truncated_gaussian_random", {
            "shape": list(shape), "dtype": dtype, "mean": self.loc,
            "std": self.scale}


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def resolve(self, shape, dtype, fan_hint):
        return "uniform_random", {"shape": list(shape), "dtype": dtype,
                                  "min": self.low, "max": self.high}


def _fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


class Xavier(Initializer):
    """Glorot (reference initializer.py XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None):
        self.uniform = uniform
        self.fan_in, self.fan_out = fan_in, fan_out

    def resolve(self, shape, dtype, fan_hint):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return "uniform_random", {"shape": list(shape), "dtype": dtype,
                                      "min": -limit, "max": limit}
        std = math.sqrt(2.0 / (fi + fo))
        return "gaussian_random", {"shape": list(shape), "dtype": dtype,
                                   "mean": 0.0, "std": std}


class MSRA(Initializer):
    """Kaiming (reference initializer.py MSRAInitializer)."""

    def __init__(self, uniform=True, fan_in=None):
        self.uniform = uniform
        self.fan_in = fan_in

    def resolve(self, shape, dtype, fan_hint):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            return "uniform_random", {"shape": list(shape), "dtype": dtype,
                                      "min": -limit, "max": limit}
        std = math.sqrt(2.0 / fi)
        return "gaussian_random", {"shape": list(shape), "dtype": dtype,
                                   "mean": 0.0, "std": std}


class NumpyArrayInitializer(Initializer):
    """Initialize from a literal array (reference initializer.py
    NumpyArrayInitializer → assign_value op)."""

    def __init__(self, value):
        import numpy as np

        self.value = np.asarray(value)

    def resolve(self, shape, dtype, fan_hint):
        if tuple(self.value.shape) != tuple(shape):
            raise ValueError(
                f"NumpyArrayInitializer value shape {self.value.shape} "
                f"does not match parameter shape {tuple(shape)}")
        return "assign_value", {"shape": list(shape), "dtype": dtype,
                                "values": self.value.reshape(-1).tolist()}


class Bilinear(Initializer):
    """Bilinear upsampling kernel init for transposed convs (reference
    initializer.py BilinearInitializer); weight shape (C_out, C_in, H, W)."""

    def resolve(self, shape, dtype, fan_hint):
        import numpy as np

        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D weight")
        h, w = shape[2], shape[3]
        f_h, f_w = (h + 1) // 2, (w + 1) // 2
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        y = np.arange(h)[:, None]
        x = np.arange(w)[None, :]
        filt = ((1 - np.abs(y / f_h - c_h)) *
                (1 - np.abs(x / f_w - c_w))).astype(np.float64)
        # reference BilinearInitializer writes the filter into EVERY
        # (out, in) channel pair (initializer.py, np.tile over C_out*C_in)
        weight = np.tile(filt, (shape[0], shape[1], 1, 1))
        return "assign_value", {"shape": list(shape), "dtype": dtype,
                                "values": weight.reshape(-1).tolist()}


KaimingUniform = MSRA
XavierInitializer = Xavier
ConstantInitializer = Constant
NormalInitializer = Normal
UniformInitializer = Uniform
BilinearInitializer = Bilinear

_global_initializer = [None, None]   # [weight_init, bias_init]


def set_global_initializer(weight_init, bias_init=None):
    """Default initializer for parameters that do not specify one
    (reference initializer.py set_global_initializer). Pass None, None
    to reset."""
    _global_initializer[0] = weight_init
    _global_initializer[1] = bias_init


def resolve_initializer(initializer, shape, dtype, fan_hint=None):
    if initializer is None:
        initializer = _global_initializer[0] or Xavier()
    return initializer.resolve(shape, dtype, fan_hint)

"""``LayerNorm``, ``BatchNorm`` and ``BatchNorm2D`` (port of
``paddle_tpu/nn/norm.py``). LayerNorm's default epsilon is 1e-5, as
there: BERT's encoder layers build ``LayerNorm(d)`` with that default,
and only its embedding and MLM norms pass the configuration's 1e-12.
Batch norm keeps its running statistics in the persistable buffers
``_mean`` (zeros) and ``_variance`` (ones), so ``state_dict()`` keys
match the JAX layer's; ``momentum`` is Paddle's (0.9 keeps 90 % of the
old running value, see ``functional.batch_norm``). ``weight_attr``/
``bias_attr`` take what ``ParamAttr._to_attr`` takes; False drops the
parameter."""
from __future__ import annotations

import torch

from .._device import resolve_device
from . import functional as F
from . import initializer as I
from .layer import Layer

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm2D"]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, device=None, generator=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        kw = {"device": device, "generator": generator}
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0), **kw)
        self.bias = self.create_parameter(self._normalized_shape,
                                          attr=bias_attr, is_bias=True, **kw)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


class BatchNorm(Layer):
    """Normalises over every axis but the channel axis; train mode uses
    the batch's statistics and updates the running ones, eval mode uses
    the running ones."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None,
                 generator=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        kw = {"device": device, "generator": generator}
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0), **kw)
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True, **kw)
        device = resolve_device(device)
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}")


class BatchNorm2D(BatchNorm):
    pass

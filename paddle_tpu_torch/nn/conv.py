"""``Conv2D`` (port of ``paddle_tpu/nn/conv.py`` ``_ConvNd`` and
``Conv2D``). The weight is (C_out, C_in/groups, kh, kw), Kaiming-uniform
over fan_in = C_in/groups * kh * kw; the bias is U(-1/sqrt(fan_in),
1/sqrt(fan_in)), and ``bias_attr=False`` means no bias parameter;
``weight_attr``/``bias_attr`` take what ``ParamAttr._to_attr`` takes.
``padding_mode`` is accepted and not stored: the convolution pads with
zeros whatever the mode, as the JAX package's ``_ConvNd`` does
(``paddle_tpu/nn/conv.py:18-47``). ``data_format`` "NHWC" takes and
gives channel-last tensors, the weight's layout unchanged."""
from __future__ import annotations

import math

from . import functional as F
from . import initializer as I
from .layer import Layer

__all__ = ["Conv2D"]


class Conv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, generator=None):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = F._tuple_n(kernel_size, 2)
        self._stride = F._tuple_n(stride, 2)
        self._padding = padding
        self._dilation = F._tuple_n(dilation, 2)
        self._groups = groups
        self._data_format = data_format
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        kw = {"device": device, "generator": generator}
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups) + self._kernel_size,
            attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in), **kw)
        bound = 1.0 / math.sqrt(fan_in)
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound), **kw)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")

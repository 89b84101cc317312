"""``MaxPool2D`` and ``AdaptiveAvgPool2D`` (port of
``paddle_tpu/nn/pooling.py``). ``MaxPool2D`` stores ``return_mask`` and
``data_format`` and pools NCHW whatever they say, as the JAX layer does
(its ``forward`` hands the functional neither); ``AdaptiveAvgPool2D``
takes NCHW or NHWC."""
from __future__ import annotations

from . import functional as F
from .layer import Layer

__all__ = ["MaxPool2D", "AdaptiveAvgPool2D"]


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW"):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.return_mask = return_mask
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)

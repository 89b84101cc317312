"""``LayerNorm`` (port of ``paddle_tpu/nn/norm.py``). The default
epsilon is 1e-5, as there: BERT's encoder layers build ``LayerNorm(d)``
with that default, and only its embedding and MLM norms pass the
configuration's 1e-12."""
from __future__ import annotations

from . import functional as F
from . import initializer as I
from .layer import Layer

__all__ = ["LayerNorm"]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, device=None,
                 generator=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        kw = {"device": device, "generator": generator}
        self.weight = self.create_parameter(
            self._normalized_shape, default_initializer=I.Constant(1.0),
            **kw)
        self.bias = self.create_parameter(self._normalized_shape,
                                          is_bias=True, **kw)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")

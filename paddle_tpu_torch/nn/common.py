"""Common layers: ``Linear``, ``Embedding``, ``Dropout``, ``Tanh`` and
``ReLU`` (port of ``paddle_tpu/nn/common.py`` and the ``ReLU`` layer
``paddle_tpu/nn/__init__.py`` exports). ``weight_attr``/``bias_attr``
take what ``ParamAttr._to_attr`` takes; ``bias_attr=False`` drops the
bias."""
from __future__ import annotations

import torch

from . import functional as F
from . import initializer as I
from .layer import Layer

__all__ = ["Linear", "Embedding", "Dropout", "Tanh", "ReLU"]


class Linear(Layer):
    """y = x @ W + b, W: (in_features, out_features) (reference fc/mul
    op); the transpose of ``torch.nn.Linear``'s weight."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, device=None, generator=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        kw = {"device": device, "generator": generator}
        self.weight = self.create_parameter([in_features, out_features],
                                            attr=weight_attr, **kw)
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True, **kw)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(Layer):
    """Rows of a (num_embeddings, embedding_dim) table gathered by id
    (reference lookup_table_v2_op). ``padding_idx`` (a negative one
    counts from num_embeddings) names a row that starts at zero and
    whose lookups give zero and pass no gradient."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, device=None,
                 generator=None):
        super().__init__()
        self._padding_idx = None if padding_idx is None else (
            padding_idx if padding_idx >= 0
            else num_embeddings + padding_idx)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.XavierUniform(), device=device,
            generator=generator)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)


class Dropout(Layer):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout(x, p=self.p, training=self.training)


class Tanh(Layer):
    def forward(self, x):
        return F.tanh(x)


class ReLU(Layer):
    def forward(self, x):
        return F.relu(x)

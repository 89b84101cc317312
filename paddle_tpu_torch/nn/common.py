"""Common layers: ``Linear``, ``Embedding``, ``Dropout``, ``Tanh`` and
``ReLU`` (port of ``paddle_tpu/nn/common.py`` and the ``ReLU`` layer
``paddle_tpu/nn/__init__.py`` exports)."""
from __future__ import annotations

from . import functional as F
from . import initializer as I
from .layer import Layer

__all__ = ["Linear", "Embedding", "Dropout", "Tanh", "ReLU"]


class Linear(Layer):
    """y = x @ W + b, W: (in_features, out_features) (reference fc/mul
    op); the transpose of ``torch.nn.Linear``'s weight."""

    def __init__(self, in_features, out_features, device=None,
                 generator=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        kw = {"device": device, "generator": generator}
        self.weight = self.create_parameter([in_features, out_features],
                                            **kw)
        self.bias = self.create_parameter([out_features], is_bias=True,
                                          **kw)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, device=None,
                 generator=None):
        super().__init__()
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim],
            default_initializer=I.XavierUniform(), device=device,
            generator=generator)

    def forward(self, x):
        return F.embedding(x, self.weight)


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

"""The ``nn`` layers and functional ops BERT uses (port of the matching
part of ``paddle_tpu/nn``)."""
from . import functional, initializer
from .common import Dropout, Embedding, Linear, Tanh
from .container import LayerList
from .layer import Layer
from .norm import LayerNorm
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["functional", "initializer", "Layer", "Linear", "Embedding",
           "Dropout", "Tanh", "LayerNorm", "LayerList",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]

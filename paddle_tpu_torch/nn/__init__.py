"""The ``nn`` layers and functional ops of BERT and the vision models
(port of the matching part of ``paddle_tpu/nn``)."""
from . import functional, initializer
from .common import Dropout, Embedding, Linear, ReLU, Tanh
from .container import LayerList, Sequential
from .conv import Conv2D
from .layer import Layer
from .loss import CrossEntropyLoss
from .norm import BatchNorm, BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["functional", "initializer", "Layer", "Linear", "Embedding",
           "Dropout", "Tanh", "ReLU", "LayerNorm", "BatchNorm",
           "BatchNorm2D", "Conv2D", "MaxPool2D", "AdaptiveAvgPool2D",
           "CrossEntropyLoss", "LayerList", "Sequential",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]

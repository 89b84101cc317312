"""The ``nn`` layers and functional ops of BERT, GPT, the Transformer
NMT and the vision models, and gradient clipping (port of the matching
part of ``paddle_tpu/nn``)."""
from . import clip, functional, initializer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue, clip_grad_norm_)
from .common import Dropout, Embedding, Linear, ReLU, Tanh
from .container import LayerList, Sequential
from .conv import Conv2D
from .layer import Layer, ParamAttr, Parameter
from .loss import CrossEntropyLoss
from .norm import BatchNorm, BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["clip", "functional", "initializer", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm", "GradientClipByValue",
           "GradientClipByNorm", "GradientClipByGlobalNorm",
           "clip_grad_norm_", "Layer", "ParamAttr", "Parameter", "Linear", "Embedding",
           "Dropout", "Tanh", "ReLU", "LayerNorm", "BatchNorm",
           "BatchNorm2D", "Conv2D", "MaxPool2D", "AdaptiveAvgPool2D",
           "CrossEntropyLoss", "LayerList", "Sequential",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]

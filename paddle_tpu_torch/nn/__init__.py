"""``paddle.nn`` of the port: the paddle-style layers this slice ports,
their functionals and initializers, and gradient clipping."""

from . import functional, initializer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer.activation import GELU, ReLU, Tanh
from .layer.common import Dropout, Embedding, Linear
from .layer.layers import Layer, LayerList, ParameterList
from .layer.norm import LayerNorm
from .layer.transformer import (MultiHeadAttention, TransformerEncoder,
                                TransformerEncoderLayer)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Dropout", "Embedding", "GELU", "Layer", "LayerList",
           "LayerNorm", "Linear", "MultiHeadAttention", "ParameterList",
           "ReLU", "Tanh", "TransformerEncoder", "TransformerEncoderLayer",
           "clip_grad_norm_", "clip_grad_value_", "functional",
           "initializer"]

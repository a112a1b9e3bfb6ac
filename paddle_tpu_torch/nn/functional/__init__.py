"""``paddle.nn.functional``: the functionals this slice ports (the rest
is ROADMAP.md A10)."""

from .activation import gelu, relu, softmax, tanh
from .common import dropout, embedding, linear
from .flash_attention import flash_attention, scaled_dot_product_attention
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ["cross_entropy", "dropout", "embedding", "flash_attention",
           "gelu", "layer_norm", "linear", "relu",
           "scaled_dot_product_attention", "softmax", "tanh"]

"""``Linear``, ``Embedding`` and ``Dropout`` (port of the parts of
``paddle_tpu/nn/layer/common.py`` this slice runs)."""

from __future__ import annotations

import torch

from .. import functional as F
from ..functional.init_utils import param_attr_init
from ..initializer import Constant, Normal, XavierUniform
from .layers import Layer


class Linear(Layer):
    """y = xW + b, weight ``[in, out]`` (Paddle's layout)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = param_attr_init((in_features, out_features),
                                      self._dtype, weight_attr, False,
                                      XavierUniform())
        if bias_attr is not False:
            self.bias = param_attr_init((out_features,), self._dtype,
                                        bias_attr, True, Constant(0.0))
        else:
            self.bias = None

    def forward(self, input):
        return F.linear(input, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(Layer):
    """A ``[num_embeddings, embedding_dim]`` table, N(0, 1) unless
    ``weight_attr`` says otherwise; the ``padding_idx`` row starts at 0.
    ``sparse=True`` (SelectedRows gradients) is ROADMAP.md A4."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        if sparse:
            raise NotImplementedError(
                "Embedding(sparse=True) is not ported yet: ROADMAP.md A4 "
                "(SelectedRows gradients with lazy_mode)")
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = param_attr_init((num_embeddings, embedding_dim),
                                      self._dtype, weight_attr, False,
                                      Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight._data[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, input):
        return F.dropout(input, self.p, self.axis, self.training, self.mode)

    def extra_repr(self):
        return f"p={self.p}"


__all__ = ["Dropout", "Embedding", "Linear"]

"""``GELU``, ``Tanh`` and ``ReLU`` (port of the parts of
``paddle_tpu/nn/layer/activation.py`` this slice runs)."""

from __future__ import annotations

from .. import functional as F
from .layers import Layer


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self._approximate)


class Tanh(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


__all__ = ["GELU", "ReLU", "Tanh"]

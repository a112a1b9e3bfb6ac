"""``LayerNorm`` (port of ``paddle_tpu/nn/layer/norm.py``'s): unit weight,
zero bias, fp32 statistics (``functional.layer_norm``).  ``amp.decorate``
leaves its parameters in fp32 at O2."""

from __future__ import annotations

from .. import functional as F
from ..functional.init_utils import param_attr_init
from ..initializer import Constant
from .layers import Layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._normalized_shape = ((normalized_shape,)
                                  if isinstance(normalized_shape, int)
                                  else tuple(normalized_shape))
        self._epsilon = epsilon
        if weight_attr is not False:
            self.weight = param_attr_init(self._normalized_shape, self._dtype,
                                          weight_attr, False, Constant(1.0))
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = param_attr_init(self._normalized_shape, self._dtype,
                                        bias_attr, True, Constant(0.0))
        else:
            self.bias = None

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)


__all__ = ["LayerNorm"]

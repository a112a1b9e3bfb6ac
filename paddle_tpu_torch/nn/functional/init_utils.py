"""``ParamAttr`` and parameter creation shared by the layers (port of
``paddle_tpu/nn/functional/init_utils.py``)."""

from __future__ import annotations

from ...core import dtype as dtypes
from ...core.tensor import Parameter


class ParamAttr:
    """reference: python/paddle/base/param_attr.py ParamAttr."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


def param_attr_init(shape, dtype, attr, is_bias, default_initializer):
    """A new ``Parameter`` of ``shape``: the initializer of ``attr`` (a
    ``ParamAttr`` or a callable), else ``default_initializer``, else
    zeros for a bias and ``XavierUniform`` for a weight."""
    from ..initializer import Constant, XavierUniform

    shape = tuple(int(s) for s in shape)
    init, name, trainable = None, None, True
    if isinstance(attr, ParamAttr):
        init, name, trainable = attr.initializer, attr.name, attr.trainable
    elif callable(attr):
        init = attr
    if init is None:
        init = default_initializer
    if init is None:
        init = Constant(0.0) if is_bias else XavierUniform()
    p = Parameter(init(shape, dtypes.convert_dtype(dtype)), name=name,
                  trainable=trainable)
    if isinstance(attr, ParamAttr):
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
    return p

"""Initializers (port of ``paddle_tpu/nn/initializer``).

Each returns a ``torch.Tensor`` of ``shape`` and ``dtype`` on the default
device, drawn in fp32 from that device's default generator
(``tensor.random``) and then cast, as the JAX ones draw in fp32 and
cast.  Fans follow Paddle: ``fan_in = shape[0] * receptive``, ``fan_out
= shape[1] * receptive`` (a ``Linear`` weight is ``[in, out]``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core.tensor import Tensor, _to_torch
from ...device import default_device
from ...tensor.random import default_generator


def _normal(shape):
    dev = default_device()
    return torch.randn(shape, generator=default_generator(dev), device=dev)


def _uniform(shape, low, high):
    dev = default_device()
    u = torch.rand(shape, generator=default_generator(dev), device=dev)
    return u * (high - low) + low


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(shape, self.value, dtype=dtype,
                          device=default_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        return (self.mean + self.std * _normal(shape)).to(dtype)


class TruncatedNormal(Initializer):
    """N(mean, std) truncated to ``[a, b]`` (absolute bounds, as JAX
    takes them)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype):
        # inverse CDF of the standard normal between the bounds
        lo = (self.a - self.mean) / self.std
        hi = (self.b - self.mean) / self.std
        cdf = [0.5 * (1 + math.erf(x / math.sqrt(2))) for x in (lo, hi)]
        u = _uniform(shape, cdf[0], cdf[1])
        z = math.sqrt(2) * torch.erfinv(2 * u - 1)
        return (self.mean + self.std * z.clamp(lo, hi)).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        return _uniform(shape, self.low, self.high).to(dtype)


def _fans(shape):
    if len(shape) < 2:
        return shape[0] if shape else 1, shape[0] if shape else 1
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[0] * receptive, shape[1] * receptive


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return (std * _normal(shape)).to(dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, -limit, limit).to(dtype)


def _kaiming_gain(nonlinearity, negative_slope):
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return math.sqrt(2.0)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        std = _kaiming_gain(self.nonlinearity, self.negative_slope) \
            / math.sqrt(fi)
        return (std * _normal(shape)).to(dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        limit = _kaiming_gain(self.nonlinearity, self.negative_slope) \
            * math.sqrt(3.0 / fi)
        return _uniform(shape, -limit, limit).to(dtype)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype):
        v = self.value._data if isinstance(self.value, Tensor) else \
            _to_torch(self.value, device=default_device())
        return v.reshape(shape).to(dtype=dtype, device=default_device())


__all__ = ["Assign", "Constant", "Initializer", "KaimingNormal",
           "KaimingUniform", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform"]

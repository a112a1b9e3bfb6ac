"""Random sampling over explicit generators (port of
``paddle_tpu/tensor/random.py``).

The JAX module splits a process-global key chain; here each device has
one default ``torch.Generator`` (:func:`default_generator`), made on
first use and seeded from the last :func:`seed`, and every sampler,
initializer and dropout draws from the generator of its device.  torch's
global RNG is never used.  The streams differ from JAX's, so tests hold
sampled values by their distribution.
"""

from __future__ import annotations

import random as _pyrandom

import torch

from ..core import dtype as dtypes
from ..core.tensor import Tensor
from ..device import default_device

_GENERATORS: dict[torch.device, torch.Generator] = {}
#: the seed of the last ``seed()``; unseeded, each generator starts from a
#: fresh random seed, as the JAX default generator does
_SEED: list = [None]


def _key(device):
    dev = torch.device(device) if device is not None else default_device()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_generator(device=None) -> torch.Generator:
    """The default generator of ``device`` (default: the default
    device)."""
    dev = _key(device)
    gen = _GENERATORS.get(dev)
    if gen is None:
        gen = _GENERATORS[dev] = torch.Generator(device=dev)
        gen.manual_seed(_SEED[0] if _SEED[0] is not None
                        else _pyrandom.randrange(2 ** 31 - 1))
    return gen


def seed(value):
    """Reset every device's default generator to ``value``."""
    _SEED[0] = int(value)
    for gen in _GENERATORS.values():
        gen.manual_seed(_SEED[0])
    return default_generator()


def get_rng_state(device=None):
    """``[state]`` of the device's default generator."""
    return [Tensor._wrap(default_generator(device).get_state())]


def set_rng_state(state, device=None):
    s = state[0] if isinstance(state, (list, tuple)) else state
    default_generator(device).set_state(
        s._data if isinstance(s, Tensor) else s)


def _states():
    """Every made generator's state (``recompute`` restores them for its
    replay)."""
    return {dev: gen.get_state() for dev, gen in _GENERATORS.items()}


def _set_states(states):
    for dev, s in states.items():
        _GENERATORS[dev].set_state(s)


def _dt(dtype, default=torch.float32):
    d = dtypes.convert_dtype(dtype)
    return default if d is None else d


def _shape(shape):
    from .creation import _shape as s
    return s(shape)


def _draw(fn, shape, dtype, **kw):
    dev = default_device()
    return Tensor._wrap(fn(_shape(shape), generator=default_generator(dev),
                           device=dev, dtype=dtype, **kw))


def rand(shape, dtype=None, name=None):
    return _draw(torch.rand, shape, _dt(dtype))


def randn(shape, dtype=None, name=None):
    return _draw(torch.randn, shape, _dt(dtype))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    u = rand(shape, dtype)._data
    return Tensor._wrap(u * (max - min) + min)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """fp32 ``mean + std * N(0, 1)``; with tensor ``mean``/``std`` the
    shape is theirs, broadcast."""
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m = mean._data if isinstance(mean, Tensor) else mean
        s = std._data if isinstance(std, Tensor) else std
        dev = (m if isinstance(m, torch.Tensor) else s).device
        shp = torch.broadcast_shapes(torch.as_tensor(m).shape,
                                     torch.as_tensor(s).shape)
        z = torch.randn(shp, generator=default_generator(dev), device=dev)
        return Tensor._wrap(m + s * z)
    z = randn(shape if shape is not None else [])._data
    return Tensor._wrap(mean + std * z)


def randint(low=0, high=None, shape=[1], dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = default_device()
    return Tensor._wrap(torch.randint(
        low, high, _shape(shape), generator=default_generator(dev),
        device=dev, dtype=_dt(dtype, torch.int64)))


def bernoulli(x, name=None):
    """1 with probability ``x`` elementwise, in ``x``'s dtype."""
    d = x._data
    return Tensor._wrap(torch.bernoulli(
        d.float(), generator=default_generator(d.device)).to(d.dtype))


__all__ = ["bernoulli", "default_generator", "get_rng_state", "normal",
           "rand", "randint", "randn", "seed", "set_rng_state", "uniform"]

"""``Layer``, ``LayerList`` and ``ParameterList`` (port of
``paddle_tpu/nn/layer/layers.py``).

``Layer`` subclasses ``torch.nn.Module``.  Assigning a ``Parameter``
wrapper to an attribute registers its ``torch.nn.Parameter`` under the
same name (``_parameters``) and keeps the wrapper in the instance dict,
so ``layer.weight`` is the wrapper while ``torch.nn.Module``'s own
methods, CUDA graphs, ``torch.utils.checkpoint`` and the port's
optimizers and train step see plain torch parameters.  Sublayers are
torch submodules.  Paddle's API is on top: ``parameters()`` and
``named_parameters()`` (lists and generators of wrappers, torch's
order and names), ``sublayers``, ``state_dict``/``set_state_dict``
(Paddle's names and layout), ``train``/``eval``, forward pre/post hooks
(torch's), ``to(device, dtype)`` in place and ``create_parameter``.
Paddle-style buffers (``register_buffer`` with a ``Tensor``) are
ROADMAP.md A10: no layer of this slice has one.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ...core import dtype as dtypes
from ...core.tensor import Parameter, Tensor, _to_torch


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtypes.convert_dtype(dtype)

    # -- attribute plumbing --------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        if isinstance(value, torch.nn.Parameter):
            value = Parameter._from_torch(value, name)
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call super().__init__() first")
            self.__dict__.pop(name, None)
            self._modules.pop(name, None)
            self._buffers.pop(name, None)
            self.register_parameter(name, value._data)
            self.__dict__[name] = value
        elif params is not None and name in params:
            if value is None:
                del params[name]
                self.__dict__[name] = None
            elif isinstance(value, Tensor):
                self.__dict__[name].set_value(value)
            else:
                super().__setattr__(name, value)
        else:
            super().__setattr__(name, value)

    def __delattr__(self, name):
        self.__dict__.pop(name, None)
        if name in self._parameters or name in self._modules:
            super().__delattr__(name)

    # -- parameter creation ------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        from ..functional.init_utils import param_attr_init
        if attr is False:
            return None
        return param_attr_init(shape, dtypes.convert_dtype(dtype)
                               or self._dtype, attr, is_bias,
                               default_initializer)

    def add_parameter(self, name, parameter):
        setattr(self, name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    # -- iteration -----------------------------------------------------------
    def _walk(self, prefix, include_sublayers):
        """(qualified name, wrapper) of every parameter, each once,
        sublayer by sublayer in registration order."""
        seen = set()
        layers = (self.named_sublayers(prefix=prefix, include_self=True)
                  if include_sublayers else [(prefix, self)])
        for lname, lay in layers:
            for name, t in lay._parameters.items():
                if t is None or id(t) in seen:
                    continue
                seen.add(id(t))
                w = lay.__dict__.get(name)
                if not (isinstance(w, Parameter) and w._data is t):
                    w = Parameter._from_torch(t, name)
                yield (f"{lname}.{name}" if lname else name), w

    def parameters(self, include_sublayers=True):
        return [p for _, p in self._walk("", include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        """(name, ``Parameter``) pairs.  A call with torch's ``recurse``
        keyword (``torch.nn.Module.parameters(layer)`` makes one) gets
        torch's answer: (name, ``torch.nn.Parameter``)."""
        if recurse is not None:
            return torch.nn.Module.named_parameters(self, prefix, recurse,
                                                    remove_duplicate)
        return self._walk(prefix, include_sublayers)

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        if layers_set is None:
            layers_set = set()
        if id(self) in layers_set:
            return
        layers_set.add(id(self))
        if include_self:
            yield prefix, self
        for name, lay in self._modules.items():
            if lay is None:
                continue
            sub = f"{prefix}.{name}" if prefix else name
            if isinstance(lay, Layer):
                yield from lay.named_sublayers(prefix=sub, include_self=True,
                                               layers_set=layers_set)
            elif id(lay) not in layers_set:
                layers_set.add(id(lay))
                yield sub, lay

    # -- hooks ---------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``; a returned value replaces the
        outputs.  Returns a handle with ``remove()``."""
        return self.register_forward_hook(hook)

    # ``register_forward_pre_hook(hook)`` is torch's: ``hook(layer,
    # inputs)``, a returned value replaces the inputs, as in Paddle.

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    # -- state dict ----------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        """``{name: Parameter}`` (the wrappers themselves, not copies)."""
        dest = (destination if destination is not None
                else collections.OrderedDict())
        for name, p in self.named_parameters(
                include_sublayers=include_sublayers):
            dest[structured_name_prefix + name] = p
        return dest

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each entry (a ``Tensor``, ``torch.Tensor`` or numpy array,
        bf16 numpy included) into the parameter of that name, in place and
        cast to its dtype.  Returns ``(missing, unexpected)``; a shape
        mismatch raises ``ValueError``."""
        own = dict(self.named_parameters())
        unexpected = []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            tgt = own[k]._data
            val = v._data if isinstance(v, Tensor) else _to_torch(
                np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                device=tgt.device)
            if tuple(tgt.shape) != tuple(val.shape):
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{tuple(tgt.shape)} vs {tuple(val.shape)}")
            tgt.copy_(val)
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    def load_numpy_state(self, state):
        """Load the JAX model's ``{name: np.asarray(p._data)}`` (Paddle's
        names, such as ``bert.embeddings.word_embeddings.weight``); every
        name must match both ways."""
        missing, unexpected = self.set_state_dict(state)
        if missing or unexpected:
            raise KeyError(f"load_numpy_state: missing {missing}, "
                           f"unexpected {unexpected}")
        return self

    # -- dtype / device ------------------------------------------------------
    @torch.no_grad()
    def to(self, device=None, dtype=None, blocking=None):
        """Move every parameter to ``device`` and cast it to ``dtype``, in
        place: each parameter stays the same object."""
        from ...core.tensor import _device_of
        dev = _device_of(device)
        dt = dtypes.convert_dtype(dtype)
        for _, p in self.named_parameters():
            p._data.data = p._data.data.to(device=dev, dtype=dt)
        if dt is not None:
            for lay in self.sublayers(include_self=True):
                if isinstance(lay, Layer):
                    lay._dtype = dt
        return self

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    @property
    def dropout_generator(self):
        """The generator this layer's dropout draws from (the default
        generator of its parameters' device): a CUDA-graph capture
        registers it (``jit.CompiledTrainStep``)."""
        from ...tensor.random import default_generator
        p = next(iter(torch.nn.Module.parameters(self)), None)
        return default_generator(p.device if p is not None else None)


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, l in enumerate(sublayers):
                self.add_sublayer(str(i), l)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __setitem__(self, idx, layer):
        self.add_sublayer(list(self._modules)[idx], layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def extend(self, layers):
        for l in layers:
            self.append(l)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self.__dict__[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return (self.__dict__[n] for n in self._parameters)

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self


__all__ = ["Layer", "LayerList", "ParameterList"]

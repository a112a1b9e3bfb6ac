"""The eager ``Tensor`` and ``Parameter`` (port of
``paddle_tpu/core/tensor.py``).

A ``Tensor`` is a thin wrapper whose ``_data`` is a ``torch.Tensor``, as
the JAX one wraps a ``jax.Array``.  Autograd metadata lives on
``_data``: ``stop_gradient`` is the inverse of ``_data.requires_grad``
and ``.grad`` wraps ``_data.grad``.  A ``Parameter``'s ``_data`` is a
``torch.nn.Parameter``; its ``optimize_attr``, ``need_clip`` and
``regularizer`` live on that torch parameter too, so the optimizers and
clips, which work on torch parameters, read them.

Binary operators follow jnp's promotion where torch's differs: a Python
scalar is weak in both (bf16 × 2.0 stays bf16) and, as in jnp, is
rounded to a 16-bit tensor's dtype before the op; two tensors promote
by ``torch.promote_types`` whatever their ranks (a 0-d fp32 tensor
times a bf16 tensor is fp32, as in jnp; plain torch keeps bf16).
"""

from __future__ import annotations

import itertools
import numbers
import operator

import numpy as np
import torch

from . import dtype as dtypes
from .autograd import run_backward
from .dispatch import apply_op
from .selected_rows import (SelectedRows, grad_of, set_sparse_grad,
                            sparse_grad)

_names = itertools.count(1)


def _to_torch(data, dtype=None, device=None):
    """``data`` (a ``torch.Tensor``, numpy array, scalar or nested list) as
    a ``torch.Tensor``, with Paddle's defaults: float64 data becomes
    float32, Python ints int64; a new tensor lands on ``device`` or the
    default device (``device.default_device``)."""
    dt = dtypes.convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        if device is not None or dt is not None:
            data = data.to(device=device, dtype=dt)
        return data
    arr = np.asarray(data)
    if arr.dtype.name == "bfloat16":      # ml_dtypes: torch has no numpy bf16
        arr, dt = arr.astype(np.float32), dt or torch.bfloat16
    if dt is None and arr.dtype == np.float64:
        dt = torch.float32
    if device is None:
        from ..device import default_device
        device = default_device()
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:     # e.g. np.asarray of a jax.Array
        arr = arr.copy()
    return torch.as_tensor(arr, dtype=dt, device=device)


def _device_of(place):
    if place is None or isinstance(place, torch.device):
        return place
    name = str(place)
    return torch.device("cuda" + name[3:] if name.startswith("gpu")
                        else name)


def _promote(a, b):
    """Both tensors cast to their promoted dtype (jnp's rule for two
    arrays, whatever their ranks)."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) \
            and a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        return a.to(dt), b.to(dt)
    return a, b


def _binary(fn):
    return lambda a, b: fn(*_promote(a, b))


def weak_scalar(value, dtype):
    """A Python float as jnp takes it against a tensor of ``dtype``:
    rounded to that dtype first when it is a 16-bit float (bf16 × 0.9 is
    bf16 × bf16(0.9) in jnp; torch would multiply by 0.9 in fp32)."""
    if isinstance(value, float) and dtype in (torch.bfloat16, torch.float16):
        return torch.tensor(value, dtype=dtype).item()
    return value


class Tensor:
    """An eager tensor: ``_data`` is the ``torch.Tensor``."""

    persistable = False
    trainable = True

    def __init__(self, data, dtype=None, place=None, stop_gradient=True,
                 name=None):
        if isinstance(data, Tensor):
            data = data._data
        self._data = _to_torch(data, dtype, _device_of(place))
        self.name = name or f"generated_tensor_{next(_names)}"
        if not stop_gradient:
            self.stop_gradient = False

    @classmethod
    def _wrap(cls, data):
        t = cls.__new__(cls)
        t._data = data
        t.name = f"generated_tensor_{next(_names)}"
        return t

    # -- basic properties ----------------------------------------------------
    @property
    def data(self):
        return self

    @data.setter
    def data(self, value):
        self._data.data = value._data if isinstance(value, Tensor) else \
            _to_torch(value, device=self._data.device)

    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def ndim(self):
        return self._data.dim()

    def dim(self):
        return self._data.dim()

    @property
    def size(self):
        return self._data.numel()

    @property
    def place(self):
        return self._data.device

    @property
    def T(self):
        return apply_op("transpose",
                        lambda x: x.permute(*range(x.dim() - 1, -1, -1)),
                        self)

    @property
    def is_leaf(self):
        return self._data.is_leaf

    def numel(self):
        return Tensor._wrap(torch.tensor(self.size, dtype=torch.int64,
                                         device=self._data.device))

    # -- autograd metadata ---------------------------------------------------
    @property
    def stop_gradient(self):
        return not self._data.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        d = self._data
        if value and d.requires_grad:
            if d.is_leaf:
                d.requires_grad_(False)
            else:
                self._data = d.detach()
        elif not value and not d.requires_grad and (
                d.is_floating_point() or d.is_complex()):
            d.requires_grad_(True)

    @property
    def grad(self):
        """The gradient: a ``Tensor``, or the ``SelectedRows`` of a sparse
        embedding's table (merged to dense once a dense gradient met
        it)."""
        g = grad_of(self._data)
        return g if g is None or isinstance(g, SelectedRows) \
            else Tensor._wrap(g)

    @grad.setter
    def grad(self, value):
        if isinstance(value, SelectedRows):
            self._data.grad = None
            set_sparse_grad(self._data, value)
            return
        set_sparse_grad(self._data, None)
        self._data.grad = value._data if isinstance(value, Tensor) else value

    # -- conversion ----------------------------------------------------------
    def numpy(self):
        """A numpy copy; bf16 comes back as float32 (numpy has no bf16)."""
        d = self._data.detach().cpu()
        return (d.float() if d.dtype == torch.bfloat16 else d).numpy()

    def item(self, *idx):
        a = self.numpy()
        return a.item(*idx) if idx else a.item()

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def astype(self, dtype):
        dt = dtypes.convert_dtype(dtype)
        return apply_op("cast", lambda x: x.to(dt), self)

    cast = astype

    def clone(self):
        return apply_op("assign", torch.clone, self)

    def detach(self):
        return Tensor._wrap(self._data.detach())

    def detach_(self):
        self._data = self._data.detach()
        return self

    def cpu(self):
        return Tensor._wrap(self._data.cpu())

    def cuda(self, device_id=None, blocking=True):
        return Tensor._wrap(self._data.cuda(device_id))

    def to(self, *args, **kwargs):
        """``to(device)``, ``to(dtype)`` or both (``device=``,
        ``dtype=``); ``blocking`` is accepted and ignored."""
        device, dtype = kwargs.get("device"), kwargs.get("dtype")
        for a in args:
            if isinstance(a, torch.device) or (isinstance(a, str) and a.split(
                    ":")[0] in ("cpu", "gpu", "cuda")):
                device = a
            elif a is not None and not isinstance(a, bool):
                dtype = a
        out = self
        if device is not None:
            out = Tensor._wrap(self._data.to(_device_of(device)))
        return out.astype(dtype) if dtype is not None else out

    # -- autograd ------------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph=False):
        run_backward([self], [grad_tensor], retain_graph=retain_graph)

    def register_hook(self, hook):
        """``hook(grad)`` runs on this tensor's gradient in the backward;
        a returned tensor replaces it.  Returns a handle with
        ``remove()``."""
        def torch_hook(g):
            r = hook(Tensor._wrap(g))
            return r._data if isinstance(r, Tensor) else r
        return self._data.register_hook(torch_hook)

    def clear_gradient(self, set_to_zero=False):
        if set_to_zero and sparse_grad(self._data) is not None:
            # a SelectedRows gradient: its rows go, the dense zeros stay
            set_sparse_grad(self._data, None)
            self._data.grad = torch.zeros_like(self._data)
        elif set_to_zero and self._data.grad is not None:
            self._data.grad.zero_()
        else:
            set_sparse_grad(self._data, None)
            self._data.grad = None

    clear_grad = clear_gradient

    @torch.no_grad()
    def zero_(self):
        """Fill the tensor's data (not its gradient) with zeros."""
        self._data.zero_()
        return self

    @torch.no_grad()
    def set_value(self, value):
        """Copy ``value`` into this tensor in place, cast to its dtype
        (a ``Parameter`` stays the same torch parameter)."""
        src = value._data if isinstance(value, Tensor) else _to_torch(
            value, device=self._data.device)
        if tuple(src.shape) != tuple(self._data.shape):
            raise ValueError(f"set_value: shape {list(src.shape)} does not "
                             f"match {self.shape}")
        self._data.copy_(src)

    def _inplace_assign(self, out):
        """Rebind this tensor to ``out``'s value and graph."""
        self._data = out._data
        return self

    # -- operators -----------------------------------------------------------
    def _b(self, name, fn, other, reverse=False):
        if isinstance(other, np.generic):
            other = other.item()
        if isinstance(other, numbers.Number):
            other = weak_scalar(other, self._data.dtype)
            a, b = (other, self) if reverse else (self, other)
            return apply_op(name, fn, a, b)
        if not isinstance(other, Tensor):
            other = Tensor(other, place=self._data.device)
        a, b = (other, self) if reverse else (self, other)
        return apply_op(name, _binary(fn), a, b)

    def __add__(self, o):
        return self._b("add", operator.add, o)

    def __radd__(self, o):
        return self._b("add", operator.add, o, reverse=True)

    def __sub__(self, o):
        return self._b("subtract", operator.sub, o)

    def __rsub__(self, o):
        return self._b("subtract", operator.sub, o, reverse=True)

    def __mul__(self, o):
        return self._b("multiply", operator.mul, o)

    def __rmul__(self, o):
        return self._b("multiply", operator.mul, o, reverse=True)

    def __truediv__(self, o):
        return self._b("divide", operator.truediv, o)

    def __rtruediv__(self, o):
        return self._b("divide", operator.truediv, o, reverse=True)

    def __floordiv__(self, o):
        return self._b("floor_divide", operator.floordiv, o)

    def __mod__(self, o):
        return self._b("remainder", operator.mod, o)

    def __pow__(self, o):
        return self._b("pow", operator.pow, o)

    def __rpow__(self, o):
        return self._b("pow", operator.pow, o, reverse=True)

    def __matmul__(self, o):
        return self._b("matmul", operator.matmul, o)

    def __neg__(self):
        return apply_op("scale", torch.neg, self)

    def __abs__(self):
        return apply_op("abs", torch.abs, self)

    def __invert__(self):
        return apply_op("bitwise_not", torch.bitwise_not, self)

    def _cmp(self, fn, o):
        o = o._data if isinstance(o, Tensor) else o
        return Tensor._wrap(fn(self._data, o))

    def __lt__(self, o):
        return self._cmp(torch.lt, o)

    def __le__(self, o):
        return self._cmp(torch.le, o)

    def __gt__(self, o):
        return self._cmp(torch.gt, o)

    def __ge__(self, o):
        return self._cmp(torch.ge, o)

    def __eq__(self, o):
        if o is None:
            return False
        return self._cmp(torch.eq, o)

    def __ne__(self, o):
        if o is None:
            return True
        return self._cmp(torch.ne, o)

    def __hash__(self):
        return id(self)

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __bool__(self):
        return bool(self._data.detach())

    def __int__(self):
        return int(self._data.detach())

    def __float__(self):
        return float(self._data.detach())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- indexing ------------------------------------------------------------
    @staticmethod
    def _unwrap_index(idx):
        if isinstance(idx, Tensor):
            return idx._data
        if isinstance(idx, tuple):
            return tuple(Tensor._unwrap_index(i) for i in idx)
        return idx

    def __getitem__(self, idx):
        idx = Tensor._unwrap_index(idx)
        return apply_op("slice", lambda x: x[idx], self)

    def __setitem__(self, idx, value):
        idx = Tensor._unwrap_index(idx)
        if not isinstance(value, Tensor):
            value = Tensor(value, place=self._data.device)

        def set_value(x, v):
            y = x.clone()
            y[idx] = v.to(x.dtype)
            return y
        self._inplace_assign(apply_op("set_value", set_value, self, value))

    # -- repr ----------------------------------------------------------------
    def __repr__(self):
        return (f"Tensor(shape={self.shape}, dtype="
                f"{dtypes.dtype_name(self.dtype)}, place={self.place}, "
                f"stop_gradient={self.stop_gradient},\n"
                f"       {self.numpy()!r})")

    __str__ = __repr__

    # numpy priority so np scalar * Tensor routes here
    __array_priority__ = 100


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: on ``place``, else the default device."""
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)


def _on_param(attr, default):
    """A ``Parameter`` attribute kept on its torch parameter."""
    def get(self):
        return getattr(self._data, attr, default)

    def set_(self, value):
        setattr(self._data, attr, value)
    return property(get, set_)


class Parameter(Tensor):
    """A trainable tensor: ``_data`` is a ``torch.nn.Parameter``
    (``EagerParamBase``)."""

    persistable = True

    def __init__(self, data, dtype=None, name=None, trainable=True):
        super().__init__(data, dtype=dtype, name=name)
        d = self._data.detach()
        self._data = torch.nn.Parameter(
            d, requires_grad=trainable and d.is_floating_point())

    @classmethod
    def _from_torch(cls, param, name=None):
        """The wrapper of an existing torch parameter (no copy)."""
        p = cls._wrap(param)
        if name is not None:
            p.name = name
        return p

    @property
    def trainable(self):
        return self._data.requires_grad

    @trainable.setter
    def trainable(self, value):
        self._data.requires_grad_(bool(value))

    optimize_attr = _on_param("optimize_attr", {"learning_rate": 1.0})
    need_clip = _on_param("need_clip", True)
    regularizer = _on_param("regularizer", None)

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


def unwrap(x):
    """The ``torch.Tensor`` of a ``Tensor``; anything else as it is."""
    return x._data if isinstance(x, Tensor) else x

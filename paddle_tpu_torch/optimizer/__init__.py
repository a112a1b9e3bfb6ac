"""Optimizers (port of ``paddle_tpu/optimizer/__init__.py``: ``Optimizer``,
``Adam``, ``AdamW``; dense gradients only).

The update is the JAX package's formula in plain torch ops, step for
step: gradients cast to fp32, ``m = b1*m + (1-b1)*g``, ``v = b2*v +
(1-b2)*g*g``, per-parameter fp32 ``beta1_pow``/``beta2_pow``, ``mhat /
(sqrt(vhat) + eps)`` (``torch.optim.AdamW`` puts eps elsewhere), and
AdamW's decoupled ``master * (1 - lr*decay)``.  Under
``multi_precision=True`` a bf16 parameter gets an fp32 master, made from
the parameter at its first step; after each update the master is written
back into the parameter **in place**.

The JAX update is XLA with no Pallas kernel behind it, so no kernel is
owed here.  Learning-rate schedulers, gradient clipping, parameter
groups, per-parameter decay and lr ratios, and sparse (``SelectedRows``)
gradients are a later slice: ROADMAP.md A4.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from ..profiler import counters

_TODO = "is not ported yet: ROADMAP.md A4 (training: the rest of optimizer)"


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        if not isinstance(learning_rate, numbers.Real):
            raise NotImplementedError(f"a learning-rate scheduler {_TODO}")
        if grad_clip is not None:
            raise NotImplementedError(f"grad_clip {_TODO}")
        if parameters is None:
            raise ValueError("the optimizer needs parameters=")
        parameters = list(parameters)
        if any(isinstance(p, dict) for p in parameters):
            raise NotImplementedError(f"parameter groups {_TODO}")
        # (name, parameter) pairs, as ``model.named_parameters()`` gives
        # them, name the state_dict entries; bare tensors are param_<i>
        self._param_names = [p[0] if isinstance(p, tuple) else f"param_{i}"
                             for i, p in enumerate(parameters)]
        parameters = [p[1] if isinstance(p, tuple) else p
                      for p in parameters]
        if weight_decay is not None and not isinstance(weight_decay,
                                                       numbers.Real):
            raise NotImplementedError(f"a weight-decay regularizer {_TODO}")
        self._parameter_list = parameters
        self._learning_rate = float(learning_rate)
        self._multi_precision = multi_precision
        self._weight_decay = float(weight_decay or 0.0)
        self._accumulators: dict[str, dict[int, torch.Tensor]] = {}
        self._master_weights: dict[int, torch.Tensor] = {}
        self._step_count = 0

    # -- accumulators --------------------------------------------------------
    def _acc(self, name, p, init=None):
        store = self._accumulators.setdefault(name, {})
        if id(p) not in store:
            store[id(p)] = (torch.zeros_like(self._master(p)) if init is None
                            else init)
        return store[id(p)]

    def _set_acc(self, name, p, value):
        self._accumulators[name][id(p)] = value

    def _uses_master(self, p):
        return self._multi_precision and p.dtype != torch.float32

    def _master(self, p):
        """fp32 master weight of a low-precision parameter (the parameter
        itself otherwise)."""
        if not self._uses_master(p):
            return p.detach()
        if id(p) not in self._master_weights:
            self._master_weights[id(p)] = p.detach().float()
        return self._master_weights[id(p)]

    def _write_back(self, p, new_master):
        if self._uses_master(p):
            self._master_weights[id(p)] = new_master
        p.detach().copy_(new_master)

    # -- step ----------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        counters.inc("optimizer.steps")
        self._step_count += 1
        for p in self._parameter_list:
            if p.grad is None:
                continue
            g = p.grad
            self._update_param(p, g.float() if self._multi_precision else g)

    def _update_param(self, p, g):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.grad = None

    # -- state dict ----------------------------------------------------------
    def _names(self):
        return {id(p): n for p, n in zip(self._parameter_list,
                                         self._param_names)}

    def state_dict(self):
        """``{"master_weights": {name: t}, "accumulators": {acc: {name:
        t}}, "step": n, "LR_Scheduler": {}}`` — the JAX layout, keyed by
        parameter name, holding the optimizer's own tensors."""
        names = self._names()
        return {
            "master_weights": {names[pid]: v
                               for pid, v in self._master_weights.items()},
            "LR_Scheduler": {},
            "accumulators": {acc: {names[pid]: v for pid, v in store.items()}
                             for acc, store in self._accumulators.items()},
            "step": self._step_count,
        }

    def set_state_dict(self, state):
        """Copy a :meth:`state_dict` (tensors or numpy arrays) onto the
        parameters' devices; unknown names are ignored, as in JAX."""
        by_name = dict(zip(self._param_names, self._parameter_list))

        def tensor(v, p):
            if isinstance(v, torch.Tensor):
                return v.detach().to(p.device, copy=True)
            arr = np.asarray(v)
            if arr.dtype.name == "bfloat16":   # numpy has no bf16 of its own
                arr = arr.astype(np.float32)
            return torch.from_numpy(np.array(arr)).to(p.device)

        self._step_count = int(state.get("step", 0))
        for acc, store in state.get("accumulators", {}).items():
            dst = self._accumulators.setdefault(acc, {})
            for name, v in store.items():
                if name in by_name:
                    dst[id(by_name[name])] = tensor(v, by_name[name])
        for name, v in state.get("master_weights", {}).items():
            if name in by_name:
                self._master_weights[id(by_name[name])] = tensor(
                    v, by_name[name])

    def load_numpy_state(self, jax_state, names):
        """Resume from the JAX optimizer's ``state_dict()``.  JAX keys its
        entries by generated parameter names (``generated_tensor_<n>``, in
        insertion order, not parameter order), so ``names`` maps each JAX
        name to this optimizer's parameter name.  With the optimizer
        built on ``model.named_parameters()``, build it from the JAX model
        as ``{p.name: attr for attr, p in jm.named_parameters()}``.  Every
        JAX name in the state must be mapped."""
        def rename(store):
            unknown = sorted(set(store) - set(names))
            if unknown:
                raise KeyError(f"load_numpy_state: JAX names {unknown} are "
                               "not in names")
            return {names[k]: v for k, v in store.items()}

        self.set_state_dict({
            "step": jax_state.get("step", 0),
            "master_weights": rename(jax_state.get("master_weights", {})),
            "accumulators": {acc: rename(store) for acc, store in
                             jax_state.get("accumulators", {}).items()},
        })


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        if lazy_mode or amsgrad:
            raise NotImplementedError(f"lazy_mode/amsgrad {_TODO}")
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _moments(self, p, g):
        one = torch.ones((), dtype=torch.float32, device=p.device)
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        b1p = self._acc("beta1_pow", p, one)
        b2p = self._acc("beta2_pow", p, one.clone())
        m = self._beta1 * m + (1 - self._beta1) * g
        v = self._beta2 * v + (1 - self._beta2) * g * g
        b1p = b1p * self._beta1
        b2p = b2p * self._beta2
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        self._set_acc("beta1_pow", p, b1p)
        self._set_acc("beta2_pow", p, b2p)
        return m / (1 - b1p), v / (1 - b2p)

    def _update_param(self, p, g):
        master = self._master(p)
        if self._weight_decay:  # Adam: L2 into the gradient
            g = g + self._weight_decay * master
        mhat, vhat = self._moments(p, g)
        self._write_back(p, master - self._learning_rate * mhat
                         / (torch.sqrt(vhat) + self._eps))


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 amsgrad=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad)
        if not isinstance(weight_decay, numbers.Real):
            raise NotImplementedError(f"a weight-decay regularizer {_TODO}")
        self._wd = float(weight_decay)

    def _update_param(self, p, g):
        master = self._master(p)
        lr = self._learning_rate
        mhat, vhat = self._moments(p, g)
        self._write_back(p, master * (1 - lr * self._wd)
                         - lr * mhat / (torch.sqrt(vhat) + self._eps))


__all__ = ["Optimizer", "Adam", "AdamW"]

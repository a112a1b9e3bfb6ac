"""Optimizers (port of ``paddle_tpu/optimizer/__init__.py``).

Each update is the JAX package's formula in plain torch ops, step for
step and in the same order of operations: gradients cast to fp32 under
``multi_precision``, per-parameter fp32 accumulators (Adam's
``beta1_pow``/``beta2_pow`` included), AdamW's decoupled ``master * (1
- lr*decay)``.  A 16-bit parameter gets an fp32 master, made from the
parameter at its first step and written back into it after each update.

Every accumulator and master is updated **in place**, so the tensors a
captured CUDA graph writes are the ones the optimizer holds
(``jit.CompiledTrainStep`` replays the step body as a graph).  For the
same reason the learning rate is a 0-d fp32 device tensor per parameter
group, filled before the update: from ``get_lr()`` by :meth:`step`, from
a device vector by a fused window; and the step count the updates read
(NAdam's and RAdam's bias corrections) is a 0-d device tensor counted up
in place.  A step reads nothing back to the host.

``learning_rate`` is a float or an ``lr.LRScheduler``; ``grad_clip`` a
clip object of ``nn.clip``; ``weight_decay`` a float or an
``L2Decay``/``L1Decay`` (whose coefficient enters the gradient as the
JAX package adds it, ``g + coeff * w``, for both).  ``parameters`` is a
list of tensors or ``(name, tensor)`` pairs (torch parameters or the
paddle-style ``Parameter``s of ``Layer.parameters()``, whose torch
parameters the optimizer keeps), or of groups ``{"params":
[...], "learning_rate": factor, "weight_decay": coeff}``: Paddle scales
a group's lr by its factor and gives its parameters its decay (the JAX
package reads neither key).

Sparse (``SelectedRows``) gradients, from ``nn.Embedding(sparse=True)``:
:meth:`Optimizer.step` routes them through a clip that handles them
(``ClipGradByGlobalNorm``) or past one that does not, with the JAX
package's ``RuntimeWarning``, and then to ``_update_param_sparse``,
which densifies and runs the dense rule unless the class has a row-wise
one: SGD's, and Adam's and AdamW's ``lazy_mode`` (untouched rows keep
their moments, the beta powers advance for the whole table, AdamW
decays the touched rows only; ``amsgrad`` densifies).

``LBFGS`` computes what the JAX class computes: one two-loop-recursion
step of length ``lr`` per ``step(closure)``, with no line search.

The JAX update is XLA with no Pallas kernel behind it, so no kernel is
owed here.
"""

from __future__ import annotations

import numbers
import warnings

import numpy as np
import torch

from ..core.selected_rows import SelectedRows, grad_of, set_sparse_grad
from ..core.tensor import unwrap
from ..profiler import counters
from . import lr
from .lr import LRScheduler

_GROUP_KEYS = {"params", "learning_rate", "weight_decay"}


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = coeff


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = coeff


def _coeff(weight_decay, default=0.0):
    """A decay's coefficient: a number as it is, a regularizer's
    ``_coeff``, ``default`` for anything else (the JAX rule)."""
    if isinstance(weight_decay, numbers.Real):
        return float(weight_decay)
    return float(getattr(weight_decay, "_coeff",
                         getattr(weight_decay, "coeff", default)))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        if parameters is None:
            raise ValueError("the optimizer needs parameters=")
        if not isinstance(learning_rate, (numbers.Real, LRScheduler)):
            raise TypeError(f"learning_rate must be a number or an "
                            f"LRScheduler, got {type(learning_rate)}")
        parameters = list(parameters)
        groups = (parameters if parameters and isinstance(parameters[0], dict)
                  else [{"params": parameters}])
        self._param_groups, self._parameter_list = [], []
        self._param_names, self._group_of = [], {}
        for gi, group in enumerate(groups):
            unknown = sorted(set(group) - _GROUP_KEYS)
            if unknown:
                raise ValueError(f"parameter group keys {unknown}: the port "
                                 f"reads {sorted(_GROUP_KEYS)}")
            params = []
            for item in group["params"]:
                # (name, parameter) pairs, as model.named_parameters()
                # gives them, name the state_dict entries; bare tensors
                # are param_<i>
                name_, p = item if isinstance(item, tuple) else (None, item)
                p = unwrap(p)   # a Layer's Parameter: its torch parameter
                self._param_names.append(
                    name_ or f"param_{len(self._parameter_list)}")
                self._parameter_list.append(p)
                self._group_of[id(p)] = gi
                params.append(p)
            self._param_groups.append({**group, "params": params})
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._weight_decay = _coeff(weight_decay)
        self._accumulators: dict[str, dict[int, torch.Tensor]] = {}
        self._master_weights: dict[int, torch.Tensor] = {}
        self._step_count = 0
        #: parameters whose update this rank makes on a slice only (the
        #: mesh train step's storage sharding): ``id -> view function``
        #: of the slice, and that slice's gradient for the next update
        self._shard_views = {}
        self._shard_grads = {}
        #: the same parameters' storage specs over ``_shard_mesh``
        #: (:meth:`state_dict` gathers their slices whole)
        self._shard_specs = {}
        self._shard_mesh = None
        dev = (self._parameter_list[0].device if self._parameter_list
               else torch.device("cpu"))
        #: one 0-d fp32 lr a group (its factor applied), on the device
        self._lr_tensors = [torch.zeros((), dtype=torch.float32, device=dev)
                            for _ in self._param_groups]
        #: ``_step_count`` on the device, in float64 so that the bias
        #: corrections computed from it are the Python floats JAX uses
        self._step_t = torch.zeros((), dtype=torch.float64, device=dev)

    # -- lr ------------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = value

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    def _peek_lrs(self, k):
        """The lr values (host floats) of the next ``k`` steps, read
        without stepping the scheduler (``LRScheduler.peek``); a constant
        lr repeats."""
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate.peek(k)
        return [float(self._learning_rate)] * int(k)

    def _fill_lr(self, value):
        """Set every group's lr tensor from a host float."""
        for t, g in zip(self._lr_tensors, self._param_groups):
            t.fill_(float(value))
            if g.get("learning_rate", 1.0) != 1.0:
                t.mul_(g["learning_rate"])

    def _load_lr(self, src):
        """Set every group's lr tensor from a 0-d device tensor (graph
        safe: no host value is baked in)."""
        for t, g in zip(self._lr_tensors, self._param_groups):
            t.copy_(src)
            if g.get("learning_rate", 1.0) != 1.0:
                t.mul_(g["learning_rate"])

    def _zero_lr_where(self, found):
        for t in self._lr_tensors:
            t.copy_(torch.where(found, torch.zeros_like(t), t))

    def _param_lr(self, p):
        return getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)

    def _lr_of(self, p):
        """The lr tensor of ``p``: its group's, times its own factor."""
        t = self._lr_tensors[self._group_of[id(p)]]
        f = self._param_lr(p)
        return t if f == 1.0 else t * f

    def _decay(self, p, default):
        group = self._param_groups[self._group_of[id(p)]]
        if "weight_decay" in group:
            return _coeff(group["weight_decay"])
        return default

    # -- accumulators --------------------------------------------------------
    def _acc(self, name, p, init=None):
        """Accumulator ``name`` of ``p`` (created at first use, zeros like
        the master unless ``init`` is given); updated in place."""
        store = self._accumulators.setdefault(name, {})
        if id(p) not in store:
            store[id(p)] = (torch.zeros_like(self._master(p)) if init is None
                            else init)
        return store[id(p)]

    def _uses_master(self, p):
        return self._multi_precision and p.dtype != torch.float32

    def _view(self, p):
        """What an update of ``p`` writes: the parameter, or the view of
        this rank's slice of it when its state is sharded."""
        view = self._shard_views.get(id(p))
        return p.detach() if view is None else view(p.detach())

    def _master(self, p):
        """fp32 master weight of a low-precision parameter (the parameter
        itself otherwise, so in-place updates land in it); this rank's
        slice of either when its state is sharded."""
        if not self._uses_master(p):
            return self._view(p)
        if id(p) not in self._master_weights:
            self._master_weights[id(p)] = self._view(p).float()
        return self._master_weights[id(p)]

    def _write_back(self, p, master):
        if self._uses_master(p):
            self._view(p).copy_(master)

    def _state_of(self, p):
        """Every tensor an update of ``p`` writes that exists now."""
        out = [p.detach()]
        if id(p) in self._master_weights:
            out.append(self._master_weights[id(p)])
        out.extend(store[id(p)] for store in self._accumulators.values()
                   if id(p) in store)
        return out

    # -- step ----------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        self._fill_lr(self.get_lr())
        self._apply()

    @torch.no_grad()
    def _apply(self, found=None, sq=None):
        """Clip and update with the lr tensors as they are.  With
        ``found`` (a 0-d bool device tensor: a GradScaler overflow), every
        tensor that existed before the update keeps its old value where
        ``found`` is true (the JAX ``_skip_select``).  ``sq``: the
        gradients' sums of squares for the clip (``nn.clip``), when the
        caller has them."""
        counters.inc("optimizer.steps")
        pg = [(p, g) for p, g in ((p, self._shard_grads[id(p)]
                                   if id(p) in self._shard_grads
                                   else grad_of(p))
                                  for p in self._parameter_list
                                  if p.requires_grad) if g is not None]
        if self._grad_clip is not None:
            pg = self._clip(pg, sq)
        self._step_count += 1
        self._step_t.add_(1)
        for p, g in pg:
            if isinstance(g, SelectedRows):
                self._update_param_sparse(p, g)
                continue
            g = g.float() if self._multi_precision else g
            if found is None:
                self._update_param(p, g)
                continue
            old = [(t, t.clone()) for t in self._state_of(p)]
            self._update_param(p, g)
            for t, before in old:
                t.copy_(torch.where(found, before, t))

    def _clip(self, pg, sq):
        """The clip's pairs.  A clip that does not handle SelectedRows gets
        the dense pairs only; the sparse ones bypass it, warned (JAX)."""
        clip = self._grad_clip
        if getattr(clip, "_handles_selected_rows", False):
            return list(clip(pg) if sq is None else clip(pg, sq))
        dense = [(p, g) for p, g in pg if not isinstance(g, SelectedRows)]
        sparse = [(p, g) for p, g in pg if isinstance(g, SelectedRows)]
        if sparse:
            warnings.warn(
                f"{type(clip).__name__} does not support SelectedRows "
                f"gradients; {len(sparse)} sparse grad(s) bypass clipping",
                RuntimeWarning, stacklevel=3)
        return list(clip(dense) if sq is None else clip(dense, sq)) + sparse

    def _update_param(self, p, g):
        raise NotImplementedError

    def _update_param_sparse(self, p, sr):
        """A SelectedRows gradient.  Default: densify and run the dense
        rule (numerically a dense gradient).  Classes with a row-wise rule
        override it (SGD; Adam's and AdamW's lazy_mode)."""
        g = sr.to_dense()
        self._update_param(p, g.float() if self._multi_precision
                           else g.to(p.dtype))

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.grad = None
            set_sparse_grad(p, None)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    # -- state dict ----------------------------------------------------------
    def _names(self):
        return {id(p): n for p, n in zip(self._parameter_list,
                                         self._param_names)}

    def _whole(self, p, v):
        """A copy of state tensor ``v`` of parameter ``p`` as a whole
        tensor: a storage slice (the mesh step's sharded state) gathered
        from every rank's, anything else cloned."""
        spec = self._shard_specs.get(id(p))
        if spec is None or tuple(v.shape) != tuple(self._view(p).shape):
            return v.detach().clone()    # whole, or a per-parameter scalar
        from ..distributed.sharding_utils import gather_shard
        return gather_shard(v.detach(), spec, self._shard_mesh)

    def state_dict(self):
        """The JAX layout ``{"master_weights": {name: t}, "accumulators":
        {acc: {name: t}}, "step": n, "LR_Scheduler": {...}}``, keyed by
        parameter name, plus ``"lr"``: the group lr tensors.  Tensors are
        whole copies, as JAX's are: the optimizer goes on updating its own
        in place, and a mesh step's storage-sharded state is gathered from
        every rank's slice (so every rank of the mesh calls)."""
        names = self._names()
        params = {id(p): p for p in self._parameter_list}
        sched = self._learning_rate
        return {
            "master_weights": {names[pid]: self._whole(params[pid], v)
                               for pid, v in self._master_weights.items()},
            "LR_Scheduler": (sched.state_dict()
                             if isinstance(sched, LRScheduler) else {}),
            "accumulators": {acc: {names[pid]: self._whole(params[pid], v)
                                   for pid, v in store.items()}
                             for acc, store in self._accumulators.items()},
            "step": self._step_count,
            "lr": [t.clone() for t in self._lr_tensors],
        }

    def set_state_dict(self, state):
        """Load a :meth:`state_dict` (tensors or numpy arrays); unknown
        names are ignored, as in JAX.  A tensor the optimizer already
        holds is overwritten in place, so a captured train step keeps
        writing the tensors the optimizer reads.  Where a mesh step
        shards a parameter's state, a whole tensor is cut to this rank's
        slice (a tensor of the slice's shape is taken as it is)."""
        by_name = dict(zip(self._param_names, self._parameter_list))

        def put(store, key, v, p):
            if isinstance(v, torch.Tensor):
                src = v.detach()
            else:
                arr = np.asarray(v)
                if arr.dtype.name == "bfloat16":  # numpy has no bf16
                    arr = arr.astype(np.float32)
                src = torch.from_numpy(np.array(arr))
            view = self._shard_views.get(id(p))
            if (view is not None and tuple(src.shape) == tuple(p.shape)
                    and tuple(view(p.detach()).shape) != tuple(p.shape)):
                src = view(src.to(p.device)).contiguous()
            if key in store:
                store[key].copy_(src)
            else:
                store[key] = src.to(p.device, copy=True)

        self._step_count = int(state.get("step", 0))
        self._step_t.fill_(self._step_count)
        for acc, store in state.get("accumulators", {}).items():
            dst = self._accumulators.setdefault(acc, {})
            for name, v in store.items():
                if name in by_name:
                    put(dst, id(by_name[name]), v, by_name[name])
        for name, v in state.get("master_weights", {}).items():
            if name in by_name:
                put(self._master_weights, id(by_name[name]), v,
                    by_name[name])
        sched = self._learning_rate
        if isinstance(sched, LRScheduler) and state.get("LR_Scheduler"):
            sched.set_state_dict(state["LR_Scheduler"])
        for t, v in zip(self._lr_tensors, state.get("lr", ())):
            t.copy_(torch.as_tensor(v, dtype=torch.float32))

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
            "LR_Scheduler": jax_state.get("LR_Scheduler", {}),
        })


def _one(p):
    return torch.ones((), dtype=torch.float32, device=p.device)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    def _update_param(self, p, g):
        m = self._master(p)
        wd = self._decay(p, self._weight_decay)
        if wd:
            g = g + wd * m
        m.sub_(self._lr_of(p) * g)
        self._write_back(p, m)

    def _update_param_sparse(self, p, sr):
        """Row-wise SGD: only the gradient's rows move (duplicates add up);
        no weight decay, as the reference's sparse SGD (decay would make
        the update dense)."""
        m = self._master(p)
        m.index_add_(0, sr.rows, sr.values.to(m.dtype) * -self._lr_of(p))
        self._write_back(p, m)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update_param(self, p, g):
        m = self._master(p)
        wd = self._decay(p, self._weight_decay)
        if wd:
            g = g + wd * m
        vel = self._acc("velocity", p)
        vel.mul_(self._momentum).add_(g)
        upd = (g + self._momentum * vel) if self._nesterov else vel
        m.sub_(self._lr_of(p) * upd)
        self._write_back(p, m)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._amsgrad = amsgrad
        self._lazy_mode = lazy_mode

    def _moments(self, p, g):
        b1, b2 = self._beta1, self._beta2
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        b1p = self._acc("beta1_pow", p, _one(p))
        b2p = self._acc("beta2_pow", p, _one(p))
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        b1p.mul_(b1)
        b2p.mul_(b2)
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        if self._amsgrad:
            vmax = self._acc("moment2_max", p)
            torch.maximum(vmax, vhat, out=vmax)
            vhat = vmax
        return mhat, vhat

    def _update_param(self, p, g):
        master = self._master(p)
        wd = self._decay(p, self._weight_decay)
        if wd:  # Adam: L2 into the gradient
            g = g + wd * master
        mhat, vhat = self._moments(p, g)
        master.sub_(self._lr_of(p) * mhat / (torch.sqrt(vhat) + self._eps))
        self._write_back(p, master)

    def _update_param_sparse(self, p, sr):
        """lazy_mode: the row-wise update (untouched rows keep their
        moments; the beta powers advance for the whole table).  Without
        it the dense rule applies (densify: untouched rows still decay
        their moments); amsgrad densifies too, since its running max is
        global."""
        if not self._lazy_mode or self._amsgrad:
            return super()._update_param_sparse(p, sr)
        self._lazy_row_update(p, sr, self._lr_of(p), decay=0.0)

    def _lazy_row_update(self, p, sr, lr_t, decay):
        """Adam on the unique rows of ``sr`` (duplicates summed in fp32),
        each accumulator and the master written back row by row;
        ``decay`` is AdamW's decoupled decay of the touched rows."""
        b1, b2 = self._beta1, self._beta2
        rows, inv = torch.unique(sr.rows, sorted=True, return_inverse=True)
        g = torch.zeros((rows.numel(), *sr.values.shape[1:]),
                        dtype=torch.float32, device=sr.values.device)
        g.index_add_(0, inv, sr.values.float())
        master = self._master(p)
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        b1p = self._acc("beta1_pow", p, _one(p))
        b2p = self._acc("beta2_pow", p, _one(p))
        mr = b1 * m[rows] + (1 - b1) * g
        vr = b2 * v[rows] + (1 - b2) * g * g
        b1p.mul_(b1)
        b2p.mul_(b2)
        m.index_copy_(0, rows, mr)
        v.index_copy_(0, rows, vr)
        upd = lr_t * (mr / (1 - b1p)) / (torch.sqrt(vr / (1 - b2p))
                                         + self._eps)
        master.index_copy_(0, rows, master[rows] * (1 - lr_t * decay) - upd)
        self._write_back(p, master)


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01).  ``lr_ratio(p)``
    scales a parameter's lr; ``apply_decay_param_fun(name)`` false
    exempts the parameter of that name from decay (names as given with
    the parameters, ``param_<i>`` for bare tensors)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad)
        self._wd = _coeff(weight_decay, default=0.01)
        self._apply_decay_fn = apply_decay_param_fun
        self._lr_ratio = lr_ratio
        self._name_of = self._names()

    def _update_param(self, p, g):
        master = self._master(p)
        lr_t = self._lr_of(p)
        if self._lr_ratio is not None:
            lr_t = lr_t * self._lr_ratio(p)
        decay = self._decay(p, self._wd)
        if self._apply_decay_fn is not None and not self._apply_decay_fn(
                self._name_of[id(p)]):
            decay = 0.0
        mhat, vhat = self._moments(p, g)
        if decay:   # master * (1 - lr*0) is master itself
            master.mul_(1 - lr_t * decay)
        master.sub_(lr_t * mhat / (torch.sqrt(vhat) + self._eps))
        self._write_back(p, master)

    def _update_param_sparse(self, p, sr):
        """lazy_mode decays the touched rows only (the densified path
        decays the whole table through :meth:`_update_param`)."""
        if not self._lazy_mode or self._amsgrad:
            return Optimizer._update_param_sparse(self, p, sr)
        lr_t = self._lr_of(p)
        if self._lr_ratio is not None:
            lr_t = lr_t * self._lr_ratio(p)
        decay = self._decay(p, self._wd)
        if self._apply_decay_fn is not None and not self._apply_decay_fn(
                self._name_of[id(p)]):
            decay = 0.0
        self._lazy_row_update(p, sr, lr_t, decay)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _update_param(self, p, g):
        m = self._master(p)
        wd = self._decay(p, self._weight_decay)
        if wd:
            g = g + wd * m
        acc = self._acc("moment", p, torch.full_like(m, self._init_acc))
        acc.add_(g * g)
        m.sub_(self._lr_of(p) * g / (torch.sqrt(acc) + self._eps))
        self._write_back(p, m)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._eps, self._rho = epsilon, rho

    def _update_param(self, p, g):
        m = self._master(p)
        wd = self._decay(p, self._weight_decay)
        if wd:
            g = g + wd * m
        rho = self._rho
        avg_sq = self._acc("avg_squared_grad", p)
        avg_upd = self._acc("avg_squared_update", p)
        avg_sq.mul_(rho).add_((1 - rho) * g * g)
        upd = (-torch.sqrt(avg_upd + self._eps)
               / torch.sqrt(avg_sq + self._eps) * g)
        avg_upd.mul_(rho).add_((1 - rho) * upd * upd)
        m.add_(self._lr_of(p) * upd)
        self._write_back(p, m)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _update_param(self, p, g):
        master = self._master(p)
        wd = self._decay(p, self._weight_decay)
        if wd:
            g = g + wd * master
        m = self._acc("moment", p)
        u = self._acc("inf_norm", p)
        b1p = self._acc("beta1_pow", p, _one(p))
        m.mul_(self._beta1).add_((1 - self._beta1) * g)
        torch.maximum(self._beta2 * u, torch.abs(g), out=u)
        b1p.mul_(self._beta1)
        master.sub_(self._lr_of(p) / (1 - b1p) * m / (u + self._eps))
        self._write_back(p, master)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._rho, self._eps = rho, epsilon
        self._momentum = momentum
        self._centered = centered

    def _update_param(self, p, g):
        m = self._master(p)
        wd = self._decay(p, self._weight_decay)
        if wd:
            g = g + wd * m
        rho = self._rho
        ms = self._acc("mean_square", p)
        ms.mul_(rho).add_((1 - rho) * g * g)
        if self._centered:
            mg = self._acc("mean_grad", p)
            mg.mul_(rho).add_((1 - rho) * g)
            denom = torch.sqrt(ms - mg * mg + self._eps)
        else:
            denom = torch.sqrt(ms + self._eps)
        mom = self._acc("momentum", p)
        mom.mul_(self._momentum).add_(self._lr_of(p) * g / denom)
        m.sub_(mom)
        self._write_back(p, m)


class ASGD(Optimizer):
    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._batch_num = batch_num

    def _update_param(self, p, g):
        m = self._master(p)
        wd = self._decay(p, self._weight_decay)
        if wd:
            g = g + wd * m
        d = self._acc("d", p)
        ys = self._acc("y", p)
        d.sub_(ys).add_(g)
        ys.copy_(g)
        m.sub_(self._lr_of(p) * d / self._batch_num)
        self._write_back(p, m)


class NAdam(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._psi = momentum_decay

    def _update_param(self, p, g):
        master = self._master(p)
        wd = self._decay(p, self._weight_decay)
        if wd:
            g = g + wd * master
        b1, b2, t = self._beta1, self._beta2, self._step_t
        # the scalars JAX computes as Python floats: float64, then fp32
        mu_t = b1 * (1 - 0.5 * torch.pow(0.96, t * self._psi))
        mu_t1 = b1 * (1 - 0.5 * torch.pow(0.96, (t + 1) * self._psi))
        mu_prod = self._acc("mu_prod", p, _one(p))
        mu_prod.mul_(mu_t.float())
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mu_t1 = mu_t1.float()
        mhat = (mu_t1 * m / (1 - mu_prod * mu_t1)
                + (1 - mu_t).float() * g / (1 - mu_prod))
        vhat = v / (1 - torch.pow(b2, t)).float()
        master.sub_(self._lr_of(p) * mhat / (torch.sqrt(vhat) + self._eps))
        self._write_back(p, master)


class RAdam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _update_param(self, p, g):
        master = self._master(p)
        wd = self._decay(p, self._weight_decay)
        if wd:
            g = g + wd * master
        b1, b2, t = self._beta1, self._beta2, self._step_t
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        # the scalars JAX computes as Python floats: float64, then fp32;
        # its ``if rho_t > 5`` is a select on the device
        mhat = m / (1 - torch.pow(b1, t)).float()
        b2t = torch.pow(b2, t)
        rho_inf = 2 / (1 - b2) - 1
        rho_t = rho_inf - 2 * t * b2t / (1 - b2t)
        lr_t = self._lr_of(p)
        vhat = torch.sqrt(v / (1 - b2t).float())
        r = torch.pow(((rho_t - 4) * (rho_t - 2) * rho_inf)
                      / ((rho_inf - 4) * (rho_inf - 2) * rho_t), 0.5).float()
        master.sub_(torch.where(rho_t > 5,
                                lr_t * r * mhat / (vhat + self._eps),
                                lr_t * mhat))
        self._write_back(p, master)


class Rprop(Optimizer):
    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._lr_range = learning_rate_range
        self._etas = etas

    def _update_param(self, p, g):
        m = self._master(p)
        prev = self._acc("prev_grad", p)
        step = self._acc("step_size", p, torch.empty_like(m).copy_(
            self._lr_tensors[self._group_of[id(p)]]))
        sign = torch.sign(g * prev)
        step.copy_(torch.clamp(
            torch.where(sign > 0, step * self._etas[1],
                        torch.where(sign < 0, step * self._etas[0], step)),
            self._lr_range[0], self._lr_range[1]))
        g = torch.where(sign < 0, 0.0, g)
        prev.copy_(g)
        m.sub_(torch.sign(g) * step)
        self._write_back(p, m)


class Lamb(Optimizer):
    """LAMB; ``exclude_from_weight_decay_fn(p)`` true exempts parameter
    ``p`` from decay."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update_param(self, p, g):
        master = self._master(p)
        b1, b2 = self._beta1, self._beta2
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        b1p = self._acc("beta1_pow", p, _one(p))
        b2p = self._acc("beta2_pow", p, _one(p))
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        b1p.mul_(b1)
        b2p.mul_(b2)
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        wd = self._decay(p, self._wd)
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        r = mhat / (torch.sqrt(vhat) + self._eps) + wd * master
        w_norm = torch.linalg.norm(master)
        r_norm = torch.linalg.norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        master.sub_(self._lr_of(p) * trust * r)
        self._write_back(p, master)


class LBFGS(Optimizer):
    """LBFGS as the JAX package computes it: each :meth:`step` calls
    ``closure`` (which runs the backward) once, then takes one step of
    length ``lr`` along the two-loop recursion's direction from the last
    ``history_size`` pairs ``(s, y)`` of parameter and gradient changes;
    a pair enters the history only when ``s·y > 1e-10``.  There is no
    line search: ``max_iter``, ``max_eval``, the tolerances and
    ``line_search_fn`` are taken and not used, and ``grad_clip`` is not
    applied (all as in JAX)."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False)
        self._max_iter = max_iter
        self._history = history_size
        self._s, self._y = [], []
        self._prev_flat = None
        self._prev_grad = None

    def step(self, closure=None):
        if closure is not None:
            with torch.enable_grad():
                closure()
        with torch.no_grad():
            pg = [(p, p.grad) for p in self._parameter_list
                  if p.requires_grad and p.grad is not None]
            if not pg:
                return None
            flat_g = torch.cat([g.float().reshape(-1) for _, g in pg])
            flat_w = torch.cat([p.float().reshape(-1) for p, _ in pg])
            if self._prev_flat is not None:
                s = flat_w - self._prev_flat
                y = flat_g - self._prev_grad
                if float(torch.dot(s, y)) > 1e-10:
                    self._s.append(s)
                    self._y.append(y)
                    if len(self._s) > self._history:
                        self._s.pop(0)
                        self._y.pop(0)
            q = flat_g
            alphas = []
            for s, y in zip(reversed(self._s), reversed(self._y)):
                rho = 1.0 / torch.dot(y, s)
                a = rho * torch.dot(s, q)
                q = q - a * y
                alphas.append((a, rho, s, y))
            if self._s:
                gamma = (torch.dot(self._s[-1], self._y[-1])
                         / torch.dot(self._y[-1], self._y[-1]))
                q = gamma * q
            for a, rho, s, y in reversed(alphas):
                b = rho * torch.dot(y, q)
                q = q + (a - b) * s
            self._prev_flat = flat_w
            self._prev_grad = flat_g
            new_flat = flat_w + self.get_lr() * -q
            ofs = 0
            for p, _ in pg:
                n = p.numel()
                p.copy_(new_flat[ofs:ofs + n].reshape(p.shape))
                ofs += n
        return None


__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adadelta", "Adamax", "RMSProp", "ASGD", "NAdam", "RAdam",
           "Rprop", "Lamb", "LBFGS", "L1Decay", "L2Decay", "lr"]

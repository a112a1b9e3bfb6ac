"""Tensor-parallel layers (port of
``paddle_tpu/distributed/fleet/mp_layers.py``; reference:
fleet/layers/mpu/mp_layers.py — VocabParallelEmbedding:47,
ColumnParallelLinear:334, RowParallelLinear:541,
ParallelCrossEntropy:742; the RNG tracker of fleet/layers/mpu/random.py:34).

Each layer draws its full weight as the JAX layer does (the same
initializer over the full shape) and keeps this rank's shard over the
``mp`` axis of the global mesh (the whole weight without a mesh, or
when the dimension does not divide); the Megatron collectives of
``distributed.mp_ops`` run in the forward and the backward.  The
weights carry ``placements`` and ``is_distributed``, which the mesh
train step reads.

Megatron sequence parallelism (reference:
fleet/utils/sequence_parallel_utils.py:427, 562) reuses the ``mp`` ranks
for the sequence: between the linears the activations ``[b, s/mp, h]``
hold this rank's chunk of the sequence.  ``ColumnSequenceParallelLinear``
all-gathers the sequence before its column matmul,
``RowSequenceParallelLinear`` reduce-scatters its partial sums onto the
sequence (half the bytes of the row linear's all-reduce), and
``ScatterOp``/``GatherOp`` enter and leave the split.  The row linear's
bias is marked sequence-parallel (each rank adds it to its own tokens):
its gradient is summed over ``mp`` inside the backward.
"""

from __future__ import annotations

import contextlib

import torch

from ...core.dispatch import apply_op
from ...core.tensor import unwrap
from ...nn.functional.init_utils import param_attr_init
from ...nn.initializer import Constant, XavierUniform
from ...nn.layer.layers import Layer
from .. import mp_ops
from ..env import get_mesh, get_rank
from ..sharding_utils import P, local_shard, validate_spec


class RNGStatesTracker:
    """Named random streams for tensor-parallel code (reference:
    random.py:34): ``rng_state(name)`` runs its block on the stream
    ``name`` of the default device's generator and keeps the stream's
    advance for the next block.  ``model_parallel_random_seed`` adds a
    ``global_seed`` stream (equal on every rank) and a ``local_seed`` one
    (differs by rank)."""

    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed)
        from ...tensor.random import default_generator
        gen = default_generator()
        saved = gen.get_state()
        gen.manual_seed(int(seed))
        self.states_[name] = gen.get_state()
        gen.set_state(saved)

    def get_states_tracker(self):
        return dict(self.states_)

    def set_states_tracker(self, states):
        self.states_ = dict(states)

    @contextlib.contextmanager
    def rng_state(self, name="model_parallel_rng"):
        from ...tensor.random import default_generator
        if name not in self.states_:
            self.add(name, hash(name) % (2 ** 31))
        gen = default_generator()
        saved = gen.get_state()
        gen.set_state(self.states_[name])
        try:
            yield
        finally:
            self.states_[name] = gen.get_state()
            gen.set_state(saved)


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed=None):
    import numpy as np
    seed = seed if seed is not None else np.random.randint(0, 2 ** 20)
    _RNG_STATE_TRACKER.reset()
    _RNG_STATE_TRACKER.add("global_seed", seed)
    _RNG_STATE_TRACKER.add("local_seed", seed + 1024 + get_rank())


def _mp_param(layer, shape, attr, is_bias, init, spec):
    """A parameter drawn at the full ``shape`` whose data becomes this
    rank's shard under ``spec`` on the global mesh (kept whole when the
    spec does not divide or there is no mesh)."""
    p = param_attr_init(shape, layer._dtype, attr, is_bias, init)
    t = unwrap(p)
    mesh = get_mesh()
    spec = P() if mesh is None else validate_spec(spec, shape, mesh,
                                                  quiet=True)
    if any(e is not None for e in spec):
        t.data = local_shard(t.detach(), spec, mesh)
    t.placements = spec
    t.is_distributed = any(e is not None for e in spec)
    return p


def _mp_on(param):
    return getattr(unwrap(param), "is_distributed", False) is True


class VocabParallelEmbedding(Layer):
    """Weight ``[V, H]`` split on the vocabulary: a masked local lookup
    and one all-reduce."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.weight = _mp_param(self, (num_embeddings, embedding_dim),
                                weight_attr, False, XavierUniform(),
                                P("mp", None))
        self.is_mp = _mp_on(self.weight)

    def forward(self, x):
        if not self.is_mp:
            return apply_op("embedding", lambda i, w: w[i.long()], x,
                            self.weight)
        return apply_op("c_embedding",
                        lambda i, w: mp_ops.vocab_parallel_embedding(
                            i.long(), w), x, self.weight)


class ColumnParallelLinear(Layer):
    """Weight ``[in, out]`` split on ``out``; ``gather_output`` gathers
    the output columns, else each rank keeps its own."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.gather_output = gather_output
        self.weight = _mp_param(self, (in_features, out_features),
                                weight_attr, False, XavierUniform(),
                                P(None, "mp"))
        self.bias = (_mp_param(self, (out_features,), None, True,
                               Constant(0.0), P("mp"))
                     if has_bias else None)
        self.is_mp = _mp_on(self.weight)

    def forward(self, x):
        on, gather = self.is_mp, self.gather_output

        def fn(x, w, *b):
            x = mp_ops.copy_to_mp(x) if on else x
            y = torch.matmul(x, w)
            if b:
                y = y + b[0]
            return mp_ops.gather_from_mp(y) if on and gather else y
        args = (x, self.weight) + (() if self.bias is None else (self.bias,))
        return apply_op("column_parallel_linear", fn, *args)


class RowParallelLinear(Layer):
    """Weight ``[in, out]`` split on ``in``: the partial products are
    all-reduced and the bias added once after."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.weight = _mp_param(self, (in_features, out_features),
                                weight_attr, False, XavierUniform(),
                                P("mp", None))
        self.bias = (_mp_param(self, (out_features,), None, True,
                               Constant(0.0), P())
                     if has_bias else None)
        self.is_mp = _mp_on(self.weight)

    def forward(self, x):
        on, parallel = self.is_mp, self.input_is_parallel

        def fn(x, w, *b):
            if on and not parallel:
                x = mp_ops.scatter_to_mp(x)
            y = torch.matmul(x, w)
            if on:
                y = mp_ops.reduce_from_mp(y)
            return y + b[0] if b else y
        args = (x, self.weight) + (() if self.bias is None else (self.bias,))
        return apply_op("row_parallel_linear", fn, *args)


class ParallelCrossEntropy(Layer):
    """Per-token cross entropy over logits split on the vocabulary
    (``[..., V/mp]``, as a ``ColumnParallelLinear(gather_output=False)``
    gives them): two all-reduces and a masked pick, the vocabulary never
    gathered.  Tokens at ``ignore_index`` give 0.  Returns the label's
    shape, as the JAX layer does."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        ignore = self.ignore_index

        def fn(lg, lab):
            lab = lab.long()
            if lab.dim() == lg.dim():
                lab = lab[..., 0]
            keep = lab != ignore
            if get_mesh() is None:
                lf = lg.float()
                loss = torch.logsumexp(lf, -1) - lf.gather(
                    -1, lab.clamp(min=0)[..., None])[..., 0]
            else:
                loss = mp_ops.vocab_parallel_ce(lg, lab.clamp(min=0))
            return torch.where(keep, loss, 0.0)
        return apply_op("c_softmax_with_cross_entropy", fn, input, label)


def mark_as_sequence_parallel_parameter(param):
    """Mark a parameter that each ``mp`` rank applies to its own chunk of
    the sequence (reference: sequence_parallel_utils.py
    ``mark_as_sequence_parallel_parameter``): the sequence-parallel layers
    pass it through :func:`mp_ops.copy_to_mp`, whose backward sums its
    gradient over ``mp``.  Returns ``param``."""
    unwrap(param).sequence_parallel = True
    return param


def _seq_parallel(param):
    return getattr(unwrap(param), "sequence_parallel", False)


def _mp_split():
    """Whether the global mesh splits over ``mp`` (the sequence-parallel
    ops are identities otherwise, as the JAX constraints are)."""
    mesh = get_mesh()
    return mesh is not None and mesh.degree("mp") > 1


class ColumnSequenceParallelLinear(Layer):
    """Weight ``[in, out]`` split on ``out``; the input holds this rank's
    chunk of the sequence ``[b, s/mp, in]``: all-gathered (reduce-scatter
    of its gradient) before the column matmul.  The output holds the
    whole sequence and this rank's columns ``[b, s, out/mp]``, or every
    column with ``gather_output``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.gather_output = gather_output
        self.weight = _mp_param(self, (in_features, out_features),
                                weight_attr, False, XavierUniform(),
                                P(None, "mp"))
        self.bias = (_mp_param(self, (out_features,), None, True,
                               Constant(0.0), P("mp"))
                     if has_bias else None)
        self.is_mp = _mp_on(self.weight)

    def forward(self, x):
        on, gather = self.is_mp, self.gather_output

        def fn(x, w, *b):
            if on:
                x = mp_ops.all_gather_seq(x)
            y = torch.matmul(x, w)
            if b:
                y = y + b[0]
            return mp_ops.gather_from_mp(y) if on and gather else y
        args = (x, self.weight) + (() if self.bias is None else (self.bias,))
        return apply_op("linear", fn, *args)


class RowSequenceParallelLinear(Layer):
    """Weight ``[in, out]`` split on ``in``; the partial products are
    reduce-scattered onto the sequence (``[b, s/mp, out]``) and the bias,
    marked sequence-parallel, added to this rank's tokens."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.weight = _mp_param(self, (in_features, out_features),
                                weight_attr, False, XavierUniform(),
                                P("mp", None))
        self.bias = None
        if has_bias:
            self.bias = _mp_param(self, (out_features,), None, True,
                                  Constant(0.0), P())
            mark_as_sequence_parallel_parameter(self.bias)
        self.is_mp = _mp_on(self.weight)

    def forward(self, x):
        on, parallel = self.is_mp, self.input_is_parallel
        marked = self.bias is not None and _seq_parallel(self.bias)

        def fn(x, w, *b):
            if on and not parallel:
                x = mp_ops.scatter_to_mp(x)
            y = torch.matmul(x, w)
            if on:
                y = mp_ops.reduce_scatter_seq(y)
            if not b:
                return y
            return y + (mp_ops.copy_to_mp(b[0]) if on and marked else b[0])
        args = (x, self.weight) + (() if self.bias is None else (self.bias,))
        return apply_op("linear", fn, *args)


class GatherOp(Layer):
    """All-gather along the sequence over ``mp`` (reference:
    sequence_parallel_utils.py ``GatherOp``): the whole sequence on every
    rank; backward keeps this rank's chunk of the gradient."""

    @staticmethod
    def apply(x):
        if not _mp_split():
            return x
        return apply_op("sequence_gather", mp_ops.gather_seq, x, amp=False)

    def forward(self, x):
        return self.apply(x)


class ScatterOp(Layer):
    """This rank's chunk of the sequence over ``mp`` (reference:
    sequence_parallel_utils.py ``ScatterOp``); backward all-gathers."""

    @staticmethod
    def apply(x):
        if not _mp_split():
            return x
        return apply_op("sequence_scatter", mp_ops.scatter_seq, x,
                        amp=False)

    def forward(self, x):
        return self.apply(x)


# mp_ops-style helpers (reference: fleet/layers/mpu/mp_ops.py)
def _c_identity(tensor, group=None):
    """Identity forward, all-reduce of the gradient over ``mp``."""
    return apply_op("c_identity", mp_ops.copy_to_mp, tensor)


def _c_concat(tensor, group=None):
    """All-gather of the last dimension over ``mp``."""
    return apply_op("c_concat", mp_ops.gather_from_mp, tensor)


def _c_split(tensor, group=None):
    """This rank's piece of the last dimension."""
    return apply_op("c_split", mp_ops.scatter_to_mp, tensor)


def _mp_allreduce(tensor, op=None, group=None, use_calc_stream=True):
    """All-reduce over ``mp``, identity gradient."""
    return apply_op("mp_allreduce", mp_ops.reduce_from_mp, tensor)


__all__ = ["ColumnParallelLinear", "ColumnSequenceParallelLinear",
           "GatherOp", "ParallelCrossEntropy", "RNGStatesTracker",
           "RowParallelLinear", "RowSequenceParallelLinear", "ScatterOp",
           "VocabParallelEmbedding", "get_rng_state_tracker",
           "mark_as_sequence_parallel_parameter",
           "model_parallel_random_seed"]

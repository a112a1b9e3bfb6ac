"""``Linear``, ``Embedding`` and ``Dropout`` (port of the parts of
``paddle_tpu/nn/layer/common.py`` this slice runs)."""

from __future__ import annotations

import torch

from ...core.dispatch import apply_op
from ...core.selected_rows import SelectedRows, set_sparse_grad, sparse_grad
from ...core.state import STATE
from ...core.tensor import Tensor, unwrap
from ...tensor.manipulation import reshape
from .. import functional as F
from ..functional.init_utils import param_attr_init
from ..initializer import Constant, Normal, XavierUniform
from .layers import Layer


class Linear(Layer):
    """y = xW + b, weight ``[in, out]`` (Paddle's layout)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = param_attr_init((in_features, out_features),
                                      self._dtype, weight_attr, False,
                                      XavierUniform())
        if bias_attr is not False:
            self.bias = param_attr_init((out_features,), self._dtype,
                                        bias_attr, True, Constant(0.0))
        else:
            self.bias = None

    def forward(self, input):
        return F.linear(input, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(Layer):
    """A ``[num_embeddings, embedding_dim]`` table, N(0, 1) unless
    ``weight_attr`` says otherwise; the ``padding_idx`` row starts at 0.

    ``sparse=True``: an eager backward writes the table's gradient as a
    ``SelectedRows`` holding only the batch's unique rows
    (``lookup_table_v2_grad``'s sparse path), through a hook on the rows
    the forward pulled (the JAX ``_forward_sparse``).  Without grad mode,
    for a frozen table, inside a ``jit.CompiledTrainStep`` body or during
    a CUDA-graph capture the lookup takes the dense path, as JAX does
    under tracing."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._sparse = sparse
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = param_attr_init((num_embeddings, embedding_dim),
                                      self._dtype, weight_attr, False,
                                      Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight._data[padding_idx] = 0.0

    def forward(self, x):
        if self._sparse:
            out = self._forward_sparse(x)
            if out is not None:
                return out
        return F.embedding(x, self.weight, self._padding_idx)

    def _forward_sparse(self, x):
        """The lookup through the unique rows ``w[uniq]`` pulled as a leaf
        of their own; their gradient becomes the table's SelectedRows
        (microbatches concatenate rows, a dense gradient merges to dense,
        ``paddle.grad`` leaves ``.grad`` alone).  None where the dense
        path applies."""
        w = self.weight._data
        if (STATE.tracing_depth > 0 or not torch.is_grad_enabled()
                or not w.requires_grad
                or (w.is_cuda and torch.cuda.is_current_stream_capturing())):
            return None
        ids = torch.as_tensor(unwrap(x), device=w.device).long()
        uniq, inv = torch.unique(ids.reshape(-1), sorted=True,
                                 return_inverse=True)
        pulled = w.detach()[uniq].requires_grad_(True)
        height = self._num_embeddings

        def to_selected_rows(grad):
            if not STATE.accumulating_backward:
                return grad
            prev = sparse_grad(w)
            if prev is not None:            # microbatch accumulation
                set_sparse_grad(w, SelectedRows(
                    torch.cat([prev.rows, uniq]),
                    torch.cat([prev.values, grad]), height))
            elif w.grad is not None:        # dense + sparse: merge to dense
                with torch.no_grad():
                    w.grad = w.grad + SelectedRows(
                        uniq, grad, height).to_dense()
            else:
                set_sparse_grad(w, SelectedRows(uniq, grad, height))
            return grad

        pulled.register_hook(to_selected_rows)
        out = apply_op("gather", lambda t, i: t[i], pulled, inv)
        out = reshape(out, list(ids.shape) + [self._embedding_dim])
        if self._padding_idx is not None:
            keep = (ids != self._padding_idx)[..., None]
            out = out * Tensor._wrap(keep).astype(out.dtype)
        return out

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, input):
        return F.dropout(input, self.p, self.axis, self.training, self.mode)

    def extra_repr(self):
        return f"p={self.p}"


__all__ = ["Dropout", "Embedding", "Linear"]

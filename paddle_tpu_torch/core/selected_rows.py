"""SelectedRows: the sparse-gradient carrier (port of
``paddle_tpu/core/selected_rows.py``).

``(rows, values, height)``: int64 row ids into a ``[height, ...]`` table
and one value row each, as ``nn.Embedding(sparse=True)``'s backward
makes it (``lookup_table_v2_grad``'s sparse path).  A vocab-sized table
whose batch touches k rows moves O(k·dim) gradient bytes instead of
O(V·dim).

The port keeps a parameter's sparse gradient on its torch parameter
(:func:`sparse_grad`), since a ``torch.Tensor``'s ``.grad`` can hold
only a tensor; ``Tensor.grad`` of the paddle-style surface reads it
there, and the optimizers and clips read it through
:func:`grad_of`.
"""

from __future__ import annotations

import torch


class SelectedRows:
    def __init__(self, rows, values, height):
        self.rows = torch.as_tensor(rows, device=values.device).long()
        self.values = values
        self.height = int(height)

    @property
    def shape(self):
        return [self.height] + list(self.values.shape[1:])

    @property
    def dtype(self):
        return self.values.dtype

    def to_dense(self):
        """Scatter-add into the dense twin (duplicate rows accumulate, as
        the dense embedding backward does)."""
        dense = torch.zeros((self.height, *self.values.shape[1:]),
                            dtype=self.values.dtype,
                            device=self.values.device)
        return dense.index_add_(0, self.rows, self.values)

    def merge_rows(self):
        """Accumulate duplicate rows into unique, sorted rows (MergeAdd):
        O(k·dim), never the dense twin."""
        uniq, inv = torch.unique(self.rows, sorted=True, return_inverse=True)
        if uniq.numel() == self.rows.numel():
            return self  # already unique
        merged = torch.zeros((uniq.numel(), *self.values.shape[1:]),
                             dtype=self.values.dtype,
                             device=self.values.device)
        return SelectedRows(uniq, merged.index_add_(0, inv, self.values),
                            self.height)

    def numpy(self):
        return self.to_dense().detach().cpu().numpy()

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"n_rows={self.values.shape[0]}, dim={self.shape[1:]})")


#: the attribute of a torch parameter that holds its SelectedRows gradient
_ATTR = "selected_rows_grad"


def sparse_grad(param):
    """The ``SelectedRows`` gradient of torch parameter ``param``, or
    None."""
    return getattr(param, _ATTR, None)


def set_sparse_grad(param, sr):
    setattr(param, _ATTR, sr)


def grad_of(param):
    """``param``'s gradient: its ``SelectedRows``, its dense ``.grad``, or
    None.  A sparse gradient that met a dense one in the same
    accumulation (a table used both through a sparse lookup and densely)
    merges to dense here, as the JAX backward merges them."""
    sr = sparse_grad(param)
    if sr is None:
        return param.grad
    if param.grad is None:
        return sr
    with torch.no_grad():
        param.grad = param.grad + sr.to_dense().to(param.grad.dtype)
    set_sparse_grad(param, None)
    return param.grad


__all__ = ["SelectedRows", "grad_of", "set_sparse_grad", "sparse_grad"]

"""SelectedRows: a row-sparse gradient (counterpart of
``paddle_tpu/framework/selected_rows.py``; reference: Paddle's
``phi/core/selected_rows.h``, rows + value + height).

``rows`` int64 [n] and ``values`` [n, ...] stay on the device; the dense
equivalent is ``height`` rows of ``values.shape[1:]``, duplicate row ids
summed. The port's sparse gradient arrives as a sparse COO tensor
(``nn/sparse_embedding.py``); ``from_coo`` reads it, and the optimizers
merge it (``merge_selected_rows``) before a row update.
"""
from __future__ import annotations

import torch

__all__ = ["SelectedRows", "merge_selected_rows"]


class SelectedRows:
    """rows: int64 [n]; values: [n, ...]; height: size of dim 0 of the
    dense equivalent. Duplicate row ids are allowed and sum in
    ``to_dense`` and ``merge``."""

    __slots__ = ("rows", "values", "height")

    def __init__(self, rows, values, height: int):
        self.values = torch.as_tensor(values)
        self.rows = torch.as_tensor(rows, device=self.values.device).to(
            torch.int64).reshape(-1)
        self.height = int(height)

    @classmethod
    def from_coo(cls, t: torch.Tensor) -> "SelectedRows":
        """The rows of a sparse COO tensor with one sparse dimension (the
        gradient ``torch.nn.functional.embedding(..., sparse=True)``
        leaves), duplicates kept."""
        if not t.is_sparse or t.sparse_dim() != 1:
            raise ValueError("SelectedRows.from_coo takes a sparse COO tensor "
                             "with one sparse dimension")
        return cls(t._indices()[0], t._values(), t.shape[0])

    @property
    def shape(self):
        return [self.height] + list(self.values.shape[1:])

    @property
    def dtype(self):
        return self.values.dtype

    def to_dense(self) -> torch.Tensor:
        out = self.values.new_zeros((self.height,) + self.values.shape[1:])
        return out.index_add_(0, self.rows, self.values)

    def numpy(self):
        return self.to_dense().cpu().numpy()

    def is_selected_rows(self) -> bool:
        return True

    def merge(self) -> "SelectedRows":
        return merge_selected_rows(self)

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"n_rows={self.values.shape[0]}, "
                f"value_shape={list(self.values.shape[1:])})")


def merge_selected_rows(sr: SelectedRows) -> SelectedRows:
    """Duplicate row ids summed into one slot each, rows ascending
    (reference: the merge_selected_rows op, MergeAdd). The JAX version
    keeps n slots, parking freed ones at the out-of-bounds row
    ``height`` for XLA's scatter to drop; the port's output has the
    unique rows only. The sums run in another order than JAX's, so they
    agree to rounding, not bit for bit."""
    uniq, inv = torch.unique(sr.rows, return_inverse=True)
    vals = sr.values.new_zeros((uniq.numel(),) + sr.values.shape[1:])
    return SelectedRows(uniq, vals.index_add_(0, inv, sr.values), sr.height)

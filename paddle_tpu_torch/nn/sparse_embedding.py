"""Sparse-gradient embedding lookup (counterpart of
``paddle_tpu/nn/sparse_embedding.py``; reference: ``nn.Embedding(sparse=
True)``, whose weight gradient is a SelectedRows of the looked-up rows).

The forward is a plain gather. The backward hands autograd a sparse COO
gradient of the weight (one row a looked-up id, duplicates kept, rows of
``padding_idx`` zeroed but present, as the JAX backward builds its
``SelectedRows``), O(batch * dim) instead of O(vocab * dim). Autograd
leaves it in the weight's ``.grad`` (summing duplicates later), and the
optimizer turns it into a merged ``SelectedRows``
(``framework/selected_rows.py``). Only for a leaf weight: a sparse
gradient cannot flow through further ops (an AMP cast, say).
"""
from __future__ import annotations

import torch

from ..core.enforce import enforce

__all__ = ["sparse_embedding"]


class _SparseLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, weight, padding_idx):
        ctx.save_for_backward(ids)
        ctx.padding_idx, ctx.shape = padding_idx, tuple(weight.shape)
        return weight[ids]

    @staticmethod
    def backward(ctx, gout):
        ids, = ctx.saved_tensors
        rows = ids.reshape(-1)
        vals = gout.reshape(rows.numel(), *ctx.shape[1:])
        if ctx.padding_idx is not None:
            vals = vals.masked_fill((rows == ctx.padding_idx)[:, None], 0)
        grad = torch.sparse_coo_tensor(rows[None], vals, ctx.shape,
                                       check_invariants=False)
        return None, grad, None


def sparse_embedding(ids, weight, padding_idx=None):
    """``weight[ids]``, with a sparse COO gradient for ``weight``."""
    ids = torch.as_tensor(ids, device=weight.device).long()
    if torch.is_grad_enabled() and weight.requires_grad:
        enforce(weight.is_leaf,
                "Embedding(sparse=True) requires a leaf weight (a "
                "Parameter): a sparse gradient cannot flow through upstream "
                "ops (e.g. an amp cast); use sparse=False there")
        return _SparseLookup.apply(ids, weight, padding_idx)
    return weight[ids]

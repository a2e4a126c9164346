"""Common layers (counterpart of ``paddle_tpu/nn/common.py``; only what
the ported models and the degree-1 training surface use)."""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F

__all__ = ["Dropout", "Embedding"]


class Embedding(nn.Module):
    """A lookup table ``weight`` [num_embeddings, embedding_dim] (the JAX
    ``Embedding``, nn/common.py:37-62) on ``device`` (CUDA unless the
    caller names another, as every entry point of the port): N(0, 1) at
    init (from ``generator``, a ``torch.Generator`` on that device; None:
    the default one), a negative ``padding_idx`` normalised to
    ``num_embeddings + padding_idx`` and its row zeroed at init. The
    forward is ``F.embedding`` (padding positions give zeros) or, with
    ``sparse``, the sparse-gradient lookup, whose weight gradient holds
    only the looked-up rows (``nn/sparse_embedding.py``). ``weight_attr``
    (a ParamAttr) raises: the port has no ParamAttr (ROADMAP.md queue 1,
    item 2.2)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse: bool = False, weight_attr=None,
                 name=None, device=None, dtype=None, generator=None):
        super().__init__()
        if weight_attr is not None:
            raise NotImplementedError(
                "Embedding(weight_attr=...): the port has no ParamAttr "
                "(ROADMAP.md queue 1, item 2.2)")
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = (padding_idx if padding_idx is None
                             or padding_idx >= 0
                             else num_embeddings + padding_idx)
        self._sparse = bool(sparse)
        # models/ imports this module: its resolve_device is fetched here
        from ..models.llama import resolve_device
        w = torch.randn(num_embeddings, embedding_dim, generator=generator,
                        device=resolve_device(device))
        if self._padding_idx is not None:
            w[self._padding_idx] = 0.0
        self.weight = nn.Parameter(w.to(dtype or torch.float32))

    def forward(self, x):
        if self._sparse:
            from .sparse_embedding import sparse_embedding
            return sparse_embedding(x, self.weight, self._padding_idx)
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(nn.Module):
    """``F.dropout`` in training mode, the identity in eval mode (the JAX
    ``Dropout``, nn/common.py:65). ``generator`` is the explicit
    ``torch.Generator`` its masks are drawn from (on the device of the
    tensors it sees; None: the default generator). ``axis`` raises when
    given, as ``F.dropout`` does."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", name=None, generator=None):
        super().__init__()
        if axis is not None:
            F.dropout(None, axis=axis)      # raises, naming the item
        self.p = p
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, p=self.p, training=self.training, mode=self.mode,
                         generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"

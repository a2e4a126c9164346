"""Common layers (counterpart of ``paddle_tpu/nn/common.py``; only what
the ported models use)."""
from __future__ import annotations

from torch import nn

from . import functional as F

__all__ = ["Dropout"]


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

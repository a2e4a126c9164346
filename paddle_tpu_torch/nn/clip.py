"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``)."""
from __future__ import annotations

from typing import List

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    """Scale every gradient by ``min(clip_norm / max(norm, 1e-6), 1)``,
    where ``norm`` is the f32 L2 norm over all of them together."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def apply_(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """Clip ``grads`` in place; returns the global norm (f32 scalar
        tensor). Each gradient keeps its dtype: the scaled value rounds
        to it, as the JAX ``(g * scale).astype(g.dtype)`` does."""
        sq = sum(torch.sum(torch.square(g.float())) for g in grads)
        norm = torch.sqrt(sq)
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-6),
                            max=1.0)
        for g in grads:
            g.mul_(scale)
        return norm

    def __repr__(self):
        return f"ClipGradByGlobalNorm(clip_norm={self.clip_norm})"

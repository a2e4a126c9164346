"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

``apply_values(grads)`` returns the clipped gradients as new tensors,
as the JAX ``apply_values`` returns new arrays; each keeps its
gradient's dtype, the scaled value computed in f32 and rounded to it,
as the JAX ``(g * scale).astype(g.dtype)`` with an f32 ``scale`` does.
The optimizers call it from their ``_fused_update``. On CUDA, Adam and
AdamW fold ``ClipGradByGlobalNorm`` into kernel K8
(``ops/kernels/fused_adam.py``); ``ClipGradByNorm`` and
``ClipGradByValue`` run here in torch before it, where XLA fused them in
the JAX package.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "global_norm"]


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The f32 L2 norm over every gradient together."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads))


class ClipGradBase:
    def apply_values(self, grads: List[torch.Tensor]
                     ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        """(clipped gradients, the global norm where the clip computes
        one, else None)."""
        raise NotImplementedError


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``min(clip_norm / max(norm, 1e-6), 1)``,
    where ``norm`` is the f32 L2 norm over all of them together."""

    def __init__(self, clip_norm: float, group_name: str = "default_group",
                 auto_skip_clip: bool = False):
        self.clip_norm = float(clip_norm)

    def coefficient(self, norm: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-6),
                           max=1.0)

    def apply_values(self, grads):
        norm = global_norm(grads)
        coef = self.coefficient(norm)
        return [(g.float() * coef).to(g.dtype) for g in grads], norm

    def __repr__(self):
        return f"ClipGradByGlobalNorm(clip_norm={self.clip_norm})"


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient on its own by
    ``min(clip_norm / max(||g||, 1e-6), 1)`` (f32 norm)."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def apply_values(self, grads):
        out = []
        for g in grads:
            n = torch.sqrt(torch.sum(torch.square(g.float())))
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-6),
                                max=1.0)
            out.append((g.float() * scale).to(g.dtype))
        return out, None


class ClipGradByValue(ClipGradBase):
    """Clamp every gradient element into ``[min, max]`` (``min``
    defaults to ``-max``)."""

    def __init__(self, max: float, min: float = None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def apply_values(self, grads):
        return [torch.clamp(g, self.min, self.max) for g in grads], None

"""NN helper ops (counterpart of ``paddle_tpu/ops/nn_ops.py``; only
what the ported serving path uses)."""
from __future__ import annotations

import torch

__all__ = ["rotate_half"]


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """[-x2, x1] pairing used by neox-style rotary embeddings."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)

"""NN helper ops (counterpart of ``paddle_tpu/ops/nn_ops.py``; only
what the ported serving and training paths use)."""
from __future__ import annotations

import torch

from .. import amp

__all__ = ["rotate_half", "fused_rope"]


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """[-x2, x1] pairing used by neox-style rotary embeddings."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _table(t: torch.Tensor, position_ids, dtype) -> torch.Tensor:
    """cos or sin, [S, D] or [1, S, 1, D], as [1 or B, S, 1, D] in
    ``dtype``; ``position_ids`` [B, S] gathers rows of the table."""
    t = t.reshape(1, t.shape[-2], 1, t.shape[-1]) if t.dim() == 2 else t
    if position_ids is not None:
        t = t[0, :, 0][position_ids.long()][:, :, None, :]
    return t.to(dtype)


def fused_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, position_ids=None):
    """Rotary embedding applied to q, k [B, S, H, D]; cos/sin [S, D] or
    [1, S, 1, D]. Each output keeps its input's dtype: the tables are
    cast to it, as the serving rope does. (The JAX ``fused_rope``
    multiplies by the f32 tables uncast, which promotes bf16 q/k to
    f32; in f32 the two are the same.) Under ``amp.auto_cast`` the port
    promotes as the JAX one does, so the dtypes that flow on into
    attention are the JAX package's."""
    out = []
    for x in (q, k):
        dt = (torch.promote_types(x.dtype, cos.dtype) if amp.enabled()
              else x.dtype)
        c = _table(cos, position_ids, dt)
        s = _table(sin, position_ids, dt)
        out.append(x * c + rotate_half(x) * s)
    return out[0], out[1]

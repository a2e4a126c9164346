"""Model-parallel layers at degree 1 (counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py``).

Tensor parallelism is a later slice; at degree 1 the three layers are a
plain embedding and plain bias-free linears. They keep the JAX layers'
names so models read the same. Note the weight layout: these are
``nn.Linear``s, weight ``[out, in]``, where the JAX package stores
``[in, out]``; ``paddle_tpu_torch.convert`` transposes on load.
"""
from __future__ import annotations

from torch import nn

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear"]


class VocabParallelEmbedding(nn.Embedding):
    """Token embedding, weight [vocab, hidden] as in the JAX package."""


class ColumnParallelLinear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=None):
        super().__init__(in_features, out_features, bias=False,
                         device=device, dtype=dtype)


class RowParallelLinear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=None):
        super().__init__(in_features, out_features, bias=False,
                         device=device, dtype=dtype)

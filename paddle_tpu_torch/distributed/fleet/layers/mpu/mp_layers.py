"""Model-parallel layers at degree 1 (counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py``).

Tensor parallelism is a later slice; at degree 1 the three layers are a
plain embedding and plain bias-free linears, and
``parallel_cross_entropy`` is the plain cross entropy. They keep the JAX layers'
names so models read the same. Note the weight layout: these are
``nn.Linear``s, weight ``[out, in]``, where the JAX package stores
``[in, out]``; ``paddle_tpu_torch.convert`` transposes on load. Under
``amp.auto_cast`` the linears cast their f32 input and weight to the AMP
dtype (op ``linear``), as the JAX dispatch hook does.
"""
from __future__ import annotations

from torch import nn
from torch.nn import functional as TF

from .....amp import cast_inputs
from .....nn import functional as F

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "parallel_cross_entropy"]


class VocabParallelEmbedding(nn.Embedding):
    """Token embedding, weight [vocab, hidden] as in the JAX package."""


class _Linear(nn.Linear):
    def forward(self, x):
        return TF.linear(*cast_inputs("linear", x, self.weight, self.bias))


class ColumnParallelLinear(_Linear):
    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=None):
        super().__init__(in_features, out_features, bias=False,
                         device=device, dtype=dtype)


class RowParallelLinear(_Linear):
    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=None):
        super().__init__(in_features, out_features, bias=False,
                         device=device, dtype=dtype)


def parallel_cross_entropy(logits, label, mp_group=None,
                           ignore_index: int = -100):
    """Softmax cross entropy over (at degree 1, unsharded) vocab logits:
    f32 log-softmax, ``ignore_index`` labels give 0, loss shape
    ``label.shape + [1]`` as the reference returns it."""
    if mp_group is not None and getattr(mp_group, "nranks", 1) > 1:
        raise NotImplementedError(
            "parallel_cross_entropy over a model-parallel group of more "
            "than one rank is not ported yet (ROADMAP.md queue 1, item 8)")
    loss = F.cross_entropy(logits, label, reduction="none",
                           ignore_index=ignore_index)
    return loss.unsqueeze(-1)

"""The TensorParallel wrapper (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/tensor_parallel.py``).

One process a rank: the wrapper makes every rank start from the same
weights, as the reference's does: each replicated parameter is broadcast
from the model-parallel group's first rank, and every parameter from the
data-parallel and the sharding group's first ranks. Forward, ``parameters`` and the state
dict are the wrapped model's. Gradient averaging over dp is
``ParallelEngine``'s (or ``HybridParallelOptimizer``'s in an eager loop).
"""
from __future__ import annotations

import torch
from torch import nn

from ... import collective as C
from ..layers.mpu.mp_layers import mp_sharded

__all__ = ["TensorParallel", "SegmentParallel"]


class _DelegateWrapper(nn.Module):
    def __init__(self, layers: nn.Module, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def parameters(self, recurse: bool = True):
        return self._layers.parameters(recurse)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, state_dict, *a, **k):
        return self._layers.load_state_dict(state_dict, *a, **k)


class TensorParallel(_DelegateWrapper):
    def __init__(self, layers: nn.Module, hcg=None, strategy=None):
        super().__init__(layers, hcg, strategy)
        if hcg is not None:
            self._broadcast(hcg)

    @torch.no_grad()
    def _broadcast(self, hcg):
        mp = hcg.get_model_parallel_group()
        for p in self._layers.parameters():
            if mp.nranks > 1 and not mp_sharded(p):
                C.broadcast(p.data, mp.ranks[0], group=mp)
            for g in (hcg.get_data_parallel_group(),
                      hcg.get_sharding_parallel_group()):
                if g.nranks > 1:
                    C.broadcast(p.data, g.ranks[0], group=g)


class SegmentParallel(_DelegateWrapper):
    def __init__(self, *a, **k):
        raise NotImplementedError(
            "SegmentParallel (a sep axis, context parallelism): not ported "
            "yet (ROADMAP.md queue 1, item 10)")


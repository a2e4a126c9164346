"""Megatron-style sequence parallelism over the model-parallel group
(counterpart of
``paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py``).

Sequence parallelism keeps activations split along the sequence between
the tensor-parallel linears: the column linear all-gathers the sequence
right before its product (backward: reduce-scatter) and the row linear
reduce-scatters its output along the sequence (backward: all-gather), in
place of plain tensor parallelism's identity / all-reduce pair. Each
primitive is one of ``mp_ops``'s autograd Functions (one process a rank,
the collective over the mp group: ``group``, else the fleet HCG's); off
an mp group of more than one rank every primitive is the identity, as
the JAX ones are outside an SPMD region.

``seq_axis`` names the sequence dim (default 0, the reference's
``[s, b, h]``; the port's models are ``[b, s, h]``). Replicated
parameters applied to sequence shards (norms, the row linear's bias) are
marked ``sequence_parallel``: ``ParallelEngine``'s step and
``HybridParallelOptimizer.step()`` sum their gradients over the mp group
before the clip and the update (``parallel.sync_hybrid_gradients``), as
the JAX engine psums them inside its step (``_param_grad_axes``).

``hybrid_configs["mp_configs"]["mp_async_allreduce"]`` (the JAX linears'
collective-matmul rings) raises: ROADMAP.md queue 1, item 10.
"""
from __future__ import annotations

from typing import List

import torch

from ....amp import cast_inputs
from ....core.enforce import enforce
from ..layers.mpu.mp_layers import _Linear, mark_distributed
from ..layers.mpu.mp_ops import (allgather_reducescatter_bwd,
                                 allgather_slice_bwd,
                                 reducescatter_allgather_bwd,
                                 slice_allgather_bwd)
from ..layers.mpu.mp_ops import mp_group as _group_of

__all__ = [
    "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
    "scatter", "gather", "all_gather", "reduce_scatter",
    "identity_in_sequence_parallel",
    "mark_as_sequence_parallel_parameter",
    "is_sequence_parallel_parameter",
    "register_sequence_parallel_allreduce_hooks",
    "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
]


def scatter(x: torch.Tensor, group=None, axis: int = 0) -> torch.Tensor:
    """This rank's slice of the sequence dim; backward all-gathers
    (reference ScatterOp)."""
    g = _group_of(group)
    if g is None:
        return x
    enforce(x.shape[axis] % g.nranks == 0,
            f"sequence dim {x.shape[axis]} must divide mp degree {g.nranks}")
    return slice_allgather_bwd(x, g, axis)


def all_gather(x: torch.Tensor, group=None, axis: int = 0) -> torch.Tensor:
    """All-gather the sequence dim; backward reduce-scatters (reference
    AllGatherOp)."""
    g = _group_of(group)
    return x if g is None else allgather_reducescatter_bwd(x, g, axis)


def gather(x: torch.Tensor, group=None, axis: int = 0) -> torch.Tensor:
    """All-gather the sequence dim; backward takes this rank's slice
    (reference GatherOp)."""
    g = _group_of(group)
    return x if g is None else allgather_slice_bwd(x, g, axis)


def reduce_scatter(x: torch.Tensor, group=None,
                   axis: int = 0) -> torch.Tensor:
    """Reduce-scatter (sum) along the sequence dim; backward all-gathers
    (reference ReduceScatterOp)."""
    g = _group_of(group)
    return x if g is None else reducescatter_allgather_bwd(x, g, axis)


class _OpAlias:
    """The reference's PyLayer surface: ``ScatterOp.apply(x)``."""

    def __init__(self, fn):
        self._fn = fn

    def apply(self, x, group=None, axis: int = 0):
        return self._fn(x, group=group, axis=axis)

    __call__ = apply


ScatterOp = _OpAlias(scatter)
GatherOp = _OpAlias(gather)
AllGatherOp = _OpAlias(all_gather)
ReduceScatterOp = _OpAlias(reduce_scatter)


def identity_in_sequence_parallel(x: torch.Tensor) -> torch.Tensor:
    return x


def mark_as_sequence_parallel_parameter(parameter) -> None:
    """Mark a replicated parameter applied to sequence shards: its
    gradient is summed over mp by ``parallel.sync_hybrid_gradients``."""
    parameter.sequence_parallel = True


def is_sequence_parallel_parameter(parameter) -> bool:
    return bool(getattr(parameter, "sequence_parallel", False))


def register_sequence_parallel_allreduce_hooks(
        model, accumulation_steps: int = 1,
        fused_allreduce: bool = False) -> List[torch.Tensor]:
    """The marked parameters of ``model``. The reference registers
    backward hooks that all-reduce their gradients over mp; here both
    ``ParallelEngine``'s step and ``HybridParallelOptimizer.step()``
    (``fleet.distributed_optimizer``) sum them over mp before the clip
    and the update (``parallel.sync_hybrid_gradients``)."""
    return [p for p in model.parameters()
            if is_sequence_parallel_parameter(p)]


def _refuse_unported(weight_attr):
    """``weight_attr`` (a ParamAttr: ROADMAP.md queue 1, item 2.2) and the
    collective-matmul rings (item 10) raise."""
    if weight_attr is not None:
        raise NotImplementedError(
            "sequence-parallel linears' weight_attr: the port has no "
            "ParamAttr (ROADMAP.md queue 1, item 2.2)")
    from ... import fleet as _fleet

    st = _fleet.get_strategy()
    mp_conf = (st.hybrid_configs.get("mp_configs") or {}) if st else {}
    if mp_conf.get("mp_async_allreduce"):
        raise NotImplementedError(
            "hybrid_configs['mp_configs']['mp_async_allreduce'] (the "
            "collective-matmul rings of the sequence-parallel linears) is "
            "not ported yet: ROADMAP.md queue 1, item 10")


class _SPLinear(_Linear):
    def _setup(self, g, seq_axis):
        self._mp_group = g
        self._seq_axis = seq_axis
        self.world_size = 1 if g is None else g.nranks
        self.is_mp = g is not None

    def extra_repr(self):
        return super().extra_repr() + f", mp={self.world_size}, sp"


class ColumnSequenceParallelLinear(_SPLinear):
    """Column-parallel linear whose input arrives sequence-sharded: the
    sequence all-gathered, then the product with this rank's output
    columns (weight ``[out / mp, in]``, bias ``[out / mp]``). Its output
    stays column-sharded: ``gather_output`` must be False."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, gather_output: bool = False,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None,
                 seq_axis: int = 0, device=None, dtype=None):
        enforce(not gather_output,
                "ColumnSequenceParallelLinear requires gather_output=False")
        _refuse_unported(weight_attr)
        g = _group_of(mp_group)
        n = 1 if g is None else g.nranks
        enforce(out_features % n == 0,
                f"out_features {out_features} must divide mp degree {n}")
        super().__init__(in_features, out_features // n, bias=has_bias,
                         device=device, dtype=dtype)
        self._setup(g, seq_axis)
        self.full_out_features = out_features
        if self.is_mp:
            mark_distributed(self.weight, 0, g)
            if self.bias is not None:
                mark_distributed(self.bias, 0, g)

    def forward(self, x):
        if self.is_mp:
            x = all_gather(x, self._mp_group, axis=self._seq_axis)
        return super().forward(x)


class RowSequenceParallelLinear(_SPLinear):
    """Row-parallel linear whose output leaves sequence-sharded: this
    rank's product (weight ``[out, in / mp]``), reduce-scattered along
    the sequence, then the replicated bias, marked sequence-parallel.
    ``input_is_parallel`` must be True."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, input_is_parallel: bool = True,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None,
                 seq_axis: int = 0, device=None, dtype=None):
        enforce(input_is_parallel,
                "RowSequenceParallelLinear requires input_is_parallel=True")
        _refuse_unported(weight_attr)
        g = _group_of(mp_group)
        n = 1 if g is None else g.nranks
        enforce(in_features % n == 0,
                f"in_features {in_features} must divide mp degree {n}")
        super().__init__(in_features // n, out_features, bias=has_bias,
                         device=device, dtype=dtype)
        self._setup(g, seq_axis)
        self.full_in_features = in_features
        if self.is_mp:
            mark_distributed(self.weight, 1, g)
            if self.bias is not None:
                # replicated, but added to sequence shards
                mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        if not self.is_mp:
            return super().forward(x)
        x, w, b = cast_inputs("linear", x, self.weight, self.bias)
        out = reduce_scatter(torch.nn.functional.linear(x, w),
                             self._mp_group, axis=self._seq_axis)
        return out if b is None else out + b

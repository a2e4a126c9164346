"""The per-strategy model wrappers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/__init__.py``):
``wrap_distributed_model`` picks one by the HCG, as the reference's
``fleet/model.py`` does: pp (or a ``PipelineLayer``) ->
``PipelineParallel``, mp -> ``TensorParallel``, sep -> ``SegmentParallel``
(raises: ROADMAP.md queue 1, item 10), dp or sharding ->
``DataParallel`` over the dp group (a sharding axis is ZeRO's, which
``ParallelEngine`` runs); the pipeline's layers come from
``parallel_layers``.
"""
from __future__ import annotations

from .parallel_layers import (LayerDesc, PipelineLayer, SegmentLayers,
                              SharedLayerDesc)
from .pipeline_parallel import PipelineParallel
from .tensor_parallel import SegmentParallel, TensorParallel

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
           "PipelineParallel", "TensorParallel", "SegmentParallel",
           "wrap_distributed_model"]


def wrap_distributed_model(model, hcg, strategy):
    if hcg is None:
        return model
    if hcg.get_pipe_parallel_world_size() > 1 or isinstance(model,
                                                            PipelineLayer):
        return PipelineParallel(model, hcg, strategy)
    if hcg.get_model_parallel_world_size() > 1:
        return TensorParallel(model, hcg, strategy)
    if hcg.get_sep_parallel_world_size() > 1:
        return SegmentParallel(model, hcg, strategy)
    if hcg.get_sharding_parallel_world_size() > 1:
        # ZeRO: the engine syncs gradients over dp x sharding; the
        # wrapper only makes every replica start from the same weights
        return TensorParallel(model, hcg, strategy)
    if hcg.get_data_parallel_world_size() > 1:
        from ...parallel import DataParallel

        return DataParallel(model, group=hcg.get_data_parallel_group())
    return model

"""The per-strategy model wrappers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/__init__.py``):
``wrap_distributed_model`` picks one by the HCG, as the reference's
``fleet/model.py`` does: pp -> ``PipelineParallel`` (raises: ROADMAP.md
queue 1, item 9), mp -> ``TensorParallel``, sep -> ``SegmentParallel``
(raises: item 10), dp -> ``DataParallel``; sharding raises (item 9).
"""
from __future__ import annotations

from .tensor_parallel import (PipelineParallel, SegmentParallel,
                              TensorParallel)

__all__ = ["PipelineParallel", "TensorParallel", "SegmentParallel",
           "wrap_distributed_model"]


def wrap_distributed_model(model, hcg, strategy):
    if hcg is None:
        return model
    if hcg.get_pipe_parallel_world_size() > 1:
        return PipelineParallel(model, hcg, strategy)
    if hcg.get_sharding_parallel_world_size() > 1:
        raise NotImplementedError(
            "fleet.distributed_model with a sharding axis (ZeRO): not "
            "ported yet (ROADMAP.md queue 1, item 9)")
    if hcg.get_model_parallel_world_size() > 1:
        return TensorParallel(model, hcg, strategy)
    if hcg.get_sep_parallel_world_size() > 1:
        return SegmentParallel(model, hcg, strategy)
    if hcg.get_data_parallel_world_size() > 1:
        from ...parallel import DataParallel

        return DataParallel(model, group=hcg.get_data_parallel_group())
    return model

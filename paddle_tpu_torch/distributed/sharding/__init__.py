"""Group-sharded (ZeRO) data parallelism (counterpart of
``paddle_tpu/distributed/sharding/__init__.py``; reference:
python/paddle/distributed/sharding/group_sharded.py:40, 149).

Levels, by the reference's names:

- ``os``: ZeRO-1, the optimizer state sharded over the sharding group;
- ``os_g``: ZeRO-2, the gradients reduce-scattered onto their shards too;
- ``p_g_os``: ZeRO-3, the parameters stored as shards between steps and
  gathered whole at the step's entry.

``group_sharded_parallel`` marks the model and the optimizer as the JAX
one does (``state_partition_axis = "sharding"``, ``_zero3`` on every
trainable parameter at ``p_g_os``; the optimizer also keeps the model,
whose linears an eager step's plan reads); ``ParallelEngine`` over a
mesh with a sharding axis runs the plan (``engine._ZeroPlan``,
``grad_buckets.ZeroStep``), and so does an eager loop through the
wrapper: one process a rank, the reduce-scatter and
the all-gathers on ``torch.distributed``. In the port stages 1 and 2 run
the same step (the gradient reduce-scattered onto the shard that is
updated), as the JAX engine's do.

``save_group_sharded_model`` writes the full state in the JAX
``framework/io.py`` format: the parameters gathered over every axis in
the JAX layout (``convert.export_jax_state_dict``), and the optimizer's
slots with each ZeRO shard gathered whole. Every rank calls it (the
gathers are collectives); the global rank 0 writes. ``offload=True``
raises: ROADMAP.md queue 1, item 9.1 (host offload).
"""
from __future__ import annotations

import os

import torch

from ...core.enforce import enforce
from ..fleet.meta_optimizers import DygraphShardingOptimizer

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]

LEVELS = ("os", "os_g", "p_g_os")


def group_sharded_parallel(model, optimizer, level: str, scaler=None,
                           group=None, offload: bool = False,
                           sync_buffers: bool = False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm: bool = False, dp_group=None,
                           exclude_layer=None):
    """Mark ``model`` and ``optimizer`` for ZeRO at ``level`` (module
    docstring); returns ``(model, optimizer, scaler)``, the optimizer
    wrapped in ``DygraphShardingOptimizer`` unless it is a fleet
    wrapper already."""
    if level not in LEVELS:
        raise ValueError(f"level must be one of {LEVELS}, got {level!r}")
    if offload:
        raise NotImplementedError(
            "group_sharded_parallel(offload=True): host offload is not "
            "ported yet (ROADMAP.md queue 1, item 9.1)")
    inner = getattr(optimizer, "_inner_opt", optimizer)
    inner.state_partition_axis = "sharding"
    inner._sharded_model = model
    if level == "p_g_os":
        for p in model.parameters():
            if p.requires_grad:
                p._zero3 = True
    if not hasattr(optimizer, "_inner_opt"):
        optimizer = DygraphShardingOptimizer(optimizer)
    return model, optimizer, scaler


@torch.no_grad()
def _whole_slots(opt) -> dict:
    """The optimizer's ``state_dict`` with every ZeRO shard (slot or f32
    master) gathered whole over the sharding group."""
    from .. import collective as C
    from ..grad_buckets import from_rank_major

    zs = getattr(opt, "_zero_step", None)
    out = opt.state_dict()
    if zs is None:
        return out
    for p in opt._parameter_list:
        e = zs.entry(p)
        if e is None or id(p) not in opt._states:
            continue
        key = opt._names[id(p)]
        tensors = dict(opt._states[id(p)])
        if id(p) in opt._master_weights:
            tensors["master_weight"] = opt._master_weights[id(p)]
        for k, t in tensors.items():
            rows = C.t_all_gather(t.contiguous().reshape(-1), zs.sh, axis=0,
                                  tiled=False) if zs.sh is not None \
                else t.reshape(1, -1)
            out[f"{key}.{k}"] = from_rank_major(rows, e[0], t.shape)
    return out


def save_group_sharded_model(model, output, optimizer=None):
    """Save the full, gathered state of a group-sharded model (module
    docstring): ``output/model.pdmodel`` and, with ``optimizer``,
    ``output/model.pdopt``."""
    from .. import collective as C
    from ...convert import export_jax_state_dict
    from ...framework import io as _io

    layers = getattr(model, "_layers", model)
    enforce(getattr(model, "_layers", None) is None
            or isinstance(layers, torch.nn.Module),
            "save_group_sharded_model takes the model or its fleet wrapper")
    state = export_jax_state_dict(layers, tensors=True)
    opt_state = None
    if optimizer is not None:
        opt_state = _whole_slots(getattr(optimizer, "_inner_opt", optimizer))
    if C.get_rank() != 0:
        return
    os.makedirs(output, exist_ok=True)
    _io.save(state, os.path.join(output, "model.pdmodel"))
    if opt_state is not None:
        _io.save(opt_state, os.path.join(output, "model.pdopt"))

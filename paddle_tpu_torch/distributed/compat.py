"""The distributed API's tail (counterpart of
``paddle_tpu/distributed/compat.py``): aliases over
``distributed/collective.py`` and ``spawn``. The auto-parallel entries
(``DistModel``, ``to_static``, ``shard_optimizer``, ``shard_scaler``,
``shard_dataloader``, ``unshard_dtensor``) raise: ROADMAP.md queue 1,
item 8.3 (they stand on the JAX ``distributed/auto_parallel/`` engine). The parameter-server datasets raise as the JAX
package's do (the brpc data path is out of the reference's scope).
"""
from __future__ import annotations

import os

import torch

from ..core.enforce import enforce
from . import collective as C

__all__ = [
    "alltoall", "alltoall_single", "gather", "scatter_object_list",
    "destroy_process_group", "get_backend", "is_available",
    "is_initialized", "wait", "spawn",
    "DistModel", "to_static", "shard_optimizer", "shard_scaler",
    "shard_dataloader", "unshard_dtensor",
    "InMemoryDataset", "QueueDataset", "CountFilterEntry",
    "ProbabilityEntry", "ShowClickEntry",
    "load_state_dict", "save_state_dict",
]

alltoall = C.alltoall
destroy_process_group = C.destroy_process_group
get_backend = C.get_backend
is_initialized = C.is_initialized
wait = C.wait


def is_available() -> bool:
    return torch.distributed.is_available()


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Single-tensor all-to-all: dim 0 split into equal blocks, block j
    to member j; written into ``out_tensor`` when given."""
    g = group or C.get_group(0)
    enforce(in_split_sizes is None and out_split_sizes is None,
            "alltoall_single takes equal splits only (split sizes None), "
            "as the JAX package does")
    result = C.all_to_all(in_tensor, group=g)
    if out_tensor is not None:
        with torch.no_grad():
            out_tensor.copy_(result)
        return out_tensor
    return result


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every member's ``tensor`` on global rank ``dst`` (appended to
    ``gather_list`` there and returned); None elsewhere. Built on
    all_gather, as the JAX package's."""
    out = []
    C.all_gather(out, tensor, group=group)
    if C.get_rank() != dst:
        return None
    if gather_list is not None:
        gather_list.extend(out)
    return out


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Member i gets the i-th block of ``in_object_list`` of global rank
    ``src`` (its length divisible by the group's size)."""
    g = group or C.get_group(0)
    objs = [list(in_object_list) if C.get_rank() == src else None]
    C.broadcast_object_list(objs, src=src, group=g)
    objs = objs[0]
    n = g.nranks
    enforce(objs is not None and len(objs) % n == 0,
            lambda: f"scatter_object_list needs len(in_object_list) "
                    f"({len(objs or [])}) divisible by the group size ({n})")
    per = len(objs) // n
    out_object_list.clear()
    out_object_list.extend(objs[g.rank * per:(g.rank + 1) * per])


def _spawn_entry(func, args, rank, nprocs):
    os.environ.update(PADDLE_TRAINER_ID=str(rank), RANK=str(rank),
                      PADDLE_TRAINERS_NUM=str(nprocs),
                      WORLD_SIZE=str(nprocs), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(nprocs))
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Start ``nprocs`` processes (spawned, not forked: a parent that
    has touched CUDA cannot fork) running ``func(*args)`` with the
    launcher's rank variables set; ``func`` must be importable. With
    ``join`` a failing child raises. Returns the processes."""
    import multiprocessing as mp

    if nprocs <= 0:
        nprocs = int(os.environ.get("PADDLE_TPU_NPROCS", "1"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_spawn_entry, args=(func, args, r, nprocs),
                         daemon=daemon) for r in range(nprocs)]
    for p in procs:
        p.start()
    if join:
        for p in procs:
            p.join()
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        enforce(not bad, f"spawn: child exit codes {bad}")
    return procs


def _auto_parallel(name):
    raise NotImplementedError(
        f"{name} (auto parallel) is not ported yet: ROADMAP.md queue 1, "
        f"item 8.3")


class DistModel:
    def __init__(self, *a, **k):
        _auto_parallel("DistModel")


def to_static(layer, loader=None, loss=None, optimizer=None, strategy=None):
    _auto_parallel("distributed.to_static")


def shard_optimizer(optimizer, shard_fn=None):
    _auto_parallel("shard_optimizer")


def shard_scaler(scaler):
    _auto_parallel("shard_scaler")


def shard_dataloader(dataloader, meshes=None, shard_dims=None,
                     is_dataset_splitted=False):
    _auto_parallel("shard_dataloader")


def unshard_dtensor(dist_tensor):
    _auto_parallel("unshard_dtensor")


def _ps_gate(name):
    raise NotImplementedError(
        f"{name} belongs to the brpc parameter-server data path, out of "
        f"the reference's scope (the JAX package raises it too)")


class InMemoryDataset:
    def __init__(self, *a, **k):
        _ps_gate("InMemoryDataset")


class QueueDataset:
    def __init__(self, *a, **k):
        _ps_gate("QueueDataset")


class CountFilterEntry:
    def __init__(self, *a, **k):
        _ps_gate("CountFilterEntry")


class ProbabilityEntry:
    def __init__(self, *a, **k):
        _ps_gate("ProbabilityEntry")


class ShowClickEntry:
    def __init__(self, *a, **k):
        _ps_gate("ShowClickEntry")


def load_state_dict(state_dict, path, **kw):
    from .checkpoint import load_state_dict as _load

    return _load(state_dict, path, **kw)


def save_state_dict(state_dict, path, **kw):
    from .checkpoint import save_state_dict as _save

    return _save(state_dict, path, **kw)

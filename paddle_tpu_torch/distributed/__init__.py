"""Distributed training (counterpart of ``paddle_tpu/distributed``): the
collectives over ``torch.distributed``, the fleet hybrid-parallel API,
``DataParallel``, the train-step engine and checkpoints. One process a
rank (``python -m paddle_tpu_torch.distributed.launch``)."""
from . import collective  # noqa: F401
from .collective import (  # noqa: F401
    P2POp, Group, ProcessGroup, ReduceOp, all_gather, all_gather_object,
    all_reduce, all_to_all, barrier, batch_isend_irecv, broadcast,
    broadcast_object_list, gather_object, get_group, get_rank,
    get_world_size, init_parallel_env, irecv, isend, new_group, ppermute,
    recv, reduce, reduce_scatter, scatter, send, split_group, stream)
from .compat import *  # noqa: F401,F403
from .parallel import DataParallel, ParallelEnv  # noqa: F401
from .sharding import (group_sharded_parallel,  # noqa: F401
                       save_group_sharded_model)

__all__ = [
    "all_gather", "all_reduce", "all_to_all", "barrier", "broadcast",
    "get_group", "get_rank", "get_world_size", "init_parallel_env",
    "new_group", "recv", "reduce", "reduce_scatter", "scatter", "send",
    "isend", "irecv", "ReduceOp", "Group", "ProcessGroup", "stream",
    "P2POp", "batch_isend_irecv", "DataParallel", "ParallelEnv",
    "split_group", "ppermute", "all_gather_object", "gather_object",
    "broadcast_object_list", "group_sharded_parallel",
    "save_group_sharded_model",
]

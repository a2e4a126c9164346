"""Role makers and ``fleet.util`` (counterpart of
``paddle_tpu/distributed/fleet/base/role_maker.py``).

Roles come from the launcher's environment (``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM``, the variables ``distributed/launch`` exports);
every process is a collective worker (no parameter servers), so
``fleet.init(role_maker=PaddleCloudRoleMaker(is_collective=True))`` runs
unchanged. ``UtilBase``'s collectives go over the world group of
``distributed/collective.py``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "UtilBase"]


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4
    COORDINATOR = 5


class RoleMakerBase:
    def __init__(self, is_collective: bool = True, **kwargs):
        self._is_collective = bool(is_collective)

    def _worker_index(self) -> int:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0"))

    def _worker_num(self) -> int:
        return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))

    def worker_index(self) -> int:
        return self._worker_index()

    def worker_num(self) -> int:
        return self._worker_num()

    def is_worker(self) -> bool:
        return True

    def is_server(self) -> bool:
        return False

    def is_first_worker(self) -> bool:
        return self._worker_index() == 0

    def role_id(self) -> int:
        return self._worker_index()

    def worker_endpoints(self, to_string=False):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        lst = [e for e in eps.split(",") if e]
        return ",".join(lst) if to_string else lst

    def server_endpoints(self, to_string=False):
        return "" if to_string else []


class PaddleCloudRoleMaker(RoleMakerBase):
    """Roles from the launcher's environment."""


class UserDefinedRoleMaker(RoleMakerBase):
    """Explicit role assignment: ``current_id`` / ``worker_num``
    override the environment."""

    def __init__(self, is_collective: bool = True, current_id: int = 0,
                 role=Role.WORKER, worker_num: int = 1,
                 server_endpoints=None, **kwargs):
        super().__init__(is_collective=is_collective)
        self._current_id = int(current_id)
        self._role = role
        self._num = int(worker_num)

    def _worker_index(self) -> int:
        return self._current_id

    def _worker_num(self) -> int:
        return self._num


class UtilBase:
    """``fleet.util``: host-side helpers over the world group."""

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        from ... import collective as C

        ops = {"sum": C.ReduceOp.SUM, "max": C.ReduceOp.MAX,
               "min": C.ReduceOp.MIN}
        if mode not in ops:
            raise ValueError(f"all_reduce mode {mode!r} not in sum/max/min")
        arr = np.asarray(input)
        t = torch.as_tensor(arr).to(C.comm_device())
        return C._c_allreduce(t, ops[mode]).cpu().numpy()

    def all_gather(self, input, comm_world="worker"):
        from ... import collective as C

        return C.all_gather_object([], input)

    def barrier(self, comm_world="worker"):
        from ... import collective as C

        C.barrier()

    def get_file_shard(self, files):
        """Split a file list contiguously across workers (the first
        len % n workers get one extra)."""
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        n = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        base, extra = divmod(len(files), n)
        start = rank * base + min(rank, extra)
        return list(files[start:start + base + (1 if rank < extra else 0)])

    def print_on_rank(self, message, rank_id=0):
        if int(os.environ.get("PADDLE_TRAINER_ID", "0")) == int(rank_id):
            print(message)

"""DataParallel, its bucketed Reducer and ParallelEnv (counterpart of
``paddle_tpu/distributed/parallel.py``).

The eager data-parallel API, one process a rank: ``DataParallel(model)``
registers a hook on every trainable parameter; the ``Reducer`` fills
buckets of about ``comm_buffer_size`` MB in reverse registration order
(gradients arrive back to front) and, the moment a bucket's last gradient
arrives, averages the bucket over the group with one all-reduce of a
flat f32 buffer (``fused_reduce_count`` counts them). A parameter used
twice in one backward (tied weights) delivers several partial gradients:
they are summed before the fire, and a bucket's fire replaces only this
pass's provisional part of each ``.grad``, so gradients accumulated
under ``no_sync`` survive. What is still pending when the backward ends
(reused or unused parameters) is reduced by a callback queued on the
autograd engine. ``find_unused_parameters`` puts every parameter in a
bucket of its own. In a world of one the reduction is the identity.

``fused_allreduce_gradients(params, group)`` averages the gradients of
``params`` over ``group`` after a backward (one all-reduce a dtype).
``sync_hybrid_gradients(params, dp_group, mp_group)`` is the hybrid
step's gradient sync that ``ParallelEngine`` and
``HybridParallelOptimizer`` both run: that mean over the dp group, then
the sum over the mp group of the gradients of parameters marked
``sequence_parallel`` (each mp rank holds only its sequence shard's
part of those: the JAX engine's ``_param_grad_axes``).
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional

import torch
from torch import nn

from ..core.enforce import enforce
from ..observability import commledger as cl
from . import collective as C

__all__ = ["DataParallel", "ParallelEnv", "Reducer",
           "fused_allreduce_gradients", "sync_hybrid_gradients"]


class ParallelEnv:
    """The launcher's environment, read at each access."""

    @property
    def rank(self) -> int:
        return C.get_rank()

    @property
    def world_size(self) -> int:
        return C.get_world_size()

    @property
    def device_id(self) -> int:
        return int(os.environ.get("LOCAL_RANK", os.environ.get(
            "FLAGS_selected_gpus", "0").split(",")[0]))

    @property
    def current_endpoint(self) -> str:
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")

    @property
    def nranks(self):
        return self.world_size

    @property
    def local_rank(self):
        return int(os.environ.get("LOCAL_RANK", self.rank))


@torch.no_grad()
def fused_allreduce_gradients(params, group: Optional[C.Group],
                              mean: bool = True) -> None:
    """Average (``mean``; else sum) the (dense) gradients of ``params``
    over ``group``: one all-reduce a dtype over a flat buffer, then /
    nranks (the JAX pmean)."""
    if group is None or group.nranks <= 1:
        return
    ps = [p for p in params if p.grad is not None]
    enforce(not any(p.grad.is_sparse for p in ps),
            "sparse (SelectedRows) gradients under data parallelism are not "
            "ported yet: ROADMAP.md queue 1, item 8.2")
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in ps:
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for same in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in same])
        C.all_reduce(flat, C.ReduceOp.AVG if mean else C.ReduceOp.SUM,
                     group=group)
        off = 0
        for p in same:
            n = p.grad.numel()
            p.grad.copy_(flat[off:off + n].view_as(p.grad))
            off += n


def sync_hybrid_gradients(params, dp_group: Optional[C.Group],
                          mp_group: Optional[C.Group]) -> None:
    """Average the gradients of ``params`` over ``dp_group``, then sum
    those of the parameters marked ``sequence_parallel`` over
    ``mp_group`` (module docstring); before the clip and the update."""
    params = list(params)
    fused_allreduce_gradients(params, dp_group)
    fused_allreduce_gradients(
        [p for p in params if getattr(p, "sequence_parallel", False)],
        mp_group, mean=False)


class Reducer:
    """Bucketed fused gradient averaging (module docstring)."""

    def __init__(self, params, group=None, comm_buffer_size_mb: float = 25.0,
                 find_unused_parameters: bool = False):
        self.group = group
        self._params = [p for p in params if p.requires_grad]
        self._enabled = True
        budget = 0 if find_unused_parameters else \
            comm_buffer_size_mb * (1 << 20)
        self._buckets: List[List[torch.Tensor]] = []
        cur, cur_bytes = [], 0
        for p in reversed(self._params):
            nbytes = p.numel() * p.element_size()
            if cur and cur_bytes + nbytes > budget:
                self._buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(p)
            cur_bytes += nbytes
        if cur:
            self._buckets.append(cur)
        self._bucket_of = {id(p): bi for bi, b in enumerate(self._buckets)
                           for p in b}
        self._pending: List[Dict[int, torch.Tensor]] = [
            {} for _ in self._buckets]
        self._flush_queued = False
        self.fused_reduce_count = 0
        # the forward thread's open comm captures (``DataParallel.forward``):
        # a CUDA backward's hooks run on autograd's device thread
        self.captures = ()

    @property
    def num_buckets(self) -> int:
        return len(self._buckets)

    def hook_for(self, p):
        bi = self._bucket_of[id(p)]

        def hook(grad):
            if not self._enabled:
                return grad
            if not self._flush_queued:
                # the end-of-backward flush (the reference Reducer's
                # finalize_backward)
                torch.autograd.Variable._execution_engine.queue_callback(
                    self._end_of_backward)
                self._flush_queued = True
            with cl.carried(self.captures):
                return self._arrive(bi, p, grad)

        return hook

    def _end_of_backward(self):
        self._flush_queued = False
        with cl.carried(self.captures):
            self.flush()

    def flush(self):
        """Reduce the partial buckets still pending (reused parameters'
        late partials; buckets starved by parameters with no gradient)."""
        if not self._enabled:
            for pend in self._pending:
                pend.clear()
            return
        for bi in range(len(self._buckets)):
            self._reduce_pending(bi)

    def _arrive(self, bi, p, grad):
        pend = self._pending[bi]
        prev = pend.get(id(p))
        pend[id(p)] = grad if prev is None else prev + grad
        if len(pend) < len(self._buckets[bi]):
            return grad           # provisional: swapped when the bucket fires
        return self._reduce_pending(bi, p, grad)

    @torch.no_grad()
    def _reduce_pending(self, bi, p=None, p_cur=None):
        """Average bucket ``bi``'s pending gradients with one all-reduce
        and swap them into their ``.grad``s; for ``p`` (whose hook is
        firing, its current partial ``p_cur`` not yet accumulated) return
        the value to accumulate instead."""
        pend = self._pending[bi]
        if not pend:
            return None
        bucket = [q for q in self._buckets[bi] if id(q) in pend]
        vals = [pend[id(q)] for q in bucket]
        flat = torch.cat([v.reshape(-1).float() for v in vals])
        red = C.t_pmean(flat, self.group)
        self.fused_reduce_count += 1
        off, out = 0, None
        for q, v in zip(bucket, vals):
            n = v.numel()
            piece = red[off:off + n].view_as(v).to(v.dtype)
            off += n
            if q is p:
                # .grad already holds this pass's earlier partials of p
                # (v - p_cur): the reduced total lands exactly once
                out = piece - (v - p_cur)
            elif q.grad is not None:
                q.grad.copy_(q.grad - v + piece)
            else:
                q.grad = piece.clone()
        self._pending[bi] = {}
        return out


class DataParallel(nn.Module):
    """Data parallelism over ``group`` (the world by default): gradients
    averaged by a bucketed ``Reducer`` on parameter hooks."""

    def __init__(self, layers: nn.Module, strategy=None,
                 comm_buffer_size: float = 25, last_comm_buffer_size: float = 1,
                 find_unused_parameters=False,
                 group: Optional[C.Group] = None):
        super().__init__()
        self._layers = layers
        self.group = group or C.get_group(0)
        self.find_unused_parameters = find_unused_parameters
        self._reducer = Reducer(layers.parameters(), group=self.group,
                                comm_buffer_size_mb=comm_buffer_size,
                                find_unused_parameters=find_unused_parameters)
        self._hooks = [p.register_hook(self._reducer.hook_for(p))
                       for p in layers.parameters() if p.requires_grad]

    def forward(self, *inputs, **kwargs):
        self._reducer.captures = cl.open_captures()
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    load_state_dict = set_state_dict

    def scale_loss(self, loss):
        return loss

    @contextlib.contextmanager
    def no_sync(self):
        """Skip the gradient averaging inside the context (local
        accumulation)."""
        self._reducer._enabled = False
        try:
            yield
        finally:
            self._reducer._enabled = True

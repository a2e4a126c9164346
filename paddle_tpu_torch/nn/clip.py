"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

``apply_values(grads)`` returns the clipped gradients as new tensors,
as the JAX ``apply_values`` returns new arrays; each keeps its
gradient's dtype, the scaled value computed in f32 and rounded to it,
as the JAX ``(g * scale).astype(g.dtype)`` with an f32 ``scale`` does.
The optimizers call it from their ``_fused_update``. On CUDA, Adam and
AdamW fold ``ClipGradByGlobalNorm`` into kernel K8
(``ops/kernels/fused_adam.py``); ``ClipGradByNorm`` and
``ClipGradByValue`` run here in torch before it, where XLA fused them in
the JAX package. With sparse (SelectedRows) gradients the optimizer
passes their squared norm as ``extra_sq`` and scales their values by
the same ``coefficient``, as the JAX step does.

Under tensor parallelism (``GradSync``, which ``ParallelEngine`` gives the
optimizer over a mesh) every norm is the global one: the squared sums of
a rank's mp shards are all-reduced over the model-parallel group and the
replicated gradients counted once, so mp 2 clips as degree 1 does. (The
JAX package's clip runs inside ``shard_map`` on the gradients it sees
and takes the rank's own norm: ROADMAP.md queue 3.)
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "global_norm", "GradSync"]


def global_norm(grads: List[torch.Tensor], sync=None,
                sharded=None) -> torch.Tensor:
    """The f32 L2 norm over every gradient together (across the
    tensor-parallel ranks with a ``GradSync`` and the gradients'
    ``sharded`` flags)."""
    if sync is not None:
        return torch.sqrt(sync.sq_sum(grads, sharded))
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads))


class GradSync:
    """How a step's gradients cross ranks: ``mp_group`` (a Group of more
    than one rank, or None), over which the squared sums of mp-sharded
    gradients are all-reduced, and ``found_group``, over which an
    overflow flag is maxed (every rank of a mesh; the JAX engine's pmax
    over every axis of more than one rank)."""

    def __init__(self, mp_group=None, found_group=None):
        self.mp_group = mp_group
        self.found_group = found_group

    @staticmethod
    def sharded(params) -> List[bool]:
        """Per parameter: is it a tensor-parallel shard?"""
        return [getattr(p, "mp_group", None) is not None for p in params]

    def sq_sum(self, grads, sharded, extra_sq=0.0) -> torch.Tensor:
        """The f32 squared L2 norm of ``grads`` over the mp group: the
        shards' local sum all-reduced, then the replicated ones' added."""
        from ..distributed import collective as C

        dev = grads[0].device if grads else torch.device("cpu")
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        sh = sum((torch.sum(torch.square(g.float()))
                  for g, s in zip(grads, sharded) if s), zero)
        rep = sum((torch.sum(torch.square(g.float()))
                   for g, s in zip(grads, sharded) if not s), zero)
        if self.mp_group is not None:
            sh = C.t_psum(sh.reshape(1), self.mp_group).reshape(())
        return sh + rep + extra_sq

    def max_found(self, found: torch.Tensor) -> torch.Tensor:
        """An overflow flag maxed over ``found_group``."""
        from ..distributed import collective as C

        if self.found_group is None:
            return found
        return C.t_pmax(found, self.found_group)


class ClipGradBase:
    def apply_values(self, grads: List[torch.Tensor]
                     ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        """(clipped gradients, the global norm where the clip computes
        one, else None)."""
        raise NotImplementedError


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``min(clip_norm / max(norm, 1e-6), 1)``,
    where ``norm`` is the f32 L2 norm over all of them together."""

    def __init__(self, clip_norm: float, group_name: str = "default_group",
                 auto_skip_clip: bool = False):
        self.clip_norm = float(clip_norm)

    def coefficient(self, norm: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-6),
                           max=1.0)

    def apply_values(self, grads, extra_sq=0.0, sync=None, sharded=None):
        """``extra_sq``: the squared norm of gradients clipped elsewhere
        under the same global norm (the optimizer's merged SelectedRows
        gradients); ``sync`` / ``sharded``: the tensor-parallel norm
        (module docstring)."""
        if sync is not None:
            norm = torch.sqrt(sync.sq_sum(grads, sharded, extra_sq))
        else:
            norm = torch.sqrt(torch.as_tensor(
                sum(torch.sum(torch.square(g.float())) for g in grads)
                + extra_sq))
        coef = self.coefficient(norm)
        return [(g.float() * coef).to(g.dtype) for g in grads], norm

    def __repr__(self):
        return f"ClipGradByGlobalNorm(clip_norm={self.clip_norm})"


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient on its own by
    ``min(clip_norm / max(||g||, 1e-6), 1)`` (f32 norm)."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def apply_values(self, grads, sync=None, sharded=None):
        sq = [torch.sum(torch.square(g.float())) for g in grads]
        if sync is not None and sync.mp_group is not None and any(sharded):
            from ..distributed import collective as C

            # one all-reduce for every sharded tensor's squared sum
            idx = [i for i, s in enumerate(sharded) if s]
            tot = C.t_psum(torch.stack([sq[i] for i in idx]), sync.mp_group)
            for j, i in enumerate(idx):
                sq[i] = tot[j]
        out = []
        for g, ss in zip(grads, sq):
            n = torch.sqrt(ss)
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-6),
                                max=1.0)
            out.append((g.float() * scale).to(g.dtype))
        return out, None


class ClipGradByValue(ClipGradBase):
    """Clamp every gradient element into ``[min, max]`` (``min``
    defaults to ``-max``)."""

    def __init__(self, max: float, min: float = None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def apply_values(self, grads, sync=None, sharded=None):
        return [torch.clamp(g, self.min, self.max) for g in grads], None

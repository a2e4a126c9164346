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
replicated gradients counted once, so mp 2 clips as degree 1 does. Over
a mesh with a pipeline or a ZeRO axis (``GradSync(norm_group=...)``)
the norm is taken over every rank: each rank sums the squares of the
gradients it counts (``grad_counted``, set by the engine: an mp shard,
or a replicated gradient on mp rank 0; a ZeRO shard, or a whole
gradient on sharding rank 0; a tied copy on stage 0 only; dp rank 0),
and the sums are all-reduced over ``norm_group``, so every element
counts once. ``ClipGradByNorm`` there sums each tensor's squares over
its ``norm_groups`` (its mp group, its ZeRO shards' group). (The JAX package's clip runs inside ``shard_map`` on the
gradients it sees and takes the rank's own norm: ROADMAP.md queue 3.)
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


class NormFlag:
    """A tensor's part in the norms over a pipeline / ZeRO mesh:
    ``counted`` (its squared sum enters the global norm on this rank; the
    flag's truth value) and ``groups``, the groups over which the
    tensor's own squared sum is summed (its mp group when it is an mp
    shard, the sharding group when it is a ZeRO shard)."""

    __slots__ = ("counted", "groups")

    def __init__(self, counted: bool, groups=()):
        self.counted = bool(counted)
        self.groups = tuple(groups)

    def __bool__(self):
        return self.counted


class GradSync:
    """How a step's gradients cross ranks: ``mp_group`` (a Group of more
    than one rank, or None), over which the squared sums of mp-sharded
    gradients are all-reduced, and ``found_group``, over which an
    overflow flag is maxed (every rank of a mesh; the JAX engine's pmax
    over every axis of more than one rank). With ``norm_group`` the
    counted gradients' squared sums are all-reduced over it and the
    others left out (module docstring)."""

    def __init__(self, mp_group=None, found_group=None, norm_group=None):
        self.mp_group = mp_group
        self.found_group = found_group
        self.norm_group = norm_group

    def sharded(self, params) -> List[bool]:
        """Per tensor, the flag that splits the norm's reduce: is it an
        mp shard (or, with ``norm_group``, a ``NormFlag`` from the
        tensor's ``grad_counted`` and ``norm_groups``)?"""
        if self.norm_group is not None:
            return [NormFlag(getattr(p, "grad_counted", True),
                             getattr(p, "norm_groups", ())) for p in params]
        return [getattr(p, "mp_group", None) is not None for p in params]

    def reduce_split(self, sums: torch.Tensor) -> None:
        """K8's split reduce between its phases: ``sums[0]`` (the flagged
        tensors' squared sum) all-reduced, ``sums[1]`` (the others') kept
        (replicated over mp) or, with ``norm_group``, zeroed."""
        from ..distributed import collective as C

        if self.norm_group is not None:
            C.all_reduce(sums[0:1], C.ReduceOp.SUM, group=self.norm_group)
            sums[1:2].zero_()
        elif self.mp_group is not None:
            C.all_reduce(sums[0:1], C.ReduceOp.SUM, group=self.mp_group)

    def sq_sum(self, grads, sharded, extra_sq=0.0) -> torch.Tensor:
        """The f32 squared L2 norm of ``grads`` over the mp group: the
        shards' local sum all-reduced, then the replicated ones' added;
        with ``norm_group``, the counted ones' sum all-reduced over it."""
        from ..distributed import collective as C

        dev = grads[0].device if grads else torch.device("cpu")
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        sh = sum((torch.sum(torch.square(g.float()))
                  for g, s in zip(grads, sharded) if s), zero)
        if self.norm_group is not None:
            return C.t_psum((sh + extra_sq).reshape(1),
                            self.norm_group).reshape(())
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
        from ..distributed import collective as C

        sq = [torch.sum(torch.square(g.float())) for g in grads]
        if sync is not None and sync.norm_group is not None:
            # a tensor's norm over its shards: one all-reduce a group
            # chain for every squared sum that takes it (NormFlag.groups)
            chains = {}
            for i, f in enumerate(sharded):
                if f.groups:
                    chains.setdefault(f.groups, []).append(i)
            for groups, idx in chains.items():
                tot = torch.stack([sq[i] for i in idx])
                for g in groups:
                    tot = C.t_psum(tot, g)
                for j, i in enumerate(idx):
                    sq[i] = tot[j]
        elif sync is not None and sync.mp_group is not None and any(sharded):
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

"""Bucketed gradient reduce-scatter and ZeRO parameter gather
(counterpart of ``paddle_tpu/distributed/grad_buckets.py``), and the
ZeRO step they serve.

The knobs are the JAX package's (``strategy_config`` / ``stage_config``
read ``hybrid_configs["sharding_configs"]``): ``comm_overlap`` with
``comm_buffer_size_MB`` buckets the gradient sync, ``sharding_stage``
(1/2: ``os`` / ``os_g``, 3: ``p_g_os``) and
``stage3_release_after_forward`` pick the ZeRO storage.

``build_plan`` groups the trainable parameters by sync signature (the
ZeRO reduce-scatter, or a mean over the data group; dtype; stage-3
storage; the pipeline chunk they belong to) and cuts each group into
buckets of about ``comm_buffer_size_MB`` in reverse registration order,
as the JAX plan does. ``BucketPlan.digest()`` is a hash of its canonical
description, the same in every process.

``ZeroStep`` runs one step's ZeRO work over the sharding group: a
bucket's gradients are packed rank-major (rank r's chunk of every
parameter's shard dim as row r) into one flat buffer, averaged over dp,
and reduce-scattered over sharding with the blocks added in rank order
(``collective.psum_scatter_ordered``), then divided by the degree; a
parameter alone goes through the same function, so bucketed and
unbucketed syncs give the same bits. With ``comm_overlap`` a bucket
fires from ``register_post_accumulate_grad_hook`` the moment its last
gradient has been accumulated in an armed backward (``arm``: every
parameter for one backward; a pipeline arms each chunk before its last
microbatch's backward); what never arrived is synced at the step's end.
The update (kernel K8 for Adam / AdamW on CUDA) runs on each rank's
shards: shard-shaped moments and f32 masters, the parameter shard. At
stage 1/2 the parameters stay whole: the updated shards are all-gathered
back, one flat all-gather a bucket. At stage 3 each parameter is stored
as its shard between steps (``p.data`` is the shard, ``p.zero_stored``
says how to gather it), is gathered whole at the step's entry (one flat
all-gather a bucket with ``comm_overlap`` and
``stage3_release_after_forward``, else one a parameter) and released
after the update; its gradients take the stage-2 path, so stage 3 gives
stage 2's bits.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..observability import commledger as cl
from . import collective as C

__all__ = ["BucketPlan", "build_plan", "strategy_config", "stage_config",
           "ZeroStep", "DEFAULT_BUFFER_MB", "rank_major", "from_rank_major"]

DEFAULT_BUFFER_MB = 25.0


def _strategy(strategy):
    if strategy is None:
        from . import fleet as _fleet

        strategy = _fleet.get_strategy()
    return strategy


def strategy_config(strategy=None) -> Tuple[bool, float]:
    """(comm_overlap, comm_buffer_size_MB) of the active fleet strategy,
    or the defaults without one."""
    strategy = _strategy(strategy)
    if strategy is None:
        return False, DEFAULT_BUFFER_MB
    sc = strategy.hybrid_configs.get("sharding_configs") or {}
    return (bool(sc.get("comm_overlap", False)),
            float(sc.get("comm_buffer_size_MB", DEFAULT_BUFFER_MB)))


def stage_config(strategy=None) -> Tuple[int, bool]:
    """(sharding_stage, stage3_release_after_forward); (2, True) with no
    strategy."""
    strategy = _strategy(strategy)
    if strategy is None:
        return 2, True
    sc = strategy.hybrid_configs.get("sharding_configs") or {}
    return (int(sc.get("sharding_stage", 2)),
            bool(sc.get("stage3_release_after_forward", True)))


def rank_major(g: torch.Tensor, d: int, n: int) -> torch.Tensor:
    """[n, -1]: row r holds rank r's chunk of dim ``d`` in the shard's
    own layout."""
    s = tuple(g.shape)
    loc = s[d] // n
    return g.reshape(s[:d] + (n, loc) + s[d + 1:]).movedim(d, 0).reshape(
        n, -1)


def from_rank_major(rows: torch.Tensor, d: int, shard_shape) -> torch.Tensor:
    """The whole tensor from its n rank-major rows (``rank_major``'s
    inverse)."""
    n = rows.shape[0]
    shard_shape = tuple(shard_shape)
    full = list(shard_shape)
    full[d] *= n
    return rows.reshape((n,) + shard_shape).movedim(0, d).reshape(full)


@dataclass(frozen=True)
class BucketEntry:
    pid: int                     # id(param): the runtime key, not hashed
    index: int                   # position among the trainable parameters
    shape: Tuple[int, ...]       # the local gradient's shape
    dtype: str
    shard_dim: Optional[int]     # ZeRO scatter dim (the port's layout)
    stored: bool = False         # stage 3: stored as its shard

    def describe(self) -> Tuple:
        return (self.index, self.shape, self.dtype, self.shard_dim,
                self.stored)

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n * torch.empty((), dtype=getattr(
            torch, self.dtype.replace("torch.", ""))).element_size()


@dataclass
class BucketGroup:
    kind: str                    # "rs" (ZeRO reduce-scatter) | "pmean"
    dtype: str
    stored: bool
    segment: int                 # the pipeline chunk (0 without one)
    entries: List[BucketEntry] = field(default_factory=list)
    buckets: List[List[BucketEntry]] = field(default_factory=list)

    def describe(self) -> Tuple:
        return (self.kind, self.dtype, self.stored, self.segment,
                tuple(tuple(e.describe() for e in b) for b in self.buckets))


class BucketPlan:
    """The static bucketing of one engine's trainable parameters."""

    def __init__(self, groups: List[BucketGroup], buffer_mb: float):
        self.groups = groups
        self.buffer_mb = buffer_mb
        self.buckets: List[Tuple[BucketGroup, List[BucketEntry]]] = [
            (g, b) for g in groups for b in g.buckets]
        self.bucket_of: Dict[int, int] = {
            e.pid: bi for bi, (_, b) in enumerate(self.buckets) for e in b}

    def covers(self, pid: int) -> bool:
        return pid in self.bucket_of

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def describe(self) -> Tuple:
        return (round(self.buffer_mb, 6),
                tuple(g.describe() for g in self.groups))

    def digest(self) -> str:
        return hashlib.sha256(repr(self.describe()).encode()).hexdigest()


def build_plan(trainable: Sequence[torch.Tensor], zero, data_n: int,
               buffer_mb: float = DEFAULT_BUFFER_MB,
               segment_of: Optional[Callable] = None,
               skip: Callable = lambda p: False) -> Optional[BucketPlan]:
    """The bucket plan of ``trainable`` (module docstring): ZeRO plan
    entries reduce-scatter (``zero``: the engine's ``_ZeroPlan`` or
    None), the rest average over a data group of ``data_n`` ranks (left
    out when ``data_n`` is 1); ``skip(p)`` leaves a parameter to the
    step's end (the tied copies, sequence-parallel ones). None when
    nothing buckets."""
    target = max(float(buffer_mb), 1e-6) * (1 << 20)
    sigs: Dict[Tuple, BucketGroup] = {}
    order: List[Tuple] = []
    for index in range(len(trainable) - 1, -1, -1):
        p = trainable[index]
        if skip(p):
            continue
        e = zero.entry(p) if zero is not None else None
        if e is not None:
            kind, shard_dim, stored = "rs", e[0], bool(e[1])
        elif data_n > 1:
            kind, shard_dim, stored = "pmean", None, False
        else:
            continue
        seg = int(segment_of(p)) if segment_of is not None else 0
        dtype = str(p.dtype)
        key = (kind, dtype, stored, seg)
        if key not in sigs:
            sigs[key] = BucketGroup(kind=kind, dtype=dtype, stored=stored,
                                    segment=seg)
            order.append(key)
        sigs[key].entries.append(BucketEntry(
            pid=id(p), index=index, shape=tuple(p.shape), dtype=dtype,
            shard_dim=shard_dim, stored=stored))
    groups = []
    for key in order:
        g = sigs[key]
        bucket, size = [], 0
        for e in g.entries:
            bucket.append(e)
            size += e.nbytes
            if size >= target:
                g.buckets.append(bucket)
                bucket, size = [], 0
        if bucket:
            g.buckets.append(bucket)
        groups.append(g)
    return BucketPlan(groups, float(buffer_mb)) if groups else None


class ZeroStep:
    """One rank's ZeRO (and bucketed data-parallel) gradient sync,
    shard update and parameter gather (module docstring). ``zero``: the
    ``_ZeroPlan`` (entries ``{id(p): (dim, stored)}``) or None;
    ``sharding`` / ``dp`` / ``data``: the groups (None for one rank);
    ``plan``: a ``BucketPlan`` with ``comm_overlap``, else None."""

    def __init__(self, params, zero, sharding, dp, data, plan=None,
                 release: bool = True):
        self.params = [p for p in params if p.requires_grad]
        self.zero = zero
        self.sh = sharding
        self.dp = dp
        self.data = data
        self.plan = plan
        self.release_buckets = release
        self.n = sharding.nranks if sharding is not None else 1
        self.rank = sharding.rank if sharding is not None else 0
        self._by_id = {id(p): p for p in self.params}
        self.synced: Dict[int, torch.Tensor] = {}
        self._armed: set = set()
        self._arrived: Dict[int, set] = {}
        self._fired: set = set()
        self._captures = ()
        self._shards: Dict[int, torch.Tensor] = {}   # stage-3 storage
        self._hooks = []
        if plan is not None:
            for p in self.params:
                if plan.covers(id(p)):
                    self._hooks.append(p.register_post_accumulate_grad_hook(
                        self._hook))

    # -- stage-3 storage ----------------------------------------------------
    def entry(self, p):
        return self.zero.entry(p) if self.zero is not None else None

    def stored(self) -> List[torch.Tensor]:
        return [p for p in self.params
                if self.entry(p) is not None and self.entry(p)[1]]

    @torch.no_grad()
    def store(self):
        """Keep only this rank's shard of every stage-3 parameter."""
        for p in self.stored():
            if getattr(p, "zero_stored", None) is not None:
                continue
            d = self.entry(p)[0]
            shard = rank_major(p.data, d, self.n)[self.rank].reshape(
                self._shard_shape(p.shape, d)).clone()
            self._set_shard(p, shard, tuple(p.shape))

    def _set_shard(self, p, shard, full_shape):
        self._shards[id(p)] = shard
        p.data = shard
        p.zero_stored = (self.sh, self.entry(p)[0], full_shape)

    def _shard_shape(self, shape, d):
        s = list(shape)
        s[d] //= self.n
        return tuple(s)

    @torch.no_grad()
    def gather(self):
        """Every stage-3 parameter whole (step entry)."""
        todo = [p for p in self.stored()
                if getattr(p, "zero_stored", None) is not None]
        for ps in self._gather_groups(todo, self.release_buckets):
            self._gather_flat(ps, self._shards)

    def _gather_groups(self, ps, by_bucket: bool):
        """``ps`` in the groups one all-gather each moves: their buckets'
        members (``by_bucket`` and a plan), the rest one at a time."""
        groups = []
        if self.plan is not None and by_bucket:
            ids = {id(p) for p in ps}
            for g, bucket in self.plan.buckets:
                mine = [self._by_id[e.pid] for e in bucket
                        if g.kind == "rs" and e.pid in ids]
                if mine:
                    groups.append(mine)
                    ids -= {id(p) for p in mine}
            ps = [p for p in ps if id(p) in ids]
        return groups + [[p] for p in ps]

    def _gather_flat(self, ps, shards):
        """One all-gather of ``shards``' entries for ``ps`` into the whole
        parameters: a stored one's ``p.data`` replaced, a whole one's
        written in place."""
        flat = torch.cat([shards[id(p)].reshape(-1) for p in ps])
        rows = C.t_all_gather(flat, self.sh, axis=0, tiled=False) \
            if self.sh is not None else flat.unsqueeze(0)
        off = 0
        for p in ps:
            shard = shards[id(p)]
            k = shard.numel()
            full = from_rank_major(rows[:, off:off + k], self.entry(p)[0],
                                   shard.shape)
            off += k
            if getattr(p, "zero_stored", None) is not None:
                p.data = full.contiguous()
                p.zero_stored = None
            else:
                p.data.copy_(full)

    # -- gradient sync -----------------------------------------------------
    def arm(self, params=None):
        """Let the buckets of ``params`` (all by default) fire in the
        next backward that accumulates their gradients."""
        if self.plan is None:
            return
        ps = self.params if params is None else params
        self._armed.update(id(p) for p in ps if self.plan.covers(id(p)))
        self._captures = cl.open_captures()

    def _hook(self, p):
        pid = id(p)
        if pid not in self._armed or p.grad is None:
            return
        bi = self.plan.bucket_of[pid]
        if bi in self._fired:
            return
        arrived = self._arrived.setdefault(bi, set())
        arrived.add(pid)
        _, bucket = self.plan.buckets[bi]
        if len(arrived) == len(bucket):
            with cl.carried(self._captures):
                self._fire(bi)

    @torch.no_grad()
    def _fire(self, bi):
        g, bucket = self.plan.buckets[bi]
        ps = [self._by_id[e.pid] for e in bucket
              if self._by_id[e.pid].grad is not None]
        self._fired.add(bi)
        if not ps:
            return
        if g.kind == "rs":
            self._reduce_scatter(ps)
        else:
            self._mean(ps)

    def _mean(self, ps):
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        flat = C.t_pmean(flat, self.data) if self.data is not None else flat
        off = 0
        for p in ps:
            k = p.grad.numel()
            self.synced[id(p)] = _aligned(flat[off:off + k].view_as(p.grad))
            off += k
            p.grad = None

    def _reduce_scatter(self, ps):
        """dp mean, then the ordered reduce-scatter over sharding, / n."""
        rows = torch.cat([rank_major(p.grad, self.entry(p)[0], self.n)
                          for p in ps], dim=1)
        if self.dp is not None:
            rows = C.t_pmean(rows, self.dp)
        mine = C.psum_scatter_ordered(rows, self.sh) / self.n
        off = 0
        for p in ps:
            shape = self._shard_shape(p.grad.shape, self.entry(p)[0])
            k = p.grad.numel() // self.n
            self.synced[id(p)] = _aligned(mine[off:off + k].reshape(shape))
            off += k
            p.grad = None

    @torch.no_grad()
    def finish_sync(self):
        """After the backward(s): fire the armed buckets still pending
        (their gradients that never came are left out), then sync every
        other gradient: a ZeRO entry one parameter at a time, the rest
        one mean a dtype over a flat buffer. Returns {id(p): synced
        gradient, or this rank's shard of it}."""
        if self.plan is not None:
            for bi in range(self.plan.num_buckets):
                if bi not in self._fired and any(
                        e.pid in self._armed
                        for e in self.plan.buckets[bi][1]):
                    self._fire(bi)
        rest = [p for p in self.params
                if p.grad is not None and id(p) not in self.synced]
        plain = []
        for p in rest:
            if self.entry(p) is not None:
                self._reduce_scatter([p])
            else:
                plain.append(p)
        if plain and self.data is not None:
            by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
            for p in plain:
                by_dtype.setdefault(p.grad.dtype, []).append(p)
            for same in by_dtype.values():
                self._mean(same)
        for p in plain:
            if id(p) not in self.synced:
                self.synced[id(p)] = p.grad
                p.grad = None
        out = self.synced
        self.synced = {}
        self._armed.clear()
        self._arrived.clear()
        self._fired.clear()
        return out

    # -- the update ----------------------------------------------------------
    def shard_of(self, p) -> torch.Tensor:
        """This rank's shard of ``p`` to update in place: the stored shard
        at stage 3, else a copy of the rank-major chunk."""
        if id(p) in self._shards:
            return self._shards[id(p)]
        d = self.entry(p)[0]
        return rank_major(p.data, d, self.n)[self.rank].reshape(
            self._shard_shape(p.shape, d)).clone()

    @torch.no_grad()
    def after_update(self, updated: Dict[int, torch.Tensor]):
        """Stage 1/2: the updated shards all-gathered into the whole
        parameters (one all-gather a bucket with a plan); stage 3: every
        parameter back to its (updated) shard."""
        whole = []
        for p in self.params:
            e = self.entry(p)
            if e is None:
                continue
            if e[1]:
                if getattr(p, "zero_stored", None) is None:
                    self._set_shard(p, self._shards[id(p)], tuple(p.shape))
            elif id(p) in updated:
                whole.append(p)
        for ps in self._gather_groups(whole, True):
            self._gather_flat(ps, updated)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where it starts off a 16-byte boundary (a
    view into a bucket's flat buffer; K8 takes 16-byte-aligned tensors)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()

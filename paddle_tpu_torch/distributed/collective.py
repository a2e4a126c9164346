"""Collective communication over ``torch.distributed`` (counterpart of
``paddle_tpu/distributed/collective.py``).

The JAX package runs every rank inside one process: a ``Group`` there is
a set of mesh axis names and each collective lowers to an XLA collective
inside ``shard_map``, where a rank is a traced ``lax.axis_index``. The
port runs one process per rank, as Paddle does: a ``Group`` is a
``torch.distributed`` process group plus the global ranks it spans, and
``group.rank`` is a Python int.

``init_parallel_env`` starts the process group of the job (``RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``, or the ``PADDLE_*``
names the launcher exports, or an explicit ``init_method``). The backend
is explicit and nothing falls back:

- ``backend=None`` takes NCCL when every local rank has a card of its
  own, and raises when ranks would share one (NCCL refuses two ranks on
  one device, "Duplicate GPU detected"); ``backend="gloo"`` runs them on
  the shared card, their collectives over gloo;
- ``device="cpu"`` takes gloo on the CPU; a CUDA request with no card
  raises.

A group of one rank with no process group (a world of one outside an
initialised environment, or an axis of size 1) is an identity, as the
JAX collectives are at world size 1. The world group of an initialised
environment runs its collectives through its process group at any size
(so NCCL at world size 1 still runs NCCL).

gloo and CUDA tensors: gloo's own CUDA path aborted a rank on the H100's
torch (a write from the device pointer, ``gloo::IoException``), so the
collective layer stages every CUDA tensor of a gloo group through pinned
host memory itself: one copy to the host, the collective there, one copy
back. The compute stays on the card; the staging's bytes and seconds are
booked on the world (``staging_stats()``: device-to-host copies, the gloo
call and its wait, host-to-device copies) and, under an open comm-ledger
capture, on the collective's record as a host hop (``host_bytes``). Each
staged tensor gets a fresh pinned buffer, which a p2p task holds until
its ``wait``.

Every collective books its op kind, group label, local shape, dtype and
group size into ``observability/commledger.py`` while a capture is open,
as the JAX ``_note_shim`` does at trace time. The kinds are the JAX
ledger's: all-reduce sum / mean / broadcast / reduce / scatter book
``psum`` (as the JAX lowering's masked psum), max ``pmax``, min ``pmin``;
p2p ``ppermute``.

The functional shims ``t_psum`` ... ``t_ppermute`` (the JAX ``t_*``) and
the ``_c_*`` ops return new tensors and are what model code calls; the
Paddle API forms (``all_reduce``, ``broadcast``, ``scatter``, ``recv``)
write into the tensor they are given, as Paddle's do. None of them is
differentiable: ``fleet/layers/mpu/mp_ops.py`` pairs them into
``torch.autograd.Function``s. ``src`` / ``dst`` are global ranks, as in
Paddle and torch; ``perm`` pairs are ranks within the group, as in JAX.

``spmd_region(data_group)`` marks code running as one rank of a step
over split data (``ParallelEngine``'s ``fn``), as the JAX engine's
``shard_map`` region does; ``spmd_data_group()`` names the group its
batch is split over there (None outside one, or without a split).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.enforce import enforce

__all__ = [
    "ReduceOp", "Group", "ProcessGroup", "init_parallel_env", "new_group",
    "get_group", "get_rank", "get_world_size", "all_reduce", "all_gather",
    "all_gather_object", "broadcast_object_list", "all_to_all", "alltoall",
    "reduce_scatter", "broadcast", "reduce", "scatter", "send", "recv",
    "isend", "irecv", "barrier", "split_group", "stream",
    "all_reduce_mean_value", "wait", "ppermute", "gather_object",
    "is_initialized", "P2POp", "batch_isend_irecv", "staging_stats",
    "t_psum", "t_pmean", "t_pmax", "t_pmin", "t_all_gather",
    "t_psum_scatter", "t_all_to_all", "t_ppermute", "spmd_region",
    "spmd_data_group", "loss_denominator", "current_loss_denominator",
    "psum_scatter_ordered",
]

DEFAULT_TIMEOUT_S = 600.0

_SPMD: List[Optional["Group"]] = []
_DEN: List[Optional[torch.Tensor]] = []


@contextlib.contextmanager
def spmd_region(data_group: Optional["Group"] = None):
    """Run the block as one rank of a step whose batch is split over
    ``data_group`` (module docstring)."""
    _SPMD.append(data_group)
    try:
        yield
    finally:
        _SPMD.pop()


def spmd_data_group() -> Optional["Group"]:
    return _SPMD[-1] if _SPMD else None


@contextlib.contextmanager
def loss_denominator(den: Optional[torch.Tensor]):
    """A masked loss inside the block divides by ``den``, this rank's
    mask count of the whole batch (a pipeline's microbatch takes the
    batch's, not its own); None leaves the loss's own."""
    _DEN.append(den)
    try:
        yield
    finally:
        _DEN.pop()


def current_loss_denominator() -> Optional[torch.Tensor]:
    return _DEN[-1] if _DEN else None


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT,
             ReduceOp.AVG: dist.ReduceOp.SUM}
_LEDGER_KIND = {ReduceOp.SUM: "psum", ReduceOp.AVG: "psum",
                ReduceOp.PROD: "psum", ReduceOp.MAX: "pmax",
                ReduceOp.MIN: "pmin"}


class Group:
    """A communication group: the global ranks it spans (in order) and
    its ``torch.distributed`` process group (None for one rank outside
    an initialised environment, or an axis of size 1: an identity).
    ``rank`` is this process's index in ``ranks`` (-1 if not a member);
    ``name`` labels its ledger records (the HCG names its groups by
    axis, as the JAX mesh axes are named)."""

    _next_gid = 0

    def __init__(self, ranks: Sequence[int], pg=None, name: str = "",
                 backend: Optional[str] = None):
        self.ranks = [int(r) for r in ranks]
        self.nranks = len(self.ranks)
        self.process_group = pg
        self.backend = backend
        self.name = name or "ranks" + "_".join(map(str, self.ranks))
        self.id = Group._next_gid
        Group._next_gid += 1

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def rank(self) -> int:
        me = _world.rank
        return self.ranks.index(me) if me in self.ranks else -1

    def is_member(self) -> bool:
        return self.rank >= 0

    def get_group_rank(self, global_rank: int) -> int:
        return self.ranks.index(int(global_rank))

    def __repr__(self):
        return (f"Group(name={self.name!r}, ranks={self.ranks}, "
                f"backend={self.backend})")


ProcessGroup = Group


class _World:
    """This process's view of the job: its rank, the world size, the
    backend, the device its collectives' tensors live on, the groups
    made so far, and the host staging's bytes and seconds."""

    def __init__(self):
        self.initialized = False
        self.rank = 0
        self.world_size = 1
        self.backend: Optional[str] = None
        self.device = None
        self.timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
        self.default_group = Group([0], name="world")
        self.groups: Dict[int, Group] = {0: self.default_group}
        self.staged_bytes = 0
        self.staged_ops = 0
        # seconds by part: device-to-host copies, gloo, host-to-device
        self.staged_parts = {"d2h": 0.0, "gloo": 0.0, "h2d": 0.0}


_world = _World()


def _env_int(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def _local_world(world_size: int) -> int:
    """Ranks on this host: the launcher's ``LOCAL_WORLD_SIZE`` (or
    ``PADDLE_LOCAL_SIZE``), else the whole world (one host)."""
    return _env_int("LOCAL_WORLD_SIZE", "PADDLE_LOCAL_SIZE",
                    default=world_size)


def _init_method() -> str:
    master = os.environ.get("PADDLE_MASTER")
    if "MASTER_ADDR" not in os.environ and master:
        host, _, port = master.rpartition(":")
        return f"tcp://{host}:{port}"
    return "env://"


def init_parallel_env(backend: Optional[str] = None, device=None,
                      timeout: Optional[float] = None,
                      init_method: Optional[str] = None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None) -> Group:
    """Start (once) this process's part of the job and return the world
    group. ``rank`` / ``world_size`` default to ``RANK`` /
    ``WORLD_SIZE`` (or ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM``);
    the rendezvous to ``init_method``, else ``MASTER_ADDR`` /
    ``MASTER_PORT`` (or ``PADDLE_MASTER``). ``device``: None for this
    rank's card (``LOCAL_RANK`` modulo the cards present), ``"cpu"`` for
    gloo on the CPU. ``timeout`` (seconds) bounds every collective of
    every group. A world of one with no backend named starts no process
    group (its collectives are identities)."""
    if _world.initialized:
        return _world.default_group
    rank = _env_int("RANK", "PADDLE_TRAINER_ID", default=0) \
        if rank is None else int(rank)
    world_size = _env_int("WORLD_SIZE", "PADDLE_TRAINERS_NUM", default=1) \
        if world_size is None else int(world_size)
    enforce(0 <= rank < world_size,
            f"init_parallel_env: rank {rank} outside a world of {world_size}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_parallel_env: paddle_tpu_torch runs on the CUDA device "
                "by default and none is available; pass device='cpu' for "
                "gloo on the CPU")
        cards = torch.cuda.device_count()
        local_rank = _env_int("LOCAL_RANK", "PADDLE_LOCAL_RANK",
                              default=rank)
        shared = _local_world(world_size) > cards
        if backend is None:
            if shared:
                raise RuntimeError(
                    f"init_parallel_env: {_local_world(world_size)} ranks "
                    f"on this host share {cards} card(s); NCCL refuses two "
                    f"ranks on one device. Pass backend='gloo' to run them "
                    f"on the shared card with gloo collectives (staged "
                    f"through host memory)")
            backend = "nccl"
        elif backend == "nccl" and shared:
            raise RuntimeError(
                f"init_parallel_env(backend='nccl'): "
                f"{_local_world(world_size)} ranks share {cards} card(s); "
                f"NCCL refuses two ranks on one device (backend='gloo' "
                f"runs them over gloo)")
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    else:
        if backend is None:
            backend = "gloo"
        enforce(backend == "gloo",
                f"init_parallel_env: backend {backend!r} on the CPU; gloo "
                f"is the CPU backend")
    enforce(backend in ("nccl", "gloo"),
            f"init_parallel_env: backend {backend!r} (nccl or gloo)")
    _world.timeout = datetime.timedelta(
        seconds=DEFAULT_TIMEOUT_S if timeout is None else float(timeout))
    _world.rank, _world.world_size = rank, world_size
    _world.backend, _world.device = backend, dev
    pg = None
    named = device is not None or backend is not None
    if world_size > 1 or named:
        if not dist.is_initialized():
            kw = dict(backend=backend, rank=rank, world_size=world_size,
                      timeout=_world.timeout)
            if world_size == 1 and init_method is None \
                    and "MASTER_ADDR" not in os.environ \
                    and "PADDLE_MASTER" not in os.environ:
                kw["store"] = dist.HashStore()
            else:
                kw["init_method"] = init_method or _init_method()
            if backend == "nccl":
                kw["device_id"] = dev
            dist.init_process_group(**kw)
        pg = dist.group.WORLD
    g = Group(list(range(world_size)), pg=pg, name="world", backend=backend)
    _world.default_group = g
    _world.groups = {0: g}
    _world.initialized = True
    return g


def destroy_process_group(group: Optional[Group] = None) -> None:
    """Tear the job's process groups down and forget the world (the
    next ``init_parallel_env`` starts afresh)."""
    if group is not None and group is not _world.default_group:
        if group.process_group is not None:
            dist.destroy_process_group(group.process_group)
        _world.groups.pop(group.id, None)
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    _world.__init__()


def is_initialized() -> bool:
    return _world.initialized


def get_backend(group: Optional[Group] = None) -> Optional[str]:
    g = group or _world.default_group
    return g.backend


def get_rank(group: Optional[Group] = None) -> int:
    """This process's rank: global, or within ``group``."""
    return _world.rank if group is None else group.rank


def get_world_size(group: Optional[Group] = None) -> int:
    return _world.world_size if group is None else group.nranks


def get_group(gid: int = 0) -> Group:
    return _world.groups.get(gid, _world.default_group)


def comm_device() -> torch.device:
    """The device the job's collectives expect tensors on."""
    return _world.device or torch.device("cpu")


def new_group(ranks: Optional[Sequence[int]] = None, backend=None,
              timeout=None, name: str = "") -> Group:
    """A subgroup over global ``ranks`` (all of them by default). As
    with ``torch.distributed.new_group``, every process of the world
    calls it with the same ranks, members or not; a group of one rank
    gets no process group (an identity)."""
    ranks = list(range(_world.world_size)) if ranks is None \
        else sorted(int(r) for r in ranks)
    enforce(ranks and all(0 <= r < _world.world_size for r in ranks),
            f"new_group: ranks {ranks} outside a world of "
            f"{_world.world_size}")
    backend = backend or _world.backend
    pg = None
    if len(ranks) > 1:
        enforce(dist.is_initialized(),
                "new_group over more than one rank needs init_parallel_env")
        pg = dist.new_group(ranks, backend=backend,
                            timeout=_world.timeout if timeout is None
                            else datetime.timedelta(seconds=float(timeout)))
    g = Group(ranks, pg=pg, name=name, backend=backend)
    _world.groups[g.id] = g
    return g


def split_group(parent: Group, every: int) -> Group:
    """Split ``parent`` into contiguous subgroups of ``every`` ranks and
    return the one holding this process (every process makes all of
    them, as ``new_group`` needs)."""
    enforce(every > 0 and parent.nranks % every == 0,
            f"split_group: {parent.nranks} ranks not divisible by {every}")
    if parent.nranks == every:
        return parent
    mine = None
    for lo in range(0, parent.nranks, every):
        g = new_group(parent.ranks[lo:lo + every],
                      name=f"{parent.name}/{every}.{lo // every}")
        if _world.rank in g.ranks:
            mine = g
    return mine


def staging_stats() -> Dict[str, float]:
    """The host staging of gloo collectives on CUDA tensors since the
    process started: bytes copied (to the host and back), seconds spent
    in all (``seconds``) and by part (``d2h_seconds`` the copies to the
    host, ``gloo_seconds`` the collective on the host copies and the wait
    for a p2p transfer, ``h2d_seconds`` the copies back) and collectives
    staged."""
    parts = _world.staged_parts
    return {"bytes": _world.staged_bytes, "seconds": sum(parts.values()),
            "ops": _world.staged_ops, "d2h_seconds": parts["d2h"],
            "gloo_seconds": parts["gloo"], "h2d_seconds": parts["h2d"]}


# ---------------------------------------------------------------------------
# the core: identity, direct, or staged through pinned host memory
# ---------------------------------------------------------------------------


def _group(group: Optional[Group]) -> Group:
    return group or _world.default_group


def _active(g: Group) -> bool:
    return g.process_group is not None


def _note(op: str, g: Group, x: torch.Tensor, args: Tuple = (),
          host_bytes: int = 0) -> None:
    from ..observability import commledger as cl

    if cl.active():
        cl.note(op, (g.name,), tuple(x.shape), x.dtype, g.nranks, args,
                host_bytes=host_bytes)


def _staged(g: Group, tensors: Sequence[torch.Tensor]) -> bool:
    """Does this call stage through the host (gloo with a CUDA tensor)?"""
    return g.backend == "gloo" and any(
        t is not None and t.is_cuda for t in tensors)


def _host(t: torch.Tensor, copy: bool) -> torch.Tensor:
    """A pinned buffer of ``t``'s shape, holding ``t``'s values when
    ``copy`` (timed as device-to-host)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if copy:
        t0 = time.perf_counter()
        h.copy_(t)
        _world.staged_parts["d2h"] += time.perf_counter() - t0
    return h


def _timed(part: str, fn: Callable):
    t0 = time.perf_counter()
    out = fn()
    _world.staged_parts[part] += time.perf_counter() - t0
    return out


def _run(g: Group, fn: Callable, ins: Sequence[torch.Tensor],
         outs: Sequence[torch.Tensor]) -> int:
    """Run ``fn(ins, outs)`` (a torch.distributed call on ``g``'s process
    group) and return the bytes staged: 0 when direct; with gloo and
    CUDA tensors the inputs are copied to pinned host buffers, ``fn``
    runs on those, and the outputs are copied back (an output that is
    also an input is copied once each way)."""
    if not _staged(g, list(ins) + list(outs)):
        fn(list(ins), list(outs))
        return 0
    hmap: Dict[int, torch.Tensor] = {}
    for t in ins:
        hmap[id(t)] = _host(t, copy=True)
    for t in outs:
        if id(t) not in hmap:
            hmap[id(t)] = _host(t, copy=False)
    _timed("gloo", lambda: fn([hmap[id(t)] for t in ins],
                              [hmap[id(t)] for t in outs]))

    def back():
        for t in outs:
            t.copy_(hmap[id(t)])
    _timed("h2d", back)
    nbytes = sum(t.numel() * t.element_size() for t in ins) + \
        sum(t.numel() * t.element_size() for t in outs)
    _world.staged_bytes += nbytes
    _world.staged_ops += 1
    return nbytes


def _contig(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_contiguous() else x.contiguous()


def _allreduce_(g: Group, x: torch.Tensor, op: int) -> torch.Tensor:
    """All-reduce ``x`` in place over ``g`` (``x`` contiguous)."""
    pg = g.process_group
    hb = _run(g, lambda i, o: dist.all_reduce(o[0], _TORCH_OP[op], group=pg),
              [x], [x])
    if op == ReduceOp.AVG:
        if x.is_floating_point():
            x.div_(g.nranks)
        else:
            x.floor_divide_(g.nranks)
    _note(_LEDGER_KIND[op], g, x, ("prod",) if op == ReduceOp.PROD else (),
          hb)
    return x


def _gather0(g: Group, x: torch.Tensor) -> torch.Tensor:
    """[nranks, *x.shape]: every member's ``x``, in group order."""
    # as [1, *shape]: the output's dim-0 blocks are the members' inputs
    x = _contig(x).reshape((1,) + tuple(x.shape))
    out = torch.empty((g.nranks,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    pg = g.process_group
    hb = _run(g, lambda i, o: dist.all_gather_into_tensor(o[0], i[0],
                                                          group=pg),
              [x], [out])
    _note("all_gather", g, x[0], (0,), hb)
    return out


def _scatter0(g: Group, x: torch.Tensor) -> torch.Tensor:
    """Reduce-scatter (sum) ``x`` over its dim 0 (``x.shape[0]``
    divisible by ``nranks``): this member's block of the sum."""
    x = _contig(x)
    enforce(x.shape[0] % g.nranks == 0,
            f"reduce_scatter: dim 0 of {tuple(x.shape)} not divisible by "
            f"{g.nranks}")
    out = torch.empty((x.shape[0] // g.nranks,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    pg = g.process_group
    hb = _run(g, lambda i, o: dist.reduce_scatter_tensor(o[0], i[0],
                                                         group=pg),
              [x], [out])
    _note("reduce_scatter", g, x, (0,), hb)
    return out


def _a2a0(g: Group, x: torch.Tensor, book: str = "all_to_all"
          ) -> torch.Tensor:
    """All-to-all over dim 0: block j of ``x`` goes to member j; block i
    of the result came from member i (booked as ``book``)."""
    x = _contig(x)
    enforce(x.shape[0] % g.nranks == 0,
            f"all_to_all: dim 0 of {tuple(x.shape)} not divisible by "
            f"{g.nranks}")
    out = torch.empty_like(x)
    pg = g.process_group
    hb = _run(g, lambda i, o: dist.all_to_all_single(o[0], i[0], group=pg),
              [x], [out])
    _note(book, g, x, (0, 0) if book == "all_to_all" else (0,), hb)
    return out


def psum_scatter_ordered(rows: torch.Tensor,
                         group: Optional[Group] = None) -> torch.Tensor:
    """Reduce-scatter of ``rows`` [nranks, k] (row j is member j's block):
    this member's block of the sum, the members' blocks added in rank
    order, so every element's sum is the same however the blocks were
    packed (bucketed or one tensor at a time). One all-to-all moves the
    bytes a reduce-scatter moves; it is booked as ``reduce_scatter``."""
    g = _group(group)
    if not _active(g):
        return rows[0]
    got = _a2a0(g, _contig(rows), book="reduce_scatter")
    acc = got[0].clone()
    for i in range(1, g.nranks):
        acc += got[i]
    return acc


# ---------------------------------------------------------------------------
# the functional shim (the JAX t_*): new tensors, booked in the ledger
# ---------------------------------------------------------------------------


def t_psum(x: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    g = _group(group)
    if not _active(g):
        return x
    return _allreduce_(g, x.clone(memory_format=torch.contiguous_format),
                       ReduceOp.SUM)


def t_pmean(x: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    g = _group(group)
    if not _active(g):
        return x
    return _allreduce_(g, x.clone(memory_format=torch.contiguous_format),
                       ReduceOp.AVG)


def t_pmax(x: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    g = _group(group)
    if not _active(g):
        return x
    return _allreduce_(g, x.clone(memory_format=torch.contiguous_format),
                       ReduceOp.MAX)


def t_pmin(x: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    g = _group(group)
    if not _active(g):
        return x
    return _allreduce_(g, x.clone(memory_format=torch.contiguous_format),
                       ReduceOp.MIN)


def t_all_gather(x: torch.Tensor, group: Optional[Group] = None, axis=0,
                 tiled=True) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``axis`` (``tiled``), or
    stacked on a new ``axis``."""
    g = _group(group)
    if not _active(g):
        return x if tiled else x.unsqueeze(axis)
    out = _gather0(g, x)
    if not tiled:
        return out.movedim(0, axis)
    return torch.cat(out.unbind(0), dim=axis % max(x.dim(), 1))


def t_psum_scatter(x: torch.Tensor, group: Optional[Group] = None,
                   scatter_dimension=0, tiled=True) -> torch.Tensor:
    """This member's block (along ``scatter_dimension``) of the sum over
    the group."""
    g = _group(group)
    if not _active(g):
        return x
    enforce(tiled, "t_psum_scatter(tiled=False) is not ported")
    d = scatter_dimension % x.dim()
    out = _scatter0(g, x.movedim(d, 0))
    return out.movedim(0, d)


def t_all_to_all(x: torch.Tensor, group: Optional[Group] = None,
                 split_axis=0, concat_axis=0, tiled=True) -> torch.Tensor:
    """Split ``split_axis`` into ``nranks`` blocks, send block j to
    member j, concatenate what arrives along ``concat_axis``."""
    g = _group(group)
    if not _active(g):
        return x
    enforce(tiled, "t_all_to_all(tiled=False) is not ported")
    s, c = split_axis % x.dim(), concat_axis % x.dim()
    n = g.nranks
    blocks = torch.stack(x.chunk(n, dim=s), dim=0)
    got = _a2a0(g, blocks)
    return torch.cat(got.unbind(0), dim=c)


def t_ppermute(x: torch.Tensor, group: Optional[Group] = None,
               perm=()) -> torch.Tensor:
    """Collective permute: for each (src, dst) pair of group ranks, src's
    ``x`` lands on dst; a member nobody sends to gets zeros (XLA's
    rule)."""
    g = _group(group)
    perm = [(int(a), int(b)) for a, b in perm]
    me = g.rank
    if not _active(g):
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    x = _contig(x)
    out = torch.zeros_like(x)
    ops = []
    for a, b in perm:
        if a == me and b == me:
            out.copy_(x)
        elif b == me:
            ops.append(P2POp(irecv, out, g.ranks[a], g))
    for a, b in perm:
        if a == me and b != me:
            ops.append(P2POp(isend, x, g.ranks[b], g))
    for t in batch_isend_irecv(ops) if ops else []:
        t.wait()
    return out


# the _c_* ops: the functional collectives the model code calls
def _c_allreduce(x, op=ReduceOp.SUM, group=None):
    g = _group(group)
    if not _active(g):
        return x
    return _allreduce_(g, x.clone(memory_format=torch.contiguous_format), op)


def _c_allgather(x, group=None, axis=0):
    return t_all_gather(x, group, axis=axis, tiled=True)


def _c_reducescatter(x, group=None, axis=0):
    return t_psum_scatter(x, group, scatter_dimension=axis, tiled=True)


def _c_alltoall(x, group=None, split_axis=0, concat_axis=0):
    return t_all_to_all(x, group, split_axis=split_axis,
                        concat_axis=concat_axis)


def _c_broadcast(x, group=None, src=0):
    """``x`` of global rank ``src`` on every member (a new tensor)."""
    g = _group(group)
    if not _active(g):
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    pg = g.process_group
    hb = _run(g, lambda i, o: dist.broadcast(o[0], int(src), group=pg),
              [y], [y])
    _note("psum", g, y, ("broadcast",), hb)
    return y


def _c_ppermute(x, group=None, perm=()):
    return t_ppermute(x, group, perm)


# ---------------------------------------------------------------------------
# the Paddle API
# ---------------------------------------------------------------------------


def _write_back(tensor: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    if value is not tensor:
        with torch.no_grad():
            tensor.copy_(value)
    return tensor


def all_reduce(tensor: torch.Tensor, op: int = ReduceOp.SUM,
               group: Optional[Group] = None, sync_op: bool = True):
    """Reduce ``tensor`` over ``group`` in place; returns it."""
    g = _group(group)
    if not _active(g):
        return tensor
    with torch.no_grad():
        if tensor.is_contiguous():
            return _allreduce_(g, tensor, op)
        return _write_back(tensor, _allreduce_(g, tensor.contiguous(), op))


def all_reduce_mean_value(tensor: torch.Tensor,
                          group: Optional[Group] = None) -> torch.Tensor:
    return t_pmean(tensor, group)


def all_gather(tensor_list, tensor=None, group: Optional[Group] = None,
               sync_op: bool = True, axis=0):
    """Paddle's ``all_gather(tensor_list, tensor)``: fills
    ``tensor_list`` with every member's tensor and returns them
    concatenated along ``axis``."""
    if tensor is None:
        tensor, tensor_list = tensor_list, None
    g = _group(group)
    if not _active(g):
        if tensor_list is not None:
            tensor_list.append(tensor)
        return tensor
    out = _gather0(g, tensor)
    if tensor_list is not None:
        tensor_list.extend(out.unbind(0))
    return torch.cat(out.unbind(0), dim=axis % max(tensor.dim(), 1))


def reduce_scatter(tensor, tensor_or_tensor_list=None, op=ReduceOp.SUM,
                   group: Optional[Group] = None, sync_op=True, axis=0):
    """This member's block of the sum. With a list (Paddle's form) the
    blocks are its entries and the result is written into ``tensor``;
    otherwise ``tensor`` is split along ``axis`` and the block
    returned."""
    enforce(op in (ReduceOp.SUM, ReduceOp.AVG),
            "reduce_scatter takes ReduceOp.SUM or AVG")
    src = tensor_or_tensor_list if tensor_or_tensor_list is not None \
        else tensor
    if isinstance(src, (list, tuple)):
        src = torch.cat(list(src), dim=axis)
    g = _group(group)
    out = t_psum_scatter(src, g, scatter_dimension=axis)
    if op == ReduceOp.AVG and _active(g):
        out = out / g.nranks
    if tensor_or_tensor_list is not None and tensor is not None \
            and tuple(tensor.shape) == tuple(out.shape):
        return _write_back(tensor, out)
    return out


def all_to_all(out_tensor_list, in_tensor_list=None,
               group: Optional[Group] = None, sync_op: bool = True):
    """List form (Paddle's): ``in_tensor_list[j]`` goes to member j and
    ``out_tensor_list[i]`` is what member i sent. A single tensor is
    split along dim 0 and returned re-assembled."""
    if in_tensor_list is None:
        x = out_tensor_list
    else:
        x = torch.cat(list(in_tensor_list), dim=0) \
            if isinstance(in_tensor_list, (list, tuple)) else in_tensor_list
    g = _group(group)
    out = _a2a0(g, x) if _active(g) else x
    if isinstance(out_tensor_list, list) and in_tensor_list is not None:
        out_tensor_list.clear()
        out_tensor_list.extend(out.chunk(g.nranks, dim=0))
    return out


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    return all_to_all(out_tensor_list if out_tensor_list is not None
                      else in_tensor_list,
                      in_tensor_list if out_tensor_list is not None else None,
                      group=group, sync_op=sync_op)


def broadcast(tensor: torch.Tensor, src: int = 0,
              group: Optional[Group] = None, sync_op: bool = True):
    """``tensor`` of global rank ``src``, written into every member's."""
    g = _group(group)
    if not _active(g):
        return tensor
    return _write_back(tensor, _c_broadcast(tensor, g, src))


def reduce(tensor: torch.Tensor, dst: int = 0, op=ReduceOp.SUM,
           group: Optional[Group] = None, sync_op: bool = True):
    """As the JAX package: the reduction lands on every member (a
    superset of Paddle's contract, which defines it on ``dst`` only)."""
    return all_reduce(tensor, op=op, group=group)


def scatter(tensor: torch.Tensor, tensor_list=None, src: int = 0,
            group: Optional[Group] = None, sync_op: bool = True):
    """Member i receives ``tensor_list[i]`` of global rank ``src`` into
    ``tensor``."""
    g = _group(group)
    if not _active(g):
        if tensor_list:
            _write_back(tensor, tensor_list[0])
        return tensor
    if g.rank == g.get_group_rank(src):
        enforce(tensor_list is not None and len(tensor_list) == g.nranks,
                f"scatter: the source needs {g.nranks} tensors")
        stacked = torch.stack([_contig(t) for t in tensor_list])
    else:
        stacked = torch.empty((g.nranks,) + tuple(tensor.shape),
                              dtype=tensor.dtype, device=tensor.device)
    full = _c_broadcast(stacked, g, src)
    return _write_back(tensor, full[g.rank])


# -- point to point ---------------------------------------------------------


class _Task:
    """A pending p2p operation: ``wait()`` waits for it and then copies
    a staged receive back to the device."""

    def __init__(self, tensor, work=None, finish=None, buf=None,
                 staged=False):
        self.tensor = tensor
        self._work = work
        self._finish = finish
        self._buf = buf       # a staged host buffer, alive until done
        self._staged = staged

    def wait(self):
        if self._work is not None:
            part = _timed if self._staged else (lambda _, fn: fn())
            part("gloo", self._work.wait)
            self._work = None
            if self._finish is not None:
                part("h2d", self._finish)
                self._finish = None
            self._buf = None
        return self.tensor

    def is_completed(self):
        return self._work is None


# world of one: (src, dst) -> FIFO of sent tensors, so a self send/recv
# pair moves the bytes instead of silently doing nothing
_loopback: Dict[Tuple[int, int], List[torch.Tensor]] = {}


def _p2p(kind: str, tensor: torch.Tensor, peer: int,
         group: Optional[Group], tag: int = 0) -> _Task:
    g = _group(group)
    peer = int(peer)
    if not _active(g) or peer == _world.rank:
        enforce(peer == _world.rank,
                f"{kind}(peer={peer}) in a single-process world: only the "
                f"process itself (rank {_world.rank}) can be its peer")
        if kind == "send":
            _loopback.setdefault((peer, peer), []).append(tensor.clone())
        else:
            q = _loopback.get((peer, peer))
            enforce(bool(q), f"recv(src={peer}): no matching send buffered "
                             f"(single-process loopback)")
            with torch.no_grad():
                tensor.copy_(q.pop(0).reshape(tensor.shape))
        return _Task(tensor)
    pg = g.process_group
    staged = _staged(g, [tensor])
    buf = _host(tensor, copy=kind == "send") if staged else _contig(tensor)
    if kind == "send":
        work = dist.isend(buf, peer, group=pg, tag=int(tag))
        finish = None
    else:
        work = dist.irecv(buf, peer, group=pg, tag=int(tag))

        def finish():
            if buf is not tensor:
                with torch.no_grad():
                    tensor.copy_(buf)
    if staged:
        _world.staged_bytes += tensor.numel() * tensor.element_size()
        _world.staged_ops += 1
    if kind == "send":
        _note("ppermute", g, tensor, (peer,),
              tensor.numel() * tensor.element_size() if staged else 0)
    return _Task(tensor, work, finish, buf, staged)


def send(tensor: torch.Tensor, dst: int = 0, group: Optional[Group] = None,
         sync_op: bool = True):
    return _p2p("send", tensor, dst, group).wait() if sync_op else \
        _p2p("send", tensor, dst, group)


def recv(tensor: torch.Tensor, src: int = 0, group: Optional[Group] = None,
         sync_op: bool = True):
    task = _p2p("recv", tensor, src, group)
    return task.wait() if sync_op else task


def isend(tensor, dst=0, group=None, tag: int = 0) -> _Task:
    """Send ``tensor`` to global rank ``dst`` without waiting; ``tag``
    matches it with the receive posted under the same tag."""
    return _p2p("send", tensor, dst, group, tag)


def irecv(tensor, src=0, group=None, tag: int = 0) -> _Task:
    return _p2p("recv", tensor, src, group, tag)


class P2POp:
    """One batched point-to-point operation: ``op`` is ``isend`` or
    ``irecv``, bound to a tensor and a peer's global rank."""

    def __init__(self, op, tensor, peer, group=None, tag: int = 0):
        enforce(op in (isend, irecv),
                "P2POp op must be paddle_tpu_torch.distributed isend or "
                "irecv")
        self.op = op
        self.tensor = tensor
        self.peer = int(peer)
        self.group = group
        self.tag = int(tag)


def batch_isend_irecv(p2p_op_list) -> List[_Task]:
    """Post every receive of the list, then every send, in list order;
    one task each (wait them all)."""
    enforce(len(p2p_op_list) > 0, "batch_isend_irecv needs >= 1 P2POp")
    for p in p2p_op_list:
        enforce(isinstance(p, P2POp),
                "batch_isend_irecv takes a list of P2POp")
    order = [p for p in p2p_op_list if p.op is irecv] + \
        [p for p in p2p_op_list if p.op is isend]
    tasks = {id(p): p.op(p.tensor, p.peer, p.group, p.tag) for p in order}
    return [tasks[id(p)] for p in p2p_op_list]


def ppermute(tensor: torch.Tensor, perm: List[Tuple[int, int]],
             group: Optional[Group] = None) -> torch.Tensor:
    return t_ppermute(tensor, group, perm)


def barrier(group: Optional[Group] = None) -> None:
    g = _group(group)
    if not _active(g):
        return
    if g.backend == "nccl":
        torch.cuda.synchronize()
    dist.barrier(group=g.process_group)


def wait(tensor, group=None, use_calc_stream=True):
    """Block until the work queued for ``tensor`` has finished."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


# -- object collectives ------------------------------------------------------


def all_gather_object(object_list, obj, group=None):
    g = _group(group)
    if not _active(g):
        object_list.append(obj)
        return object_list
    out = [None] * g.nranks
    dist.all_gather_object(out, obj, group=g.process_group)
    object_list.extend(out)
    return object_list


def gather_object(obj, dst: int = 0, group=None):
    """Every member's ``obj`` on global rank ``dst`` (a list), None on
    the others."""
    g = _group(group)
    if not _active(g):
        return [obj]
    out = [None] * g.nranks if _world.rank == dst else None
    dist.gather_object(obj, out, dst=int(dst), group=g.process_group)
    return out


def broadcast_object_list(object_list, src: int = 0, group=None):
    g = _group(group)
    if _active(g):
        dist.broadcast_object_list(object_list, src=int(src),
                                   group=g.process_group)
    return object_list


class stream:
    """``paddle.distributed.stream`` namespace: the same collectives (the
    port issues them on the current stream)."""

    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    reduce_scatter = staticmethod(reduce_scatter)
    alltoall = staticmethod(alltoall)
    broadcast = staticmethod(broadcast)
    reduce = staticmethod(reduce)

"""The train-step engine (counterpart of
``paddle_tpu/distributed/engine.py`` ``ParallelEngine``), at degree 1
and over a data- and tensor-parallel mesh.

Usage, as in the JAX package::

    eng = ParallelEngine(model, opt)            # or (model, opt, hcg.mesh)
    step = eng.train_step(lambda model, batch:
                          loss_fn(model(batch["x"]), batch["y"]))
    loss = step({"x": xb, "y": yb})

Where the JAX engine traced forward, backward and update into one
sharded XLA program, the port runs them eagerly on the model's device:
``fn(model, batch)``, ``loss.backward()``, ``optimizer.step()`` (which
clips) and ``optimizer.clear_grad()``; an LR scheduler then advances
once, as in the JAX engine. No ``torch.compile``, no CUDA graph.
``eng.stats`` counts the distinct batch signatures (tree structure,
shapes, dtypes) under "train", as the JAX engine's compile counter
does.

``train_step(fn, scaler=GradScaler(...))`` runs the JAX engine's AMP
protocol (``engine.py:752-932``) with the scaler's state on the device
and no host read inside the step: the scale is capped (2^15 for an f16
loss, 2^62 otherwise) and seeds the backward; the optimizer's update
(kernel K8 for Adam and AdamW on CUDA) finds overflow over every
gradient, unscales them in f32 rounded to their dtype, leaves
parameters, masters and moments exactly as they were on overflow,
advances the applied-step count that drives bias correction only on
applied steps, and keeps the scale's dynamic or static bookkeeping.

Telemetry, as the JAX engine's (``engine.py:355-406``, ``:1156-1330``):
every step books a goodput ``compile`` segment (a new batch signature,
or the first step after a restore) or ``step_compute``, and updates the
``paddle_tpu_train_*`` series of ``observability.get_registry()``: step
seconds (the host's dispatch window), steps, tokens, tokens/s and MFU
(between step entries), loss, grad norm, the batch-signature counters
and the CUDA allocator's bytes. The loss, the grad norm (the
optimizer's, or the global norm of the gradients when it computes
none) and the scaler's ``found`` flag go to the host without a sync:
copied ``non_blocking`` into pinned memory behind a CUDA event, they
are read once the event has completed — at a later step's entry, or
at the latest in ``metrics_snapshot()`` — and only then reach the
gauges and the engine's own ``HealthMonitor`` (one-step lag; a step
the scaler skipped never reaches the detector). With
``PADDLE_TPU_TIMESERIES_DIR`` set, a sampler journals the registry
every ``PADDLE_TPU_TIMESERIES_S`` seconds.

Checkpoints, as the JAX engine's (``engine.py:1495-1700``), in its
format (``distributed/checkpoint``): ``save_checkpoint`` writes the
parameters, the optimizer's moments and f32 masters (keyed
``optim.<structured name>.<slot>``), the step count, LR schedule,
scaler state and the model's random generators in one atomic commit;
``restore_checkpoint`` loads them in place. ``nn.Linear`` weights, and
their moments and masters, are stored ``[in, out]`` as the JAX package
stores them (``convert.py``'s rule), so a checkpoint of either package
restores into the other. The random streams are each package's own:
the port saves its ``torch.Generator`` states under ``rng.torch.*`` and
a restore keeps the current stream for a key it does not find, as the
JAX restore does — so a resume across packages is exact in parameters,
slots, counters and schedules, not in dropout draws.

The memory ledger (``mem_ledger=True`` or ``PADDLE_TPU_MEM_LEDGER=1``;
``observability/memledger.py``): a batch signature's first step is
measured into its ledger (parameters, optimizer state, masters and the
batch read; parameters, state, masters and the loss written, all but
the loss in place; on a card the caching allocator's peak over the step
less what was allocated before it, read from host-side counters), its
gauges republished every step, with the state accounting and the
allocator's live bytes. ``memory_ledger()``, ``state_accounting()`` and
``roofline_report()`` read them.

Over ``hcg.mesh`` (``fleet.init``; one process a rank) the step follows
the JAX engine's (``engine.py:820-955``): ``train_step`` takes the
global batch and each dp rank trains on its block of every array leaf's
dim 0; after the backward every gradient is averaged over the dp group
(one all-reduce a dtype, over a flat buffer); the optimizer gets a
``nn.clip.GradSync`` so its clip and the reported global norm are the
norm over the mp group (sharded gradients' squared sums all-reduced,
replicated ones counted once) and a loss scaler's overflow flag is
maxed over every rank; the loss returned is the mean over every rank.
Telemetry stays per process (its tokens are the global batch's).
Parameters marked ``sequence_parallel`` (replicated, applied to sequence
shards: ``fleet.utils.sequence_parallel_utils``) have their gradients
summed over the mp group after the dp mean, before the clip and the
update (the JAX ``_param_grad_axes``); the clip counts them once, as
replicated.

``train_step(fn, batch_specs=...)`` and ``eval_step(fn, batch_specs=None)
-> step(batch, out_spec=None)`` take one ``PartitionSpec`` per array leaf
of the global batch (in its flatten order: dict keys sorted, as
``jax.tree_util`` orders them). A spec names, for each dim, the mesh axis
(or axes, major first) it is split over, or None: each rank takes its
block of that dim at its coordinate on the axis, so ``P()`` gives every
rank the whole leaf, ``P("dp")`` (the default for a leaf with a dim)
splits dim 0 over dp, and ``P(None, "mp")`` gives each mp rank its slice
of dim 1 (the sequence, for sequence parallelism). ``eval_step`` runs
``fn(model, batch)`` without gradients and gathers each output leaf by
``out_spec`` (default ``P("dp")`` over a dp axis of more than one rank,
else ``P()``: every rank's own output), as the JAX ``shard_map``'s
out_specs assemble it.

Still raising over a mesh: the pipeline, sharding (ZeRO) and ``comm_overlap``
axes and knobs (ROADMAP.md queue 1, item 9), sep / ep and ``quant_comm``
(item 10), offload (item 9) and checkpoints across processes (items 9
and 11).
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..amp import GradScaler
from ..convert import _linear_weights
from ..core.compile_stats import CompileStats
from ..core.enforce import enforce
from ..models.llama import resolve_device
from ..nn.clip import GradSync, global_norm
from ..observability import flops as _flops
from ..observability import goodput as _gp
from ..observability import healthmon as _hm
from ..observability import memledger as _ml
from ..observability.catalog import train_metrics as _train_metrics
from ..optimizer.lr import LRScheduler
from . import collective as C
from . import failpoints as _fp
from .parallel import sync_hybrid_gradients

__all__ = ["ParallelEngine", "PartitionSpec", "P"]

_ITEM9_10 = "ROADMAP.md queue 1, items 9 and 10"
# mesh axes the port does not run yet, and the item that ports each
_AXIS_ITEM = {"pp": 9, "sharding": 9, "sep": 10, "ep": 10}


def _map(batch, fn):
    """Apply ``fn`` to every leaf of a dict/list/tuple batch; returns
    (mapped batch, structure key, leaves)."""
    leaves = []

    def walk(x):
        if isinstance(x, dict):
            items = [(k, *walk(x[k])) for k in sorted(x)]
            return ({k: v for k, v, _ in items},
                    ("dict", tuple((k, s) for k, _, s in items)))
        if isinstance(x, (list, tuple)):
            items = [walk(v) for v in x]
            return (type(x)(v for v, _ in items),
                    (type(x).__name__, tuple(s for _, s in items)))
        leaf = fn(x)
        leaves.append(leaf)
        return leaf, "*"

    mapped, structure = walk(batch)
    return mapped, structure, leaves


class PartitionSpec(tuple):
    """How a batch or output leaf is split across the mesh's ranks: per
    dim, an axis name, a tuple of axis names (major first) or None (not
    split). Named as the JAX ``PartitionSpec``; trailing dims it does not
    name are not split."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _spec_axes(entry):
    """A spec entry's axis names, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _batch_tokens(leaves) -> int:
    """Tokens one batch carries: the largest integer leaf (token ids
    [B, S] beat labels [B]); else the leading dim of the first leaf
    (samples), as the JAX engine counts them."""
    tensors = [v for v in leaves if isinstance(v, torch.Tensor)]
    tok = max((v.numel() for v in tensors if v.dim() >= 1
               and not v.is_floating_point() and not v.is_complex()
               and v.dtype != torch.bool), default=0)
    if tok == 0 and tensors:
        tok = int(tensors[0].shape[0]) if tensors[0].dim() >= 1 else 1
    return tok


def _model_generators(model) -> Dict[str, torch.Generator]:
    """Every ``torch.Generator`` a module of ``model`` holds, by the
    first ``<module path>.<attribute>`` that names it (GPT: its hidden
    dropout's on the device, its attention dropout's seeds on the CPU)."""
    out: Dict[str, torch.Generator] = {}
    seen = set()
    for mname, mod in model.named_modules():
        for attr, v in vars(mod).items():
            if isinstance(v, torch.Generator) and id(v) not in seen:
                seen.add(id(v))
                out[f"{mname}.{attr}" if mname else attr] = v
    return out


class _Scalars:
    """One step's loss, grad norm and scaler ``found`` on their way to
    the host: copied ``non_blocking`` into pinned memory behind a CUDA
    event (at once on the CPU). Absent values read as None."""

    __slots__ = ("host", "event", "present", "step")

    def __init__(self, vals, step: int):
        self.present = [v is not None for v in vals]
        self.step = step
        dev = next(v.device for v in vals if v is not None)
        cuda = dev.type == "cuda"
        self.host = torch.zeros(len(vals), dtype=torch.float32,
                                pin_memory=cuda)
        for i, v in enumerate(vals):
            if v is not None:
                self.host[i:i + 1].copy_(v.detach().reshape(1).float(),
                                         non_blocking=cuda)
        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev))

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def values(self):
        if self.event is not None:
            self.event.synchronize()
        return [v if p else None
                for v, p in zip(self.host.tolist(), self.present)]


class ParallelEngine:
    def __init__(self, model, optimizer=None, mesh=None, comm_overlap=None,
                 comm_buffer_size_mb=None, mem_ledger=None, quant_comm=None,
                 sharding_stage=None, stage3_release_after_forward=None,
                 offload=None):
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None:
            for axis, item in _AXIS_ITEM.items():
                if mesh.shape.get(axis, 1) > 1:
                    raise NotImplementedError(
                        f"ParallelEngine over a mesh with a {axis} axis of "
                        f"{mesh.shape[axis]}: not ported yet (ROADMAP.md "
                        f"queue 1, item {item})")
        knobs = {"comm_overlap": comm_overlap, "quant_comm": quant_comm,
                 "sharding_stage": sharding_stage,
                 "stage3_release_after_forward":
                     stage3_release_after_forward, "offload": offload,
                 "comm_buffer_size_mb": comm_buffer_size_mb}
        on = sorted(k for k, v in knobs.items() if v not in (None, False))
        if on:
            raise NotImplementedError(
                f"ParallelEngine {', '.join(on)}: not ported yet "
                f"({_ITEM9_10})")
        self.model = model
        # a fleet optimizer wrapper steps its inner optimizer
        self.optimizer = getattr(optimizer, "_inner_opt", optimizer)
        self._dp = self._mp = self._world = None
        if self.mesh is not None:
            dp, mp = self.mesh.groups["dp"], self.mesh.groups["mp"]
            self._dp = dp if dp.nranks > 1 else None
            self._mp = mp if mp.nranks > 1 else None
            self._world = C.get_group(0)
            if self._mp is not None and self.optimizer is not None:
                self.optimizer._grad_sync = GradSync(
                    mp_group=self._mp, found_group=self._world)
        params = list(model.parameters())
        # the model's device is the engine's; a CUDA model without a card
        # raises here as it does where it is built
        self.device = resolve_device(params[0].device if params else None)
        self.stats = CompileStats()
        # telemetry (observability/), as the JAX engine's: host-side, on
        # scalars read once their step has finished
        self._metrics = _train_metrics()
        # a PER-ENGINE health monitor: a fresh model's first loss is never
        # judged against another run's converged window
        self._health = _hm.HealthMonitor()
        self._health.register_healthz("train_health")
        self._n_params_cfg = _flops.params_from_config(
            getattr(model, "config", None))
        self._peak_flops, _ = _flops.peak_flops_per_chip(self.device)
        self._bytes_limit = (torch.cuda.mem_get_info(self.device)[1]
                             if self.device.type == "cuda" else None)
        self._stats_reported = (0, 0)    # (compiles, cache_hits) published
        self._pending: deque = deque()   # _Scalars not yet published
        self._prev_step_entry = None
        self._last_tokens = 0
        self._last_step_seconds = 0.0
        self._last_dispatch_fresh = False
        # set by restore_checkpoint: the next step books as compile and
        # stays out of the step-time baseline
        self._post_restore_warmup = False
        self.sampler = None
        ts_dir = os.environ.get("PADDLE_TPU_TIMESERIES_DIR")
        if ts_dir:
            from ..observability import timeseries as _ts
            try:
                self.sampler = _ts.attach_dir(ts_dir, interval_s=float(
                    os.environ.get("PADDLE_TPU_TIMESERIES_S", "5.0")))
            except (OSError, ValueError):
                self.sampler = None
        # the memory ledger (observability/memledger.py): one ledger a
        # batch signature, measured at its first step
        self._mem_on = (bool(int(os.environ.get(
            "PADDLE_TPU_MEM_LEDGER", "0") or 0))
            if mem_ledger is None else bool(mem_ledger))
        self._mem_ledgers: Dict[Any, Any] = {}
        self._last_key = None
        self._state_acct = None
        self._live_peak = 0

    @property
    def params(self):
        """The model's parameters, in order."""
        return list(self.model.parameters())

    def _to_device(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x).to(self.device)
        return x

    def train_step(self, fn: Callable, batch_specs=None,
                   scaler=None) -> Callable[[Any], torch.Tensor]:
        """``step(batch) -> loss``: ``fn(model, batch)`` (a scalar loss),
        its backward, the optimizer's step and clear_grad, then one step
        of an LR scheduler. Array leaves of the batch move to the model's
        device. With an enabled ``amp.GradScaler`` the step runs the loss
        scaler's protocol on the device (module docstring); the loss
        returned is unscaled."""
        if scaler is not None and not isinstance(scaler, GradScaler):
            raise TypeError(f"train_step(scaler=...) takes an "
                            f"amp.GradScaler, got {type(scaler).__name__}")
        use_scaler = scaler is not None and scaler.is_enable()
        # the scaler's settings key the step, as they key the JAX
        # engine's executable
        amp_key = ((scaler._dynamic, scaler._incr_every, scaler._decr_every,
                    scaler._incr_ratio, scaler._decr_ratio)
                   if use_scaler else None)
        specs = self._check_specs(batch_specs)
        if self.optimizer is None:
            raise ValueError("ParallelEngine.train_step needs an optimizer")

        def run(batch):
            """fn, backward, update: (loss, grad norm, found)."""
            opt = self.optimizer
            with C.spmd_region(self._dp):
                loss = fn(self.model, batch)
            found = None
            if use_scaler:
                # the applied-step count is seeded from the optimizer's
                # count before this step (the JAX engine's -1)
                amp = scaler._amp_step(
                    self.device, 2.0 ** 15 if loss.dtype == torch.float16
                    else 2.0 ** 62, fallback_step=opt._step_count)
                # the cap keeps the backward seed itself finite; a power
                # of two keeps scale and unscale an exact round trip
                amp.scale.clamp_(max=amp.cap)
                amp.sync = opt._grad_sync
                # loss scaling = seeding the backward with the scale
                loss.backward(amp.scale.to(loss.dtype).reshape(loss.shape))
                self._sync_grads()
                opt.step(amp=amp)
                scaler._found_inf_dev = found = amp.found
            else:
                loss.backward()
                self._sync_grads()
                opt.step()
            gnorm = opt.grad_norm
            if gnorm is None:
                # the JAX step always returns the global norm
                ps = [p for p in opt._parameter_list
                      if p.grad is not None and not p.grad.is_sparse]
                if ps:
                    with torch.no_grad():
                        gnorm = global_norm(
                            [p.grad for p in ps], **opt._sync_kw(ps))
            opt.clear_grad()
            if isinstance(opt._lr, LRScheduler):
                opt._lr.step()   # once per train step, as the JAX engine
            loss = loss.detach()
            if self._world is not None:
                # the mean over every rank (JAX engine.py:955)
                loss = C.t_pmean(loss.reshape(1), self._world).reshape(
                    loss.shape)
            return loss, gnorm, found

        def step(batch):
            t_entry = time.perf_counter()
            # fault-injection site: fires before any state mutates
            _fp.hit("engine.step_dispatch")
            # earlier steps' scalars whose copies have landed (never waits)
            self._flush_pending_scalars(block=False)
            batch, structure, leaves = _map(batch, self._to_device)
            n_tok = _batch_tokens(leaves)
            batch, leaves = self._local_batch(batch, specs)
            key = (structure, tuple(
                (tuple(v.shape), str(v.dtype)) for v in leaves
                if isinstance(v, torch.Tensor)), specs, amp_key)
            fresh = self.stats.note("train", key)
            self._last_key = key
            probe = (_ml.TempProbe(self.device)
                     if self._mem_on and key not in self._mem_ledgers
                     else None)
            self._last_dispatch_fresh = fresh or self._post_restore_warmup
            self._post_restore_warmup = False
            led = _gp.current()
            if led is not None:
                led.begin("compile" if self._last_dispatch_fresh
                          else "step_compute",
                          step=int(self.optimizer._step_count) + 1)
            try:
                loss, gnorm, found = run(batch)
                if probe is not None:
                    self._mem_ledgers[key] = self._step_ledger(
                        leaves, loss, probe.temp_bytes())
                self._note_step(t_entry, n_tok, loss, gnorm, found)
            finally:
                if led is not None:
                    led.end()
            return loss

        return step

    # -- the batch across the mesh ----------------------------------------
    def _check_specs(self, specs):
        """``batch_specs`` as a tuple of PartitionSpecs (None: the
        default, dim 0 over dp), every axis one of the mesh's."""
        if specs is None:
            return None
        specs = tuple(P() if s is None else P(*s) for s in specs)
        names = self.mesh.axis_names if self.mesh is not None else ("dp",)
        for s in specs:
            for entry in s:
                for a in _spec_axes(entry):
                    enforce(a in names, f"ParallelEngine: batch spec {s} "
                            f"names axis {a!r}, not one of the mesh's "
                            f"{tuple(names)}")
        return specs

    def _axis(self, a):
        """(this rank's coordinate, size) on mesh axis ``a``."""
        if self.mesh is None:
            return 0, 1
        return self.mesh.coords.get(a, 0), self.mesh.shape.get(a, 1)

    def _block(self, x, spec):
        """This rank's block of a global leaf by ``spec``."""
        if not isinstance(x, torch.Tensor):
            return x
        enforce(len(spec) <= x.dim(),
                f"ParallelEngine: spec {spec} names {len(spec)} dims of a "
                f"{x.dim()}-d leaf")
        for d, entry in enumerate(spec):
            idx, n = 0, 1
            for a in _spec_axes(entry):
                c, size = self._axis(a)
                idx, n = idx * size + c, n * size
            if n == 1:
                continue
            enforce(x.shape[d] % n == 0,
                    f"ParallelEngine: a batch leaf's dim {d} ({x.shape[d]}) "
                    f"must divide its split over {entry} ({n})")
            b = x.shape[d] // n
            x = x.narrow(d, idx * b, b)
        return x

    def _local_batch(self, batch, specs):
        """(this rank's batch, its leaves): each leaf's block by its spec
        (``specs`` None: dim 0 of every leaf with a dim over dp)."""
        if specs is None:
            def spec_of(v):
                return P("dp") if isinstance(v, torch.Tensor) and v.dim() \
                    else P()
        else:
            n = len(_map(batch, lambda v: v)[2])
            enforce(n == len(specs),
                    f"ParallelEngine: {len(specs)} batch specs for a batch "
                    f"of {n} leaves (one spec a leaf, in flatten order)")
            it = iter(specs)

            def spec_of(v):
                return next(it)
        mapped, _, leaves = _map(batch, lambda v: self._block(v, spec_of(v)))
        return mapped, leaves

    def _gather_out(self, x, spec):
        """A whole output leaf from this rank's block: each split dim
        all-gathered over its axes, the innermost first."""
        if not isinstance(x, torch.Tensor):
            return x
        enforce(len(spec) <= x.dim(),
                f"ParallelEngine.eval_step: out_spec {spec} names "
                f"{len(spec)} dims of a {x.dim()}-d output")
        for d, entry in enumerate(spec):
            for a in reversed(_spec_axes(entry)):
                g = self.mesh.groups[a] if self.mesh is not None else None
                if g is not None and g.nranks > 1:
                    x = C.t_all_gather(x.contiguous(), g, axis=d)
        return x

    def _sync_grads(self):
        """The dp mean and the sequence-parallel sum over mp (module
        docstring; ``parallel.sync_hybrid_gradients``)."""
        sync_hybrid_gradients(self.optimizer._parameter_list, self._dp,
                              self._mp)

    def eval_step(self, fn: Callable, batch_specs=None
                  ) -> Callable[..., Any]:
        """``step(batch, out_spec=None)``: ``fn(model, batch)`` on this
        rank's blocks of the global batch (``batch_specs``, as
        ``train_step``'s) without gradients, every output leaf gathered by
        ``out_spec`` (one PartitionSpec; module docstring). Array leaves move
        to the model's device; the model's train / eval mode is the
        caller's."""
        specs = self._check_specs(batch_specs)

        def step(batch, out_spec=None):
            batch, structure, _ = _map(batch, self._to_device)
            batch, leaves = self._local_batch(batch, specs)
            if out_spec is None:
                out_spec = P("dp") if self._dp is not None else P()
            self.stats.note("eval", (structure, tuple(
                (tuple(v.shape), str(v.dtype)) for v in leaves
                if isinstance(v, torch.Tensor)), specs, repr(out_spec)))
            with torch.no_grad(), C.spmd_region(self._dp):
                out = fn(self.model, batch)
            return _map(out, lambda v: self._gather_out(v, out_spec))[0]

        return step

    # -- telemetry (observability/) -------------------------------------
    def _flush_pending_scalars(self, block: bool = True):
        """Publish earlier steps' loss / grad norm into their gauges and
        the health monitor, oldest first: every pending step when
        ``block`` (``metrics_snapshot``), else only those whose copies
        have landed (a step's entry: never a sync)."""
        while self._pending and (block or self._pending[0].ready()):
            rec = self._pending.popleft()
            try:
                lv, gn, found = rec.values()
                m = self._metrics
                m["loss"].set(lv)
                if gn is not None:
                    m["grad_norm"].set(gn)
                # a step the scaler skipped (found_inf) is protocol, not
                # an anomaly: its scalars never enter the windows
                if found is None or found == 0.0:
                    self._health.observe(loss=lv, grad_norm=gn,
                                         step=rec.step)
            except Exception:
                pass        # a dead device must not take telemetry down

    def _note_step(self, t_entry: float, n_tok: int, loss, gnorm,
                   found=None):
        """Host-side per-step instrumentation; the device scalars are
        queued, never read here."""
        now = time.perf_counter()
        m = self._metrics
        m["step_seconds"].observe(now - t_entry)
        m["steps"].inc()
        m["tokens"].inc(n_tok)
        # step-time stall watch on the dispatch window (entry to return);
        # compile dispatches stay out of the baseline
        if not self._last_dispatch_fresh:
            try:
                self._health.observe(step_seconds=now - t_entry)
            except Exception:
                pass
        # throughput between step ENTRIES: with the device running
        # behind the host, the inter-step gap is the honest step time
        if self._prev_step_entry is not None:
            dt = max(t_entry - self._prev_step_entry, 1e-9)
            self._last_step_seconds = dt
            tps = n_tok / dt
            m["tokens_per_sec"].set(tps)
            n_params = self._n_params_cfg or sum(
                p.numel() for p in self.model.parameters())
            # every rank takes the global batch, so tps is the job's rate:
            # its FLOPs over every card of the mesh (JAX engine.py:1235)
            m["mfu"].set(_flops.mfu(
                n_params, tps, self._n_devices(), self._peak_flops,
                config=getattr(self.model, "config", None)))
        self._prev_step_entry = t_entry
        self._pending.append(_Scalars(
            (loss, gnorm, found), int(self.optimizer._step_count)))
        m["grad_buckets"].set(0.0)   # the unbucketed update (items 9-10)
        rc, rh = self._stats_reported
        if self.stats.compiles > rc:
            m["compiles"].inc(self.stats.compiles - rc,
                              site="train_engine")
        if self.stats.cache_hits > rh:
            m["cache_hits"].inc(self.stats.cache_hits - rh,
                                site="train_engine")
        self._stats_reported = (self.stats.compiles,
                                self.stats.cache_hits)
        if self.device.type == "cuda":
            # the caching allocator's host-side counters (no device sync)
            st = torch.cuda.memory_stats(self.device)
            dev = str(self.device.index or 0)
            for k, v in (("bytes_in_use",
                          st.get("allocated_bytes.all.current", 0)),
                         ("peak_bytes_in_use",
                          st.get("allocated_bytes.all.peak", 0)),
                         ("bytes_limit", self._bytes_limit)):
                m["device_memory"].set(float(v), device=dev, stat=k)
        self._last_tokens = n_tok
        if self._mem_on:
            self._note_memory(m, n_tok)
        led_gp = _gp.current()
        if led_gp is not None:
            try:
                led_gp.publish(m)
            except Exception:
                pass    # a dead journal must not take the step down
        from ..observability import get_registry

        get_registry().snapshot()    # feeds the flight-record ring

    def _note_memory(self, m, n_tok: int):
        """The memory ledger's gauges at a step's end: the step's ledger,
        the state accounting (made once) and the allocator's live bytes.
        Host-side counters only."""
        led = self._mem_ledgers.get(self._last_key)
        if led is not None:
            led.publish(m, program="train")
        if self._state_acct is None:
            self._state_acct = _ml.account_engine(self, batch_tokens=n_tok)
        self._state_acct.publish(m)
        lb = _ml.live_bytes(self.device)
        if lb:
            self._live_peak = max(self._live_peak, lb)
            m["mem_live"].set(lb)
            m["mem_live_peak"].set(self._live_peak)

    def _step_ledger(self, leaves, loss, temp_bytes):
        """The ledger of one train step (memledger.analyze): it reads the
        parameters, optimizer state, masters and batch; it writes the
        parameters, state and masters in place, and the loss."""
        opt = self.optimizer
        state = [v for st in getattr(opt, "_states", {}).values()
                 for v in st.values() if isinstance(v, torch.Tensor)]
        masters = list(getattr(opt, "_master_weights", {}).values())
        own = self.params + state + masters
        return _ml.analyze(
            "train",
            reads=own + [v for v in leaves if isinstance(v, torch.Tensor)],
            writes=own + [loss], in_place=own, temp_bytes=temp_bytes)

    # -- memory accounting (observability/memledger) ---------------------
    def memory_ledger(self, key=None):
        """The memory ledger of the last step's (or ``key``'s) batch
        signature. With the ledger on it was measured at the signature's
        first step; with it off it is made here from the tensors alone,
        its temporaries not measured (said in its note). None before any
        step."""
        key = key if key is not None else self._last_key
        if key is None:
            return None
        led = self._mem_ledgers.get(key)
        if led is None:
            led = self._step_ledger([], torch.zeros((), device=self.device),
                                    None)
        return led

    def state_accounting(self, batch_tokens: Optional[int] = None):
        """Measured model-state accounting (memledger.account_engine):
        parameters, gradients, optimizer state and masters, the analytic
        activation-checkpoint term, and the auto_tuner's drift. Cached
        after the first step; ``batch_tokens`` overrides the last step's
        token count for the checkpoint term."""
        if self._state_acct is not None and batch_tokens is None:
            return self._state_acct
        acct = _ml.account_engine(
            self, batch_tokens=int(batch_tokens if batch_tokens is not None
                                   else self._last_tokens))
        if batch_tokens is None:
            self._state_acct = acct
        return acct

    def roofline_report(self, exposed=None):
        """The roofline verdict of the last step (memledger.roofline):
        the flop accountant's FLOPs for its tokens, the memory ledger's
        traffic, against the last inter-step interval; "unknown" off the
        card. ``exposed`` (an exposed-comm report) supplies measured
        interconnect seconds and step time where one exists."""
        n_params = self._n_params_cfg or sum(p.numel() for p in self.params)
        fl = _flops.train_flops_per_token(
            n_params, config=getattr(self.model, "config", None)) \
            * self._last_tokens / self._n_devices()
        led = self.memory_ledger()
        traffic = led.traffic_bytes if led is not None and \
            led.available else 0.0
        exp_ici = None
        step_s = self._last_step_seconds
        if exposed is not None:
            exp_ici = sum(exposed.exposed_seconds.values())
            step_s = exposed.step_seconds or step_s
        return _ml.roofline(
            step_seconds=step_s, flops_per_step=fl,
            hbm_traffic_bytes=traffic, wire_bytes=0.0, device=self.device,
            exposed_ici_seconds=exp_ici, program="train")

    def metrics_snapshot(self):
        """Publish every pending step's scalars (waiting for their
        copies), then return the registry snapshot."""
        self._flush_pending_scalars(block=True)
        from ..observability import get_registry

        return get_registry().snapshot()

    def _n_devices(self) -> int:
        """The cards one step runs on: the mesh's size, else 1."""
        return self.mesh.size if self.mesh is not None else 1

    def pod_throughput(self) -> Dict[str, float]:
        """Job-level tokens/s over every process (``cross_host_sum``).
        Over a mesh every rank's gauge is already the job's rate (each
        takes the global batch), so each adds its 1/mesh-size share: the
        sum is the job's rate once, the mean of the ranks' readings.
        Without a mesh each process trains on its own batches and adds
        its whole gauge."""
        from ..observability import cross_host_sum, process_count

        local = self._metrics["tokens_per_sec"].value()
        total = cross_host_sum(local / self._n_devices())
        self._metrics["pod_tokens_per_sec"].set(total)
        return {"local_tokens_per_sec": local,
                "pod_tokens_per_sec": total,
                "processes": float(process_count())}

    def pod_step_skew(self) -> Dict[str, Any]:
        """The straggler gauges over the last inter-step interval (one
        process: skew 0, host 0)."""
        return self._health.observe_pod_skew(self._last_step_seconds)

    # -- crash-consistent checkpointing (distributed/checkpoint) ---------
    def _ensure_opt_states(self):
        opt = self.optimizer
        for p in opt._parameter_list:
            if p.requires_grad:
                opt._param_state(p)

    def _model_tensors(self):
        """The model's parameters and persistent buffers in the JAX
        layout (``nn.Linear`` weights as ``[in, out]`` views): the
        save's source and the restore's in-place target."""
        linear = _linear_weights(self.model)
        return {k: v.t() if k in linear else v
                for k, v in self.model.state_dict().items()}

    def _optim_tensors(self):
        """(slots, tensors): the optimizer's moments and masters, each
        materialized if missing, in the JAX layout (``opt_state_tensors``)."""
        from .fleet.elastic.resume import opt_state_tensors

        self._ensure_opt_states()
        return opt_state_tensors(self.model, self.optimizer,
                                 transposed=_linear_weights(self.model))

    def _checkpoint_state(self, scaler=None):
        """The full training state as (state dict, json meta): the
        model's and the optimizer's tensors, the model's generator states
        under ``rng``, and the counters, LR schedule and scaler state."""
        state: Dict[str, Any] = {"model": self._model_tensors()}
        opt = self.optimizer
        meta: Dict[str, Any] = {"format": 1}
        if opt is not None:
            _, tensors = self._optim_tensors()
            if tensors:
                state["optim"] = tensors
            meta["opt_step_count"] = int(opt._step_count)
            if isinstance(opt._lr, LRScheduler):
                meta["lr_scheduler"] = opt._lr.state_dict()
            else:
                meta["lr"] = float(opt.get_lr())
        if scaler is not None:
            meta["scaler"] = scaler.state_dict()
        rng = {f"torch.{name}": g.get_state().numpy()
               for name, g in _model_generators(self.model).items()}
        if rng:
            state["rng"] = rng
        return state, meta

    def save_checkpoint(self, path: Optional[str] = None, *,
                        manager=None, step: Optional[int] = None,
                        scaler=None, extra_meta: Optional[Dict] = None,
                        async_save: bool = False) -> None:
        """Write a crash-consistent checkpoint of the engine's whole
        training state (``_checkpoint_state``).

        ``path``: one atomic checkpoint directory; or pass ``manager``
        (a ``checkpoint.CheckpointManager``) for rolling keep-last-k
        retention. ``async_save`` / the manager's async mode stall only
        for the device-to-host copy, which is complete when this returns
        (a following step may update the tensors in place); the commit
        happens in the background (``checkpoint.wait_async_saves()`` /
        ``manager.wait()`` to join). ``step`` defaults to the
        optimizer's applied-step count."""
        state, meta = self._checkpoint_state(scaler)
        if step is None:
            step = meta.get("opt_step_count", 0)
        meta["step"] = int(step)
        if extra_meta:
            meta.update(extra_meta)
        if manager is not None:
            manager.save(state, step=int(step), extra_meta=meta)
            return
        enforce(path is not None,
                "save_checkpoint needs a path or a CheckpointManager")
        from .checkpoint import save_state_dict

        save_state_dict(state, path, async_save=async_save, extra_meta=meta)

    def restore_checkpoint(self, path: str, scaler=None) -> Dict[str, Any]:
        """Restore the engine in place from a committed checkpoint of
        either package: parameters, optimizer moments and masters,
        scaler, counters, LR schedule, and the generators it finds.
        Returns the checkpoint's meta dict (incl. ``step``). Never
        changes a shape, dtype or the set of batch signatures; its wall
        time is journaled as the goodput ``restore`` segment, and the
        next step books as ``compile``."""
        with _gp.segment("restore"):
            meta = self._restore_checkpoint_inner(path, scaler)
        self._post_restore_warmup = True
        return meta

    def _restore_checkpoint_inner(self, path: str, scaler=None
                                  ) -> Dict[str, Any]:
        from .checkpoint import open_checkpoint, read_extra_meta
        from .fleet.elastic.resume import _apply_opt_state

        # one read of the files for every load below
        ckpt = open_checkpoint(path)
        meta = read_extra_meta(ckpt.path)
        opt = self.optimizer
        # model parameters first, then the slots (materialized from the
        # loaded weights where the optimizer had none)
        ckpt.load({"model": self._model_tensors()})
        if opt is not None:
            slots, tensors = self._optim_tensors()
            if tensors:
                ckpt.load({"optim": tensors})
                _apply_opt_state(opt, slots, tensors)
            opt._step_count = int(meta.get("opt_step_count",
                                           meta.get("step", 0)))
            if "lr_scheduler" in meta and isinstance(opt._lr,
                                                     LRScheduler):
                opt._lr.set_state_dict(meta["lr_scheduler"])
            if "lr" in meta and not isinstance(opt._lr, LRScheduler):
                opt.set_lr(float(meta["lr"]))
        if scaler is not None and "scaler" in meta:
            scaler.load_state_dict(meta["scaler"])
        # generators: a key the checkpoint lacks keeps its current stream
        gens = _model_generators(self.model)
        targets = {"rng": {f"torch.{n}": np.zeros(0, np.uint8)
                           for n in gens}}
        ckpt.load(targets)
        for name, g in gens.items():
            st = targets["rng"][f"torch.{name}"]
            if getattr(st, "size", 0):
                g.set_state(torch.from_numpy(
                    np.ascontiguousarray(st, dtype=np.uint8)))
        return meta

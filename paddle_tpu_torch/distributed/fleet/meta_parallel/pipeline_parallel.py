"""PipelineParallel: ``train_batch`` / ``eval_batch`` for PipelineLayer
models (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``).

The JAX package compiles the whole pipeline into one SPMD program (a
``lax.scan`` + ``ppermute`` rotation whose vjp is the reverse schedule,
each tick under ``jax.checkpoint`` to bound activation memory). The port
runs the schedule that design stands in for: the reference Paddle's 1F1B
(``forward_backward_pipeline``), and with ``vpp > 1`` virtual stages the
interleaved 1F1B of Megatron-LM, one process a rank. ``schedule`` gives
each stage's order of forward ``("F", m, v)`` and backward ``("B", m,
v)`` work on microbatch ``m`` and chunk ``v``: a warmup of forwards, then
one forward and one backward in turn, then the remaining backwards; at
most ``warmup + 1`` microbatches' activations are alive on a stage at
once (``peak_live``).

Activations travel forward and their gradients back by ``isend`` /
``irecv`` on the pp group (``collective.py``), each message tagged with
its (microbatch, virtual stage, direction): a receive is waited for just
before its work, sends never block the schedule and are waited for at
its end, so the order of work on each rank alone decides progress (a
hung peer fails the collective's timeout, and the launcher stops the
job). The activation shape is ``[micro_batch, *inputs.shape[1:],
hidden]`` in the blocks' dtype. NCCL ignores the tags, so over an NCCL
pp group the schedule raises (ROADMAP.md queue 1, item 8.1); gloo (ranks
sharing a card, or the CPU) runs it.

The loss runs on the last stage for each microbatch: the criterion's
mean over the microbatch over ``accumulate_steps`` (the whole batch's
mean, as the JAX package's one epilogue over the local batch takes it);
with ``labels = (labels, loss_mask)`` each microbatch's masked sum over
the whole batch's mask count (``collective.loss_denominator``), so a
masked loss keeps one denominator. The sum goes to every rank of the pp
group (the JAX ``_pp_collect``). Gradients accumulate over the
microbatches; ``ParallelEngine`` then syncs them (the tied copies over
the shared group, dp, ZeRO) and runs the update. The
``paddle_tpu_train_pp_bubble_fraction`` gauge carries (S - 1) / (vpp M +
S - 1), labelled ``pp_vpp``, as the JAX engine publishes it.

Checkpoints across processes and ``profile_exposed_comm`` over a
pipeline raise (ROADMAP.md queue 1, item 11).
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from ....core.enforce import enforce
from ... import collective as C
from ..layers.mpu.mp_layers import mp_sharded
from .parallel_layers.pp_layers import PipelineLayer
from .tensor_parallel import _DelegateWrapper

__all__ = ["PipelineParallel", "schedule", "warmup_count", "peak_live",
           "bubble"]

_ITEM11 = ("ROADMAP.md queue 1, item 11 (checkpoints and run-time services "
           "across processes)")


def warmup_count(S: int, s: int, M: int, V: int = 1) -> int:
    """Forwards stage ``s`` runs before its first backward."""
    if V == 1:
        return min(S - s - 1, M)
    return min((S - s - 1) * 2 + (V - 1) * S, M * V)


def schedule(S: int, s: int, M: int, V: int = 1
             ) -> List[Tuple[str, int, int]]:
    """Stage ``s``'s work in order: ``(kind, microbatch, chunk)``. The
    k-th forward is on chunk ``(k // S) % V`` and microbatch ``(k // (S
    V)) S + k % S``; the k-th backward on chunk ``V - 1 - (k // S) % V``
    (1F1B at V = 1: forward and backward k on microbatch k)."""
    enforce(V == 1 or M % S == 0,
            f"accumulate_steps ({M}) must be a multiple of pp_degree ({S}) "
            f"when num_virtual_pipeline_stages is {V}")
    total = M * V

    def mb(k):
        return (k // (S * V)) * S + k % S

    warm = warmup_count(S, s, M, V)
    ops: List[Tuple[str, int, int]] = []
    f = b = 0
    for _ in range(warm):
        ops.append(("F", mb(f), (f // S) % V))
        f += 1
    for _ in range(total - warm):
        ops.append(("F", mb(f), (f // S) % V))
        f += 1
        ops.append(("B", mb(b), V - 1 - (b // S) % V))
        b += 1
    while b < total:
        ops.append(("B", mb(b), V - 1 - (b // S) % V))
        b += 1
    return ops


def bubble(S: int, M: int, V: int = 1) -> float:
    """The schedule's idle share: (S - 1) / (V M + S - 1)."""
    return (S - 1) / (V * M + S - 1)


def peak_live(ops) -> int:
    """The most (microbatch, chunk) activations alive at once."""
    live = peak = 0
    for kind, _, _ in ops:
        live += 1 if kind == "F" else -1
        peak = max(peak, live)
    return peak


def _unwrap_optimizer(opt):
    return getattr(opt, "_inner_opt", opt)


def _micro(x, m: int, M: int):
    """Microbatch ``m`` of ``M`` of a batch leaf (tensors split on dim 0;
    tuples and lists leaf by leaf)."""
    if isinstance(x, (tuple, list)):
        return type(x)(_micro(t, m, M) for t in x)
    if isinstance(x, torch.Tensor) and x.dim():
        b = x.shape[0] // M
        return x.narrow(0, m * b, b)
    return x


class PipelineParallel(_DelegateWrapper):
    def __init__(self, layers: PipelineLayer, hcg=None, strategy=None):
        enforce(isinstance(layers, PipelineLayer),
                "PipelineParallel expects a PipelineLayer model")
        super().__init__(layers, hcg, strategy)
        pconf = getattr(strategy, "pipeline_configs", {}) or {}
        self.accumulate_steps = int(pconf.get("accumulate_steps", 1))
        self.micro_batch_size = int(pconf.get("micro_batch_size", 0))
        self._engine = None
        self._train_step = None
        self.total_loss = None
        self.last_schedule: List[Tuple[str, int, int]] = []
        if hcg is not None:
            self._broadcast(hcg)

    @torch.no_grad()
    def _broadcast(self, hcg):
        """Every rank starts from the same weights: mp-replicated ones
        from the mp group's first rank, every one over dp and sharding
        from their first ranks, the tied copies from stage 0."""
        mp = hcg.get_model_parallel_group()
        shared = hcg.get_pipe_shared_group()
        for p in self._layers.parameters():
            if mp.nranks > 1 and not mp_sharded(p):
                C.broadcast(p.data, mp.ranks[0], group=mp)
            if getattr(p, "pp_shared", None) is not None \
                    and shared.nranks > 1:
                C.broadcast(p.data, shared.ranks[0], group=shared)
            for g in (hcg.get_data_parallel_group(),
                      hcg.get_sharding_parallel_group()):
                if g.nranks > 1:
                    C.broadcast(p.data, g.ranks[0], group=g)

    # -- engine plumbing -------------------------------------------------
    def _ensure_engine(self, optimizer):
        if self._engine is None:
            from ...engine import ParallelEngine

            self._engine = ParallelEngine(
                self._layers, _unwrap_optimizer(optimizer),
                self._hcg.mesh if self._hcg is not None else None)
            self._engine._pipeline = self
        return self._engine

    def _check_batch(self, inputs):
        if self._hcg is None:
            return
        vpp = self._layers.get_num_virtual_stages()
        pp = self._hcg.get_pipe_parallel_world_size()
        if vpp > 1:
            enforce(self.accumulate_steps % pp == 0,
                    "pipeline_configs['accumulate_steps'] "
                    f"({self.accumulate_steps}) must be a multiple of "
                    f"pp_degree ({pp}) when pp_configs"
                    f"['num_virtual_pipeline_stages'] is {vpp}: the "
                    "interleaved schedule runs microbatches in groups of "
                    "pp_degree")
        if self.micro_batch_size <= 0:
            return
        first = inputs[0] if isinstance(inputs, (tuple, list)) else inputs
        data_deg = (self._hcg.get_data_parallel_world_size()
                    * self._hcg.get_sharding_parallel_world_size())
        want = self.micro_batch_size * self.accumulate_steps * data_deg
        enforce(first.shape[0] == want,
                f"global batch {first.shape[0]} != micro_batch_size "
                f"{self.micro_batch_size} x accumulate_steps "
                f"{self.accumulate_steps} x data degree {data_deg}")

    def bubble_fraction(self) -> float:
        return bubble(self._layers.get_num_stages(), self.accumulate_steps,
                      self._layers.get_num_virtual_stages())

    # -- the schedule ----------------------------------------------------
    def _peers(self):
        """(pp group, previous stage's global rank, next stage's)."""
        hcg = self._hcg
        if hcg is None or hcg.get_pipe_parallel_world_size() <= 1:
            return None, None, None
        g = hcg.get_pipe_parallel_group()
        # NCCL matches p2p by order on one stream a peer pair, not by
        # tag: the schedule's sends and receives would wait on each other
        enforce(g.backend != "nccl",
                "PipelineParallel over NCCL (a card a rank): the schedule's "
                "p2p is matched by tag, which NCCL ignores; pairing each "
                "send with the peer's receive in one batched call is not "
                "ported yet (ROADMAP.md queue 1, item 8.1). Ranks sharing "
                "a card, or the CPU, run it over gloo", NotImplementedError)
        return g, hcg.get_p2p_prev_rank(), hcg.get_p2p_next_rank()

    def _act(self, inputs, mb: int, device):
        """An empty activation of one microbatch (module docstring)."""
        first = inputs[0] if isinstance(inputs, (tuple, list)) else inputs
        hidden = self._layers.config.hidden_size
        dtype = next(iter(self._layers.blocks.parameters())).dtype
        return torch.empty((mb,) + tuple(first.shape[1:]) + (hidden,),
                           dtype=dtype, device=device)

    def _run(self, batch, seed=None, train: bool = True,
             loss: bool = True):
        """The schedule over this rank's batch (engine-split): forward
        and, when ``train``, backward of every microbatch (``seed``: the
        loss scaler's backward seed). Returns the batch's loss, the same
        on every pp rank; without ``loss``, the last stage's outputs of
        every microbatch (other stages: None)."""
        L = self._layers
        S, V, s = L.get_num_stages(), L.get_num_virtual_stages(), L._stage
        M = self.accumulate_steps
        inputs, labels = batch["inputs"], batch["labels"]
        lbs = list(labels) if isinstance(labels, (tuple, list)) \
            else [labels]
        first = inputs[0] if isinstance(inputs, (tuple, list)) else inputs
        enforce(first.shape[0] % M == 0,
                f"local batch {first.shape[0]} not divisible by "
                f"accumulate_steps {M}")
        mb = first.shape[0] // M
        dev = next(iter(L.parameters())).device
        masked = len(lbs) > 1
        den = lbs[-1].sum().to(torch.float32) if masked else None
        g, prv, nxt = self._peers()
        ops = schedule(S, s, M, V) if train else \
            [("F", m, v) for m in range(M) for v in range(V)]
        self.last_schedule = ops
        last_vs = S * V - 1
        saved = {}
        sends: List[Any] = []
        outs: List[torch.Tensor] = []
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)

        def tag(m, vs, back):
            return 2 * (m * S * V + vs) + int(back)

        for kind, m, v in ops:
            vs = v * S + s
            if kind == "F":
                if vs == 0:
                    x = _micro(inputs, m, M)
                else:
                    x = self._act(inputs, mb, dev)
                    C.irecv(x, prv, g, tag(m, vs - 1, False)).wait()
                    x.requires_grad_(train)
                with torch.set_grad_enabled(train):
                    out = L.run_chunk(v, x, m)
                    if vs == last_vs and loss:
                        lb = [_micro(t, m, M) for t in lbs]
                        with C.loss_denominator(den):
                            out = L._loss_fn(out, *lb)
                        if not masked:
                            out = out / M
                        loss_sum = loss_sum + out.detach().float()
                if vs != last_vs:
                    sends.append(C.isend(out.detach(), nxt, g,
                                         tag(m, vs, False)))
                elif not loss:
                    outs.append(out)
                if train:
                    saved[(m, v)] = (x if vs > 0 else None, out)
                continue
            x, out = saved.pop((m, v))
            zs = getattr(self._engine, "_zstep", None)
            if zs is not None and m == M - 1:
                # the chunk's last backward: its buckets may fire
                zs.arm(L.chunk_parameters(v))
            if vs == last_vs:
                torch.autograd.backward(
                    out, None if seed is None
                    else seed.to(out.dtype).reshape(out.shape))
            else:
                gout = torch.empty_like(out)
                C.irecv(gout, nxt, g, tag(m, vs, True)).wait()
                torch.autograd.backward(out, gout)
            if vs > 0:
                sends.append(C.isend(x.grad, prv, g, tag(m, vs - 1, True)))
        for t in sends:
            t.wait()
        if not loss:
            return torch.cat(outs, 0) if outs else None
        if g is not None:
            # the last stage's sum on every pp rank (a masked psum)
            if not L.is_last_stage():
                loss_sum = torch.zeros_like(loss_sum)
            loss_sum = C.t_psum(loss_sum.reshape(1), g).reshape(())
        return loss_sum

    # -- reference API ---------------------------------------------------
    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One pipeline step over ``data = [inputs, labels]`` (the global
        batch): the schedule, the gradient sync and the update; returns
        the batch's loss."""
        inputs, labels = data
        self._check_batch(inputs)
        if lr_scheduler is not None:
            _unwrap_optimizer(optimizer).set_lr_scheduler(lr_scheduler)
        eng = self._ensure_engine(optimizer)
        if self._train_step is None:
            def fn(model, batch, seed=None):
                return self._run(batch, seed)

            self._train_step = eng.train_step(fn, scaler=scaler,
                                              fwd_bwd=True)
        self.total_loss = self._train_step({"inputs": inputs,
                                            "labels": labels})
        return self.total_loss

    def eval_batch(self, data, compute_loss: bool = True):
        """Forward only over ``data = [inputs, labels]``: the loss (the
        mean over every rank, as the JAX ``eval_batch``'s pmean) with
        ``compute_loss``; without it the last stage's outputs of this
        rank's batch, in microbatch order (other stages: None)."""
        from ...engine import P

        inputs, labels = data
        enforce(self._engine is not None,
                "call train_batch once before eval_batch (or use forward "
                "directly)")
        eng = self._engine

        def fn(model, batch):
            out = self._run(batch, train=False, loss=compute_loss)
            if compute_loss and eng._world is not None:
                out = C.t_pmean(out.reshape(1), eng._world).reshape(())
            return out
        return eng.eval_step(fn)({"inputs": inputs, "labels": labels},
                                 out_spec=P())

    def save_checkpoint(self, *a, **k):
        raise NotImplementedError(
            f"PipelineParallel.save_checkpoint: checkpoints of a pipeline "
            f"across processes are not ported yet ({_ITEM11})")

    def restore_checkpoint(self, *a, **k):
        raise NotImplementedError(
            f"PipelineParallel.restore_checkpoint: not ported yet "
            f"({_ITEM11})")

    def profile_exposed_comm(self, *a, **k):
        raise NotImplementedError(
            f"PipelineParallel.profile_exposed_comm: the exposed-comm "
            f"replay over a pipeline is not ported yet ({_ITEM11})")

"""The train-step engine at degree 1 (counterpart of
``paddle_tpu/distributed/engine.py`` ``ParallelEngine``).

Usage, as in the JAX package::

    eng = ParallelEngine(model, opt)
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

Everything above degree 1 raises: a mesh of more than one device
(ROADMAP.md queue 1, item 8), ZeRO, offload, quantized or overlapped
communication and the memory ledger (items 9 and 10).
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..amp import GradScaler
from ..core.compile_stats import CompileStats
from ..models.llama import resolve_device
from ..optimizer.lr import LRScheduler

__all__ = ["ParallelEngine"]

_ITEM8 = "ROADMAP.md queue 1, item 8 (the communication base)"
_ITEM9_10 = "ROADMAP.md queue 1, items 9 and 10"


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


class ParallelEngine:
    def __init__(self, model, optimizer=None, mesh=None, comm_overlap=None,
                 comm_buffer_size_mb=None, mem_ledger=None, quant_comm=None,
                 sharding_stage=None, stage3_release_after_forward=None,
                 offload=None):
        if mesh is not None and mesh.size > 1:
            raise NotImplementedError(
                f"ParallelEngine over a mesh of {mesh.size} devices is not "
                f"ported yet: {_ITEM8}")
        knobs = {"comm_overlap": comm_overlap, "mem_ledger": mem_ledger,
                 "quant_comm": quant_comm, "sharding_stage": sharding_stage,
                 "stage3_release_after_forward":
                     stage3_release_after_forward, "offload": offload,
                 "comm_buffer_size_mb": comm_buffer_size_mb}
        on = sorted(k for k, v in knobs.items() if v not in (None, False))
        if on:
            raise NotImplementedError(
                f"ParallelEngine {', '.join(on)}: not ported yet "
                f"({_ITEM9_10})")
        self.model = model
        self.optimizer = optimizer
        params = list(model.parameters())
        # the model's device is the engine's; a CUDA model without a card
        # raises here as it does where it is built
        self.device = resolve_device(params[0].device if params else None)
        self.stats = CompileStats()

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
        if batch_specs is not None:
            raise NotImplementedError(
                f"ParallelEngine.train_step(batch_specs=...) shards over a "
                f"mesh: not ported yet ({_ITEM8})")
        if self.optimizer is None:
            raise ValueError("ParallelEngine.train_step needs an optimizer")

        def step(batch):
            batch, structure, leaves = _map(batch, self._to_device)
            self.stats.note("train", (structure, tuple(
                (tuple(v.shape), str(v.dtype)) for v in leaves
                if isinstance(v, torch.Tensor)), amp_key))
            opt = self.optimizer
            loss = fn(self.model, batch)
            if use_scaler:
                # the applied-step count is seeded from the optimizer's
                # count before this step (the JAX engine's -1)
                amp = scaler._amp_step(
                    self.device, 2.0 ** 15 if loss.dtype == torch.float16
                    else 2.0 ** 62, fallback_step=opt._step_count)
                # the cap keeps the backward seed itself finite; a power
                # of two keeps scale and unscale an exact round trip
                amp.scale.clamp_(max=amp.cap)
                # loss scaling = seeding the backward with the scale
                loss.backward(amp.scale.to(loss.dtype).reshape(loss.shape))
                opt.step(amp=amp)
                scaler._found_inf_dev = amp.found
            else:
                loss.backward()
                opt.step()
            opt.clear_grad()
            if isinstance(opt._lr, LRScheduler):
                opt._lr.step()   # once per train step, as the JAX engine
            return loss.detach()

        return step

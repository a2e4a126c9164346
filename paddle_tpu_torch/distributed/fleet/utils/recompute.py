"""Activation recomputation (counterpart of
``paddle_tpu/distributed/fleet/utils/recompute.py``).

``recompute(function, *args)`` runs ``function`` without keeping its
internal activations and runs it again inside the backward, where the
gradients of its inputs and parameters are taken (a reentrant
``torch.autograd.Function``). The JAX package wraps the block in
``jax.checkpoint``, which replays one traced program, so its dropout
masks match by construction. Here the replay is a second eager run, so
before it runs it is put back into the state its forward ran in:

- every random generator the block can draw from: the generators its
  modules hold (a model's hidden-dropout generator, its attention
  generator, from which each K1 call draws one Philox seed), the fleet
  RNG tracker's streams, and the default CPU and CUDA generators. The
  replay draws the same masks and hands K1/K2 the same seed; afterwards
  every generator is set back to where the backward found it, so a step
  with recompute leaves them as a step without it does;
- the ``amp.auto_cast`` state, so the replay casts as its forward did;
- the ``collective.spmd_region`` the forward ran in: ``ParallelEngine``
  runs the backward after its region has closed, and a replayed masked
  loss (``_masked_mean_over_splits``) must take the denominator over the
  same dp group as its forward did;
- the comm ledger's captures open at the forward: a CUDA backward runs
  on autograd's device thread, and the replay's collectives (and those
  of its backward) are booked into them there (``commledger.carried``).

The parameters the block touches are found as the JAX function finds
them (a module, a bound method of one, or a closure's cells holding
modules or tensors: ``recompute(lambda h: self.mlp(h), h)``) and enter
the Function as inputs, so its output takes a gradient even when no
input needs one; their gradients accumulate in the replay's backward.
``use_reentrant`` is accepted and both values run this replay (the JAX
package ignores it too); ``preserve_rng_state=False`` replays with the
generators as the backward finds them.
"""
from __future__ import annotations

import contextlib
from typing import Any, List

import torch
from torch import nn

from ....amp import restored, state_snapshot
from ....observability import commledger as cl
from ... import collective as C

__all__ = ["recompute", "recompute_sequential"]


def _roots(function) -> List[Any]:
    """What ``function`` reaches: itself if a module, a bound method's
    owner, and its closure's cells."""
    roots = [function] if isinstance(function, nn.Module) else []
    owner = getattr(function, "__self__", None)
    if isinstance(owner, nn.Module):
        roots.append(owner)
    for cell in getattr(function, "__closure__", None) or ():
        try:
            roots.append(cell.cell_contents)
        except ValueError:
            continue
    return roots


def _collect_params(function) -> List[torch.Tensor]:
    """The trainable tensors ``function`` touches (the JAX
    ``_collect_params``), each once."""
    seen, params = set(), []
    for v in _roots(function):
        cands = (v.parameters() if isinstance(v, nn.Module)
                 else [v] if isinstance(v, torch.Tensor) else [])
        for p in cands:
            if p.requires_grad and id(p) not in seen:
                seen.add(id(p))
                params.append(p)
    return params


def _generators(function) -> List[torch.Generator]:
    """Every generator a replay of ``function`` could draw from."""
    from ..layers.mpu.random import get_rng_state_tracker

    out = {}
    for v in _roots(function):
        if isinstance(v, torch.Generator):
            out[id(v)] = v
        if isinstance(v, nn.Module):
            for mod in v.modules():
                for a in vars(mod).values():
                    if isinstance(a, torch.Generator):
                        out[id(a)] = a
    for g in get_rng_state_tracker().states_.values():
        out[id(g)] = g
    out[id(torch.default_generator)] = torch.default_generator
    if torch.cuda.is_initialized():
        for g in torch.cuda.default_generators:
            out[id(g)] = g
    return list(out.values())


def _flatten(obj, leaves):
    """``obj``'s tensor leaves (lists, tuples, dicts walked) appended to
    ``leaves``; returns a function rebuilding ``obj`` from new leaves."""
    if isinstance(obj, torch.Tensor):
        i = len(leaves)
        leaves.append(obj)
        return lambda new: new[i]
    if isinstance(obj, (list, tuple)):
        parts = [_flatten(v, leaves) for v in obj]
        return lambda new: type(obj)(f(new) for f in parts)
    if isinstance(obj, dict):
        parts = {k: _flatten(v, leaves) for k, v in obj.items()}
        return lambda new: {k: f(new) for k, f in parts.items()}
    return lambda new: obj


class _Replay:
    """One recomputed call: how to run it and the state it ran in."""

    def __init__(self, function, rebuild, preserve_rng_state):
        self.function = function
        self.rebuild = rebuild
        self.gens = _generators(function) if preserve_rng_state else []
        self.rng = [g.get_state() for g in self.gens]
        self.amp = state_snapshot()
        self.spmd = C.spmd_data_group()
        self.captures = cl.open_captures()

    def call(self, tensors):
        args, kwargs = self.rebuild(list(tensors))
        return self.function(*args, **kwargs)

    @contextlib.contextmanager
    def forward_state(self):
        """The generators, AMP state and SPMD region of the forward; the
        generators set back to where they were on leaving."""
        now = [g.get_state() for g in self.gens]
        for g, st in zip(self.gens, self.rng):
            g.set_state(st)
        try:
            with restored(self.amp), C.spmd_region(self.spmd):
                yield
        finally:
            for g, st in zip(self.gens, now):
                g.set_state(st)


class _Recompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, replay, n_in, *tensors):
        ctx.replay, ctx.n_in = replay, n_in
        ctx.save_for_backward(*tensors[:n_in])
        with torch.no_grad():
            out = replay.call(tensors[:n_in])
        ctx.multi = isinstance(out, (tuple, list))
        outs = tuple(out) if ctx.multi else (out,)
        ctx.mark_non_differentiable(*[
            o for o in outs if isinstance(o, torch.Tensor)
            and not (o.is_floating_point() or o.is_complex())])
        return outs if ctx.multi else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        replay = ctx.replay
        inputs = [x.detach().requires_grad_(x.requires_grad)
                  for x in ctx.saved_tensors]
        with cl.carried(replay.captures):
            with replay.forward_state(), torch.enable_grad():
                out = replay.call(inputs)
            outs = tuple(out) if ctx.multi else (out,)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if isinstance(o, torch.Tensor) and o.requires_grad
                     and g is not None]
            if pairs:
                torch.autograd.backward([o for o, _ in pairs],
                                        [g for _, g in pairs])
        n_params = len(ctx.needs_input_grad) - 2 - ctx.n_in
        return (None, None, *[x.grad if x.requires_grad else None
                              for x in inputs], *([None] * n_params))


def recompute(function, *args, use_reentrant: bool = True,
              preserve_rng_state: bool = True, **kwargs):
    """``function(*args, **kwargs)`` without its internal activations:
    they are recomputed in the backward (module docstring). Returns what
    ``function`` returns (a tensor or a tuple of tensors)."""
    params = _collect_params(function)
    leaves: List[torch.Tensor] = []
    rebuild = _flatten((args, kwargs), leaves)
    if not torch.is_grad_enabled() or not (
            params or any(t.requires_grad for t in leaves)):
        return function(*args, **kwargs)
    replay = _Replay(function, rebuild, preserve_rng_state)
    return _Recompute.apply(replay, len(leaves), *leaves, *params)


class _Seq(nn.Module):
    """A run of layers as one module (the JAX ``_Seq``)."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, *x):
        for layer in self.layers:
            x = layer(*x) if isinstance(x, tuple) else layer(x)
        return x


def recompute_sequential(ctx: dict, functions, *args, **kwargs):
    """Recompute a sequence of layers (an ``nn.Sequential`` or a list) in
    ``ctx["segments"]`` segments, each one ``recompute`` call."""
    segments = int(ctx.get("segments", 1)) if ctx else 1
    layers = list(functions)
    if segments <= 1:
        return recompute(_Seq(layers), *args, **kwargs)
    size = max(1, len(layers) // segments)
    out = args
    for start in range(0, len(layers), size):
        out = recompute(_Seq(layers[start:start + size]),
                        *(out if isinstance(out, tuple) else (out,)),
                        **kwargs)
        kwargs = {}
    return out

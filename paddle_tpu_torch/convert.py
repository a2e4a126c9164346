"""Carry weights between the JAX package and the port.

``load_jax_state_dict(model, state)`` takes ``{structured name:
np.ndarray}`` named as ``paddle_tpu``'s ``Layer.state_dict()`` names them
(``llama.layers.0.self_attn.q_proj.weight``, ...). The JAX package stores
``Linear`` weights as ``[in, out]``; the port's linears are
``nn.Linear``s (``[out, in]``), so the weights of ``nn.Linear`` modules,
and only those, are transposed. Raw parameters that keep Paddle's
``[in, out]`` layout in the port too, such as ``FusedMultiTransformer``'s
``qkv_weights_0`` or ``ffn1_weights_0``, are carried as they are. Every
name and shape must match both ways, or the load raises before anything
is written. The caller builds ``state`` with numpy, so the port never
imports JAX.

``export_jax_state_dict(model)`` is the inverse: ``{JAX name:
np.ndarray}`` with the linears transposed back to ``[in, out]``, for
comparing parameters with the JAX package after training steps
(bf16 parameters come out as float32 arrays, which numpy can hold).
With ``tensors=True`` the values are CPU tensors in the parameters' own
dtypes instead (bf16 stays bf16), which ``framework.io.save`` writes as
the JAX package writes a state dict: ``save(export_jax_state_dict(model,
tensors=True), path)`` is a params file either package serves.
``load_jax_state_dict`` takes such tensors as well as arrays.

A model quantized for serving (``nn.quant.quantize_for_serving``) carries
``*.weight_quant`` (int8, ``[out, in]`` in both packages, so never
transposed; int4 packed ``[out, in // 2]``) and ``*.weight_scale`` (f32)
both ways bit for bit: int8 stays int8.

Under tensor parallelism (a model built after ``fleet.init`` with mp > 1)
``load_jax_state_dict(model, state, hcg=None)`` slices the JAX package's
full weights for this rank: column-parallel weights and biases by output
(the rows of the port's ``[out, in]``), row-parallel weights by input,
the vocab embedding by rows; a row-parallel bias and everything else is
replicated and loaded whole. ``hcg`` names the model-parallel rank and
degree (default: the group each shard was built for).
``export_jax_state_dict`` gathers the shards back into the full JAX
layout (an all-gather over the mp group: every rank calls it), so
parameters compare whole.

A ``PipelineLayer`` (``GPTForCausalLMPipe``) carries the JAX
``PipelineLayer``'s names: its ``jax_names()`` maps each local parameter
to a JAX name and, for a block, a row of the stacked ``blocks__*`` array
(``[L, ...]``, or ``[vpp, L / vpp, ...]`` under virtual stages), so each
pp rank loads the rows of its own chunks, with the mp slice on top, and
the tied copy on the last stage loads the embedding. Names of parts
another rank holds are not this rank's to check. Export gathers a
ZeRO stage-3 parameter's shards over the sharding group, the mp shards,
then every stage's rows over the pp group (``all_gather_object``), so
every rank gets the whole JAX state.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_state_dict", "export_jax_state_dict"]


def _linear_weights(model: nn.Module):
    return {f"{name}.weight" for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


def _shard(p: torch.Tensor, hcg=None):
    """(group, split dim) of a tensor-parallel shard, or None."""
    g = getattr(p, "mp_group", None)
    if g is None:
        return None
    if hcg is not None:
        g = hcg.get_model_parallel_group()
    return g, p.split_axis


def _local(t: torch.Tensor, shard) -> torch.Tensor:
    """This rank's slice of the full tensor ``t`` (port layout)."""
    if shard is None:
        return t
    g, axis = shard
    n = t.shape[axis] // g.nranks
    return t.narrow(axis, g.rank * n, n)


def _names(model: nn.Module):
    """{port name: (JAX name, stacked row or None)}."""
    fn = getattr(model, "jax_names", None)
    if callable(fn):
        return fn()
    return {n: (n, None) for n, _ in model.named_parameters()}


@torch.no_grad()
def load_jax_state_dict(model: nn.Module, state: Dict[str, np.ndarray],
                        hcg=None) -> None:
    params = dict(model.named_parameters())
    names = _names(model)
    wanted = {j for j, _ in names.values()}
    missing = sorted(wanted - set(state))
    unexpected = [] if hasattr(model, "jax_names") else sorted(
        set(state) - wanted)
    if missing or unexpected:
        raise KeyError(f"load_jax_state_dict: names differ; missing "
                       f"{missing}, unexpected {unexpected}")
    linear = _linear_weights(model)
    converted = {}
    for name, p in params.items():
        jname, row = names[name]
        src = state[jname]
        if row is not None:
            src = src[row]
        if isinstance(src, torch.Tensor):
            t = src.detach()
        else:
            arr = np.asarray(src)
            if arr.dtype.kind not in "fiu":     # e.g. ml_dtypes bfloat16
                arr = arr.astype(np.float32)
            t = torch.tensor(np.ascontiguousarray(arr))
        if name in linear:
            t = t.T
        t = _local(t, _shard(p, hcg))
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"load_jax_state_dict: {name} has shape "
                             f"{tuple(src.shape)} in the "
                             f"JAX state, the port expects "
                             f"{tuple(p.shape)}"
                             + (" (transposed from [in, out])"
                                if name in linear else ""))
        converted[name] = t
    for name, p in params.items():
        p.copy_(converted[name].to(device=p.device, dtype=p.dtype))


@torch.no_grad()
def export_jax_state_dict(model: nn.Module, tensors: bool = False) -> Dict:
    from .distributed import collective as C

    linear = _linear_weights(model)
    names = _names(model)
    out = {}
    rows: Dict[str, Dict[tuple, object]] = {}
    for name, p in model.named_parameters():
        stored = getattr(p, "zero_stored", None)
        shard = _shard(p)
        p = p.detach()
        if stored is not None:
            from .distributed.grad_buckets import from_rank_major

            group, dim, _ = stored
            got = C.t_all_gather(p.contiguous().reshape(-1), group, axis=0,
                                 tiled=False)
            p = from_rank_major(got, dim, p.shape)
        if shard is not None:
            p = C.t_all_gather(p.contiguous(), shard[0], axis=shard[1])
        if name in linear:
            p = p.T
        if tensors:
            v = p.contiguous().cpu()
        else:
            v = np.ascontiguousarray(
                (p.float() if p.is_floating_point() else p).cpu().numpy())
        jname, row = names[name]
        if row is None:
            out.setdefault(jname, v)
        else:
            rows.setdefault(jname, {})[row] = v
    pp = _pipe_group(model)
    if pp is not None:
        parts = C.all_gather_object([], (out, rows), group=pp)
        out, rows = {}, {}
        for o, r in parts:     # stage order: stage 0's copy of a tie wins
            for k, v in o.items():
                out.setdefault(k, v)
            for k, v in r.items():
                rows.setdefault(k, {}).update(v)
    for jname, got in rows.items():
        lead = tuple(max(r[d] for r in got) + 1
                     for d in range(len(next(iter(got)))))
        first = next(iter(got.values()))
        if tensors:
            full = torch.empty(lead + tuple(first.shape), dtype=first.dtype)
        else:
            full = np.empty(lead + tuple(first.shape), first.dtype)
        for r, v in got.items():
            full[r] = v
        out[jname] = full
    return out


def _pipe_group(model: nn.Module):
    """A pipeline's pp group of more than one rank, or None."""
    if not hasattr(model, "jax_names") or model.get_num_stages() <= 1:
        return None
    from .distributed import fleet

    hcg = fleet.get_hybrid_communicate_group()
    g = hcg.get_pipe_parallel_group() if hcg is not None else None
    return g if g is not None and g.nranks > 1 else None

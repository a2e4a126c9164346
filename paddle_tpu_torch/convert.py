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


@torch.no_grad()
def load_jax_state_dict(model: nn.Module, state: Dict[str, np.ndarray],
                        hcg=None) -> None:
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing or unexpected:
        raise KeyError(f"load_jax_state_dict: names differ; missing "
                       f"{missing}, unexpected {unexpected}")
    linear = _linear_weights(model)
    converted = {}
    for name, p in params.items():
        src = state[name]
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
    linear = _linear_weights(model)
    out = {}
    for name, p in model.named_parameters():
        shard = _shard(p)
        p = p.detach()
        if shard is not None:
            from .distributed import collective as C

            p = C.t_all_gather(p.contiguous(), shard[0], axis=shard[1])
        if name in linear:
            p = p.T
        if tensors:
            out[name] = p.contiguous().cpu()
            continue
        arr = (p.float() if p.is_floating_point() else p).cpu().numpy()
        out[name] = np.ascontiguousarray(arr)
    return out

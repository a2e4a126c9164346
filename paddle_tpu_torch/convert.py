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


@torch.no_grad()
def load_jax_state_dict(model: nn.Module,
                        state: Dict[str, np.ndarray]) -> None:
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing or unexpected:
        raise KeyError(f"load_jax_state_dict: names differ; missing "
                       f"{missing}, unexpected {unexpected}")
    linear = _linear_weights(model)
    converted = {}
    for name, p in params.items():
        arr = np.asarray(state[name])
        if arr.dtype.kind not in "fiu":     # e.g. ml_dtypes bfloat16
            arr = arr.astype(np.float32)
        if name in linear:
            arr = arr.T
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"load_jax_state_dict: {name} has shape "
                             f"{tuple(np.asarray(state[name]).shape)} in the "
                             f"JAX state, the port expects "
                             f"{tuple(p.shape)}"
                             + (" (transposed from [in, out])"
                                if name in linear else ""))
        converted[name] = torch.tensor(np.ascontiguousarray(arr))
    for name, p in params.items():
        p.copy_(converted[name].to(device=p.device, dtype=p.dtype))


@torch.no_grad()
def export_jax_state_dict(model: nn.Module) -> Dict[str, np.ndarray]:
    linear = _linear_weights(model)
    out = {}
    for name, p in model.named_parameters():
        arr = p.detach().float().cpu().numpy()
        out[name] = np.ascontiguousarray(arr.T if name in linear else arr)
    return out

"""The optimizer half of a training checkpoint (counterpart of
``paddle_tpu/distributed/fleet/elastic/resume.py``'s ``opt_state_tensors``
and ``_apply_opt_state``; the rest of that module waits on ROADMAP.md
queue 1, item 11).

Keys are the MODEL's structured parameter names, as in the JAX package
(``gpt.layers.0.attn.qkv_proj.weight.moment1``, ``....master_weight``):
a function of the module tree alone, stable across rebuilds, processes
and packages.

Layout: the JAX package stores ``Linear`` weights ``[in, out]``, the
port's ``nn.Linear`` ``[out, in]``. Names in ``transposed`` (the engine
passes ``convert``'s ``nn.Linear`` weights) are given as ``.t()`` views,
so each such weight's moments and master carry the JAX layout too, and
a load into the view writes the port's layout.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

import torch

__all__ = ["opt_state_tensors"]


def opt_state_tensors(model, optimizer, transposed: Iterable[str] = ()
                      ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Optimizer state (tensor slots + master weights) as checkpoint
    tensors keyed by the model's structured parameter names.

    Returns ``(slots, tensors)``: ``slots[key] = (param, slot_name,
    is_transposed)`` for writing loaded values back, ``tensors[key]`` the
    live tensor (a ``.t()`` view for a transposed name) as the save
    source and the in-place load target."""
    transposed = set(transposed)
    name_of = {id(p): n for n, p in model.named_parameters()}
    slots: Dict[str, Any] = {}
    tensors: Dict[str, torch.Tensor] = {}
    for i, p in enumerate(optimizer._parameter_list or []):
        name = name_of.get(id(p)) or optimizer._names.get(id(p)) \
            or f"param_{i}"
        flip = name in transposed
        st = dict(optimizer._states.get(id(p)) or {})
        mw = optimizer._master_weights.get(id(p))
        if mw is not None:
            st["master_weight"] = mw
        for k, v in st.items():
            if not isinstance(v, torch.Tensor):
                continue
            slots[f"{name}.{k}"] = (p, k, flip)
            tensors[f"{name}.{k}"] = v.t() if flip and v.dim() == 2 else v
    return slots, tensors


@torch.no_grad()
def _apply_opt_state(optimizer, slots, tensors) -> None:
    """Write loaded checkpoint tensors back into the optimizer. A tensor
    that is the live slot (or its view, as ``opt_state_tensors`` gives
    them and ``load_state_dict`` fills in place) is already there."""
    for key, (p, k, flip) in slots.items():
        dst = (optimizer._master_weights[id(p)] if k == "master_weight"
               else optimizer._states[id(p)][k])
        src = tensors[key]
        if src.data_ptr() == dst.data_ptr() and src.numel() == dst.numel():
            continue
        if flip and src.dim() == 2:
            src = src.t()
        dst.copy_(src.to(device=dst.device, dtype=dst.dtype))

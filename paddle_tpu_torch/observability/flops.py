"""Flop accountant: model FLOPs/token + MFU from the model config
(counterpart of ``paddle_tpu/observability/flops.py``).

MFU follows the PaLM/Megatron convention (PAPERS.md: Megatron-LM): a
decoder-only transformer spends ~6*N FLOPs per token (fwd 2N + bwd 4N),
optionally plus the attention term 12*L*h*S that 6N omits; recompute
FLOPs are deliberately EXCLUDED so remat lowers measured MFU honestly.
The accountant reads whatever config the model carries (GPTConfig /
LlamaConfig expose ``num_params()``); when there is no config it falls
back to summing parameter sizes, which the engine can always do.

``peak_flops_per_chip`` knows the card the port runs on, the H100 (SXM):
989e12 dense bf16 FLOP/s and 3.35e12 HBM bytes/s, NVIDIA's published
figures. Any other device gives (0, 0), so MFU reads 0.0 there. The
interconnect floors (``ici_bytes_per_sec``, ``comm_seconds_lower_bound``)
wait on NCCL across cards, which needs a host with more than one
(ROADMAP.md queue 1, item 8.1).
"""
from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["params_from_config", "train_flops_per_token",
           "peak_flops_per_chip", "mfu", "PEAK_BY_CARD"]

# (peak dense bf16 FLOPs/s, HBM bytes/s) by a substring of the CUDA
# device name, lower case
PEAK_BY_CARD = {
    "h100": (989e12, 3.35e12),
}


def params_from_config(config) -> Optional[int]:
    """Parameter count from a model config, or None (configs across the
    model zoo expose ``num_params()``; anything else is ignored)."""
    fn = getattr(config, "num_params", None)
    if callable(fn):
        try:
            return int(fn())
        except Exception:
            return None
    return None


def train_flops_per_token(n_params: int, *, config=None,
                          with_attention: bool = True) -> float:
    """~FLOPs one training token costs: 6*N plus (when the config
    exposes layer geometry) the 12*L*h*S attention-matmul term."""
    f = 6.0 * n_params
    if with_attention and config is not None:
        L = getattr(config, "num_layers", None)
        h = getattr(config, "hidden_size", None)
        S = getattr(config, "max_position_embeddings", None)
        if L and h and S:
            f += 12.0 * L * h * S
    return f


def peak_flops_per_chip(device) -> Tuple[float, float]:
    """(peak dense bf16 FLOPs/s, HBM bytes/s) of a torch device (or a
    device name): the H100's figures on an H100, (0, 0) on the CPU and
    on any card the table does not know, where MFU is not meaningful."""
    if isinstance(device, str) and ":" not in device and \
            device not in ("cpu", "cuda"):
        name = device
    else:
        import torch

        device = torch.device(device)
        if device.type != "cuda" or not torch.cuda.is_available():
            return (0.0, 0.0)
        name = torch.cuda.get_device_name(device)
    name = name.lower()
    for k, v in PEAK_BY_CARD.items():
        if k in name:
            return v
    return (0.0, 0.0)


def mfu(n_params: int, tokens_per_sec: float, n_devices: int,
        peak_per_chip: float, *, config=None) -> float:
    """Model-FLOPs utilization of the whole slice; 0.0 when peak is
    unknown (CPU) so gauges stay well-defined everywhere."""
    denom = peak_per_chip * max(n_devices, 1)
    if denom <= 0:
        return 0.0
    return train_flops_per_token(n_params, config=config) \
        * tokens_per_sec / denom

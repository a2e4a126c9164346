"""Hand-written Hopper kernels of the port (counterpart of
``paddle_tpu/ops/pallas``).

Every kernel module holds three things: the wrapper a model calls, the
plain PyTorch version of the same function, and a launch counter on the
wrapper. The wrapper checks device, dtype, shape and contiguity and
raises on anything the kernel does not take. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises. Nothing
falls back.

This module holds the checks the wrappers share and the ctypes argument
helpers; ``_build.py`` builds and loads the libraries.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["DTYPE_CODES", "dtype_code", "ptr", "route", "stream",
           "want_contiguous"]

# the dtype codes the C entry points switch on
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def route(*tensors: torch.Tensor) -> str:
    """"cpu" or "cuda": the device type every tensor lies on. Mixed
    devices, or any other device type, raise."""
    dev = {t.device for t in tensors}
    if len(dev) != 1:
        raise ValueError(f"kernel inputs on several devices: {sorted(map(str, dev))}")
    kind = next(iter(dev)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"kernel inputs on unsupported device {kind!r}")
    return kind


def dtype_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        "(float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]


def want_contiguous(t: torch.Tensor, name: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (shape "
                         f"{tuple(t.shape)}, strides {t.stride()})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device: kernels launch there
    and never synchronise."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)

"""K3: fused RMSNorm (counterpart of ``paddle_tpu/ops/pallas/rms_norm.py``).

``rms_norm`` replaces ``rms_norm_fused`` (forward only: training, and
with it the backward, is a later slice). The CUDA source is
``csrc/rms_norm.cu``; its header gives the bound (bytes: each row read
once, written once) and the design. ``rms_norm_dense`` is the plain
PyTorch version with the same f32 formula.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, dtype_code, ptr, route, stream, want_contiguous

__all__ = ["rms_norm", "rms_norm_dense"]

_THREADS = 256
_MAX_VECS = 8          # 16-byte vectors a thread keeps in registers


def rms_norm_dense(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Plain version: f32 mean of squares per row, ``x*rsqrt(ms+eps)*w``,
    cast back to x's dtype."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * weight.float()).to(x.dtype)


@functools.cache
def _lib():
    lib = _build.library("rms_norm")
    fn = lib.rms_norm_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x [..., H] normalized over the last dim, weight [H]."""
    H = x.shape[-1]
    if weight.shape != (H,):
        raise ValueError(f"rms_norm: weight shape {tuple(weight.shape)} "
                         f"!= ({H},)")
    code = dtype_code(x, "rms_norm x")
    if weight.dtype != x.dtype:
        raise TypeError(f"rms_norm: weight dtype {weight.dtype} != x dtype "
                        f"{x.dtype}")
    if route(x, weight) == "cpu":
        return rms_norm_dense(x, weight, eps)
    want_contiguous(x, "rms_norm x")
    want_contiguous(weight, "rms_norm weight")
    per_vec = 16 // x.element_size()
    if H % per_vec or H > _THREADS * _MAX_VECS * per_vec:
        raise ValueError(f"rms_norm: hidden size {H} must be a multiple of "
                         f"{per_vec} and at most "
                         f"{_THREADS * _MAX_VECS * per_vec} for {x.dtype}")
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("rms_norm: x and weight must be 16-byte aligned")
    out = torch.empty_like(x)
    rows = x.numel() // H
    rc = _lib()(ptr(x), ptr(weight), ptr(out), rows, H, float(eps), code,
                stream(x))
    _build.check(rc, "rms_norm")
    rms_norm.launches += 1
    return out


rms_norm.launches = 0

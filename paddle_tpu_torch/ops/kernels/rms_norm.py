"""K3: fused RMSNorm (counterpart of ``paddle_tpu/ops/pallas/rms_norm.py``).

``rms_norm`` replaces ``rms_norm_fused`` and its custom VJP. On CUDA
tensors the forward launches the kernel of ``csrc/rms_norm.cu`` (its
header gives the bound, bytes, and the design) inside a
``torch.autograd.Function``; the backward is ``rms_norm_grad``, the
analytic VJP of the same f32 formula in plain torch ops, as the JAX
package leaves its ``_bwd`` to XLA rather than to Pallas.
``rms_norm_dense`` is the plain version of the forward; on CPU tensors
``rms_norm`` is that, and autograd differentiates it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import (_build, counted, dtype_code, ptr, route, stream,
               want_contiguous)

__all__ = ["rms_norm", "rms_norm_dense", "rms_norm_grad"]

_THREADS = 256
_MAX_VECS = 8          # 16-byte vectors a thread keeps in registers


def rms_norm_dense(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Plain version: f32 mean of squares per row, ``x*rsqrt(ms+eps)*w``,
    cast back to x's dtype."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * weight.float()).to(x.dtype)


def rms_norm_grad(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                  eps: float = 1e-6):
    """VJP of ``rms_norm_dense`` for the output gradient ``g``: (dx, dw)
    in x's and weight's dtypes, computed in f32. With r = rsqrt(ms + eps)
    and gw = g * w: dx = r * (gw - x * r^2 * mean(gw * x)) and
    dw = sum over rows of g * x * r."""
    xf = x.float()
    gf = g.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    gw = gf * weight.float()
    dx = r * (gw - xf * (r * r) * (gw * xf).mean(dim=-1, keepdim=True))
    dw = (gf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(weight.dtype)


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
    dtype_code(x, "rms_norm x")
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
    # under no_grad (serving) the Function records no graph: one launch
    # either way
    return _RMSNorm.apply(x, weight, float(eps))


def _launch(x, weight, eps):
    out = torch.empty_like(x)
    rows = x.numel() // x.shape[-1]
    rc = _lib()(ptr(x), ptr(weight), ptr(out), rows, x.shape[-1], eps,
                dtype_code(x, "rms_norm x"), stream(x))
    _build.check(rc, "rms_norm")
    rms_norm.launches += 1
    return out


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _launch(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_grad(x, weight, g, ctx.eps)
        return dx, dw, None


rms_norm = counted(rms_norm)

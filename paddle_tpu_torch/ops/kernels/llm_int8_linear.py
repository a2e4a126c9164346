"""K10: LLM.int8's linear (a port-only kernel: the counterpart of what XLA
makes of ``paddle_tpu/nn/quant.py`` ``llm_int8_linear`` :97, the outlier
decomposition of Dettmers et al., arXiv:2208.07339, whose int8 x int8 ->
int32 product the JAX package leaves to XLA; there is no ``pallas_call``
to port).

``llm_int8_linear(x, q, scale, bias, threshold)`` computes, step by step
as the JAX function does (its f32 roundings decide the int8 half's
bits):

    xf       = x.float()                                  x [..., K]
    outlier  = max over every leading row of |xf| > threshold   [K]
    x_in     = where(outlier, 0, xf)
    a_scale  = max(max_k |x_in|, 1e-10) / 127             per row, a true division
    xq       = clip(round(x_in / a_scale), -127, 127)     int8, half to even
    acc      = xq @ q.T                                   int32, exact
    y_int    = acc.float() * a_scale * scale
    y_fp     = where(outlier, xf, 0) @ (q.float() * scale[:, None]).T
    out      = (y_int + y_fp (+ bias.float())).to(x.dtype)

with ``q`` int8 ``[N, K]`` and ``scale`` f32 ``[N]`` from
``weight_quantize(w, "llm.int8")``. On CUDA tensors it launches
``csrc/llm_int8_linear.cu`` (its header gives the bound and the design: a
pre-pass for the column absmax, the compacted outlier columns and xq, then
the product on the int8 tensor cores with the outlier term in its
epilogue, read from x and the int8 weight); the call never reads back to
the host, so a CUDA graph captures it. On CPU tensors it runs
``llm_int8_linear_dense``, the plain version, whose int8 product is an
int32 matrix product: exact while K * 127^2 < 2^31 (K up to about 133k).
On CUDA tensors the plain version (which only the checks call there)
takes the product in float64, exact for any K it will meet.

``parts=True`` returns ``(out, parts)``, ``parts`` holding the
intermediates the checks compare: ``col_amax`` f32 [K], ``xq`` int8 [M,
K], ``a_scale`` f32 [M], ``acc`` int32 [M, N] (M the leading rows
flattened), and from the kernel also ``idx`` int32 [K] and ``count``
int32 [1] (the first ``count`` of ``idx`` are the outlier columns in
ascending order).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import (_build, counted, dtype_code, ptr, route, stream,
               want_contiguous)

__all__ = ["llm_int8_linear", "llm_int8_linear_dense"]

_BK = 64      # k bytes a ring stage of the product (kBK)


def _int8_product(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """xq [M, K] int8 times q [N, K] int8 transposed, exactly, as int32."""
    if xq.device.type == "cpu":
        return torch.matmul(xq.int(), q.int().T)
    # sums of integers below 2^53 are exact in float64
    return torch.matmul(xq.double(), q.double().T).to(torch.int32)


def llm_int8_linear_dense(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          threshold: float = 6.0, parts: bool = False):
    """Plain version (module docstring)."""
    K, N = x.shape[-1], q.shape[0]
    xf = x.float().reshape(-1, K)
    col_amax = (xf.abs().amax(dim=0) if xf.shape[0]
                else torch.zeros(K, device=x.device))
    outlier = col_amax > threshold
    zero = torch.zeros((), device=x.device)
    x_in = torch.where(outlier, zero, xf)
    rowmax = torch.clamp(x_in.abs().amax(dim=-1, keepdim=True), min=1e-10)
    # tensor divisors: CUDA divides by a host scalar as a product with its
    # reciprocal, which rounds twice
    a_scale = rowmax / torch.full_like(rowmax, 127.0)
    xq = torch.clamp(torch.round(x_in / a_scale), -127, 127).to(torch.int8)
    acc = _int8_product(xq, q)
    y_int = acc.float() * a_scale * scale
    y_fp = torch.where(outlier, xf, zero) @ (q.float() * scale[:, None]).T
    out = y_int + y_fp
    if bias is not None:
        out = out + bias.float()
    out = out.to(x.dtype).reshape(*x.shape[:-1], N)
    if not parts:
        return out
    return out, dict(col_amax=col_amax, xq=xq, a_scale=a_scale[:, 0],
                     acc=acc)


@functools.cache
def _lib():
    fn = _build.library("llm_int8_linear").llm_int8_linear_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x, q, scale, bias):
    if q.dtype != torch.int8 or q.dim() != 2:
        raise TypeError(f"llm_int8_linear: weight must be a 2-D int8 "
                        f"tensor [out, in], got {q.dtype} {tuple(q.shape)}")
    dtype_code(x, "llm_int8_linear x")
    N, K = q.shape
    if K == 0 or x.dim() < 1 or x.shape[-1] != K:
        raise ValueError(f"llm_int8_linear: x {tuple(x.shape)} does not "
                         f"end in the weight's in_features {K} (> 0)")
    if scale is None or scale.dtype != torch.float32 or \
            tuple(scale.shape) != (N,):
        got = None if scale is None else (scale.dtype, tuple(scale.shape))
        raise TypeError(f"llm_int8_linear: weight_scale must be float32 "
                        f"[{N}], got {got}")
    if bias is not None and (tuple(bias.shape) != (N,) or bias.dtype
                             not in (x.dtype, torch.float32)):
        raise TypeError(f"llm_int8_linear: bias must be [{N}] in {x.dtype} "
                        f"or float32, got {bias.dtype} {tuple(bias.shape)}")


def llm_int8_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    threshold: float = 6.0, parts: bool = False):
    """x [..., K] (bf16 or f32) through LLM.int8's linear: [..., N] in x's
    dtype (module docstring). ``q`` int8 [N, K], ``scale`` f32 [N],
    ``bias`` [N] in x's dtype or f32, or None."""
    _check(x, q, scale, bias)
    tensors = (x, q, scale) + ((bias,) if bias is not None else ())
    if route(*tensors) == "cpu":
        return llm_int8_linear_dense(x, q, scale, bias, threshold, parts)
    for t, name in zip(tensors, ("x", "weight", "weight_scale", "bias")):
        want_contiguous(t, f"llm_int8_linear {name}")
    N, K = q.shape
    M = x.numel() // K
    dev = x.device
    out = torch.empty(*x.shape[:-1], N, dtype=x.dtype, device=dev)
    Kp = -(-K // _BK) * _BK     # xq's row pitch: K rounded up, pad zero
    amax = torch.empty(K, dtype=torch.float32, device=dev)
    idx = torch.empty(K, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    a_scale = torch.empty(M, dtype=torch.float32, device=dev)
    xq = torch.empty(M, Kp, dtype=torch.int8, device=dev)
    acc = (torch.empty(M, N, dtype=torch.int32, device=dev) if parts
           else None)
    if M and N:
        vec = int(K % 16 == 0 and q.data_ptr() % 16 == 0)
        rc = _lib()(ptr(x), ptr(q), ptr(scale),
                    ptr(bias) if bias is not None else None, ptr(out),
                    ptr(acc) if acc is not None else None, ptr(amax),
                    ptr(idx), ptr(count), ptr(a_scale), ptr(xq), M, N, K,
                    Kp, dtype_code(x, "x"),
                    -1 if bias is None else dtype_code(bias, "bias"),
                    float(threshold), vec, stream(x))
        _build.check(rc, "llm_int8_linear")
        llm_int8_linear.launches += 1
    if not parts:
        return out
    return out, dict(col_amax=amax, xq=xq[:, :K], a_scale=a_scale, acc=acc,
                     idx=idx, count=count)


llm_int8_linear = counted(llm_int8_linear)

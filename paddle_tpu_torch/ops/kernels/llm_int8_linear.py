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
``csrc/llm_int8_linear.cu`` (its header gives the bound and the design);
the call never reads back to the host, so a CUDA graph captures it.
``llm_int8_route`` says which body a launch takes, from the shapes and the
weight's alignment alone: ``wgmma`` (M > 16, K a multiple of 16 and the
weight 16-byte aligned, what TMA addresses: a pre-pass for the column
absmax, the compacted outlier columns, xq and the first ``CAPACITY``
outlier columns of x and of the dequantized weight gathered into dense
f32 buffers, then the product on wgmma s8: persistent CTAs, one an SM, a
producer warpgroup filling a TMA ring across tiles, the outlier term in
the epilogue), ``gemv`` (M <= 16 under the same condition: a one-cluster
pre-pass, then one launch behind it with programmatic dependent launch
that streams the weights through mma.sync s8, K cut into up to 8 slices
of one thread-block cluster) or ``mma`` (any other shape: the pre-pass
without the gathers, then mma.sync s8 tiles). ``route_tiles`` counts a
product's units of work. On CPU tensors it runs
``llm_int8_linear_dense``, the plain version, whose int8 product is an
int32 matrix product: exact while K * 127^2 < 2^31 (K up to about 133k). On CUDA tensors the plain version
(which only the checks call there) takes the product in float64, exact
for any K it will meet.

``parts=True`` returns ``(out, parts)``, ``parts`` holding the
intermediates the checks compare: ``col_amax`` f32 [K], ``xq`` int8 [M,
K], ``a_scale`` f32 [M], ``acc`` int32 [M, N] (M the leading rows
flattened), and from the kernel also ``idx`` int32 [K] and ``count``
int32 [1] (the first ``count`` of ``idx`` are the outlier columns in
ascending order) and ``body``, the body the launch took.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import (_build, counted, dtype_code, ptr, route, stream,
               want_contiguous)
from .weight_only_linear import gemv_split

__all__ = ["CAPACITY", "LlmInt8Route", "llm_int8_linear",
           "llm_int8_linear_dense", "llm_int8_route", "route_tiles"]

_BK = 64      # xq's row pitch: K rounded up to this (kBK)
CAPACITY = 64  # outlier columns gathered once a call into x_out [M, .] and
               # w_out [N, .] (kOutCap); columns past it are gathered at a
               # stride of K where the epilogue uses them
_BODIES = {"mma": 0, "wgmma": 1, "gemv": 2}
_WG_ROWS, _WG_COLS = 256, 128  # wgmma: xq rows x weight rows a CTA
_MMA_TILE = 128          # mma: rows and columns a CTA
_GV_COLS = 128           # gemv: weight rows a CTA
_GV_BLOCK = 64           # gemv: k bytes a block
_GV_RING = 6 * 4 * 128 * 16  # gemv: the cp.async ring (kGvRingBytes)
_GV_X_BYTES = 48 * 1024  # gemv: staged xq a window at most (kGvXBytes)


class LlmInt8Route(NamedTuple):
    body: str      # "gemv", "wgmma" or "mma"
    splits: int    # K slices (gemv; 1 otherwise)
    ks: int        # k bytes a slice covers (gemv; K otherwise)


def _gemv_smem(rows: int, ks: int) -> int:
    """The gemv body's dynamic shared memory (csrc ``gemv_smem``): the
    ring, then the staged xq window (a pitch 64 bytes past a multiple of
    128) or the partial sums, whichever is larger."""
    window = min(ks // _GV_BLOCK, (_GV_X_BYTES // rows - 128) // _GV_BLOCK)
    pitch = -(-window * _GV_BLOCK // 128) * 128 + 64
    return _GV_RING + max(rows * pitch, 2 * rows * (_GV_COLS + 4) * 4)


@functools.lru_cache(maxsize=None)
def llm_int8_route(M: int, N: int, K: int,
                   aligned: bool = True) -> LlmInt8Route:
    """The body a launch at these shapes takes, and the gemv body's K
    slices; ``aligned``: the weight starts on 16 bytes (torch's
    allocations do). Shapes and alignment alone decide it: TMA and the
    16-byte copies need rows of a multiple of 16 bytes."""
    if not (aligned and K % 16 == 0):
        return LlmInt8Route("mma", 1, K)
    if M > 16:
        return LlmInt8Route("wgmma", 1, K)
    # K9's split search (gemv_split) over this body's shared memory
    rows = 8 if M <= 8 else 16
    return LlmInt8Route("gemv", *gemv_split(
        K, N, _GV_BLOCK, lambda ks: _gemv_smem(rows, ks)))


def route_tiles(plan: LlmInt8Route, M: int, N: int) -> int:
    """The product's units of work at M rows and N columns: wgmma's 256 x
    128 tiles (which persistent CTAs, one an SM, walk), gemv's CTAs (a
    128-column block and K slice each), mma's 128 x 128 tiles (a CTA
    each)."""
    cdiv = lambda a, b: -(-a // b)        # noqa: E731
    if plan.body == "wgmma":
        return cdiv(M, _WG_ROWS) * cdiv(N, _WG_COLS)
    if plan.body == "gemv":
        return cdiv(N, _GV_COLS) * plan.splits
    return cdiv(M, _MMA_TILE) * cdiv(N, _MMA_TILE)


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
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
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
    plan = llm_int8_route(M, N, K, q.data_ptr() % 16 == 0)
    out = torch.empty(*x.shape[:-1], N, dtype=x.dtype, device=dev)
    Kp = -(-K // _BK) * _BK     # xq's row pitch: K rounded up, pad zero
    # the column absmax, then the outlier mask (a bit a column)
    amax = torch.empty(K + -(-K // 32), dtype=torch.float32, device=dev)
    idx = torch.empty(K, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    a_scale = torch.empty(M, dtype=torch.float32, device=dev)
    xq = torch.empty(M, Kp, dtype=torch.int8, device=dev)
    # the first CAPACITY outlier columns of x (gemv, wgmma) and of the
    # dequantized weight (wgmma), gathered once a call, column-major (rows
    # of M or N rounded up to 4 floats: 16-byte copies)
    pad4 = lambda v: -(-v // 4) * 4       # noqa: E731
    x_out = (torch.empty(CAPACITY, pad4(M), dtype=torch.float32,
                         device=dev) if plan.body != "mma" else None)
    w_out = (torch.empty(CAPACITY, pad4(N), dtype=torch.float32,
                         device=dev) if plan.body == "wgmma" else None)
    acc = (torch.empty(M, N, dtype=torch.int32, device=dev) if parts
           else None)
    if M and N:
        opt = lambda t: ptr(t) if t is not None else None     # noqa: E731
        rc = _lib()(ptr(x), ptr(q), ptr(scale), opt(bias), ptr(out),
                    opt(acc), ptr(amax), ptr(idx), ptr(count), ptr(a_scale),
                    ptr(xq), opt(x_out), opt(w_out), M, N, K, Kp,
                    dtype_code(x, "x"),
                    -1 if bias is None else dtype_code(bias, "bias"),
                    float(threshold), _BODIES[plan.body], plan.splits,
                    plan.ks, stream(x))
        _build.check(rc, "llm_int8_linear")
        llm_int8_linear.launches += 1
    if not parts:
        return out
    return out, dict(col_amax=amax[:K], xq=xq[:, :K], a_scale=a_scale,
                     acc=acc, idx=idx, count=count, body=plan.body)


llm_int8_linear = counted(llm_int8_linear)

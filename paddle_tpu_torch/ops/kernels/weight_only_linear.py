"""K9: the int8 / int4 weight-only linear (a port-only kernel: the
counterpart of the fusion XLA makes of ``paddle_tpu/nn/quant.py``
``weight_only_linear`` :78, where the int8 convert folds into the
matmul's operand read; there is no ``pallas_call`` to port).

``weight_only_linear(x, q, scale, bias, int4)`` computes

    y[..., n] = ((sum_k x[..., k] * q[n, k]) * scale[n] + bias[n]).to(x.dtype)

over the integer weights (int8 ``[N, K]``, or int4 packed two a byte into
``[N, K/2]``, the even k in the low nibble), an f32 sum, then the scale,
then the bias in f32, then one rounding, as the JAX function does. On
CUDA tensors it launches the kernels of ``csrc/weight_only_linear.cu``
(its header gives the bound and the design), which read the quantized
bytes and never write a dequantized copy; on CPU tensors it runs
``weight_only_linear_dense``, the plain version. ``weight_only_route``
says which body a launch takes: ``gemv`` (bf16 ``x``, M <= 16: a
streaming pass over the weights in one launch, the weights converted in
registers into mma.sync A fragments against x as B; up to 8 K slices run
as one thread-block cluster and add their sums in slice order through
distributed shared memory; launched with programmatic dependent launch, so
its first weight reads overlap the previous kernel's tail), ``wgmma``
(bf16 ``x``, M > 16: TMA brings x and the weight bytes into a ring in
shared memory, and the product runs transposed on wgmma with the weights,
converted straight into registers, as its A operand while the previous
step's wgmma runs), ``tile`` (bf16 ``x``, M > 16 where TMA cannot address
the operands: K not a multiple of 16 bytes of weights a row, or a pointer
not 16-byte aligned; mma.sync over weight tiles converted in shared
memory) or ``fma`` (f32 ``x`` at any M, 16 rows a block: f32 FMAs, no
TF32, so the card's fp32 runs match the CPU's; where it splits K a second
kernel adds the slices' sums in slice order). The wrapper allocates with
``torch.empty`` only, launches on the current stream, chooses its route
from the shapes and the pointers' alignment and never synchronises, so a
CUDA graph captures it whole. ``weight_only_linear_wgmma.launches``
counts the launches that took the ``wgmma`` body (beside the wrapper's
own count of all).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from . import (_build, counted, dtype_code, ptr, route, stream,
               want_contiguous)

__all__ = ["WeightOnlyRoute", "gemv_split", "route_cluster", "route_grid",
           "route_kernels", "route_smem", "unpack_int4",
           "weight_only_linear", "weight_only_linear_dense",
           "weight_only_linear_wgmma", "weight_only_route"]

_SMS = 132               # H100 SXM
_SMEM_CAP = 96 * 1024    # bytes of staged x an fma block may hold
_FMA_ROWS = (1, 4, 8, 16)    # rows a block (csrc launch_fma)
_SM_SMEM = 228 * 1024    # shared memory an SM holds (1 KB of it a block's)
_GV_COLS = 128           # gemv: weight rows (output columns) a block
_GV_SPLITS = 8           # gemv: K slices, one cluster, at most
_GV_PER_SM = 4           # gemv: blocks an SM holds at most (registers)
_GV_PACK = 0.9           # gemv: share of the SMs' block slots the clusters
                         # fill (a cluster's blocks share one GPC)
_GV_FIXED = 8            # gemv: a block's cost beyond its k blocks, in k
                         # blocks (the first loads, x, the cluster sum)
_GV_RING = 6 * 4 * 128 * 16  # gemv: the cp.async ring, 6 k blocks of 4
                         # 16-byte pieces a thread (kGvRingBytes)
_GV_X_BYTES = 48 * 1024  # gemv: staged x a window at most (kGvXBytes)
_BODIES = {"fma": 0, "tile": 1, "gemv": 2, "wgmma": 3}
_TILE = 128              # tile: rows and columns a block; wgmma: columns
_WG_ROWS = 256           # wgmma: rows a block
_BK = 64                 # tile and wgmma: k a step


class WeightOnlyRoute(NamedTuple):
    body: str      # "gemv", "wgmma", "tile" or "fma"
    rows: int      # rows a block (gemv 8 or 16; fma 1, 4, 8 or 16; tile
                   # 128; wgmma 256)
    splits: int    # K slices (gemv, fma)
    ks: int        # k a slice covers


def unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """[N, K/2] packed int8 -> [N, K] int8 in -8..7: the low nibble
    sign-extended by ``(q << 4) >> 4`` (torch's int8 left shift wraps, as
    XLA's does), the high one by the arithmetic ``q >> 4``."""
    lo = (q << 4) >> 4
    hi = q >> 4
    return torch.stack([lo, hi], dim=-1).reshape(q.shape[0],
                                                 q.shape[1] * 2)


def weight_only_linear_dense(x: torch.Tensor, q: torch.Tensor,
                             scale: torch.Tensor,
                             bias: Optional[torch.Tensor] = None,
                             int4: bool = False) -> torch.Tensor:
    """Plain version: ``((x.float() @ q.float().T) * scale + bias)
    .to(x.dtype)``, int4 unpacked first."""
    qi = unpack_int4(q) if int4 else q
    out = (x.float() @ qi.float().T) * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def gemv_split(K: int, N: int, kb: int, smem) -> tuple:
    """(splits, ks): how a gemv body (K9's, and K10's) cuts K. A block
    owns 128 weight rows and one K slice of whole k blocks of ``kb``
    weights; at most 8 slices run as one cluster. A launch takes its waves
    (blocks over the slots their shared memory, ``smem(ks)`` bytes a
    block, leaves an SM) times a block's k blocks plus a fixed cost; the
    split count with the least cost wins, the most splits on a tie."""
    steps = -(-K // kb)
    cols = -(-N // _GV_COLS)
    best = None
    for want in range(1, min(_GV_SPLITS, steps) + 1):
        per = -(-steps // want)
        splits = -(-steps // per)
        per_sm = min(_GV_PER_SM, _SM_SMEM // (smem(per * kb) + 1024))
        waves = math.ceil(cols * splits / (_GV_PACK * _SMS * per_sm))
        cost = waves * (per + _GV_FIXED)
        if best is None or cost <= best[0]:
            best = (cost, (splits, per * kb))
    return best[1]


@functools.lru_cache(maxsize=None)
def weight_only_route(M: int, N: int, K: int, int4: bool,
                      dtype: torch.dtype,
                      aligned: bool = True) -> WeightOnlyRoute:
    """The body, rows a block, K slices and slice length a launch at
    these shapes takes; ``aligned``: x and the weight start on 16 bytes
    (torch's allocations do). Shapes and alignment alone decide it."""
    w = 32 if int4 else 16                 # weights in a lane's 16 bytes
    if dtype == torch.bfloat16:
        if M > 16:
            # TMA needs rows of a multiple of 16 bytes and aligned bases
            if aligned and K % w == 0:
                return WeightOnlyRoute("wgmma", _WG_ROWS, 1, K)
            return WeightOnlyRoute("tile", _TILE, 1, K)
        # 64 int8 / 128 int4 weights a k block (PERF.md §6 has the sweep)
        mr = 8 if M <= 8 else 16
        splits, ks = gemv_split(K, N, 4 * w, lambda ks: route_smem(
            WeightOnlyRoute("gemv", mr, 1, ks), int4))
        return WeightOnlyRoute("gemv", mr, splits, ks)
    else:
        # 4 warps of 4 or 8 columns, steps of 32 w; x staged as f32 with 4
        # floats of padding a lane chunk
        mr = next(r for r in _FMA_ROWS if r >= min(M, 16))
        step = 32 * w
        blocks = -(-N // (4 * (4 if mr == 16 else 8))) * -(-M // mr)
        max_steps = max(1, _SMEM_CAP // (mr * 32 * (w + 4) * 4))
        target = 3 * _SMS
        body = "fma"
    steps = -(-K // step)
    splits = min(steps, max(-(-steps // max_steps), -(-target // blocks)))
    per = -(-steps // splits)
    return WeightOnlyRoute(body, mr, -(-steps // per), per * step)


@functools.cache
def _lib():
    fn = _build.library("weight_only_linear").weight_only_linear_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def route_smem(plan: WeightOnlyRoute, int4: bool) -> int:
    """Dynamic shared memory (bytes) a launch on ``plan`` takes, from the
    kernels' constants (``weight_only_linear_smem`` in the C library is
    the kernels' own count; chip_smoke.py holds the two equal)."""
    w = 32 if int4 else 16
    qb = _BK // 2 if int4 else _BK        # weight bytes a row a k step
    if plan.body == "fma":
        return plan.rows * (plan.ks // w) * (w + 4) * 4
    if plan.body == "gemv":   # the ring; the x window, later the sums
        kb = 4 * w
        window = min(plan.ks // kb, _GV_X_BYTES // (plan.rows * kb * 2))
        return _GV_RING + max(plan.rows * (window * kb + 8) * 2,
                              plan.rows * (_GV_COLS + 4) * 4)
    if plan.body == "tile":               # 3 stages, rows padded by 8
        return 3 * _TILE * (_BK + 8) * 2 + 3 * _TILE * qb \
            + _TILE * (_BK + 8) * 2
    # wgmma: 4 ring slots of (x, weight bytes), 4 mbarriers, 1024 bytes
    # to align the swizzled panels
    return 4 * (_WG_ROWS * _BK * 2 + _TILE * qb) + 4 * 8 + 1024


def route_grid(plan: WeightOnlyRoute, M: int, N: int) -> tuple:
    """The launch grid (x, y, z) of ``plan`` at M rows and N columns, as
    the C launch functions form it: gemv (column blocks of 128, splits:
    one cluster of ``route_cluster`` a column block), fma (column blocks
    of 16 or 32, splits, row blocks), tile (column blocks, row blocks of
    128), wgmma (one block a 256 x 128 tile)."""
    cdiv = lambda a, b: -(-a // b)        # noqa: E731
    if plan.body == "gemv":
        return (cdiv(N, _GV_COLS), plan.splits, 1)
    if plan.body == "fma":
        return (cdiv(N, 4 * (4 if plan.rows >= 16 else 8)), plan.splits,
                cdiv(M, plan.rows))
    if plan.body == "tile":
        return (cdiv(N, _TILE), cdiv(M, _TILE), 1)
    return (cdiv(M, _WG_ROWS) * cdiv(N, _TILE), 1, 1)


def route_cluster(plan: WeightOnlyRoute) -> tuple:
    """The thread-block cluster (x, y, z) a launch on ``plan`` forms: the
    gemv body's K slices of a column block are one cluster; the other
    bodies launch no cluster."""
    return (1, plan.splits, 1) if plan.body == "gemv" else (1, 1, 1)


def route_kernels(plan: WeightOnlyRoute) -> int:
    """Kernels a call on ``plan`` launches: two where the fma body splits
    K (its slices' sums are added by a second kernel), else one."""
    return 2 if plan.body == "fma" and plan.splits > 1 else 1


def _check(x, q, scale, bias, int4):
    K = x.shape[-1]
    if q.dtype != torch.int8 or q.dim() != 2:
        raise TypeError(f"weight_only_linear: weight must be a 2-D int8 "
                        f"tensor, got {q.dtype} {tuple(q.shape)}")
    dtype_code(x, "weight_only_linear x")
    if int4 and K % 2:
        raise ValueError(f"weight_only_linear: int4 needs an even input "
                         f"dimension, got K = {K}")
    kq = 2 * q.shape[1] if int4 else q.shape[1]
    if kq != K:
        raise ValueError(f"weight_only_linear: x has K = {K}, the "
                         f"{'int4' if int4 else 'int8'} weight "
                         f"{tuple(q.shape)} covers {kq}")
    N = q.shape[0]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (N,):
        raise TypeError(f"weight_only_linear: scale must be float32 [{N}], "
                        f"got {scale.dtype} {tuple(scale.shape)}")
    if bias is not None and (tuple(bias.shape) != (N,) or bias.dtype
                             not in (x.dtype, torch.float32)):
        raise TypeError(f"weight_only_linear: bias must be [{N}] in "
                        f"{x.dtype} or float32, got {bias.dtype} "
                        f"{tuple(bias.shape)}")


def weight_only_linear(x: torch.Tensor, q: torch.Tensor,
                       scale: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       int4: bool = False) -> torch.Tensor:
    """x [..., K] (bf16 or f32) times the quantized weight, scaled, plus
    bias: [..., N] in x's dtype. ``q`` int8 [N, K] or, with ``int4``,
    packed [N, K/2]; ``scale`` f32 [N]; ``bias`` [N] in x's dtype or f32,
    or None."""
    _check(x, q, scale, bias, int4)
    tensors = (x, q, scale) + ((bias,) if bias is not None else ())
    if route(*tensors) == "cpu":
        return weight_only_linear_dense(x, q, scale, bias, int4)
    for t, name in zip(tensors, ("x", "weight", "scale", "bias")):
        want_contiguous(t, f"weight_only_linear {name}")
    K, N = x.shape[-1], q.shape[0]
    M = x.numel() // K if K else 0
    out = torch.empty(*x.shape[:-1], N, dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, q))
    plan = weight_only_route(M, N, K, int4, x.dtype, aligned)
    work = (torch.empty(plan.splits, M, N, dtype=torch.float32,
                        device=x.device) if route_kernels(plan) > 1
            else None)
    vec = int(K % (32 if int4 else 16) == 0 and aligned)
    bias_code = -1 if bias is None else dtype_code(bias, "bias")
    rc = _lib()(ptr(x), ptr(q), ptr(scale),
                ptr(bias) if bias is not None else None, ptr(out),
                ptr(work) if work is not None else None, M, N, K, int(int4),
                dtype_code(x, "x"), bias_code, _BODIES[plan.body],
                plan.rows, plan.splits, plan.ks, vec, stream(x))
    _build.check(rc, "weight_only_linear")
    weight_only_linear.launches += 1
    if plan.body == "wgmma":
        weight_only_linear_wgmma.launches += 1
    return out


def weight_only_linear_wgmma() -> None:
    """The launch counter of K9's ``wgmma`` body and nothing more:
    ``weight_only_linear`` adds one to ``weight_only_linear_wgmma.launches``
    beside its own count where a launch takes that body, so a run shows
    that its bf16 M > 16 calls went through it (CUDA-graph replays count
    it through ``add_launches``, as every counter)."""


weight_only_linear = counted(weight_only_linear)
weight_only_linear_wgmma = counted(weight_only_linear_wgmma)

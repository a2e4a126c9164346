"""K1 + K2: flash attention forward and backward (counterpart of
``paddle_tpu/ops/pallas/flash_attention.py``).

``flash_attention_fwd(q, k, v, causal, scale, q_segment_ids,
kv_segment_ids)`` is the differentiable entry a model calls, as the JAX
``flash_attention_fwd`` (custom VJP) is. On CUDA tensors its forward
launches K1 and its backward launches K2 (``flash_attention_bwd``: a
pre-pass, one dq kernel and one dk/dv kernel); on CPU tensors it is the
plain version ``flash_attention_dense``, and autograd differentiates
that.

The CUDA source is ``csrc/flash_attention.cu`` (with the Hopper helpers
of ``csrc/hopper.cuh``); its header gives the shape limits, the bound
(operations, at training shapes) and the design: bf16 at D = 64 and 128
runs wgmma/TMA bodies that need an ``sm_90a`` card. Layout
``[B, S, H, D]``; k and v may carry fewer heads (GQA, ``H % KV == 0``),
which the kernels take natively: no repeated K/V.
``lse`` is f32 ``[B, H, Sq]``. Segment ids are int32 ``[B, Sq]`` and
``[B, Skv]``; they get no gradient.

The backward's ``delta = rowsum(dO * O)`` (f32), which the JAX
``_fa_bwd`` leaves to XLA, is K2's pre-pass kernel: it writes delta and
``lse * log2(e)`` into an f32 workspace ``[2, B, H, Sp]`` (Sp = Sq
rounded up to 64) that the wrapper allocates.

K1's Hopper body is built at several tiles (block_q, block_kv)
(``fwd_tiles``). The default is (128, 128); with
``FLAGS_use_autotune`` on, ``_select_blocks`` has K7 (``autotune.py``)
measure them at the call's shape and launches the fastest, as the JAX
``_prep`` does. Every tile computes the same bits (the softmax runs in
the same 64-key sub-steps), so the choice changes only the speed. K2
keeps its own tiles, whatever K1 ran.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import (DTYPE_CODES, _build, counted, dtype_code, ptr, route, stream,
               want_contiguous)
from . import autotune as _autotune
from ...core import flags as _flags

__all__ = ["flash_attention_fwd", "flash_attention_fwd_lse",
           "flash_attention_bwd", "flash_attention_dense",
           "flash_attention_bwd_dense", "fwd_tiles", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128)
_NEG = -1e30


def _keep_mask(Sq, Skv, causal, qseg, kseg, device, keep=None):
    """[B or 1, 1, 1, Sq, Skv] keep-mask (True = attend) or None; an
    explicit ``keep`` [B or 1, Sq, Skv] joins the causal and segment
    masks."""
    if keep is not None:
        keep = keep[:, None, None]
    if causal:
        # bottom-right convention: row r sees keys <= r + Skv - Sq
        tri = torch.ones(Sq, Skv, dtype=torch.bool, device=device).tril(
            Skv - Sq)[None, None, None]
        keep = tri if keep is None else keep & tri
    if qseg is not None:
        same = (qseg[:, :, None] == kseg[:, None, :])[:, None, None]
        keep = same if keep is None else keep & same
    return keep


def flash_attention_dense(q, k, v, causal=False, scale=None,
                          q_segment_ids=None, kv_segment_ids=None, keep=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] f32).
    ``keep`` is an optional boolean [B or 1, Sq, Skv] mask (True =
    attend) on top of the causal and segment masks; the kernels take no
    such mask.

    The GQA broadcast of the JAX ``_gqa_sdpa`` (ops/attention.py:31): q
    reshapes to [B, KV, rep, Sq, D] and the kv planes broadcast over rep,
    so no K/V copies. f32 scores and softmax; masked scores -1e30 with
    probability exactly 0 and l clamped at 1e-30, as the kernels do, so
    a row that sees no key gives 0. Autograd differentiates it."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    qf = q.transpose(1, 2).float().reshape(B, KV, rep, Sq, D)
    kf = k.transpose(1, 2).float()[:, :, None]           # [B, KV, 1, Skv, D]
    vf = v.transpose(1, 2).float()[:, :, None]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale   # [B, KV, rep, Sq, Skv]
    keep = _keep_mask(Sq, Skv, causal, q_segment_ids, kv_segment_ids,
                      q.device, keep)
    if keep is not None:
        s = s.masked_fill(~keep, _NEG)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    if keep is not None:
        p = p * keep
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, vf) / l
    lse = (m + torch.log(l)).reshape(B, H, Sq)
    out = out.reshape(B, H, Sq, D).transpose(1, 2).to(q.dtype)
    return out, lse


def flash_attention_bwd_dense(q, k, v, dout, causal=False, scale=None,
                              q_segment_ids=None, kv_segment_ids=None):
    """Plain backward: (dq, dk, dv) by autograd through
    ``flash_attention_dense``."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out, _ = flash_attention_dense(qq, kk, vv, causal, scale,
                                       q_segment_ids, kv_segment_ids)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


@functools.cache
def _lib():
    lib = _build.library("flash_attention")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd_launch.argtypes = (
        [vp] * 7 + [i] * 7 + [f, i, i, i, vp])
    lib.flash_attention_fwd_launch.restype = i
    lib.flash_attention_fwd_tiles.argtypes = [i, i, ctypes.POINTER(i), i]
    lib.flash_attention_fwd_tiles.restype = i
    lib.flash_attention_bwd_launch.argtypes = (
        [vp] * 12 + [i] * 7 + [f, i, i, vp])
    lib.flash_attention_bwd_launch.restype = i
    return lib


def _check(q, k, v, qseg, kseg, what):
    """Shape and type checks shared by both routes; returns the segment
    ids as contiguous int32 (or None)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: q, k, v must be [B, S, H, D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{what}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be [B, Skv, KV, D] with "
                         f"q's B={B}, D={D}")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{what}: {H} query heads are not a multiple of "
                         f"{KV} kv heads")
    dtype_code(q, what)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v dtypes differ ({q.dtype}, "
                        f"{k.dtype}, {v.dtype})")
    if (qseg is None) != (kseg is None):
        raise ValueError(f"{what}: q/kv segment ids must be given together")
    if qseg is None:
        return None, None
    if tuple(qseg.shape) != (B, Sq) or tuple(kseg.shape) != (B, k.shape[1]):
        raise ValueError(f"{what}: segment ids {tuple(qseg.shape)}, "
                         f"{tuple(kseg.shape)} must be [B, Sq], [B, Skv]")
    return (qseg.to(torch.int32).contiguous(),
            kseg.to(torch.int32).contiguous())


def _check_cuda(tensors, D, what):
    """The kernels read these with 16-byte vectors."""
    for name, t in tensors.items():
        want_contiguous(t, f"{what} {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not supported by the kernel "
                         f"(one of {HEAD_DIMS})")


def _present(*tensors):
    return [t for t in tensors if t is not None]


def _opt(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(0) if t is None else ptr(t)


@functools.cache
def fwd_tiles(D: int, dtype: torch.dtype) -> Tuple[Tuple[int, int], ...]:
    """K1's built tiles (block_q, block_kv) for head dim ``D`` and
    ``dtype``, the default first, as the CUDA library lists them
    (``flash_attention_fwd_tiles``): the Hopper body's instances for bf16
    at D = 64 and 128, none for the bodies with one tile. Builds the
    library; a CUDA-only call."""
    if dtype not in DTYPE_CODES:
        return ()
    buf = (ctypes.c_int * 64)()
    n = _lib().flash_attention_fwd_tiles(int(D), DTYPE_CODES[dtype], buf, 32)
    return tuple((buf[2 * i], buf[2 * i + 1]) for i in range(min(n, 32)))


def _k1(q, k, v, causal, scale, qseg, kseg, blocks=None):
    """Launch K1: (out, lse). ``blocks`` = (block_q, block_kv), one of
    ``fwd_tiles``; None is the body's default tile."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    _check_cuda({"q": q, "k": k, "v": v}, D, "flash_attention_fwd")
    if blocks is not None and tuple(blocks) not in fwd_tiles(D, q.dtype):
        raise ValueError(f"flash_attention_fwd: tile {tuple(blocks)} is not "
                         f"built for D={D} {q.dtype}; built: "
                         f"{list(fwd_tiles(D, q.dtype))}")
    bq, bkv = (0, 0) if blocks is None else blocks
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    rc = _lib().flash_attention_fwd_launch(
        ptr(q), ptr(k), ptr(v), _opt(qseg), _opt(kseg), ptr(out), ptr(lse),
        B, Sq, Skv, H, KV, D, int(bool(causal)), float(scale),
        dtype_code(q, "q"), int(bq), int(bkv), stream(q))
    _build.check(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _capturing() -> bool:
    return torch.cuda.is_current_stream_capturing()


@functools.cache
def _card(device: torch.device) -> str:
    return torch.cuda.get_device_name(device)


@functools.cache
def _k1_build() -> str:
    """The build hash of the library this process loads (``_lib``)."""
    return _build.build_hash("flash_attention")


def _autotune_key(q, k, causal) -> str:
    """The JAX ``_prep`` key (``flash:{B}x{Sq}x{H}x{D}:{Skv}:{dtype}:
    {causal}``, the dtype spelled as JAX spells it), then the port's own
    fields: the kv heads, the card's name and K1's build hash, so a tile
    measured on another card or against another K1 build is never
    reused."""
    B, Sq, H, D = q.shape
    dtype = str(q.dtype).replace("torch.", "")
    return (f"flash:{B}x{Sq}x{H}x{D}:{k.shape[1]}:{dtype}:{bool(causal)}"
            f":kv{k.shape[2]}:{_card(q.device)}:{_k1_build()}")


def _select_blocks(q, k, causal, qseg):
    """K1's tile for this call (counterpart of the tile choice in the JAX
    ``_prep``, flash_attention.py:456-477): None (the default tile) with
    ``FLAGS_use_autotune`` off, on CPU tensors, with segment ids (JAX
    skips the search under interpret and with segment ids too) or with
    at most one built tile; otherwise K7's choice, measured at this shape
    on the first call and cached (``autotune.autotune``). A cache miss
    while a CUDA graph is being captured raises: a search cannot run
    inside a capture."""
    if not (_flags._get("use_autotune", False) and _on_card(q)
            and qseg is None and q.shape[1] > 0 and k.shape[1] > 0):
        return None
    cands = fwd_tiles(q.shape[3], q.dtype)
    if len(cands) <= 1:
        return None
    key = _autotune_key(q, k, causal)
    cache = _autotune.get_cache()
    if cache.get(key) is None and _capturing():
        raise RuntimeError(
            f"flash_attention_fwd: FLAGS_use_autotune has no tile cached for "
            f"{key} and a CUDA graph is being captured, where the search "
            "cannot run; run this shape eagerly once first")
    return _autotune.autotune(key, cands, _autotune.measure_flash_blocks(
        tuple(q.shape), k.shape[1], k.shape[2], q.dtype, bool(causal)),
        cache)


def flash_attention_bwd(q, k, v, out, lse, dout, causal=False, scale=None,
                        q_segment_ids=None, kv_segment_ids=None):
    """K2: (dq, dk, dv) of ``out = flash_attention(q, k, v)`` for the
    output gradient ``dout``, from K1's ``out`` and ``lse``. CPU tensors
    take ``flash_attention_bwd_dense``; CUDA tensors launch the
    pre-pass, the dq and the dk/dv kernels."""
    qseg, kseg = _check(q, k, v, q_segment_ids, kv_segment_ids,
                        "flash_attention_bwd")
    B, Sq, H, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if route(q, k, v, out, lse, dout, *_present(qseg, kseg)) == "cpu":
        return flash_attention_bwd_dense(q, k, v, dout, causal, scale, qseg,
                                         kseg)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} and "
                         f"dout {tuple(dout.shape)} must have q's shape")
    if dout.dtype != q.dtype or out.dtype != q.dtype:
        raise TypeError("flash_attention_bwd: out and dout must have q's "
                        "dtype")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be float32 "
                         f"[{B}, {H}, {Sq}], got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    want_contiguous(lse, "flash_attention_bwd lse")
    dout = dout.contiguous()    # autograd may hand any strides
    _check_cuda({"q": q, "k": k, "v": v, "out": out, "dout": dout}, D,
                "flash_attention_bwd")
    dq, dk, dv, _ = _k2(q, k, v, out, lse, dout, causal, scale, qseg, kseg)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


PREPASS, DQ, DKV = 1, 2, 4   # the parts of one K2 launch
PAD = 64                     # workspace rows are padded to this


def _k2(q, k, v, out, lse, dout, causal, scale, qseg, kseg,
        parts=PREPASS | DQ | DKV, work=None):
    """Launch the ``parts`` of K2 on checked CUDA tensors: (dq, dk, dv,
    work). ``work`` is the pre-pass's f32 workspace [2, B, H, Sp]
    (allocated when None); a launch without PREPASS reads the workspace
    an earlier one wrote."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if work is None:
        Sp = -(-Sq // PAD) * PAD
        work = torch.empty(2, B, H, Sp, dtype=torch.float32,
                           device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = _lib().flash_attention_bwd_launch(
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(dout), ptr(lse), ptr(work),
        _opt(qseg), _opt(kseg), ptr(dq), ptr(dk), ptr(dv), B, Sq, Skv, H,
        KV, D, int(bool(causal)), float(scale), dtype_code(q, "q"),
        int(parts), stream(q))
    _build.check(rc, "flash_attention_bwd")
    return dq, dk, dv, work


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, qseg, kseg):
        out, lse = _k1(q, k, v, causal, scale, qseg, kseg,
                       _select_blocks(q, k, causal, qseg))
        ctx.save_for_backward(q, k, v, out, lse, qseg, kseg)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, qseg, kseg = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal,
                                         ctx.scale, qseg, kseg)
        return dq, dk, dv, None, None, None, None


def flash_attention_fwd(q, k, v, causal=False, scale=None,
                        q_segment_ids=None, kv_segment_ids=None):
    """[B, Sq, H, D] attention output, differentiable in q, k and v."""
    qseg, kseg = _check(q, k, v, q_segment_ids, kv_segment_ids,
                        "flash_attention_fwd")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if route(q, k, v, *_present(qseg, kseg)) == "cpu":
        return flash_attention_dense(q, k, v, causal, scale, qseg, kseg)[0]
    return _FlashAttention.apply(q, k, v, bool(causal), scale, qseg, kseg)


def flash_attention_fwd_lse(q, k, v, causal=False, scale=None,
                            q_segment_ids=None, kv_segment_ids=None,
                            blocks=None):
    """(out, lse) with no graph: K1's two outputs (the JAX ``_fa_fwd``
    residuals), for checks and for callers that reuse the lse. On CUDA
    tensors ``blocks`` = (block_q, block_kv) runs K1 at that tile (one of
    ``fwd_tiles``); None takes the tile ``_select_blocks`` gives."""
    qseg, kseg = _check(q, k, v, q_segment_ids, kv_segment_ids,
                        "flash_attention_fwd")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    with torch.no_grad():
        if route(q, k, v, *_present(qseg, kseg)) == "cpu":
            return flash_attention_dense(q, k, v, causal, scale, qseg, kseg)
        if blocks is None:
            blocks = _select_blocks(q, k, causal, qseg)
        return _k1(q, k, v, causal, scale, qseg, kseg, blocks)


counted(flash_attention_fwd)
counted(flash_attention_bwd)

"""K5: paged decode attention (counterpart of the paged half of
``paddle_tpu/ops/pallas/decode_attention.py``).

``paged_decode_attention`` replaces the TPU kernel of the same name:
q [B, Sq, H, D] at absolute positions ``lengths[b] .. lengths[b]+Sq-1``
attends to the cache positions up to its own, read through the block
table from the shared page pool. It serves the fused ``[B, 1]`` decode
rounds and the legacy per-arrival prefill. The CUDA body is shared with
K4 (``csrc/paged_attention.cu``, whose header gives the bound and the
design): K5 is K4 with every slot live.

``paged_attention_dense`` and ``_dense_ragged`` are the plain versions
(gather the pages, f32 dense mask), as in the JAX package. The contiguous
head-major cache kernel (``decode_attention``, K6) is not ported yet.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, dtype_code, ptr, route, stream, want_contiguous

__all__ = ["paged_decode_attention", "paged_attention_dense"]

_NEG = -1e30


def _dense_ragged(q, k_cache, v_cache, lengths):
    """Dense cache attention with per-row offsets: q [B,S,H,D] against
    head-major caches [B,KV,M,D]; query slot s of row b sees cache
    positions <= lengths[b] + s. GQA broadcasts the KV plane over the
    group instead of copying it."""
    B, S, H, D = q.shape
    KV, M = k_cache.shape[1], k_cache.shape[2]
    rep = H // KV
    qf = q.transpose(1, 2).float().reshape(B, KV, rep, S, D)
    kf = k_cache.float()
    vf = v_cache.float()
    scores = torch.einsum("bkrsd,bkmd->bkrsm", qf, kf) / math.sqrt(D)
    off = lengths.to(torch.int64).reshape(B)
    q_pos = off[:, None] + torch.arange(S, device=q.device)[None, :]
    keep = torch.arange(M, device=q.device)[None, None, :] \
        <= q_pos[:, :, None]                                # [B, S, M]
    scores = torch.where(keep[:, None, None], scores,
                         torch.full_like(scores, _NEG))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrsm,bkmd->bkrsd", probs, vf)
    return out.reshape(B, H, S, D).transpose(1, 2).to(q.dtype)


def _gather_pages(pool, block_tables):
    """[P, KV, page, D] pool through [B, npages] tables -> the contiguous
    head-major view [B, KV, npages*page, D]."""
    B, npages = block_tables.shape
    g = pool[block_tables.long()]                  # [B, npages, KV, page, D]
    g = g.transpose(1, 2)                          # [B, KV, npages, page, D]
    return g.reshape(B, pool.shape[1], npages * pool.shape[2], pool.shape[3])


def paged_attention_dense(q, k_pool, v_pool, block_tables, lengths):
    """Plain version of K5: gather the pages, then dense ragged attention."""
    return _dense_ragged(q, _gather_pages(k_pool, block_tables),
                         _gather_pages(v_pool, block_tables), lengths)


def check_paged_args(name, q, k_pool, v_pool, block_tables, *rows):
    """Shape/dtype/device checks shared by K4 and K5. Returns the route
    ("cpu" or "cuda") and the q dtype code."""
    kind = route(q, k_pool, v_pool, block_tables, *rows)
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(f"{name}: q [B,Sq,H,D] and pools [P,KV,page,D] "
                         f"expected, got {tuple(q.shape)} and "
                         f"{tuple(k_pool.shape)}")
    B, Sq, H, D = q.shape
    P, KV, page, Dk = k_pool.shape
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"{name}: k/v pool shapes differ")
    if Dk != D or H % KV:
        raise ValueError(f"{name}: q heads {H} / head dim {D} do not fit "
                         f"pools with {KV} KV heads of dim {Dk}")
    code = dtype_code(q, name)
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{name}: pools must share q's dtype {q.dtype}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"{name}: block tables must be [B={B}, npages]")
    for t in (block_tables, *rows):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: tables and row metadata must be int32")
    for t in rows:
        if t.shape != (B,):
            raise ValueError(f"{name}: row metadata must be [B={B}]")
    if kind == "cuda":
        # the port's own limits: whole 8-element groups (pages split into
        # 8-key steps), head dim held in registers up to 256
        if D % 8 or D > 256 or page % 8:
            raise ValueError(f"{name}: CUDA kernel needs D % 8 == 0, "
                             f"D <= 256 and page % 8 == 0 (D={D}, "
                             f"page={page})")
        for t, n in ((q, "q"), (k_pool, "k_pool"), (v_pool, "v_pool"),
                     *((r, "row metadata") for r in rows)):
            want_contiguous(t, f"{name} {n}")
        if block_tables.stride(1) != 1:
            raise ValueError(f"{name}: block table rows must be contiguous")
    return kind, code


@functools.cache
def _lib():
    return _build.library("paged_attention")


@functools.cache
def _decode_fn():
    fn = _lib().paged_decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths):
    """Block-table KV attention with every slot live, scaled by
    1/sqrt(D) as the plain version is.

    q            [B, Sq, H, D]     rows at lengths[b] .. lengths[b]+Sq-1
    k/v_pool     [P, KV, page, D]  shared physical page pool
    block_tables [B, npages] int32 logical -> physical page per row
    lengths      [B] int32         tokens already in cache per row
    """
    kind, code = check_paged_args("paged_decode_attention", q, k_pool,
                                  v_pool, block_tables, lengths)
    if kind == "cpu":
        return paged_attention_dense(q, k_pool, v_pool, block_tables,
                                     lengths)
    B, Sq, H, D = q.shape
    KV, page = k_pool.shape[1], k_pool.shape[2]
    scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    rc = _decode_fn()(ptr(q), ptr(k_pool), ptr(v_pool), ptr(block_tables),
                      ptr(lengths), ptr(out), B, Sq, H, KV, D, page,
                      block_tables.shape[1], block_tables.stride(0), scale,
                      code, stream(q))
    _build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0

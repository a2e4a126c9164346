"""K5 and K6: decode attention over a paged or a contiguous KV cache
(counterpart of ``paddle_tpu/ops/pallas/decode_attention.py``).

``paged_decode_attention`` (K5) replaces the TPU kernel of the same name:
q [B, Sq, H, D] at absolute positions ``lengths[b] .. lengths[b]+Sq-1``
attends to the cache positions up to its own, read through the block
table from the shared page pool. It serves the fused ``[B, 1]`` decode
rounds, the legacy per-arrival prefill and paged ``Predictor.generate``.

``decode_attention`` (K6) replaces the TPU ``decode_attention``: the same
rows against the contiguous head-major cache ``[B, KV, M, D]`` of
static-cache generation (``LlamaForCausalLM.generate``, static
``Predictor.generate``, ``FusedMultiTransformer``), at a scalar or
per-row ``offset``. Both launch the bodies of ``csrc/paged_attention.cu``
(whose header gives the bound and the design): K5 is K4 with every slot
live, and K6 is K5 with direct addressing. K4, K5 and K6 follow one
rule. bf16 at head dims 64 and 128 takes the Hopper body
``wgmma_split`` (TMA loads, wgmma, split-K over long key ranges with a
merge kernel); K6 reads its cache through TMA as a pool of B pages of M
keys, so K6 and K5 over the same keys give the same bits. fp32 with at
least 16 rows a KV head (Sq * H / KV) takes ``f32_tile`` (64 rows a CTA,
K and V staged in shared memory, f32 FMA); other bf16 head dims take
``mma``, and the rest (decode rows in fp32, bf16 at D 16/32 below 16
rows) ``fma``. ``paged_route`` and ``decode_route`` say which body a
call takes, with its split count and workspace bytes.

``paged_attention_dense``, ``decode_attention_dense`` and
``_dense_ragged`` are the plain versions (gather the pages or take the
cache as it is, f32 dense mask), as in the JAX package.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import (_build, counted, dtype_code, ptr, route, stream,
               want_contiguous)

__all__ = ["PagedRoute", "decode_attention", "decode_attention_dense",
           "decode_route", "paged_attention_dense", "paged_decode_attention",
           "paged_route"]

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


def row_offsets(offset, q):
    """``offset`` (an int, or an int tensor of one or B elements) as the
    int32 [B] tensor of each row's first position, on q's device. An int
    fills on the device (no host-to-device copy); a tensor is cast and
    broadcast where it lies, so a tensor on another device raises in the
    wrapper's device check."""
    B = q.shape[0]
    if not isinstance(offset, torch.Tensor):
        return torch.full((B,), int(offset), dtype=torch.int32,
                          device=q.device)
    off = offset.to(torch.int32).reshape(-1)
    if off.numel() not in (1, B):
        raise ValueError(f"offset must be an int, or hold 1 or B={B} "
                         f"values, got shape {tuple(offset.shape)}")
    return off.expand(B).contiguous()


def decode_attention_dense(q, k_cache, v_cache, offset):
    """Plain version of K6 (the JAX ``_cache_attention_dense``,
    models/llama.py:223): the offset broadcast to [B], then
    ``_dense_ragged`` over the whole cache."""
    return _dense_ragged(q, k_cache, v_cache, row_offsets(offset, q))


def check_cache_args(name, q, k_cache, v_cache, offsets):
    """Shape/dtype/device checks of K6: q [B, Sq, H, D], caches
    [B, KV, M, D] of q's dtype, offsets int32 [B]. Returns the route and
    the q dtype code."""
    kind = route(q, k_cache, v_cache, offsets)
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError(f"{name}: q [B,Sq,H,D] and caches [B,KV,M,D] "
                         f"expected, got {tuple(q.shape)} and "
                         f"{tuple(k_cache.shape)}")
    B, Sq, H, D = q.shape
    Bk, KV, M, Dk = k_cache.shape
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: k/v cache shapes differ")
    if Bk != B or Dk != D or H % KV:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit caches "
                         f"{tuple(k_cache.shape)} (batch, head dim, or "
                         "heads not a multiple of the KV heads)")
    code = dtype_code(q, name)
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"{name}: caches must share q's dtype {q.dtype}")
    if offsets.dtype != torch.int32 or offsets.shape != (B,):
        raise TypeError(f"{name}: offsets must be int32 [B={B}]")
    if kind == "cuda":
        # the port's own limits: whole 8-element groups, head dim held in
        # registers up to 256 (M is free: loads are bounded by it)
        if D % 8 or D > 256:
            raise ValueError(f"{name}: CUDA kernel needs D % 8 == 0 and "
                             f"D <= 256 (D={D})")
        for t, n in ((q, "q"), (k_cache, "k_cache"), (v_cache, "v_cache"),
                     (offsets, "offsets")):
            want_contiguous(t, f"{name} {n}")
    return kind, code


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


_BODIES = ("fma", "mma", "wgmma_split", "f32_tile")


class PagedRoute(NamedTuple):
    """The body a K4/K5/K6 call takes (``csrc/paged_attention.cu``), its
    number of key splits, the keys a split covers and the bytes of its
    f32 split workspace."""
    body: str
    splits: int
    split_len: int
    workspace_bytes: int


@functools.lru_cache(maxsize=512)
def _plan(entry, *shape):
    """The C plan ``entry`` (paged_attention_plan or decode_attention_plan)
    of one call shape: route, splits, keys a split, workspace bytes."""
    fn = getattr(_lib(), entry)
    fn.argtypes = [ctypes.c_int] * len(shape) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 4)()
    fn(*shape, ctypes.cast(out, ctypes.c_void_p))
    return PagedRoute(_BODIES[out[0]], int(out[1]), int(out[2]), int(out[3]))


def decode_route(q, k_cache):
    """The route a K6 launch on these CUDA tensors takes (the C library's
    own plan: builds the library on first use)."""
    B, Sq, H, D = q.shape
    KV, M = k_cache.shape[1], k_cache.shape[2]
    return _plan("decode_attention_plan", B, Sq, H, KV, D, M,
                 dtype_code(q, "decode_route"))


def paged_route(q, k_pool, block_tables):
    """The route a K4 or K5 launch on these CUDA tensors takes (the C
    library's own plan: builds the library on first use)."""
    B, Sq, H, D = q.shape
    P, KV, page, _ = k_pool.shape
    return _plan("paged_attention_plan", B, Sq, H, KV, D, page,
                 block_tables.shape[1], P, dtype_code(q, "paged_route"))


def workspace(route, like):
    """The f32 split workspace of a launch (empty when it does not split),
    allocated on ``like``'s device; a CUDA graph capture records it."""
    return torch.empty(route.workspace_bytes // 4, dtype=torch.float32,
                       device=like.device)


@functools.cache
def _decode_fn():
    fn = _lib().paged_decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _cache_fn():
    fn = _lib().decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k_cache, v_cache, offset):
    """Attention of q against the contiguous head-major caches, scaled by
    1/sqrt(D) as the plain version is: query slot s of row b sees cache
    positions <= offset[b] + s, and query head h reads KV head
    h // (H / KV).

    q        [B, Sq, H, D]
    k/v      [B, KV, M, D]  M is the cache length (any value)
    offset   int, or an int tensor of 1 or B values on q's device
    """
    off = row_offsets(offset, q)
    kind, code = check_cache_args("decode_attention", q, k_cache, v_cache,
                                  off)
    if kind == "cpu":
        return _dense_ragged(q, k_cache, v_cache, off)
    B, Sq, H, D = q.shape
    KV, M = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    ws = workspace(decode_route(q, k_cache), q)
    rc = _cache_fn()(ptr(q), ptr(k_cache), ptr(v_cache), ptr(off), ptr(out),
                     ptr(ws), B, Sq, H, KV, D, M, 1.0 / math.sqrt(D), code,
                     stream(q))
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention = counted(decode_attention)


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
    P, KV, page = k_pool.shape[:3]
    scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    ws = workspace(paged_route(q, k_pool, block_tables), q)
    rc = _decode_fn()(ptr(q), ptr(k_pool), ptr(v_pool), ptr(block_tables),
                      ptr(lengths), ptr(out), ptr(ws), B, Sq, H, KV, D, page,
                      block_tables.shape[1], block_tables.stride(0), P,
                      scale, code, stream(q))
    _build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention = counted(paged_decode_attention)

"""K4: unified ragged paged attention (counterpart of
``paddle_tpu/ops/pallas/ragged_paged_attention.py``).

``ragged_paged_attention`` replaces the TPU kernel of the same name: one
launch serves a batch whose rows are ragged along two axes — slot i of
row b sits at absolute position ``starts[b] + i`` and attends to cache
positions up to its own; only slots ``i < seq_lens[b]`` are real (a
prefill chunk feeds up to Sb slots, a decode row 1, a dead row 0) and
dead slots output exactly 0. It is the attention of the serving
engine's unified ``[B, Sc]`` chunked-prefill step. The CUDA source,
with its bound and design, is ``csrc/paged_attention.cu``; in bf16 at head
dims 64 and 128 a call takes its Hopper body (``wgmma_split``), which
splits the long key ranges of decode rows and merges the f32 partials in a
second kernel of the same call; in fp32 a call of >= 16 rows a KV head
takes ``f32_tile`` (``decode_attention.paged_route`` names the body,
split count and workspace bytes).

``ragged_paged_attention_dense`` is the plain version: gather the
pages, doubly-ragged f32 dense mask, zero the dead slots.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, counted, ptr, stream
from .decode_attention import (_NEG, _gather_pages, _lib, check_paged_args,
                               paged_route, workspace)

__all__ = ["ragged_paged_attention", "ragged_paged_attention_dense"]


def ragged_paged_attention_dense(q, k_pool, v_pool, block_tables, starts,
                                 seq_lens):
    """Plain version of K4 (same math as the JAX dense fallback)."""
    B, Sq, H, D = q.shape
    k_cache = _gather_pages(k_pool, block_tables)
    v_cache = _gather_pages(v_pool, block_tables)
    KV, M = k_cache.shape[1], k_cache.shape[2]
    rep = H // KV
    qf = q.transpose(1, 2).float().reshape(B, KV, rep, Sq, D)
    scores = torch.einsum("bkrsd,bkmd->bkrsm", qf, k_cache.float()) \
        / math.sqrt(D)
    off = starts.to(torch.int64).reshape(B)
    nv = seq_lens.to(torch.int64).reshape(B)
    ar = torch.arange(Sq, device=q.device)
    q_pos = off[:, None] + ar[None, :]                          # [B, Sq]
    alive = ar[None, :] < nv[:, None]                           # [B, Sq]
    keep = (torch.arange(M, device=q.device)[None, None, :]
            <= q_pos[:, :, None]) & alive[:, :, None]
    scores = torch.where(keep[:, None, None], scores,
                         torch.full_like(scores, _NEG))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrsm,bkmd->bkrsd", probs, v_cache.float())
    out = torch.where(alive[:, None, None, :, None], out,
                      torch.zeros_like(out))
    return out.reshape(B, H, Sq, D).transpose(1, 2).to(q.dtype)


@functools.cache
def _ragged_fn():
    fn = _lib().ragged_paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ragged_paged_attention(q, k_pool, v_pool, block_tables, starts,
                           seq_lens):
    """Mixed prefill-chunk/decode attention over the paged KV pool,
    scaled by 1/sqrt(D) as the plain version is.

    q            [B, Sb, H, D]     slot i of row b at starts[b]+i
    k/v_pool     [P, KV, page, D]  shared physical page pool
    block_tables [B, npages] int32 logical -> physical page per row
                                   (rows must be contiguous; a column
                                   slice of a wider table is fine)
    starts       [B] int32         first q position per row
    seq_lens     [B] int32         valid q slots per row (0 = dead row)
    """
    kind, code = check_paged_args("ragged_paged_attention", q, k_pool,
                                  v_pool, block_tables, starts, seq_lens)
    if kind == "cpu":
        return ragged_paged_attention_dense(q, k_pool, v_pool,
                                            block_tables, starts, seq_lens)
    B, Sq, H, D = q.shape
    P, KV, page = k_pool.shape[:3]
    scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    ws = workspace(paged_route(q, k_pool, block_tables), q)
    rc = _ragged_fn()(ptr(q), ptr(k_pool), ptr(v_pool), ptr(block_tables),
                      ptr(starts), ptr(seq_lens), ptr(out), ptr(ws), B, Sq,
                      H, KV, D, page, block_tables.shape[1],
                      block_tables.stride(0), P, scale, code, stream(q))
    _build.check(rc, "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention = counted(ragged_paged_attention)

"""Attention ops (counterpart of ``paddle_tpu/ops/attention.py``).

``flash_attention`` and ``flash_attn_varlen`` route to the K1/K2
wrapper (``ops/kernels/flash_attention.py``): the kernels on CUDA
tensors, the plain version (the GQA broadcast of the JAX ``_gqa_sdpa``)
on CPU tensors. Every varlen pack, causal or not, whatever its q and k
boundaries, runs K1/K2 with the pack's per-sequence frontiers
(``varlen_ranges``). The
JAX package's ``_use_pallas`` gate and its
warn-and-fall-back ``try`` are TPU dispatch policy and are not ported:
a CUDA tensor launches the kernels or raises. Attention dropout
(``dropout`` p > 0) takes a ``generator=`` (a CPU ``torch.Generator``,
from which the call draws one 64-bit seed) or a ``seed=``, where the JAX
functions take a ``dropout_key``; it runs inside K1/K2 on CUDA tensors
(a Philox mask, ``ops/kernels/dropout_mask.py``) and in the plain
version, with the same mask, on CPU tensors. A CUDA call with dropout
never takes the dense path. Under ``amp.auto_cast`` both cast
their f32 inputs to the AMP dtype when their op name is in the white
set (``flash_attention`` is; ``flash_attn_varlen`` only through
``custom_white_list``), as the JAX dispatch hook does.
"""
from __future__ import annotations

import torch

from ..amp import cast_inputs
from .kernels.dropout_mask import draw_seed
from .kernels.flash_attention import flash_attention_fwd

__all__ = ["flash_attention", "flash_attn_varlen", "varlen_ranges"]


def _dropout_seed(dropout, generator, seed):
    """The call's Philox seed: ``seed``, or one drawn from ``generator``;
    None without dropout. Dropout with neither raises, as the JAX
    ``_sdpa_raw`` does without a ``dropout_key``."""
    if not dropout:
        return None
    if seed is not None:
        return int(seed)
    if generator is None:
        raise ValueError("attention dropout needs a generator= (a CPU "
                         "torch.Generator) or a seed=")
    return draw_seed(generator)


def flash_attention(q, k, v, causal=False, dropout=0.0, generator=None,
                    seed=None, head_offset=0):
    """Layout [batch, seqlen, num_heads, head_dim]. GQA accepted: k/v may
    carry fewer (dividing) heads; the kernels group the q heads of each
    kv head natively. ``dropout`` > 0 drops attention probabilities
    (module docstring); ``head_offset`` is the global index of head 0 in
    the mask (a tensor-parallel rank's first head)."""
    seed = _dropout_seed(dropout, generator, seed)
    q, k, v = cast_inputs("flash_attention", q, k, v)
    return flash_attention_fwd(q, k, v, causal, dropout=float(dropout),
                               seed=seed, head_offset=head_offset)


def _segments_from_cu(cu, total, device):
    """cu_seqlens [n+1] -> per-token segment ids [total] int64 (padding
    past cu[-1] gets id -1, which still self-matches so padded rows stay
    finite and are sliced away by the caller)."""
    cu = torch.as_tensor(cu, dtype=torch.int64, device=device)
    pos = torch.arange(total, dtype=torch.int64, device=device)
    seg = torch.searchsorted(cu[1:], pos, right=True)
    return torch.where(pos < cu[-1], seg, torch.full_like(seg, -1))


def _own_tokens(seg, cu, total):
    """The first and last token index whose segment id equals each id of
    ``seg`` (in the pack that ``cu`` cuts into ``total`` tokens): id -1
    is the padding past cu[-1]; an id past the pack's sequences has none
    (first > last)."""
    n = cu.numel() - 1
    sc = seg.clamp(0, max(n - 1, 0))
    lo = torch.where(seg < 0, cu[-1], cu[sc])
    hi = torch.where(seg < 0, torch.full_like(seg, total),
                     cu[(sc + 1).clamp(max=n)]) - 1
    none = seg >= n
    return lo.masked_fill(none, 0), hi.masked_fill(none, -1)


def varlen_ranges(cu_seqlens_q, cu_seqlens_k, Tq, Tk, causal, device):
    """K1/K2's frontier arrays for a varlen pack: (q_ranges [1, Tq, 2],
    kv_ranges [1, Tk, 2]) int32, each q row's (first, last) visible key and
    each key's (first, last) q row that sees it (first > last: none).

    The JAX ``flash_attn_varlen`` mask (ops/attention.py:142-166): a pair
    attends iff both tokens carry one segment id (``_segments_from_cu``;
    padding is id -1) and, causal, the key's in-sequence position is at
    most the row's frontier qp + len_k - len_q, where the positions and
    lengths are taken at the ids clipped into each pack's sequences (so
    padding measures from sequence 0, as there). A sequence's tokens are
    contiguous and the frontier grows with the row, so each row's keys,
    and each key's rows, form one range."""
    cq = torch.as_tensor(cu_seqlens_q, dtype=torch.int64, device=device)
    ck = torch.as_tensor(cu_seqlens_k, dtype=torch.int64, device=device)
    if cq.dim() != 1 or ck.dim() != 1 or cq.numel() < 2 or ck.numel() < 2:
        raise ValueError("varlen: cu_seqlens must be 1-D with at least two "
                         "entries ([0, s1, ...])")
    nq, nk = cq.numel() - 1, ck.numel() - 1
    qseg = _segments_from_cu(cq, Tq, device)
    kseg = _segments_from_cu(ck, Tk, device)
    qlo, qhi = _own_tokens(qseg, ck, Tk)       # each row's segment's keys
    klo, khi = _own_tokens(kseg, cq, Tq)       # each key's segment's rows
    if causal:
        def frontier_terms(seg):
            """q start, k start and len_k - len_q at the clipped ids."""
            qs = seg.clamp(0, nq - 1)
            ks = seg.clamp(0, nk - 1)
            return cq[qs], ck[ks], (ck[ks + 1] - ck[ks]) - (cq[qs + 1]
                                                            - cq[qs])
        q0, k0, dl = frontier_terms(qseg)
        rows = torch.arange(Tq, device=device)
        # key j of the row's id is seen iff j - k0 <= (r - q0) + dl
        qhi = torch.minimum(qhi, k0 + rows - q0 + dl)
        q0, k0, dl = frontier_terms(kseg)
        keys = torch.arange(Tk, device=device)
        klo = torch.maximum(klo, q0 + keys - k0 - dl)
    q_ranges = torch.stack([qlo, qhi], -1).to(torch.int32)[None]
    kv_ranges = torch.stack([klo, khi], -1).to(torch.int32)[None]
    return q_ranges.contiguous(), kv_ranges.contiguous()


def flash_attn_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k, causal=False,
                      scale=None, dropout=0.0, generator=None, seed=None):
    """Packed varlen attention: q/k/v [total_tokens, H, D], sequence
    boundaries ``cu_seqlens`` ([0, s1, s1+s2, ...]); tokens never attend
    across boundaries, and causal packs take each sequence's own
    bottom-right frontier (its q and k boundaries may differ, as in
    chunked prefill). K1/K2 run every pack with the frontier arrays of
    ``varlen_ranges``, which skip the other sequences' key tiles; the CPU
    route is their plain version. A row that sees no key gives 0, as in
    K1. With ``dropout`` the mask's batch row is 0 and its rows and keys
    are the packed token indices."""
    seed = _dropout_seed(dropout, generator, seed)
    q, k, v = cast_inputs("flash_attn_varlen", q, k, v)
    qr, kr = varlen_ranges(cu_seqlens_q, cu_seqlens_k, q.shape[0],
                           k.shape[0], causal, q.device)
    return flash_attention_fwd(q[None], k[None], v[None], False, scale,
                               dropout=float(dropout), seed=seed,
                               q_ranges=qr, kv_ranges=kr)[0]

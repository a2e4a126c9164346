"""Attention ops (counterpart of ``paddle_tpu/ops/attention.py``).

``flash_attention`` and ``flash_attn_varlen`` route to the K1/K2
wrapper (``ops/kernels/flash_attention.py``): the kernels on CUDA
tensors, the plain version (the GQA broadcast of the JAX ``_gqa_sdpa``)
on CPU tensors. Causal varlen packs whose q and k boundaries differ
take the plain version on either device (``flash_attn_varlen``). The
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
from .kernels.flash_attention import (flash_attention_dense,
                                       flash_attention_fwd)

__all__ = ["flash_attention", "flash_attn_varlen"]


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
                    seed=None):
    """Layout [batch, seqlen, num_heads, head_dim]. GQA accepted: k/v may
    carry fewer (dividing) heads; the kernels group the q heads of each
    kv head natively. ``dropout`` > 0 drops attention probabilities
    (module docstring)."""
    seed = _dropout_seed(dropout, generator, seed)
    q, k, v = cast_inputs("flash_attention", q, k, v)
    return flash_attention_fwd(q, k, v, causal, dropout=float(dropout),
                               seed=seed)


def _segments_from_cu(cu, total, device):
    """cu_seqlens [n+1] -> per-token segment ids [total] int32 (padding
    past cu[-1] gets id -1, which still self-matches so padded rows stay
    finite and are sliced away by the caller)."""
    cu = torch.as_tensor(cu, dtype=torch.int32, device=device)
    pos = torch.arange(total, dtype=torch.int32, device=device)
    seg = torch.searchsorted(cu[1:], pos, right=True).to(torch.int32)
    return torch.where(pos < cu[-1], seg, torch.full_like(seg, -1))


def _same_bounds(cu_q, cu_k):
    if cu_q is cu_k:
        return True
    a, b = (torch.as_tensor(c).cpu().long() for c in (cu_q, cu_k))
    return torch.equal(a, b)


def flash_attn_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k, causal=False,
                      scale=None, dropout=0.0, generator=None, seed=None):
    """Packed varlen attention: q/k/v [total_tokens, H, D], sequence
    boundaries ``cu_seqlens`` ([0, s1, s1+s2, ...]); tokens never attend
    across boundaries. K1 serves it with segment ids whenever those say
    all: every non-causal pack, and causal packs whose q and k share
    boundaries, where K1's global row >= col frontier is each sequence's
    own. Causal packs with different boundaries need a frontier per
    sequence, which K1 does not take: the plain version serves them with
    the per-sequence mask. A row that sees no key gives 0, as in K1.
    With ``dropout`` the mask's batch row is 0 and its rows and keys are
    the packed token indices; a causal pack with different boundaries
    and dropout raises on CUDA tensors (the kernels have no per-sequence
    frontier, and a CUDA dropout call never runs dense)."""
    seed = _dropout_seed(dropout, generator, seed)
    dropout = float(dropout)
    q, k, v = cast_inputs("flash_attn_varlen", q, k, v)
    Tq, Tk = q.shape[0], k.shape[0]
    qseg = _segments_from_cu(cu_seqlens_q, Tq, q.device)
    kseg = _segments_from_cu(cu_seqlens_k, Tk, q.device)
    q4, k4, v4 = q[None], k[None], v[None]
    if not causal or (Tq == Tk and _same_bounds(cu_seqlens_q, cu_seqlens_k)):
        return flash_attention_fwd(q4, k4, v4, causal, scale, qseg[None],
                                   kseg[None], dropout=dropout,
                                   seed=seed)[0]
    if dropout and q.device.type == "cuda":
        raise NotImplementedError(
            "flash_attn_varlen: causal packs whose q and k boundaries differ "
            "run the dense plain version, which a CUDA call with dropout "
            "never takes: ROADMAP.md queue 1, item 2.11")
    # per-sequence bottom-right frontier: q row r of sequence s (at
    # in-sequence position qp) sees k columns of s up to
    # qp + (len_k(s) - len_q(s))
    cq = torch.as_tensor(cu_seqlens_q, dtype=torch.int64, device=q.device)
    ck = torch.as_tensor(cu_seqlens_k, dtype=torch.int64, device=q.device)
    qs_c = qseg.long().clamp(0, cq.shape[0] - 2)
    ks_c = kseg.long().clamp(0, ck.shape[0] - 2)
    q_pos = torch.arange(Tq, device=q.device) - cq[qs_c]
    k_pos = torch.arange(Tk, device=q.device) - ck[ks_c]
    len_q = cq[qs_c + 1] - cq[qs_c]
    len_k = ck[ks_c + 1] - ck[ks_c]
    frontier = q_pos[:, None] + (len_k[None, :] - len_q[:, None])
    keep = (qseg[:, None] == kseg[None, :]) & (frontier >= k_pos[None, :])
    return flash_attention_dense(q4, k4, v4, False, scale, keep=keep[None],
                                 dropout=dropout, seed=seed)[0][0]

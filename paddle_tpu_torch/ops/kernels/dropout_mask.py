"""Attention dropout's mask: Philox4x32-10 in plain PyTorch, bit-equal to
the kernels' ``csrc/philox.cuh`` (counterpart of the ``jax.random``
Bernoulli mask of the JAX ``_sdpa_raw``, ops/nn_ops.py:693-702, and of
the ``local_dropout_key`` stream, distributed/fleet/layers/mpu/
random.py:33).

Philox4x32-10 (Salmon et al., SC'11; curand's ``curand_Philox4x32_10``)
maps a 128-bit counter and a 64-bit key to four 32-bit words.

**The counter layout** (``csrc/philox.cuh`` states the same): the key is
the call's 64-bit seed, ``(seed_lo, seed_hi)``; the element (batch row
``b``, query head ``h``, query row ``r``, key column ``c``) takes counter
``(c >> 3, r, h, b)``, of the four output words the one numbered
``(c >> 1) & 3``, and of that word the 16-bit half ``c & 1`` (the low
half for even ``c``). The element is kept iff that half ``>=
threshold(p) = round(p * 2**16)``, which keeps it with probability
``1 - p`` to within 2^-17; a kept probability is scaled by
``1 / (1 - p)`` in f32. One hash decides eight keys of a row. A mask
depends only on (seed, b, h, r, c): any slice of the rows, keys or heads
gets the same bits as the whole, a kernel can hash the elements it holds
in any order, and K2 recomputes K1's mask instead of storing it.

The JAX package resolves p in f32 (``jax.random.bernoulli``) and draws
other bits: the two packages' masks were never the same, and the tests
compare each with its own mask.

The words are computed with int64 tensor ops (32x32 -> 64-bit products
from 16-bit halves, so nothing overflows), on whatever device the caller
names: a CPU and a CUDA mask from one seed are the same bits.

``philox_check`` runs ``csrc/philox_check.cu`` on the card: the repo's
Philox beside curand's ``curand_Philox4x32_10`` on the same counters and
keys, a check of the hash alone (the kernels never call curand).

Each attention-dropout call draws one seed (``draw_seed``) from an
explicit generator on the CPU, which the model owns, so a CPU model and a
CUDA model built with the same seed draw the same masks. The JAX package
draws attention masks from its "local" RNG stream so that every model-
parallel rank masks its own heads; here a rank hashes its heads' global
indices (``head_offset``) under the model's one seed, so its mask is its
slice of the degree-1 mask.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import _build, ptr, stream

__all__ = ["M0", "M1", "W0", "W1", "philox4x32_10", "dropout_keep",
           "threshold", "keep_scale", "split_seed", "draw_seed",
           "philox_check"]

M0, M1 = 0xD2511F53, 0xCD9E8D57     # the round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85     # the key bumps (Weyl sequence)
_MASK = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``a * m`` for int64 ``a`` in [0, 2^32)
    and a 32-bit constant ``m``: a = a_hi 2^16 + a_lo, each partial
    product below 2^48."""
    t = (a & 0xFFFF) * m
    u = (a >> 16) * m
    hi = (u + (t >> 16)) >> 16
    lo = (((u & 0xFFFF) << 16) + t) & _MASK
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """The four output words (int64 tensors in [0, 2^32)) of counters
    (c0, c1, c2, c3) — int64 tensors that broadcast together — under the
    key (k0, k1)."""
    k0, k1 = int(k0) & _MASK, int(k1) & _MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & _MASK, (k1 + W1) & _MASK
    return c0, c1, c2, c3


def threshold(p: float) -> int:
    """The keep test's bound on a 16-bit half: a half >= round(p 2^16)
    keeps (halves round up; p just below 1 gives 65536: none kept)."""
    p = float(p)
    if not 0.0 <= p < 1.0:
        raise ValueError(f"attention dropout p must lie in [0, 1), got {p}")
    return int(math.floor(p * 2.0 ** 16 + 0.5))


def keep_scale(p: float) -> float:
    """1 / (1 - p), the factor of a kept probability (f32 in the
    kernels)."""
    return 1.0 / (1.0 - float(p))


def split_seed(seed: int) -> Tuple[int, int]:
    """(lo, hi) 32-bit words of a 64-bit seed: the Philox key."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK, seed >> 32


def draw_seed(generator: torch.Generator) -> int:
    """One 64-bit seed from ``generator`` (a CPU generator: the same
    seeds on every device)."""
    if generator.device.type != "cpu":
        raise ValueError("attention dropout draws its seeds from a CPU "
                         f"generator; got one on {generator.device}")
    lo, hi = torch.randint(0, 2 ** 32, (2,), generator=generator,
                           dtype=torch.int64).tolist()
    return lo | (hi << 32)


def dropout_keep(seed: int, p: float, B: int, H: int, Sq: int, Skv: int,
                 device=None, head_offset: int = 0) -> torch.Tensor:
    """Boolean keep-mask [B, H, Sq, Skv] of one attention-dropout call
    (True = kept), by the counter layout above; computed one batch row at
    a time. Head i hashes as head ``head_offset + i`` (a tensor-parallel
    rank's global heads: its mask is its slice of the degree-1 mask)."""
    k0, k1 = split_seed(seed)
    thr = threshold(p)
    G = -(-Skv // 8)
    def ar(n, *shape):
        return torch.arange(n, dtype=torch.int64, device=device).view(shape)

    g, r = ar(G, 1, 1, G), ar(Sq, 1, Sq, 1)
    h = ar(H, H, 1, 1) + int(head_offset)
    rows = []
    for b in range(B):
        bb = torch.full((1, 1, 1), b, dtype=torch.int64, device=device)
        words = philox4x32_10(g, r, h, bb, k0, k1)
        w = torch.stack(torch.broadcast_tensors(*words), dim=-1)  # [H,Sq,G,4]
        halves = torch.stack((w & 0xFFFF, w >> 16), dim=-1)  # low half first
        rows.append((halves >= thr).reshape(H, Sq, 8 * G)[..., :Skv])
    if not rows:
        return torch.zeros(0, H, Sq, Skv, dtype=torch.bool, device=device)
    return torch.stack(rows)


@functools.cache
def _lib():
    lib = _build.library("philox_check")
    vp = ctypes.c_void_p
    lib.philox_check_launch.argtypes = [vp] * 4 + [ctypes.c_int, vp]
    lib.philox_check_launch.restype = ctypes.c_int
    return lib


def philox_check(counters: torch.Tensor, keys: torch.Tensor):
    """(repo's words, curand's words), each int64 [n, 4], of counters
    [n, 4] and keys [n, 2] (values in [0, 2^32)), computed on the card by
    ``csrc/philox.cuh`` and by ``curand_Philox4x32_10``."""
    n = counters.shape[0]
    if counters.shape != (n, 4) or keys.shape != (n, 2):
        raise ValueError("philox_check: counters [n, 4] and keys [n, 2]")
    dev = torch.device("cuda", torch.cuda.current_device())
    ctr = counters.to(torch.int64).to(torch.int32).to(dev).contiguous()
    key = keys.to(torch.int64).to(torch.int32).to(dev).contiguous()
    mine = torch.empty(n, 4, dtype=torch.int32, device=dev)
    theirs = torch.empty_like(mine)
    _build.check(_lib().philox_check_launch(ptr(ctr), ptr(key), ptr(mine),
                                            ptr(theirs), n, stream(ctr)),
                 "philox_check")
    return tuple(t.to(torch.int64) & 0xFFFFFFFF for t in (mine, theirs))

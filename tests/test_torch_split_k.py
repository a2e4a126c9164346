"""The split-K algorithm of the K4/K5 Hopper bodies, held on the CPU.

``csrc/paged_attention.cu`` splits a tile's key range [0, f] into pieces
of ``split_len`` keys, computes a partial softmax state per piece (m in
base 2, l, the unnormalised acc) and merges the pieces in split order.
Only the last live tile of a (batch row, KV head) splits, and only when it
holds at most ``thin`` live rows (decode rows, short chunks). The CUDA
kernels run only on the card; this file emulates the same plan and merge
in float32 torch and holds the result against the port's plain versions
and the JAX Pallas kernels in interpret mode, within 1e-4. Small split
lengths and tiles make many splits at CPU sizes: rows whose keys end
before a split, dead slots, rows of several q heads (GQA) sharing a tile.

K6 runs the same body over the contiguous cache [B, KV, M, D] with direct
addressing: the cache is a pool of B pages of M keys, the split axis has
ceil(M / split_len) entries, every frontier is clamped at M - 1, and the
keys of the last tile past M are zeros (TMA's out-of-bounds fill) hidden
by the mask. The emulation takes that cache too (``tbl=None``) and is held
against the JAX ``decode_attention`` in interpret mode and the port's
``decode_attention_dense``.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops.pallas import decode_attention as jda
from paddle_tpu.ops.pallas import ragged_paged_attention as jra
from paddle_tpu_torch.ops.kernels import decode_attention as tda
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as tra

TOL = 1e-4
LOG2E = 1.4426950408889634
NEG = -1e30

B, Sq, D, page, npages = 4, 16, 128, 8, 16
HEADS = {"gqa_g2": (8, 4), "mha": (4, 4)}
# (tile rows, thin rows, split length): the kernel's (128, 16, 512) scaled
# down two ways -- thin tiles a quarter of a tile, and every tile thin
ROUTES = {"thin_quarter": (16, 4, 16), "thin_whole": (8, 8, 24)}
CASES = {  # (starts, seq_lens, seed)
    "mixed_chunk_straddles_pages": ([5, 77, 0, 0], [16, 1, 16, 0], 3),
    "decode_only": ([10, 1, 55, 127], [1, 1, 1, 1], 4),
    "prefill_only": ([0, 8, 16, 3], [16, 16, 16, 16], 5),
    "partial_chunks_and_dead_rows": ([31, 0, 9, 64], [7, 0, 3, 12], 6),
    # frontiers on and beside split boundaries; rows of one tile whose
    # keys end before the last split (that split sees none of their keys)
    "split_edges": ([15, 16, 46, 94], [1, 2, 3, 2], 12),
}


def _inputs(H, KV, seed):
    r = np.random.RandomState(seed)
    q = r.randn(B, Sq, H, D).astype(np.float32)
    P = B * npages + 5
    kp = r.randn(P, KV, page, D).astype(np.float32)
    vp = r.randn(P, KV, page, D).astype(np.float32)
    tbl = r.permutation(P)[:B * npages].reshape(B, npages).astype(np.int32)
    return q, kp, vp, tbl


def split_k_emulation(q, kp, vp, tbl, starts, seq_lens, tile_rows, thin,
                      split_len, tile_keys=None):
    """The kernels' plan and merge in float32: rows r = slot * G + g of a
    KV head in tiles of ``tile_rows``; the last live tile splits when it
    has at most ``thin`` live rows; split s covers keys [s * split_len,
    (s + 1) * split_len), the last one up to the tile's frontier; each
    split's (m, l, acc), then the merge in split order, 8 splits at a time
    as the merge kernel loads them. Dead slots are 0.
    With ``tbl=None`` kp and vp are K6's contiguous caches [B, KV, M, D],
    read directly: ceil(M / split_len) splits and frontiers clamped at
    M - 1. With ``tile_keys`` (a divisor of ``split_len``) the last split
    reads whole tiles of that many keys, as the kernel does: keys past the
    cache are zeros (TMA's fill past M), hidden by the mask.
    Returns the output and the number of splits each tile took."""
    Bq, S, H, Dq = q.shape
    KV = kp.shape[1]
    G = H // KV
    R = S * G
    contig = tbl is None
    nkeys = kp.shape[2] if contig else tbl.shape[1] * kp.shape[2]
    nsplit = -(-nkeys // split_len)
    flim = nkeys - 1 if contig else math.inf       # the frontier's limit
    sl2 = LOG2E / math.sqrt(Dq)
    out = torch.zeros_like(q)
    taken = []
    for b in range(Bq):
        nv = min(max(int(seq_lens[b]), 0), S)
        if contig:  # direct addressing
            keys, vals = kp[b], vp[b]
        else:
            keys = torch.cat([kp[int(p)] for p in tbl[b]], 1)  # [KV, M, D]
            vals = torch.cat([vp[int(p)] for p in tbl[b]], 1)
        if tile_keys:  # zeros past the last key, to a whole tile
            pad = -(-(nkeys + split_len) // tile_keys) * tile_keys - nkeys
            keys = torch.nn.functional.pad(keys, (0, 0, 0, pad))
            vals = torch.nn.functional.pad(vals, (0, 0, 0, pad))
        for kv in range(KV):
            ntiles = -(-R // tile_rows)
            last = (nv * G - 1) // tile_rows if nv else -1
            for t in range(ntiles):
                r0 = t * tile_rows
                nl = min(max(nv * G - r0, 0), min(tile_rows, R - r0))
                if nl == 0:
                    continue
                rows = torch.arange(r0, r0 + nl)
                slot, g = rows // G, rows % G
                fr = torch.clamp(int(starts[b]) + slot,
                                 max=flim)                      # [nl]
                f = int(fr.max())
                nsp = (min(f // split_len + 1, nsplit)
                       if t == last and nl <= thin and nsplit > 1 else 1)
                taken.append(nsp)
                qr = q[b, slot, kv * G + g]                     # [nl, D]
                parts = []
                for s in range(nsp):
                    kb = s * split_len if nsp > 1 else 0
                    ke = f + 1 if s == nsp - 1 else (s + 1) * split_len
                    if tile_keys and s == nsp - 1:  # whole tiles
                        ke = kb + -(-(ke - kb) // tile_keys) * tile_keys
                    pos = torch.arange(kb, ke)
                    sc = (qr @ keys[kv, kb:ke].T) * sl2         # base 2
                    vis = pos[None, :] <= fr[:, None]
                    sc = torch.where(vis, sc, torch.full_like(sc,
                                                              -math.inf))
                    m = torch.clamp(sc.max(1).values, min=NEG)
                    p = torch.exp2(sc - m[:, None])
                    parts.append((m, p.sum(1), p @ vals[kv, kb:ke]))
                # the merge kernel: splits in order, 8 at a time, a
                # running max rescaling the sums between groups
                M = torch.full((nl,), NEG)
                L = torch.zeros(nl)
                A = torch.zeros(nl, Dq)
                for i in range(0, nsp, 8):
                    grp = parts[i:i + 8]
                    mx = torch.stack([M] + [m for m, _, _ in grp]).max(0).values
                    c = torch.exp2(M - mx)
                    L, A = L * c, A * c[:, None]
                    for m, l, acc in grp:
                        w = torch.exp2(m - mx)
                        L = L + l * w
                        A = A + acc * w[:, None]
                    M = mx
                out[b, slot, kv * G + g] = A / torch.clamp(L, min=1e-30)[:,
                                                                           None]
    return out, taken


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_k_matches_plain_and_pallas(case, heads, route):
    starts, lens, seed = CASES[case]
    H, KV = HEADS[heads]
    q, kp, vp, tbl = _inputs(H, KV, seed)
    st, nv = np.asarray(starts, np.int32), np.asarray(lens, np.int32)
    tile_rows, thin, split_len = ROUTES[route]
    if route == "thin_whole":
        # one tile of 8 rows a KV head: every live tile is thin
        q = q[:, :tile_rows // (H // KV)]
        nv = np.minimum(nv, q.shape[1]).astype(np.int32)
    emu, taken = split_k_emulation(_t(q), _t(kp), _t(vp), _t(tbl), st, nv,
                                   tile_rows, thin, split_len)
    plain = tra.ragged_paged_attention(_t(q), _t(kp), _t(vp), _t(tbl),
                                       _t(st), _t(nv))
    pallas = np.asarray(jra.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(st), jnp.asarray(nv), interpret=True))
    assert (emu - plain).abs().max().item() < TOL
    assert np.abs(emu.numpy() - pallas).max() < TOL
    # dead slots are exactly 0
    for b in range(B):
        assert (emu[b, nv[b]:] == 0).all()
    if case in ("decode_only", "split_edges"):
        assert max(taken) > 1          # the case really splits


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("sq", [1, 2])
def test_split_k_paged_decode_matches_plain_and_pallas(heads, sq):
    """K5 (every slot live): decode rows, each its own thin tile."""
    H, KV = HEADS[heads]
    q, kp, vp, tbl = _inputs(H, KV, 9)
    q = q[:, :sq]
    lengths = np.asarray([0, 47, 48, 127 - sq + 1], np.int32)
    emu, taken = split_k_emulation(_t(q), _t(kp), _t(vp), _t(tbl), lengths,
                                   np.full(B, sq, np.int32), 8, 8, 48)
    plain = tda.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tbl),
                                       _t(lengths))
    pallas = np.asarray(jda.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(lengths), interpret=True))
    assert (emu - plain).abs().max().item() < TOL
    assert np.abs(emu.numpy() - pallas).max() < TOL
    assert sorted(set(taken)) == [1, 2, 3]


def test_split_k_row_without_keys_in_a_split_is_exact():
    """A tile whose rows' frontiers differ: the last split holds keys of
    one row only; the others' partials there are (m = -1e30, l = 0, acc =
    0) and drop out of the merge with weight exactly 0."""
    H, KV = HEADS["gqa_g2"]
    q, kp, vp, tbl = _inputs(H, KV, 13)
    st = np.asarray([15, 0, 0, 0], np.int32)
    nv = np.asarray([2, 0, 0, 0], np.int32)     # frontiers 15 and 16
    emu, taken = split_k_emulation(_t(q), _t(kp), _t(vp), _t(tbl), st, nv,
                                   16, 4, 16)
    one, _ = split_k_emulation(_t(q), _t(kp), _t(vp), _t(tbl), st, nv,
                               16, 4, 1 << 20)
    assert taken[0] == 2
    # row slot 0 never sees key 16: its merged output equals the unsplit
    # computation over keys 0..15 up to float rounding of the merge
    assert (emu[0, 0] - one[0, 0]).abs().max().item() < 1e-5
    assert (emu[0, 2:] == 0).all() and (emu[1:] == 0).all()


# -- K6: the same body over the contiguous cache ------------------------------
# (offsets per row, Sq, M); M = 104 is no multiple of either split length
# (16, 24), M = 100 none of the emulated tile (8 keys) either; "past_end"
# has rows at and past M (their frontier is clamped at M - 1: they see the
# whole cache)
CONTIG = {
    "decode_rows": ([0, 47, 48, 103], 1, 104),
    "ragged_chunks_to_the_end": ([0, 30, 88, 5], 16, 104),
    "past_end": ([95, 100, 103, 0], 16, 104),
    "m100_decode": ([99, 23, 64, 0], 1, 100),
}


def _contig_inputs(H, KV, Sq, M, seed):
    r = np.random.RandomState(seed)
    return (r.randn(B, Sq, H, D).astype(np.float32),
            r.randn(B, KV, M, D).astype(np.float32),
            r.randn(B, KV, M, D).astype(np.float32))


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("case", sorted(CONTIG))
def test_split_k_contiguous_cache_matches_plain_and_pallas(case, heads,
                                                           route):
    """K6 on the Hopper body: direct addressing, ragged offsets, M no
    multiple of the tile or the split length, frontiers clamped at M - 1,
    GQA; against decode_attention_dense and the JAX Pallas kernel (where
    its block picker takes M: pick_block(100) is 0)."""
    offs, sq, M = CONTIG[case]
    H, KV = HEADS[heads]
    q, k, v = _contig_inputs(H, KV, sq, M, 17)
    tile_rows, thin, split_len = ROUTES[route]
    st = np.asarray(offs, np.int32)
    emu, taken = split_k_emulation(_t(q), _t(k), _t(v), None, st,
                                   np.full(B, sq, np.int32), tile_rows, thin,
                                   split_len, tile_keys=8)
    plain = tda.decode_attention_dense(_t(q), _t(k), _t(v), _t(st))
    assert (emu - plain).abs().max().item() < TOL
    if M % 8 == 0:
        pallas = np.asarray(jda.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(st),
            interpret=True))
        assert np.abs(emu.numpy() - pallas).max() < TOL
    if sq == 1:                  # decode rows split (K6's nsplit from M)
        assert max(taken) == -(-M // split_len) > 1


def test_contiguous_cache_as_pages_gives_the_same_plan():
    """K6 over a cache and K5 over the same keys cut into pages (each
    row's pages in order, the last page padded with zeros) run the same
    tiles and splits: the emulated outputs are equal bit for bit."""
    H, KV = HEADS["gqa_g2"]
    M, page = 100, 8
    q, k, v = _contig_inputs(H, KV, 1, M, 19)
    st = np.asarray([99, 0, 40, 63], np.int32)
    ones = np.ones(B, np.int32)
    npg = -(-M // page)

    def pages(c):
        c = np.pad(c, ((0, 0), (0, 0), (0, npg * page - M), (0, 0)))
        return c.reshape(B, KV, npg, page, D).transpose(0, 2, 1, 3, 4) \
                .reshape(B * npg, KV, page, D)

    tbl = np.arange(B * npg, dtype=np.int32).reshape(B, npg)
    a, ta = split_k_emulation(_t(q), _t(k), _t(v), None, st, ones, 8, 8, 48,
                              tile_keys=8)
    b, tb = split_k_emulation(_t(q), _t(pages(k)), _t(pages(v)), _t(tbl), st,
                              ones, 8, 8, 48, tile_keys=8)
    assert ta == tb and max(ta) == 3
    assert torch.equal(a, b)

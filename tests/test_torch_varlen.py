"""Varlen packs through K1/K2's per-sequence frontiers, held against the
JAX package on the CPU.

``ops/attention.varlen_ranges`` builds the frontier arrays K1/K2 take
for a pack: each q row's (first, last) visible key and each key's
(first, last) q row. On CPU tensors ``flash_attn_varlen`` runs K1/K2's
plain version on those ranges (the CUDA kernels are held against the
same plain version in tests/test_torch_cuda_kernels.py). Here:

- both arrays rebuild the JAX ``flash_attn_varlen`` mask
  (ops/attention.py:142-166: segment ids from cu_seqlens, padding -1,
  each sequence's bottom-right causal frontier) exactly, over packs with
  differing q and k boundaries, padding and fewer k sequences;
- the output against ``jattn.flash_attn_varlen.raw`` (2e-5, f32; rows
  that see no key are NaN there, from its -inf softmax, and 0 here);
- q, k, v gradients against ``jax.vjp`` of that dense path (2e-5), on
  packs where every row sees a key (a NaN row's gradient is NaN there).

The packs include chip_smoke.py's three timed ones (``VARLEN_PACKS``) at
an eighth of their lengths: sequences longest first and shortest first,
each q the last half, and documents (q = k) whose blocks straddle them.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.ops import attention as jattn
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.ops.kernels import flash_attention as K1

DENSE_TOL = 2e-5


def _pack(q_lens, k_lens):
    cu_q, cu_k = (np.cumsum([0] + n).tolist() for n in (q_lens, k_lens))
    return cu_q, cu_k, cu_q[-1], cu_k[-1]


_K = [(2048 - 256 * i) // 8 for i in range(8)]
_DOCS = [n // 8 for n in (700, 2100, 260, 1300, 500, 1800, 1012, 520)]

# name: (cu_seqlens_q, cu_seqlens_k, Tq, Tk); every row sees a key in
# the first four (causal): q is each sequence's tail
PACKS = {
    "chunked": ([0, 8, 20, 26], [0, 16, 40, 48], 26, 48),
    "same": ([0, 5, 17, 30], [0, 5, 17, 30], 30, 30),
    "one_seq_rect": ([0, 12], [0, 40], 12, 40),
    "padded_both": ([0, 7, 15], [0, 10, 22], 18, 25),
    "short_q": ([0, 14, 20, 33], [0, 6, 30, 38], 33, 38),
    "empty_seq": ([0, 4, 4, 10], [0, 9, 12, 20], 10, 20),
    "fewer_k_seqs": ([0, 6, 12, 18], [0, 10, 20], 18, 24),
    "padded_q_only": ([0, 9, 16], [0, 12, 30], 20, 30),
    "phase_varlen": _pack([n // 2 for n in _K], _K),
    "phase_varlen_asc": _pack([n // 2 for n in _K[::-1]], _K[::-1]),
    "phase_varlen_train": _pack(_DOCS, _DOCS),
}
# (pack, causal) where every row sees a key (padded rows measure their
# causal frontier from sequence 0, so some see none)
GRAD_CASES = [("chunked", True), ("chunked", False), ("same", True),
              ("same", False), ("one_seq_rect", True),
              ("one_seq_rect", False), ("padded_both", False)] + [
    (pack, causal) for pack in ("phase_varlen", "phase_varlen_asc",
                                "phase_varlen_train")
    for causal in (True, False)]


def _jax_mask(cu_q, cu_k, Tq, Tk, causal):
    """The JAX flash_attn_varlen mask, written out from its source."""
    cq, ck = np.asarray(cu_q), np.asarray(cu_k)
    qseg = np.asarray(jattn._segments_from_cu(cq, Tq))
    kseg = np.asarray(jattn._segments_from_cu(ck, Tk))
    mask = qseg[:, None] == kseg[None, :]
    if causal:
        qs, ks = np.clip(qseg, 0, len(cq) - 2), np.clip(kseg, 0, len(ck) - 2)
        fr = (np.arange(Tq) - cq[qs])[:, None] + (
            (ck[ks + 1] - ck[ks])[None, :] - (cq[qs + 1] - cq[qs])[:, None])
        mask &= fr >= (np.arange(Tk) - ck[ks])[None, :]
    return mask


def _case(pack, H=4, KV=2, D=16, seed=0):
    cu_q, cu_k, Tq, Tk = PACKS[pack]
    r = np.random.RandomState(seed)
    q, do = (r.randn(Tq, H, D).astype(np.float32) for _ in range(2))
    k, v = (r.randn(Tk, KV, D).astype(np.float32) for _ in range(2))
    return q, k, v, do, cu_q, cu_k


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("pack", sorted(PACKS))
def test_frontier_arrays_are_the_jax_mask(pack, causal):
    cu_q, cu_k, Tq, Tk = PACKS[pack]
    qr, kr = tattn.varlen_ranges(cu_q, cu_k, Tq, Tk, causal, "cpu")
    assert qr.shape == (1, Tq, 2) and kr.shape == (1, Tk, 2)
    assert qr.dtype == kr.dtype == torch.int32
    want = _jax_mask(cu_q, cu_k, Tq, Tk, causal)
    assert np.array_equal(K1.ranges_keep(qr, Tk)[0].numpy(), want)
    assert np.array_equal(K1.ranges_keep(kr, Tq)[0].numpy().T, want)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("pack", sorted(PACKS))
def test_varlen_output_matches_jax(pack, causal):
    """GQA packs (4 q heads, 2 kv heads) against the JAX dense path; rows
    that see no key give 0 (NaN there)."""
    q, k, v, _, cu_q, cu_k = _case(pack)
    mine = tattn.flash_attn_varlen(*(torch.tensor(t) for t in (q, k, v)),
                                   cu_q, cu_k, causal=causal).numpy()
    rep = q.shape[1] // k.shape[1]
    ref = np.asarray(jattn.flash_attn_varlen.raw(
        jnp.asarray(q), jnp.asarray(np.repeat(k, rep, 1)),
        jnp.asarray(np.repeat(v, rep, 1)), cu_q, cu_k, causal=causal))
    blind = ~_jax_mask(cu_q, PACKS[pack][1], q.shape[0], k.shape[0],
                       causal).any(1)
    assert np.isnan(ref[blind]).all() and not np.isnan(ref[~blind]).any()
    assert (mine[blind] == 0).all()
    np.testing.assert_allclose(mine[~blind], ref[~blind], rtol=0,
                               atol=DENSE_TOL)


@pytest.mark.parametrize("pack,causal", GRAD_CASES)
def test_varlen_gradients_match_jax_vjp(pack, causal):
    """dq, dk, dv of the port's route (autograd through the plain version
    on the frontier arrays) against jax.vjp of the JAX dense path; the
    JAX side repeats the kv heads inside the differentiated function, so
    its dk, dv are the sums over each group."""
    q, k, v, do, cu_q, cu_k = _case(pack, seed=1)
    assert _jax_mask(cu_q, cu_k, q.shape[0], k.shape[0], causal).any(1).all()
    rep = q.shape[1] // k.shape[1]
    tq, tk, tv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    tattn.flash_attn_varlen(tq, tk, tv, cu_q, cu_k, causal=causal).backward(
        torch.tensor(do))

    def f(q, k, v):
        return jattn.flash_attn_varlen.raw(q, jnp.repeat(k, rep, 1),
                                           jnp.repeat(v, rep, 1), cu_q, cu_k,
                                           causal=causal)

    _, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v)))
    for mine, ref in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                                   atol=DENSE_TOL)


def test_kernel_wrapper_checks_the_frontier_arrays():
    """The arrays come in pairs, are the whole mask (no causal flag, no
    segment ids) and have [B, S, 2] shapes."""
    q = torch.zeros(1, 8, 2, 16)
    qr, kr = tattn.varlen_ranges([0, 8], [0, 8], 8, 8, True, "cpu")
    with pytest.raises(ValueError, match="together"):
        K1.flash_attention_fwd(q, q, q, q_ranges=qr)
    with pytest.raises(ValueError, match="whole mask"):
        K1.flash_attention_fwd(q, q, q, True, q_ranges=qr, kv_ranges=kr)
    with pytest.raises(ValueError, match=r"\[B, Sq, 2\]"):
        K1.flash_attention_fwd(q, q, q, q_ranges=qr[:, :4], kv_ranges=kr)
    with pytest.raises(ValueError, match="two entries"):
        tattn.varlen_ranges([0], [0, 8], 0, 8, True, "cpu")

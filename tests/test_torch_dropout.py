"""Dropout in the port on the CPU: the Philox mask of attention dropout,
``nn.functional.dropout`` / ``nn.common.Dropout``, and attention with
dropout through ``ops.attention`` and the K1/K2 wrapper's plain version.

The JAX package draws its masks from ``jax.random``, so nothing here
compares masks across the packages: the mask is held against an
independent pure-Python Philox4x32-10 and Random123's published
known-answer vector, against its keep probability (5 sigma), and for
slicing invariance; ``dropout`` against the JAX formulas
(ops/nn_ops.py:510-517) on the same mask; attention with dropout against
softmax(S) o M / (1 - p) @ V written out independently, with its autograd
gradients (1e-5, fp32).
"""
import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.common import Dropout
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.ops.kernels import dropout_mask as DM
from paddle_tpu_torch.ops.kernels import flash_attention as K1

TOL = 1e-5
_MASK = 0xFFFFFFFF


def _philox_py(ctr, key):
    """Philox4x32-10 on Python ints (Salmon et al., SC'11)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        p0 = 0xD2511F53 * c0
        p1 = 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & _MASK,
                          (p0 >> 32) ^ c3 ^ k1, p0 & _MASK)
        k0, k1 = (k0 + 0x9E3779B9) & _MASK, (k1 + 0xBB67AE85) & _MASK
    return c0, c1, c2, c3


def _words(ctr, key):
    cols = [torch.tensor([c], dtype=torch.int64) for c in ctr]
    return tuple(int(w) for w in DM.philox4x32_10(*cols, *key))


def test_philox_known_answer_vector():
    """Random123's kat_vectors for philox4x32_10, counter = key = 0."""
    want = (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)
    assert _philox_py((0, 0, 0, 0), (0, 0)) == want
    assert _words((0, 0, 0, 0), (0, 0)) == want


def test_philox_matches_pure_python():
    rs = np.random.RandomState(0)
    ctr = rs.randint(0, 2 ** 32, (256, 4), dtype=np.uint64).astype(np.int64)
    key = rs.randint(0, 2 ** 32, (256, 2), dtype=np.uint64).astype(np.int64)
    ctr[0], key[0] = _MASK, _MASK
    for c, k in zip(ctr.tolist(), key.tolist()):
        assert _words(c, k) == _philox_py(c, k)
    # broadcast: one key, a grid of counters in one call
    c = torch.tensor(ctr[:, 0])
    got = torch.stack(DM.philox4x32_10(c, c + 1, c + 2, c + 3, 7, 9), -1)
    for i in range(0, 256, 17):
        v = int(ctr[i, 0])
        assert tuple(got[i].tolist()) == _philox_py((v, v + 1, v + 2, v + 3),
                                                    (7, 9))


def test_mask_follows_the_counter_layout():
    """Element (b, h, r, c) is the 16-bit half c & 1 (low first) of word
    (c >> 1) & 3 of counter (c >> 3, r, h, b) under the key (seed_lo,
    seed_hi), kept iff >= round(p 2^16); every element of a mask whose
    last 8-key group is cut short (Skv = 13)."""
    seed, p = 0x0123456789ABCDEF, 0.3
    keep = DM.dropout_keep(seed, p, 2, 3, 9, 13)
    thr = round(p * 2 ** 16)
    key = (seed & _MASK, seed >> 32)
    for b in range(2):
        for h in range(3):
            for r in range(9):
                for c in range(13):
                    w = _philox_py((c >> 3, r, h, b), key)[(c >> 1) & 3]
                    half = (w >> 16) if c & 1 else (w & 0xFFFF)
                    assert bool(keep[b, h, r, c]) == (half >= thr)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_keep_rate_within_5_sigma(p):
    keep = DM.dropout_keep(1234, p, 2, 4, 256, 256)
    n = keep.numel()
    rate = keep.double().mean().item()
    assert abs(rate - (1 - p)) <= 5 * math.sqrt(p * (1 - p) / n)


def test_mask_is_invariant_to_slicing():
    """A mask depends only on (seed, b, h, row, col)."""
    full = DM.dropout_keep(99, 0.2, 3, 4, 40, 37)
    assert torch.equal(DM.dropout_keep(99, 0.2, 2, 3, 17, 22),
                       full[:2, :3, :17, :22])
    assert torch.equal(DM.dropout_keep(99, 0.2, 3, 4, 40, 5),
                       full[..., :5])
    assert not torch.equal(DM.dropout_keep(100, 0.2, 3, 4, 40, 37), full)


def test_seed_and_threshold_helpers():
    assert DM.split_seed(2 ** 64 + 5) == (5, 0)
    assert DM.threshold(0.0) == 0 and DM.threshold(0.5) == 2 ** 15
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        DM.threshold(1.0)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert DM.draw_seed(g1) == DM.draw_seed(g2)
    assert DM.draw_seed(g1) != DM.draw_seed(torch.Generator().manual_seed(4))


@pytest.mark.parametrize("p,want", [
    (0.0, 0), (0.1, 6554), (0.5, 32768), (1 - 2 ** -16, 65535),
    (math.nextafter(1.0, 0.0), 65536)])
def test_threshold_is_the_16_bit_bound(p, want):
    """threshold(p) = round(p 2^16), the bound on a 16-bit half: the keep
    probability 1 - threshold / 2^16 is within 2^-17 of 1 - p, and p just
    below 1 keeps nothing (no half reaches 65536)."""
    assert DM.threshold(p) == want
    assert abs(want / 2 ** 16 - p) <= 2 ** -17
    if want == 65536:
        assert not DM.dropout_keep(5, p, 1, 2, 8, 40).any()


@pytest.mark.parametrize("p", [1.0, 1.5, -1e-9, -0.5])
def test_threshold_raises_outside_0_1(p):
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        DM.threshold(p)


# -- nn.functional.dropout / Dropout ------------------------------------------
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_functional_dropout_modes_match_jax_formulas(mode, dtype):
    p = 0.3
    x = torch.randn(4, 33, 8, generator=torch.Generator().manual_seed(0)
                    ).to(dtype)
    out = F.dropout(x, p, training=True, mode=mode,
                    generator=torch.Generator().manual_seed(5))
    # the same mask: the generator's first draw
    mask = torch.rand(x.shape, generator=torch.Generator().manual_seed(5)
                      ) < 1 - p
    xj, mj, keep = jnp.asarray(x.float().numpy()), jnp.asarray(
        mask.numpy()), 1.0 - p
    xj = xj.astype(jnp.bfloat16) if dtype == torch.bfloat16 else xj
    if mode == "upscale_in_train":     # nn_ops.py:515-516
        ref = jnp.where(mj, xj / keep, 0.0).astype(xj.dtype)
    else:                              # nn_ops.py:517
        ref = jnp.where(mj, xj, 0.0).astype(xj.dtype)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))
    assert out.dtype == dtype


def test_functional_dropout_identity_cases():
    x = torch.randn(3, 5)
    for mode in ("upscale_in_train", "downscale_in_infer"):
        assert F.dropout(x, 0.5, training=False, mode=mode) is x
        assert F.dropout(x, 0.0, training=True, mode=mode) is x
    assert torch.equal(F.dropout(x, 1.0), torch.zeros_like(x))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        F.dropout(x, 0.5, axis=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Dropout(0.5, axis=0)
    with pytest.raises(ValueError, match="mode"):
        F.dropout(x, 0.5, mode="bad")


def test_dropout_layer_train_and_eval():
    g = torch.Generator().manual_seed(2)
    layer = Dropout(0.4, generator=g)
    x = torch.ones(64, 64, requires_grad=True)
    y = layer(x)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.6))
    y.sum().backward()
    assert torch.equal(x.grad, kept.float() / 0.6)
    assert torch.equal(layer.eval()(x), x)


# -- attention with dropout --------------------------------------------------
def _qkv(B, Sq, Skv, H, KV, D, seed=0):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return mk(B, Sq, H, D), mk(B, Skv, KV, D), mk(B, Skv, KV, D), \
        mk(B, Sq, H, D)


def _reference(q, k, v, causal, p, seed, qseg=None, kseg=None):
    """softmax(S) o M / (1 - p) @ V, written out per head in fp32."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    keep = DM.dropout_keep(seed, p, B, H, Sq, Skv)
    outs = []
    for h in range(H):
        kh = h // (H // KV)
        s = torch.einsum("bqd,bkd->bqk", q[:, :, h], k[:, :, kh]) \
            / math.sqrt(D)
        vis = torch.ones(Sq, Skv, dtype=torch.bool)
        if causal:
            vis = vis.tril(Skv - Sq)
        vis = vis.expand(B, Sq, Skv)
        if qseg is not None:
            vis = vis & (qseg[:, :, None] == kseg[:, None, :])
        s = s.masked_fill(~vis, float("-inf"))
        prob = torch.softmax(s, -1) * keep[:, h] / (1 - p)
        outs.append(torch.einsum("bqk,bkd->bqd", prob, v[:, :, kh]))
    return torch.stack(outs, 2)


CASES = {
    "mha_causal": (2, 24, 24, 4, 4, 16, True, False),
    "gqa_causal": (2, 20, 20, 4, 2, 32, True, False),
    "rect_causal": (1, 9, 23, 2, 1, 16, True, False),
    "noncausal": (2, 17, 30, 2, 2, 64, False, False),
    "segments": (2, 32, 32, 4, 2, 16, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_attention_dropout_and_grads_match_formula(case):
    B, Sq, Skv, H, KV, D, causal, segm = CASES[case]
    q, k, v, do = _qkv(B, Sq, Skv, H, KV, D)
    qseg = kseg = None
    if segm:
        kseg = (torch.arange(Skv) * 3 // Skv).to(torch.int32).expand(
            B, Skv).contiguous()
        qseg = kseg[:, Skv - Sq:].contiguous()
    p, seed = 0.25, 777
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    refs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = K1.flash_attention_fwd(*ins, causal, None, qseg, kseg, dropout=p,
                                 seed=seed)
    ref = _reference(*refs, causal, p, seed, qseg, kseg)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=0, atol=TOL)
    out.backward(do)
    ref.backward(do)
    for a, b in zip(ins, refs):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=0,
                                   atol=TOL)
    # the wrapper's K2 entry on CPU tensors: the same gradients
    o, lse = K1.flash_attention_fwd_lse(q, k, v, causal, None, qseg, kseg,
                                        dropout=p, seed=seed)
    grads = K1.flash_attention_bwd(q, k, v, o, lse, do, causal, None, qseg,
                                   kseg, dropout=p, seed=seed)
    for a, b in zip(grads, refs):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), rtol=0,
                                   atol=TOL)


def test_p_zero_is_the_no_dropout_path():
    q, k, v, _ = _qkv(2, 16, 16, 4, 2, 16)
    base = K1.flash_attention_fwd(q, k, v, True)
    assert torch.equal(K1.flash_attention_fwd(q, k, v, True, dropout=0.0,
                                              seed=5), base)
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    assert torch.equal(tattn.flash_attention(q, k, v, True, dropout=0.0,
                                             generator=g), base)
    assert torch.equal(g.get_state(), state)     # p = 0 draws no seed


def test_same_seed_same_output_and_generator_draws():
    q, k, v, _ = _qkv(1, 16, 16, 2, 2, 16)
    a = tattn.flash_attention(q, k, v, True, 0.5, seed=11)
    assert torch.equal(a, tattn.flash_attention(q, k, v, True, 0.5,
                                                seed=11))
    assert not torch.equal(a, tattn.flash_attention(q, k, v, True, 0.5,
                                                    seed=12))
    g = torch.Generator().manual_seed(4)
    first = tattn.flash_attention(q, k, v, True, 0.5, generator=g)
    second = tattn.flash_attention(q, k, v, True, 0.5, generator=g)
    assert not torch.equal(first, second)        # one seed a call
    g = torch.Generator().manual_seed(4)
    assert torch.equal(tattn.flash_attention(q, k, v, True, 0.5,
                                             generator=g), first)
    seed = DM.draw_seed(torch.Generator().manual_seed(4))
    assert torch.equal(first, tattn.flash_attention(q, k, v, True, 0.5,
                                                    seed=seed))


def test_varlen_dropout_is_the_packed_mask():
    T, H, D = 30, 2, 16
    q, k, v, _ = _qkv(1, T, T, H, H, D, seed=3)
    cu = [0, 11, 30]
    out = tattn.flash_attn_varlen(q[0], k[0], v[0], cu, cu, causal=True,
                                  dropout=0.3, seed=21)
    seg = torch.tensor([0] * 11 + [1] * 19, dtype=torch.int32)[None]
    ref = _reference(q, k, v, True, 0.3, 21, seg, seg)[0]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=TOL)


def test_attention_dropout_needs_a_generator_or_seed():
    """Attention dropout needs a generator or a seed (the JAX _sdpa_raw
    needs a dropout_key); the kernels' arguments are the seed's words,
    round(p 2^16) and 1 / (1 - p), at every head dim and dtype."""
    x = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="generator"):
        tattn.flash_attention(x, x, x, causal=True, dropout=0.1)
    with pytest.raises(ValueError, match="generator"):
        tattn.flash_attn_varlen(x[0], x[0], x[0], [0, 8], [0, 8],
                                dropout=0.1)
    with pytest.raises(ValueError, match="seed"):
        K1.flash_attention_fwd(x, x, x, True, dropout=0.1)
    assert K1._drop_args(0.1, 3 + (5 << 32), "f") == (
        3, 5, DM.threshold(0.1), DM.keep_scale(0.1))
    assert K1._drop_args(0.0, None, "f") is None


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is served")
    from paddle_tpu_torch.incubate.nn import FusedMultiHeadAttention
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny

    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(gpt_tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedMultiHeadAttention(64, 4)
    # attention seeds come from a CPU generator, whatever the device
    fake_cuda_generator = SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="CPU generator"):
        DM.draw_seed(fake_cuda_generator)

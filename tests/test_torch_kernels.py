"""The port's kernel modules held against the JAX package on the CPU.

On CPU tensors each wrapper of ``paddle_tpu_torch.ops.kernels`` takes its
plain PyTorch version; these tests hold that path against the JAX Pallas
kernels run in interpret mode (gate 1e-4, as tests/test_unified_ragged.py
uses) and against the JAX dense fallbacks (fp32, atol 2e-5). Inputs come
from a seeded numpy generator and pass through both packages. The CUDA
kernels themselves are compared with the same plain versions on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops.pallas import decode_attention as jda
from paddle_tpu.ops.pallas import ragged_paged_attention as jra
from paddle_tpu.ops.pallas import rms_norm as jrms
from paddle_tpu_torch.ops.kernels import decode_attention as tda
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as tra
from paddle_tpu_torch.ops.kernels import rms_norm as trms

INTERPRET_TOL = 1e-4
DENSE_TOL = 2e-5

B, Sq, D, page, npages = 4, 16, 128, 8, 16
HEADS = {"gqa_g2": (8, 4), "mha": (4, 4)}


def _inputs(H, KV, seed):
    r = np.random.RandomState(seed)
    q = r.randn(B, Sq, H, D).astype(np.float32)
    P = B * npages + 5
    kp = r.randn(P, KV, page, D).astype(np.float32)
    vp = r.randn(P, KV, page, D).astype(np.float32)
    # scrambled physical page order: exercises the table indirection
    tbl = r.permutation(P)[:B * npages].reshape(B, npages).astype(np.int32)
    return q, kp, vp, tbl


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


# the cases of tests/test_unified_ragged.py: (starts, seq_lens, seed)
RAGGED = {
    "mixed_chunk_straddles_pages": ([5, 77, 0, 0], [16, 1, 16, 0], 3),
    "decode_only": ([10, 1, 55, 127], [1, 1, 1, 1], 4),
    "prefill_only": ([0, 8, 16, 3], [16, 16, 16, 16], 5),
    "partial_chunks_and_dead_rows": ([31, 0, 9, 64], [7, 0, 3, 12], 6),
}


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("case", sorted(RAGGED))
def test_ragged_plain_matches_jax(case, heads):
    starts, lens, seed = RAGGED[case]
    H, KV = HEADS[heads]
    q, kp, vp, tbl = _inputs(H, KV, seed)
    st, nv = np.asarray(starts, np.int32), np.asarray(lens, np.int32)
    before = tra.ragged_paged_attention.launches
    out = tra.ragged_paged_attention(_t(q), _t(kp), _t(vp), _t(tbl),
                                     _t(st), _t(nv)).numpy()
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert tra.ragged_paged_attention.launches == before
    ref_k = np.asarray(jra.ragged_paged_attention(
        _j(q), _j(kp), _j(vp), _j(tbl), _j(st), _j(nv), interpret=True))
    ref_d = np.asarray(jra.ragged_paged_attention_dense(
        _j(q), _j(kp), _j(vp), _j(tbl), _j(st), _j(nv)))
    assert np.abs(out - ref_k).max() < INTERPRET_TOL
    np.testing.assert_allclose(out, ref_d, rtol=0, atol=DENSE_TOL)


@pytest.mark.parametrize("heads", sorted(HEADS))
def test_ragged_dead_slots_exact_zero(heads):
    H, KV = HEADS[heads]
    q, kp, vp, tbl = _inputs(H, KV, 7)
    nv = _t(np.asarray([0, 4, 0, 1], np.int32))
    st = _t(np.asarray([0, 11, 0, 30], np.int32))
    out = tra.ragged_paged_attention(_t(q), _t(kp), _t(vp), _t(tbl), st,
                                     nv).numpy()
    assert (out[0] == 0).all() and (out[2] == 0).all()
    assert (out[1, 4:] == 0).all() and (out[3, 1:] == 0).all()


@pytest.mark.parametrize("heads", sorted(HEADS))
def test_fully_valid_ragged_equals_paged_decode(heads):
    """With every slot valid, K4's plain version equals K5's bit for bit
    (the two-program equivalence the serving engine leans on)."""
    H, KV = HEADS[heads]
    q, kp, vp, tbl = _inputs(H, KV, 8)
    st = _t(np.asarray([0, 24, 5, 80], np.int32))
    nv = _t(np.full((B,), Sq, np.int32))
    uni = tra.ragged_paged_attention(_t(q), _t(kp), _t(vp), _t(tbl), st, nv)
    legacy = tda.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tbl), st)
    np.testing.assert_array_equal(uni.numpy(), legacy.numpy())


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("sq", [1, Sq])
def test_paged_decode_plain_matches_jax(heads, sq):
    H, KV = HEADS[heads]
    q, kp, vp, tbl = _inputs(H, KV, 9)
    q = q[:, :sq]
    lengths = np.asarray([0, 17, 60, 127 - sq + 1], np.int32)
    out = tda.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tbl),
                                     _t(lengths)).numpy()
    ref_k = np.asarray(jda.paged_decode_attention(
        _j(q), _j(kp), _j(vp), _j(tbl), _j(lengths), interpret=True))
    ref_d = np.asarray(jda.paged_attention_dense(
        _j(q), _j(kp), _j(vp), _j(tbl), _j(lengths)))
    assert np.abs(out - ref_k).max() < INTERPRET_TOL
    np.testing.assert_allclose(out, ref_d, rtol=0, atol=DENSE_TOL)


@pytest.mark.parametrize("shape", [(6, 128), (3, 5, 64), (1, 4096)])
def test_rms_norm_plain_matches_jax(shape):
    r = np.random.RandomState(10)
    x = r.randn(*shape).astype(np.float32)
    w = (1 + 0.1 * r.randn(shape[-1])).astype(np.float32)
    out = trms.rms_norm(_t(x), _t(w), 1e-5).numpy()
    ref_k = np.asarray(jrms.rms_norm_fused(_j(x), _j(w), 1e-5, True))
    ref_d = np.asarray(jrms.rms_norm_dense(_j(x), _j(w), 1e-5))
    assert np.abs(out - ref_k).max() < INTERPRET_TOL
    np.testing.assert_allclose(out, ref_d, rtol=0, atol=DENSE_TOL)


def test_rms_norm_bf16_f32_math():
    """bf16 in, f32 math, one rounding back to bf16 (JAX's formula)."""
    r = np.random.RandomState(11)
    x = r.randn(4, 64).astype(np.float32)
    w = r.randn(64).astype(np.float32)
    xb, wb = _t(x).bfloat16(), _t(w).bfloat16()
    out = trms.rms_norm(xb, wb, 1e-6)
    assert out.dtype == torch.bfloat16
    ref = jrms.rms_norm_dense(_j(xb.float().numpy()).astype(jnp.bfloat16),
                              _j(wb.float().numpy()).astype(jnp.bfloat16),
                              1e-6)
    # f32 sums may differ in order: at most one bf16 rounding step apart
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -7, atol=0)


class TestWrapperChecks:
    """The wrappers raise on what no path takes; nothing falls back."""

    def test_unsupported_device_raises(self):
        x = torch.empty(2, 64, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            trms.rms_norm(x, torch.empty(64, device="meta"))

    def test_dtype_and_shape_checks(self):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            trms.rms_norm(torch.zeros(2, 8, dtype=torch.float16),
                          torch.zeros(8, dtype=torch.float16))
        with pytest.raises(ValueError, match="weight shape"):
            trms.rms_norm(torch.zeros(2, 8), torch.zeros(4))
        q, kp, vp, tbl = (_t(a) for a in _inputs(8, 4, 1))
        st = torch.zeros(B, dtype=torch.int32)
        with pytest.raises(TypeError, match="int32"):
            tra.ragged_paged_attention(q, kp, vp, tbl.long(), st, st)
        with pytest.raises(ValueError, match="KV heads"):
            tda.paged_decode_attention(q[:, :, :6], kp[:, :4], vp[:, :4],
                                       tbl, st)
        with pytest.raises(TypeError, match="share q's dtype"):
            tda.paged_decode_attention(q, kp.double(), vp.double(), tbl, st)

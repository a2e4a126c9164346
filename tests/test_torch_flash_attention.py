"""The port's flash attention (K1/K2), RMSNorm gradient (K3) and the
attention and rope ops around them, held against the JAX package on the
CPU.

On CPU tensors the K1/K2 wrapper takes its plain version
(``flash_attention_dense``, differentiated by autograd). Its output, lse
and q/k/v gradients are held against the JAX Pallas kernel run in
interpret mode (``flash_attention_fwd(..., interpret=True)`` and the
residuals of ``_fa_fwd``, gradients by ``jax.vjp``) at 1e-4, and its
output against the JAX portable path (``ops/attention.py`` ``_gqa_sdpa``)
at 2e-5, all in fp32. The Pallas kernel takes equal head counts, so for
GQA the JAX side repeats K/V inside the differentiated function (as
``ops/attention.py:64-67`` does) and its dk/dv are the sums over each
group. Inputs come from a seeded numpy generator and pass through both
packages. The CUDA kernels are held against the same plain versions on
the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.ops import attention as jattn
from paddle_tpu.ops import nn_ops as jnn
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import rms_norm as jrms
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.ops import nn_ops as tnn
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import rms_norm as trms

INTERPRET_TOL = 1e-4
DENSE_TOL = 2e-5
RMS_GRAD_TOL = 1e-5

# (B, Sq, Skv, H, KV, D, causal, segments)
CASES = {
    "causal_s128": (2, 128, 128, 4, 4, 16, True, False),
    "full_s256": (2, 256, 256, 4, 4, 16, False, False),
    "rect_128_of_384": (1, 128, 384, 2, 2, 32, True, False),
    "segments_s128": (2, 128, 128, 4, 4, 16, True, True),
    "gqa_s256": (1, 256, 256, 4, 2, 16, True, False),
    "gqa_segments_full": (2, 128, 128, 4, 2, 16, False, True),
    # D = 32: the bf16 mma bodies' other head dim on the card
    "gqa_d32_s256": (1, 256, 256, 8, 2, 32, True, False),
    "segments_d32": (2, 128, 128, 4, 2, 32, True, True),
}


def _case(B, Sq, Skv, H, KV, D, segments, seed):
    r = np.random.RandomState(seed)
    q = r.randn(B, Sq, H, D).astype(np.float32)
    k = r.randn(B, Skv, KV, D).astype(np.float32)
    v = r.randn(B, Skv, KV, D).astype(np.float32)
    ct = r.randn(B, Sq, H, D).astype(np.float32)
    qs = ks = None
    if segments:
        ks = np.zeros((B, Skv), np.int32)
        for b in range(B):
            c1, c2 = sorted(r.choice(np.arange(1, Skv), 2, replace=False))
            ks[b, c1:] = 1
            ks[b, c2:] = 2
        qs = ks[:, Skv - Sq:].copy()
    return q, k, v, ct, qs, ks


def _jax_fa(q, k, v, causal, qs, ks):
    """JAX Pallas K1 in interpret mode with K/V repeated to q's heads."""
    rep = q.shape[2] // k.shape[2]
    kk = jnp.repeat(k, rep, axis=2) if rep > 1 else k
    vv = jnp.repeat(v, rep, axis=2) if rep > 1 else v
    qsj = None if qs is None else jnp.asarray(qs)
    ksj = None if ks is None else jnp.asarray(ks)
    return jfa.flash_attention_fwd(q, kk, vv, causal, None, True, qsj, ksj)


def _t(x):
    return None if x is None else torch.tensor(x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_forward_and_lse_match_pallas_interpret(name):
    B, Sq, Skv, H, KV, D, causal, segm = CASES[name]
    q, k, v, _, qs, ks = _case(B, Sq, Skv, H, KV, D, segm, seed=1)
    out, lse = tfa.flash_attention_fwd_lse(_t(q), _t(k), _t(v), causal, None,
                                           _t(qs), _t(ks))
    rep = H // KV
    kk, vv = (jnp.repeat(jnp.asarray(t), rep, axis=2) for t in (k, v))
    j_out, res = jfa._fa_fwd(jnp.asarray(q), kk, vv, causal, None, True,
                             None if qs is None else jnp.asarray(qs),
                             None if ks is None else jnp.asarray(ks))
    j_lse = np.asarray(res[4]).reshape(B, H, Sq)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0,
                               atol=INTERPRET_TOL)
    np.testing.assert_allclose(lse.numpy(), j_lse, rtol=0,
                               atol=INTERPRET_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_grads_match_pallas_interpret(name):
    B, Sq, Skv, H, KV, D, causal, segm = CASES[name]
    q, k, v, ct, qs, ks = _case(B, Sq, Skv, H, KV, D, segm, seed=2)
    _, vjp = jax.vjp(lambda a, b, c: _jax_fa(a, b, c, causal, qs, ks),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    j_grads = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tfa.flash_attention_fwd(tq, tk, tv, causal, None, _t(qs), _t(ks))
    out.backward(torch.tensor(ct))
    for mine, ref, which in zip((tq.grad, tk.grad, tv.grad), j_grads,
                                "qkv"):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                                   atol=INTERPRET_TOL, err_msg=f"d{which}")
    # K2's CPU route is the same gradient
    o, lse = tfa.flash_attention_fwd_lse(tq, tk, tv, causal, None, _t(qs),
                                         _t(ks))
    for a, b in zip(tfa.flash_attention_bwd(
            tq.detach(), tk.detach(), tv.detach(), o, lse, torch.tensor(ct),
            causal, None, _t(qs), _t(ks)), (tq.grad, tk.grad, tv.grad)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", [n for n in sorted(CASES)
                                  if not CASES[n][7]])
def test_flash_forward_matches_jax_portable_path(name):
    """The plain version against ``paddle_tpu.ops.attention`` on the CPU:
    its GQA broadcast ``_gqa_sdpa`` and its ``flash_attention`` op."""
    B, Sq, Skv, H, KV, D, causal, _ = CASES[name]
    q, k, v, _, _, _ = _case(B, Sq, Skv, H, KV, D, False, seed=3)
    mine = tattn.flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
    ref = jattn._gqa_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal)
    np.testing.assert_allclose(mine, np.asarray(ref), rtol=0, atol=DENSE_TOL)
    op = jattn.flash_attention.raw(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal)
    np.testing.assert_allclose(mine, np.asarray(op), rtol=0, atol=DENSE_TOL)


VARLEN_PACKS = {  # name: (cu_seqlens_k or None for q's own, Tk)
    "same_pack": (None, 64),
    "own_packs": ([0, 30, 60, 64], 64),
    "rect_packs": ([0, 30, 50, 80], 80),
}


def _varlen_case(pack):
    r = np.random.RandomState(4)
    H, D = 2, 16
    cu_q = np.asarray([0, 20, 52, 64], np.int32)
    cu_k, Tk = VARLEN_PACKS[pack]
    cu_k = cu_q if cu_k is None else np.asarray(cu_k, np.int32)
    q = r.randn(64, H, D).astype(np.float32)
    k = r.randn(Tk, H, D).astype(np.float32)
    v = r.randn(Tk, H, D).astype(np.float32)
    return q, k, v, cu_q, cu_k


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shared", sorted(VARLEN_PACKS))
def test_flash_attn_varlen_matches_jax(causal, shared):
    """Packed sequences against the JAX portable path. Rows that see no
    key (causal packs where a sequence has more q than k tokens) are NaN
    there, from its -inf softmax; the port gives them 0, as K1 and the
    JAX Pallas kernel do. Every other row agrees."""
    q, k, v, cu_q, cu_k = _varlen_case(shared)
    mine = tattn.flash_attn_varlen(_t(q), _t(k), _t(v), cu_q, cu_k,
                                   causal=causal).numpy()
    ref = np.asarray(jattn.flash_attn_varlen.raw(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cu_q, cu_k,
        causal=causal))
    blind = np.isnan(ref).all(axis=(1, 2))
    assert np.isnan(ref).any(axis=(1, 2)).sum() == blind.sum()
    assert blind.any() == (causal and shared != "same_pack")
    assert (mine[blind] == 0).all()
    np.testing.assert_allclose(mine[~blind], ref[~blind], rtol=0,
                               atol=DENSE_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shared", sorted(VARLEN_PACKS))
def test_flash_attn_varlen_routes_to_k1(causal, shared, monkeypatch):
    """Every pack, causal with its own boundaries included, routes to the
    K1/K2 wrapper with the pack's frontier arrays (``varlen_ranges``) and
    no causal flag or segment ids; the CPU route then takes the plain
    version on those ranges."""
    calls = []
    fn = tattn.flash_attention_fwd
    monkeypatch.setattr(tattn, "flash_attention_fwd", lambda *a, **kw: (
        calls.append((a[3], kw)), fn(*a, **kw))[1])
    q, k, v, cu_q, cu_k = _varlen_case(shared)
    tattn.flash_attn_varlen(_t(q), _t(k), _t(v), cu_q, cu_k, causal=causal)
    (flag, kw), = calls
    assert flag is False and "q_segment_ids" not in kw
    qr, kr = tattn.varlen_ranges(cu_q, cu_k, q.shape[0], k.shape[0], causal,
                                 "cpu")
    assert torch.equal(kw["q_ranges"], qr) and torch.equal(kw["kv_ranges"],
                                                           kr)
    # equal boundaries given as separate arrays are the same pack
    calls.clear()
    tattn.flash_attn_varlen(_t(q), _t(q), _t(q), cu_q, cu_q.copy(),
                            causal=True)
    assert len(calls) == 1 and "q_ranges" in calls[0][1]


def test_dropout_raises_naming_roadmap():
    """Attention dropout runs at every head dim and dtype
    (tests/test_torch_dropout.py; the bf16 D = 16 / 32 kernels on the
    card); what still raises names its ROADMAP item:
    ``dropout(axis=...)`` and ``Dropout(axis=...)``."""
    x = torch.zeros(1, 8, 2, 16)
    assert tfa._drop_args(0.1, 7, "flash_attention_fwd") is not None
    from paddle_tpu_torch.nn import functional as tF
    from paddle_tpu_torch.nn.common import Dropout
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tF.dropout(x, 0.1, axis=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Dropout(0.1, axis=1)


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 8, 3, 16)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention_fwd(q, kv, kv)
    seg = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        tfa.flash_attention_fwd(q, q, q, q_segment_ids=seg)


@pytest.mark.parametrize("form", ["SD", "1S1D", "position_ids"])
def test_fused_rope_matches_jax(form):
    r = np.random.RandomState(5)
    B, S, H, D = 2, 12, 3, 16
    q = r.randn(B, S, H, D).astype(np.float32)
    k = r.randn(B, S, 2, D).astype(np.float32)
    cos = r.randn(S, D).astype(np.float32)
    sin = r.randn(S, D).astype(np.float32)
    pos = None
    if form == "1S1D":
        cos, sin = cos[None, :, None], sin[None, :, None]
    if form == "position_ids":
        pos = r.randint(0, S, (B, S))
    jq, jk = jnn.fused_rope.raw(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(cos), jnp.asarray(sin),
                                None if pos is None else jnp.asarray(pos))
    tq, tk = tnn.fused_rope(_t(q), _t(k), _t(cos), _t(sin), _t(pos))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-6)


def test_fused_rope_keeps_bf16():
    x = torch.randn(1, 4, 2, 16).bfloat16()
    c = torch.randn(4, 16)
    q, k = tnn.fused_rope(x, x, c, c)
    assert q.dtype == k.dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(7, 64), (2, 5, 128)])
def test_rms_norm_grad_matches_jax_vjp(shape):
    """K3's backward formula against jax.vjp of the Pallas kernel run in
    interpret mode, and the CPU route's autograd against both."""
    r = np.random.RandomState(6)
    x = r.randn(*shape).astype(np.float32)
    w = (1 + 0.1 * r.randn(shape[-1])).astype(np.float32)
    g = r.randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jrms.rms_norm_fused(a, b, 1e-5, True),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    dx, dw = trms.rms_norm_grad(_t(x), _t(w), _t(g), 1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=0,
                               atol=RMS_GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=0,
                               atol=RMS_GRAD_TOL)
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    trms.rms_norm(tx, tw, 1e-5).backward(_t(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=0,
                               atol=RMS_GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=0,
                               atol=RMS_GRAD_TOL)

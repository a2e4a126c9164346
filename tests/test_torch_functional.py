"""``nn.functional`` and ``nn.Embedding`` of the port held against the JAX
package on the CPU: ``cross_entropy`` over every option of the JAX
``cross_entropy_loss`` (ops/nn_ops.py:561-592) and every reduction
(1e-6), Paddle's attention entry points ``scaled_dot_product_attention``
(with and without a bool or additive mask), ``flash_attention`` and
``flash_attn_unpadded`` against the JAX functions at dropout 0 (2e-5,
f32), and ``embedding`` / ``Embedding`` (exact), including
``load_jax_state_dict`` carrying the layer's weight. Inputs come from a
seeded numpy generator and pass through both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as jF
from paddle_tpu.ops import nn_ops as jops
from paddle_tpu_torch.convert import export_jax_state_dict, load_jax_state_dict
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.nn.common import Embedding

CE_TOL = 1e-6
ATTN_TOL = 2e-5

# name: (logits shape, axis, kwargs)
CE_CASES = {
    "hard": ((6, 5), -1, {}),
    "hard_ignore": ((6, 5), -1, {"ignore_index": 2}),
    "hard_label_col": ((6, 5), -1, {"label_col": True}),
    "weight": ((6, 5), -1, {"weight": True}),
    "weight_ignore": ((6, 5), -1, {"weight": True, "ignore_index": 1}),
    "smoothing": ((6, 5), -1, {"label_smoothing": 0.1}),
    "smoothing_weight_ignore": ((6, 5), -1, {"label_smoothing": 0.2,
                                             "weight": True,
                                             "ignore_index": 3}),
    "soft": ((6, 5), -1, {"soft_label": True}),
    "soft_weight_unread": ((6, 5), -1, {"soft_label": True,
                                        "weight": True}),
    "seq_hard": ((2, 7, 5), -1, {"ignore_index": 0}),
    "axis1_smoothing": ((3, 5, 4), 1, {"label_smoothing": 0.1,
                                       "ignore_index": 4}),
    "axis1_soft": ((3, 5, 4), 1, {"soft_label": True}),
    "axis0_smoothing_weight": ((5, 6), 0, {"label_smoothing": 0.3,
                                           "weight": True}),
}


def _ce_inputs(case, seed=0):
    shape, axis, kw = CE_CASES[case]
    kw = dict(kw)
    r = np.random.RandomState(seed)
    logits = (3 * r.randn(*shape)).astype(np.float32)
    n = shape[axis]
    if kw.get("soft_label"):
        lab = r.rand(*shape).astype(np.float32)
        lab /= lab.sum(axis, keepdims=True)
    else:
        lshape = tuple(s for i, s in enumerate(shape) if i != axis % len(shape))
        lab = r.randint(0, n, lshape)
        if kw.pop("label_col", False):
            lab = lab[..., None]
    if kw.pop("weight", False):
        kw["weight"] = r.rand(n).astype(np.float32) + 0.5
    return logits, lab, axis, kw


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_matches_jax(case, reduction):
    logits, lab, axis, kw = _ce_inputs(case)
    ref = np.asarray(jops.cross_entropy_loss.raw(
        jnp.asarray(logits), jnp.asarray(lab), axis=axis,
        reduction=reduction,
        **{k: (jnp.asarray(v) if k == "weight" else v)
           for k, v in kw.items()}))
    mine = tF.cross_entropy(
        torch.tensor(logits), torch.tensor(lab), axis=axis,
        reduction=reduction,
        **{k: (torch.tensor(v) if k == "weight" else v)
           for k, v in kw.items()}).numpy()
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, rtol=CE_TOL, atol=CE_TOL)


def test_cross_entropy_bf16_logits_take_an_f32_softmax():
    logits, lab, axis, kw = _ce_inputs("smoothing_weight_ignore", seed=1)
    lb = torch.tensor(logits).bfloat16()
    ref = np.asarray(jops.cross_entropy_loss.raw(
        jnp.asarray(lb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(lab), weight=jnp.asarray(kw["weight"]),
        ignore_index=kw["ignore_index"], label_smoothing=0.2))
    mine = tF.cross_entropy(lb, torch.tensor(lab),
                            weight=torch.tensor(kw["weight"]),
                            ignore_index=kw["ignore_index"],
                            label_smoothing=0.2)
    assert mine.dtype == torch.float32
    np.testing.assert_allclose(mine.numpy(), ref, rtol=CE_TOL, atol=CE_TOL)


@pytest.mark.parametrize("axis", [0, 1])
def test_cross_entropy_hard_labels_off_the_last_axis(axis):
    """Hard labels without smoothing at axis != -1: the JAX op's
    ``take_along_axis(logp, safe[..., None], axis)`` broadcasts the index
    there instead of picking (ROADMAP.md queue 3), so the port is held
    against the JAX op on the logits with the class axis moved last."""
    r = np.random.RandomState(axis)
    shape = (5, 4) if axis == 0 else (3, 5, 4)
    logits = r.randn(*shape).astype(np.float32)
    lab = r.randint(0, 5, tuple(s for i, s in enumerate(shape) if i != axis))
    lab[0] = 2
    ref = np.asarray(jops.cross_entropy_loss.raw(
        jnp.moveaxis(jnp.asarray(logits), axis, -1), jnp.asarray(lab),
        ignore_index=2, reduction="none"))
    mine = tF.cross_entropy(torch.tensor(logits), torch.tensor(lab),
                            ignore_index=2, reduction="none", axis=axis)
    np.testing.assert_allclose(mine.numpy(), ref, rtol=CE_TOL, atol=CE_TOL)


def test_cross_entropy_use_softmax_false_raises():
    x = torch.zeros(2, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tF.cross_entropy(x, torch.tensor([0, 1]), use_softmax=False)
    with pytest.raises(ValueError, match="reduction"):
        tF.cross_entropy(x, torch.tensor([0, 1]), reduction="avg")


def _qkv(B=2, S=24, H=4, D=16, Sk=None, seed=0):
    r = np.random.RandomState(seed)
    Sk = Sk or S
    return (r.randn(B, S, H, D).astype(np.float32),
            r.randn(B, Sk, H, D).astype(np.float32),
            r.randn(B, Sk, H, D).astype(np.float32))


@pytest.mark.parametrize("mask,causal", [
    ("none", False), ("none", True), ("bool", False), ("bool", True),
    ("additive", False), ("additive", True)])
def test_scaled_dot_product_attention_matches_jax(mask, causal):
    """Without a mask the port runs K1/K2 (the plain version here) with
    the bottom-right causal rule; with a bool (True = attend) or additive
    mask it runs the JAX formula in torch ops. Rectangular Sq < Sk, so
    every row sees a key."""
    q, k, v = _qkv(Sk=40, seed=1)
    r = np.random.RandomState(2)
    am = None
    if mask == "bool":
        am = r.rand(2, 1, 24, 40) > 0.3
        am[..., -1] = True                  # every row sees a key
    elif mask == "additive":
        am = (r.randn(1, 4, 24, 40) * 2).astype(np.float32)
    ref = np.asarray(jops.scaled_dot_product_attention.raw(
        *(jnp.asarray(t) for t in (q, k, v)),
        attn_mask=None if am is None else jnp.asarray(am),
        is_causal=causal))
    mine = tF.scaled_dot_product_attention(
        *(torch.tensor(t) for t in (q, k, v)),
        attn_mask=None if am is None else torch.tensor(am),
        is_causal=causal)
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0, atol=ATTN_TOL)


def test_scaled_dot_product_attention_dropout():
    """In training, dropout_p needs a generator or a seed and runs the
    kernels' Philox mask (the plain version here: the same output as
    ``flash_attention`` with that seed); not in training it is off; with
    a mask it drops by the same mask (an all-True mask: K1's output with
    that seed, 1e-6)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    q, k, v = (torch.tensor(t) for t in _qkv(seed=3))
    out = tF.scaled_dot_product_attention(q, k, v, dropout_p=0.2,
                                          is_causal=True, seed=9)
    assert torch.equal(out, K1.flash_attention_fwd(q, k, v, True,
                                                   dropout=0.2, seed=9))
    assert torch.equal(
        tF.scaled_dot_product_attention(q, k, v, dropout_p=0.2,
                                        training=False),
        K1.flash_attention_fwd(q, k, v))
    with pytest.raises(ValueError, match="generator"):
        tF.scaled_dot_product_attention(q, k, v, dropout_p=0.2)
    masked = tF.scaled_dot_product_attention(
        q, k, v, attn_mask=torch.ones(24, 24, dtype=torch.bool),
        dropout_p=0.2, seed=1)
    torch.testing.assert_close(masked, K1.flash_attention_fwd(
        q, k, v, dropout=0.2, seed=1), rtol=0, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax(causal):
    q, k, v = _qkv(seed=4)
    ref, soft = jF.flash_attention(*(paddle.to_tensor(t) for t in (q, k, v)),
                                   causal=causal, return_softmax=True)
    mine, tsoft = tF.flash_attention(*(torch.tensor(t) for t in (q, k, v)),
                                     causal=causal, return_softmax=True)
    assert soft is None and tsoft is None
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref._value), rtol=0,
                               atol=ATTN_TOL)
    with pytest.raises(NotImplementedError, match="fixed_seed_offset"):
        tF.flash_attention(*(torch.tensor(t) for t in (q, k, v)),
                           fixed_seed_offset=torch.tensor([1, 2]))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_unpadded_matches_jax(causal):
    """A pack whose q holds each sequence's tail (its own boundaries): K1/K2
    with the per-sequence frontiers against the JAX dense path."""
    r = np.random.RandomState(5)
    cu_q, cu_k = np.array([0, 6, 16, 20]), np.array([0, 10, 30, 36])
    q = r.randn(20, 2, 16).astype(np.float32)
    k, v = (r.randn(36, 2, 16).astype(np.float32) for _ in range(2))
    ref, _ = jF.flash_attn_unpadded(
        *(paddle.to_tensor(t) for t in (q, k, v)), cu_q, cu_k, 10, 20,
        causal=causal)
    mine, soft = tF.flash_attn_unpadded(
        *(torch.tensor(t) for t in (q, k, v)), cu_q, cu_k, 10, 20,
        causal=causal)
    assert soft is None
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref._value), rtol=0,
                               atol=ATTN_TOL)


@pytest.mark.parametrize("padding_idx", [None, 3, -2])
def test_embedding_matches_jax(padding_idx):
    """The functional zeroes positions holding ``padding_idx`` (as given);
    the layer normalises a negative one and zeroes its row at init; the
    gradient of a padding position is 0. Weights carried by
    load_jax_state_dict (no transpose: not an nn.Linear) and back."""
    paddle.seed(3)
    jemb = jnn.Embedding(10, 4, padding_idx=padding_idx)
    temb = Embedding(10, 4, padding_idx=padding_idx, device="cpu")
    state = {"weight": np.asarray(jemb.weight._value)}
    load_jax_state_dict(temb, state)
    np.testing.assert_array_equal(export_jax_state_dict(temb)["weight"],
                                  state["weight"])
    ids = np.array([[1, 3, 8], [3, 0, 9]])
    g = np.random.RandomState(4).randn(2, 3, 4).astype(np.float32)
    jout = jemb(paddle.to_tensor(ids))
    (jout * paddle.to_tensor(g)).sum().backward()
    tout = temb(torch.tensor(ids))
    (tout * torch.tensor(g)).sum().backward()
    np.testing.assert_array_equal(tout.detach().numpy(),
                                  np.asarray(jout._value))
    np.testing.assert_allclose(temb.weight.grad.numpy(),
                               np.asarray(jemb.weight.grad._value), rtol=0,
                               atol=1e-6)
    w = np.random.RandomState(6).randn(10, 4).astype(np.float32)
    ref = np.asarray(jops.embedding(jnp.asarray(ids), jnp.asarray(w),
                                    padding_idx=padding_idx))
    mine = tF.embedding(torch.tensor(ids), torch.tensor(w),
                        padding_idx=padding_idx).numpy()
    np.testing.assert_array_equal(mine, ref)


def test_embedding_weight_attr_raises():
    with pytest.raises(NotImplementedError, match="ParamAttr"):
        Embedding(4, 2, weight_attr=object(), device="cpu")


def test_embedding_defaults_to_the_card_and_raises_without_one():
    """Embedding runs on CUDA unless the caller names another device, as
    every entry point of the port: with no card and no device it raises,
    and never quietly lands on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is served")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Embedding(4, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Embedding(4, 2, sparse=True)
    assert Embedding(4, 2, device="cpu").weight.device.type == "cpu"

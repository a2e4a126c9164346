"""The port's ``FusedMultiHeadAttention`` and ``FusedFeedForward``
(``paddle_tpu_torch.incubate.nn``) held against the JAX layers on the
CPU, fp32: weights built by the JAX layer and carried across untransposed
by ``convert.load_jax_state_dict`` (raw ``[in, out]`` parameters), then
the output and the input and parameter gradients at dropout 0 within
1e-5, pre- and post-LN. In train mode with dropout on, the layers' masks
are checked against what their own generators draw: attention dropout
against the written-out formula on the Philox mask of the seed the layer
draws, and the FFN's dropout by its keep rate (5 sigma).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.layer import fused_transformer as jft
from paddle_tpu_torch.convert import (export_jax_state_dict,
                                      load_jax_state_dict)
from paddle_tpu_torch.incubate.nn import (FusedFeedForward,
                                          FusedMultiHeadAttention)
from paddle_tpu_torch.ops.kernels import dropout_mask as DM

TOL = 1e-5


def _state(layer):
    return {k: np.asarray(v._value) for k, v in layer.state_dict().items()}


def _perturbed(state, seed):
    """The JAX layer's weights with its zero biases and unit scales made
    random, so every parameter enters the comparison."""
    r = np.random.RandomState(seed)
    return {k: (v + 0.1 * r.randn(*v.shape)).astype(np.float32)
            for k, v in state.items()}


def _grads_jax(layer, x, loss_w):
    xt = paddle.to_tensor(x, stop_gradient=False)
    out = layer(xt)
    (out * paddle.to_tensor(loss_w)).sum().backward()
    grads = {n: np.asarray(p.grad._value)
             for n, p in layer.named_parameters() if p.grad is not None}
    return np.asarray(out._value), np.asarray(xt.grad._value), grads


def _grads_port(layer, x, loss_w):
    xt = torch.tensor(x, requires_grad=True)
    out = layer(xt)
    (out * torch.tensor(loss_w)).sum().backward()
    grads = {n: p.grad.numpy() for n, p in layer.named_parameters()
             if p.grad is not None}
    return out.detach().numpy(), xt.grad.numpy(), grads


def _compare(jl, tl, x):
    w = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    jo, jx, jgr = _grads_jax(jl, x, w)
    to, tx, tgr = _grads_port(tl, x, w)
    np.testing.assert_allclose(to, jo, rtol=0, atol=TOL)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=TOL)
    assert set(tgr) == set(jgr)
    for k in jgr:
        np.testing.assert_allclose(tgr[k], jgr[k], rtol=0, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("pre_ln", [True, False])
def test_fused_multi_head_attention_matches_jax(pre_ln):
    paddle.seed(1)
    jl = jft.FusedMultiHeadAttention(64, 4, dropout_rate=0.0,
                                     attn_dropout_rate=0.0,
                                     normalize_before=pre_ln)
    state = _perturbed(_state(jl), 2)
    jl.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    tl = FusedMultiHeadAttention(64, 4, dropout_rate=0.0,
                                 attn_dropout_rate=0.0,
                                 normalize_before=pre_ln, device="cpu")
    load_jax_state_dict(tl, state)
    exported = export_jax_state_dict(tl)
    for k, v in state.items():
        np.testing.assert_array_equal(exported[k], v, err_msg=k)
    x = np.random.RandomState(3).randn(2, 24, 64).astype(np.float32)
    _compare(jl, tl, x)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("pre_ln", [True, False])
def test_fused_feed_forward_matches_jax(activation, pre_ln):
    paddle.seed(4)
    jl = jft.FusedFeedForward(64, 160, dropout_rate=0.0,
                              activation=activation,
                              normalize_before=pre_ln)
    state = _perturbed(_state(jl), 5)
    jl.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    tl = FusedFeedForward(64, 160, dropout_rate=0.0, activation=activation,
                          normalize_before=pre_ln, device="cpu")
    load_jax_state_dict(tl, state)
    x = np.random.RandomState(6).randn(3, 10, 64).astype(np.float32)
    _compare(jl, tl, x)


def test_attention_dropout_in_train_mode_is_the_drawn_mask():
    """Train mode, attn_dropout_rate 0.3: the output equals softmax(S) o M /
    (1 - p) @ V through the rest of the block, M the Philox mask of the
    seed the layer's CPU generator draws (seed + 2718); its keep rate lies
    within 5 sigma of 0.7; eval mode drops nothing."""
    E, H, B, S, p = 64, 4, 2, 32, 0.3
    tl = FusedMultiHeadAttention(E, H, dropout_rate=0.0,
                                 attn_dropout_rate=p, normalize_before=True,
                                 device="cpu", seed=11)
    x = torch.randn(B, S, E, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = tl(x)
        seed = DM.draw_seed(torch.Generator().manual_seed(11 + 2718))
        keep = DM.dropout_keep(seed, p, B, H, S, S)
        ln = torch.nn.functional.layer_norm(x, (E,), tl.pre_ln_scale,
                                            tl.pre_ln_bias, 1e-5)
        qkv = (ln @ tl.qkv_weight + tl.qkv_bias).reshape(B, S, H, 3 * 16)
        q, k, v = qkv.split(16, -1)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(16)
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          float("-inf"))
        prob = torch.softmax(s, -1) * keep / (1 - p)
        att = torch.einsum("bhqk,bkhd->bqhd", prob, v).reshape(B, S, E)
        ref = x + att @ tl.linear_weight + tl.linear_bias
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=TOL)
    tril = torch.ones(S, S, dtype=torch.bool).tril()
    n = int(tril.sum()) * B * H
    rate = (keep & tril).sum().item() / n
    assert abs(rate - (1 - p)) <= 5 * math.sqrt(p * (1 - p) / n)
    tl.eval()
    plain = FusedMultiHeadAttention(E, H, dropout_rate=0.0,
                                    attn_dropout_rate=0.0,
                                    normalize_before=True, device="cpu",
                                    seed=11)
    with torch.no_grad():
        assert torch.equal(tl(x), plain(x))


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_feed_forward_keep_rate_in_train_mode(p):
    """linear1 = linear2 = I, biases 0, ln1 giving all ones (scale 0, bias
    1), relu: out - src is the activation dropout's mask / (1 - p) (the
    second dropout off): its keep rate within 5 sigma of 1 - p; eval mode
    gives out - src = 1."""
    d = 128
    tl = FusedFeedForward(d, d, dropout_rate=0.0, act_dropout_rate=p,
                          normalize_before=True, device="cpu", seed=3)
    with torch.no_grad():
        for name in ("linear1_weight", "linear2_weight"):
            getattr(tl, name).copy_(torch.eye(d))
        tl.ln1_scale.zero_()
        tl.ln1_bias.fill_(1.0)
        src = torch.randn(8, 64, d)
        delta = tl(src) - src
        kept = delta != 0
        n = kept.numel()
        assert torch.allclose(delta[kept], torch.full_like(delta[kept],
                                                           1 / (1 - p)))
        rate = kept.double().mean().item()
        assert abs(rate - (1 - p)) <= 5 * math.sqrt(p * (1 - p) / n)
        torch.testing.assert_close(tl.eval()(src) - src,
                                   torch.ones_like(src))


def test_unported_knobs_raise():
    with pytest.raises(RuntimeError, match="kdim"):
        FusedMultiHeadAttention(64, 4, kdim=32, device="cpu")
    with pytest.raises(RuntimeError, match="item 2.2"):
        FusedMultiHeadAttention(64, 4, qkv_weight_attr=object(),
                                device="cpu")
    with pytest.raises(RuntimeError, match="queue 3"):
        FusedFeedForward(64, 128, nranks=2, device="cpu")
    layer = FusedMultiHeadAttention(64, 4, device="cpu")
    x = torch.zeros(1, 4, 64)
    with pytest.raises(RuntimeError, match="attn_mask"):
        layer(x, attn_mask=torch.zeros(4, 4))
    with pytest.raises(RuntimeError, match="attn_mask"):
        layer(x, key=torch.zeros(1, 4, 64))
    assert layer(x, key=x, value=x).shape == (1, 4, 64)


def test_functional_fused_multi_transformer_dropout_in_training():
    """The functional stack's dropout (the JAX function's placement: each
    block's output before its residual): p = 1 drops both blocks, so a
    pre-LN stack returns its input; a seeded generator replays; eval is
    the dropout-free stack."""
    from paddle_tpu_torch.incubate.nn import functional as tif

    L, h, f = 2, 32, 48
    r = np.random.RandomState(0)
    def w(*s):
        return torch.tensor(0.2 * r.randn(*s), dtype=torch.float32)

    kw = dict(ln_scales=[1 + w(h) for _ in range(L)],
              ln_biases=[w(h) for _ in range(L)],
              qkv_weights=[w(h, 3 * h) for _ in range(L)],
              qkv_biases=[w(3 * h) for _ in range(L)],
              linear_weights=[w(h, h) for _ in range(L)],
              linear_biases=[w(h) for _ in range(L)],
              ffn_ln_scales=[1 + w(h) for _ in range(L)],
              ffn_ln_biases=[w(h) for _ in range(L)],
              ffn1_weights=[w(h, f) for _ in range(L)],
              ffn1_biases=[w(f) for _ in range(L)],
              ffn2_weights=[w(f, h) for _ in range(L)],
              ffn2_biases=[w(h) for _ in range(L)],
              trans_qkvw=False, num_heads=4)
    x = w(2, 5, h)
    assert torch.equal(tif.fused_multi_transformer(
        x, **kw, dropout_rate=1.0, training=True), x)
    run = lambda s: tif.fused_multi_transformer(  # noqa: E731
        x, **kw, dropout_rate=0.4, training=True,
        generator=torch.Generator().manual_seed(s))
    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    plain = tif.fused_multi_transformer(x, **kw)
    assert torch.equal(tif.fused_multi_transformer(
        x, **kw, dropout_rate=0.4, training=False), plain)
    assert not torch.equal(run(3), plain)

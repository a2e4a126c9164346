"""``nn.functional.scaled_dot_product_attention`` with a mask and
dropout, held against the JAX op on the CPU.

The JAX op (``paddle_tpu/ops/nn_ops.py:671-705``) draws its keep mask
from ``jax.random``; the port draws the kernels' Philox mask
(``ops/kernels/dropout_mask.py``), so the two packages never drop the
same elements. The dropout cases therefore evaluate the JAX op's own
formula with ``jax.numpy`` on the port's keep mask: output within 1e-6
(f32), gradients (``jax.vjp``) within 1e-6 of each gradient's largest
magnitude. With ``dropout_p = 0`` the masked path is the JAX op within
the masked path's existing 2e-5 (``tests/test_torch_functional.py``)
and bit for bit the no-dropout call. An all-True mask drops what K1's
plain version drops with the same seed (1e-6), and the mask read back
through the path (uniform scores, identity V) is ``dropout_keep``'s bits,
kept at a rate within 4 binomial standard deviations of 1 - p. Inputs
come from a seeded numpy generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import nn_ops as jops
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.ops.kernels import dropout_mask as DM
from paddle_tpu_torch.ops.kernels import flash_attention as K1

P = 0.2
SEED = 0x5EED_0123_4567_89AB


def _inputs(causal, mask, B=2, S=24, Sk=40, H=4, D=16, seed=1):
    r = np.random.RandomState(seed)
    q = r.randn(B, S, H, D).astype(np.float32)
    k, v = (r.randn(B, Sk, H, D).astype(np.float32) for _ in range(2))
    am = None
    if mask == "bool":
        am = r.rand(B, 1, S, Sk) > 0.3
        am[..., -1] = True                  # every row sees a key
    elif mask == "additive":
        am = (r.randn(1, H, S, Sk) * 2).astype(np.float32)
    elif mask == "padding":                  # keys past each row's length
        lens = np.array([Sk - 7, Sk])
        am = np.arange(Sk)[None, None, None, :] < lens[:, None, None, None]
    return q, k, v, am


def _jax_formula(q, k, v, am, causal, keep, p):
    """The JAX op's steps (ops/nn_ops.py:682-705) in jax.numpy, dropping
    by ``keep`` [B, H, S, Sk] instead of a jax.random draw."""
    D = q.shape[-1]
    qf, kf, vf = (jnp.swapaxes(t, 1, 2) for t in (q, k, v))
    scores = jnp.einsum("bhqd,bhkd->bhqk", qf, kf) * (1.0 / np.sqrt(D))
    if causal:
        S, Sk = q.shape[1], k.shape[1]
        scores = jnp.where(jnp.tril(jnp.ones((S, Sk), bool), k=Sk - S),
                           scores, -jnp.inf)
    if am is not None:
        scores = (jnp.where(am, scores, -jnp.inf) if am.dtype == bool
                  else scores + am)
    probs = jax.nn.softmax(scores, axis=-1)
    if p:
        probs = jnp.where(keep, probs / (1.0 - p), jnp.zeros((), probs.dtype))
    out = jnp.einsum("bhqk,bhkd->bhqd", probs, vf)
    return jnp.swapaxes(out, 1, 2)


def _port(q, k, v, am, causal, p, **kw):
    t = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = tF.scaled_dot_product_attention(
        *t, attn_mask=None if am is None else torch.tensor(am),
        dropout_p=p, is_causal=causal, **kw)
    return t, out


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask", ["bool", "additive", "padding"])
def test_dropout_zero_is_the_jax_op(mask, causal):
    q, k, v, am = _inputs(causal, mask)
    ref = np.asarray(jops.scaled_dot_product_attention.raw(
        *(jnp.asarray(a) for a in (q, k, v)), attn_mask=jnp.asarray(am),
        is_causal=causal))
    _, out = _port(q, k, v, am, causal, 0.0)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=2e-5)
    _, plain = _port(q, k, v, am, causal, 0.0, training=False)
    assert torch.equal(out, plain)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask", ["bool", "additive", "padding"])
def test_dropout_is_the_jax_formula_on_the_ports_mask(mask, causal):
    q, k, v, am = _inputs(causal, mask)
    B, S, H, _ = q.shape
    keep = DM.dropout_keep(SEED, P, B, H, S, k.shape[1]).numpy()
    (tq, tk, tv), out = _port(q, k, v, am, causal, P, seed=SEED)
    ref, vjp = jax.vjp(lambda a, b, c: _jax_formula(
        a, b, c, None if am is None else jnp.asarray(am), causal,
        jnp.asarray(keep), P), *(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-6)
    g = np.random.RandomState(7).randn(*out.shape).astype(np.float32)
    out.backward(torch.tensor(g))
    for mine, want in zip((tq.grad, tk.grad, tv.grad),
                          vjp(jnp.asarray(g))):
        want = np.asarray(want)
        np.testing.assert_allclose(mine.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("causal", [False, True])
def test_all_true_mask_drops_what_k1_drops(causal):
    q, k, v, _ = _inputs(causal, None, Sk=24)
    am = np.ones((24, 24), bool)
    _, out = _port(q, k, v, am, causal, P, seed=SEED)
    want = K1.flash_attention_fwd(*(torch.tensor(a) for a in (q, k, v)),
                                  causal, dropout=P, seed=SEED)
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_mask_read_back_and_keep_rate(p):
    """Uniform scores (q = 0) over Sk keys and V the identity: each output
    element is keep * keep_scale(p) / Sk, so the path's mask reads back
    exactly; its keep rate lies within 4 standard deviations of 1 - p."""
    B, S, H, Sk = 2, 64, 4, 64
    q = torch.zeros(B, S, H, Sk)
    k = torch.randn(B, Sk, H, Sk, generator=torch.Generator().manual_seed(0))
    v = torch.eye(Sk)[None, :, None, :].expand(B, Sk, H, Sk).contiguous()
    am = torch.ones(B, 1, S, Sk, dtype=torch.bool)
    gen = torch.Generator().manual_seed(4)
    out = tF.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                          dropout_p=p, generator=gen)
    seed = DM.draw_seed(torch.Generator().manual_seed(4))
    keep = DM.dropout_keep(seed, p, B, H, S, Sk)
    got = out.transpose(1, 2) > 0.5 / Sk
    assert torch.equal(got, keep)
    n = keep.numel()
    rate = keep.float().mean().item()
    assert abs(rate - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n)
    again = tF.scaled_dot_product_attention(
        q, k, v, attn_mask=am, dropout_p=p,
        generator=torch.Generator().manual_seed(4))
    assert torch.equal(again, out)


def test_mask_and_dropout_need_a_seed_and_not_in_eval():
    q, k, v, am = _inputs(False, "bool")
    with pytest.raises(ValueError, match="generator"):
        _port(q, k, v, am, False, P)
    _, off = _port(q, k, v, am, False, P, training=False)
    _, plain = _port(q, k, v, am, False, 0.0)
    assert torch.equal(off, plain)

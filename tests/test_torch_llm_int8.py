"""The port's ``nn.quant.llm_int8_linear`` (K10's plain version on the
CPU) held against the JAX ``paddle_tpu.nn.quant.llm_int8_linear``.

Inputs are ``tests/test_weight_only_quant.py::_setup``'s (numpy seed 0:
w [64, 32] * 0.1, x [4, 64], a bias [32]), quantized once by the JAX
``weight_quantize(w, "llm.int8")`` and handed to both packages as numpy.
Cases: threshold 2.0 (8 of the 64 columns are outliers on these 4
rows), 6.0 (none) and 6.0 with 8 planted outlier columns; with and
without the bias; 2-D and 3-D x; fp32 and bf16. Tolerances: fp32 1e-5 of the output's
largest magnitude (the outlier term's f32 sum runs in another order in
the two packages); bf16 one bf16 step of that magnitude (2^-8, the same
sums rounded once to bf16). xq, the scales and the int32 product equal
the JAX formula's, rebuilt in numpy, exactly. The kernel's routing by
shape (``llm_int8_route``) and its outlier capacity are checked from the
shapes and the CUDA source alone.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.ops.kernels import llm_int8_linear as K10

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}


def _setup():
    rng = np.random.RandomState(0)
    w = (rng.randn(64, 32).astype("float32") * 0.1)
    x = rng.randn(4, 64).astype("float32")
    b = rng.randn(32).astype("float32")
    return w, x, b


def _case(outliers, leading):
    """x (numpy f32), q int8 [32, 64], scale f32 [32], bias, threshold."""
    w, x, b = _setup()
    jq, js = jnn.quant.weight_quantize(paddle.to_tensor(w), "llm.int8")
    q, s = np.asarray(jq._value), np.asarray(js._value)
    thr = 2.0
    if outliers != "many":
        thr = 6.0
        x = np.clip(x, -5.5, 5.5)
    if outliers == "planted":
        # 8 columns up to |20|, each with one entry of |20|
        cols = np.random.RandomState(1).permutation(64)[:8]
        x[:, cols] *= 20.0 / 5.5
        x[np.arange(8) % 4, cols] = np.where(np.arange(8) % 2, -20.0, 20.0)
    if leading == "3d":
        x = np.concatenate([x, x[::-1] * 0.5]).reshape(2, 4, 64)
    return x, q, s, b, thr


def _jax(x, q, s, b, thr, dtype):
    jx = paddle.to_tensor(x, dtype=dtype)
    jb = None if b is None else paddle.to_tensor(b)
    out = jnn.quant.llm_int8_linear(jx, paddle.to_tensor(q), jb,
                                    paddle.to_tensor(s), thr)
    return np.asarray(out._value.astype("float32"))


def _numpy_int8_half(x, q, thr):
    """The JAX function's int8 half, step by step in numpy (f32): the
    outlier columns, the per-row scales, xq and the int32 product."""
    xf = x.reshape(-1, x.shape[-1]).astype(np.float32)
    outlier = np.abs(xf).max(axis=0) > np.float32(thr)
    x_in = np.where(outlier, np.float32(0), xf)
    a_scale = np.maximum(np.abs(x_in).max(axis=-1, keepdims=True),
                         np.float32(1e-10)) / np.float32(127)
    xq = np.clip(np.round(x_in / a_scale), -127, 127).astype(np.int8)
    acc = xq.astype(np.int32) @ q.astype(np.int32).T
    return outlier, a_scale[:, 0], xq, acc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("leading", ["2d", "3d"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("outliers", ["many", "none", "planted"])
def test_llm_int8_linear_matches_jax(outliers, bias, leading, dtype):
    x, q, s, b, thr = _case(outliers, leading)
    b = b if bias else None
    ref = _jax(x, q, s, b, thr, dtype)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    mine = tq.llm_int8_linear(tx, torch.tensor(q),
                              None if b is None else torch.tensor(b),
                              torch.tensor(s), thr)
    assert mine.dtype == tx.dtype and mine.shape == ref.shape
    top = np.abs(ref).max()
    err = np.abs(mine.float().numpy() - ref).max()
    assert err <= TOL[dtype] * top, (err, top)
    # the int8 half exactly as the JAX formula computes it, in numpy
    xin = tx.float().numpy()
    outlier, a_scale, xq, acc = _numpy_int8_half(xin, q, thr)
    _, parts = K10.llm_int8_linear(tx, torch.tensor(q), torch.tensor(s),
                                   None, thr, parts=True)
    n = int(outlier.sum())
    assert n >= 4 if outliers == "many" else n == {"none": 0,
                                                  "planted": 8}[outliers]
    np.testing.assert_array_equal(parts["col_amax"].numpy() > thr, outlier)
    np.testing.assert_array_equal(parts["a_scale"].numpy(), a_scale)
    np.testing.assert_array_equal(parts["xq"].numpy(), xq)
    np.testing.assert_array_equal(parts["acc"].numpy(), acc)


def test_no_outlier_output_is_the_int8_half_exactly():
    """With no outlier column the output is (acc * a_scale) * scale +
    bias, rounded once: bit for bit the numpy formula's."""
    x, q, s, b, thr = _case("none", "2d")
    _, a_scale, _, acc = _numpy_int8_half(x, q, thr)
    want = (acc.astype(np.float32) * a_scale[:, None]) * s + b
    got = tq.llm_int8_linear(torch.tensor(x), torch.tensor(q),
                             torch.tensor(b), torch.tensor(s), thr)
    np.testing.assert_array_equal(got.numpy(), want)


def test_every_column_an_outlier_is_the_f32_product():
    """A threshold below every column's absmax leaves the int8 half all
    zero: the output is x against the dequantized weight in f32."""
    x, q, s, _, _ = _case("many", "2d")
    got = tq.llm_int8_linear(torch.tensor(x), torch.tensor(q), None,
                             torch.tensor(s), -1.0)
    want = x @ (q.astype(np.float32) * s[:, None]).T
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    ref = _jax(x, q, s, None, -1.0, "float32")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_k10_wrapper_checks_raise():
    x, q, s, b, _ = _case("none", "2d")
    tx, tq_, ts = torch.tensor(x), torch.tensor(q), torch.tensor(s)
    with pytest.raises(TypeError, match="2-D int8"):
        K10.llm_int8_linear(tx, tq_.float(), ts)
    with pytest.raises(ValueError, match="in_features"):
        K10.llm_int8_linear(tx[:, :60], tq_, ts)
    with pytest.raises(ValueError, match="in_features"):
        K10.llm_int8_linear(tx[:, :0], tq_[:, :0], ts)
    with pytest.raises(TypeError, match="weight_scale must be float32"):
        K10.llm_int8_linear(tx, tq_, ts.double())
    with pytest.raises(TypeError, match="weight_scale must be float32"):
        K10.llm_int8_linear(tx, tq_, None)
    with pytest.raises(TypeError, match="bias must be"):
        K10.llm_int8_linear(tx, tq_, ts, torch.zeros(31))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K10.llm_int8_linear(tx.half(), tq_, ts)
    with pytest.raises(ValueError, match="several devices"):
        K10.llm_int8_linear(tx, tq_, ts.to("meta"))


def test_plain_version_counts_no_launch():
    """The CPU route is the plain version: the kernel's counter stays."""
    x, q, s, b, thr = _case("planted", "2d")
    n = K10.llm_int8_linear.launches
    K10.llm_int8_linear(torch.tensor(x), torch.tensor(q), torch.tensor(s),
                        torch.tensor(b), thr)
    assert K10.llm_int8_linear.launches == n


@pytest.mark.parametrize("M, N, K, body", [
    (2048, 11008, 4096, "wgmma"),   # Llama-7B's prefill: gate / up
    (2048, 4096, 11008, "wgmma"),   # its down projection
    (8, 11008, 4096, "gemv"),       # a decode step
    (16, 11008, 4096, "gemv"),      # the gemv body's last row count
    (17, 11008, 4096, "wgmma"),     # and the first past it
    (8, 72, 200, "mma"),            # K % 16 != 0: no TMA, no 16-byte copy
    (2048, 130, 130, "mma"),
])
def test_llm_int8_route_by_shape(M, N, K, body):
    """The body K10 takes comes from the shapes alone: wgmma above 16 rows
    and gemv up to 16 where TMA and 16-byte copies can address the weight
    rows (K a multiple of 16), mma otherwise."""
    plan = K10.llm_int8_route(M, N, K)
    assert plan.body == body
    if body == "gemv":
        # the K slices are whole 64-byte blocks, cover K once, one cluster
        assert plan.ks % 64 == 0 and 1 <= plan.splits <= 8
        assert (plan.splits - 1) * plan.ks < K <= plan.splits * plan.ks
    else:
        assert (plan.splits, plan.ks) == (1, K)


@pytest.mark.parametrize("M", [8, 2048])
def test_llm_int8_route_unaligned_weight_takes_mma(M):
    """A weight that does not start on 16 bytes goes to the mma body at
    any row count: TMA and cp.async need 16-byte-aligned rows."""
    assert K10.llm_int8_route(M, 11008, 4096, aligned=False).body == "mma"


def test_llm_int8_route_tiles_at_llama_shapes():
    """The units of work each body's product walks at Llama-7B's widths."""
    tiles = {(M, N, K): K10.route_tiles(K10.llm_int8_route(M, N, K), M, N)
             for M, N, K in ((2048, 11008, 4096), (2048, 4096, 11008),
                             (8, 11008, 4096))}
    assert tiles == {(2048, 11008, 4096): 8 * 86,
                     (2048, 4096, 11008): 8 * 32,
                     (8, 11008, 4096): 86 * K10.llm_int8_route(
                         8, 11008, 4096).splits}


def test_llm_int8_capacity_matches_the_kernel_source():
    """The outlier columns the wrapper allocates x_out / w_out for equal
    the capacity the kernel's source states (kOutCap), read from the
    source text: a mismatch would make the kernel write past the
    buffers."""
    from pathlib import Path
    import re
    src = (Path(K10.__file__).resolve().parents[2] / "csrc"
           / "llm_int8_linear.cu").read_text()
    cap = re.search(r"constexpr int kOutCap = (\d+);", src)
    assert cap and int(cap.group(1)) == K10.CAPACITY

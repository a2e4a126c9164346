"""The port's int8 / int4 weight-only serving held against the JAX package
on the CPU.

``nn.quant`` (``weight_quantize``, ``_unpack_int4``, ``weight_dequantize``,
``weight_only_linear``, ``WeightOnlyLinear``, ``quantize_for_serving``)
runs seeded numpy inputs through both packages: quantized bytes and scale
bits must be equal, the linear's plain version (what K9's wrapper runs on
CPU tensors) within 1e-5 relative in f32 and one bf16 ulp of the output's
largest magnitude in bf16 (the two sums run in different orders). Then
``llama_tiny`` weights built by the JAX package are carried across with
``convert.load_jax_state_dict`` and served with
``Config.enable_weight_only``: ``Predictor.generate`` (static and paged)
and a ``ServingEngine`` schedule must commit the JAX package's greedy
tokens, int8 and int4. The quantized state travels both ways through
``convert`` bit for bit. The kernel itself runs on the card
(tests/test_torch_weight_only_card.py).
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.inference import create_predictor as jax_predictor
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.nn import quant as jq
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import export_jax_state_dict, load_jax_state_dict
from paddle_tpu_torch.inference import Config, ServingEngine, create_predictor
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.ops.kernels import weight_only_linear as K9

ALGOS = ["weight_only_int8", "weight_only_int4"]
F32_TOL = 1e-5


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def _weight(seed, n_in=64, n_out=48):
    """[in, out] f32 with a zero output column and a column of exact
    rounding ties (max 127 -> scale 1: 0.5, 1.5, 2.5, -0.5, -2.5 round half
    to even)."""
    w = np.random.RandomState(seed).randn(n_in, n_out).astype(np.float32)
    w[:, 3] = 0.0
    w[:, 7] = 0.0
    w[:5, 7] = [0.5, 1.5, 2.5, -0.5, -2.5]
    w[5, 7] = 127.0
    return w


# ---------------------------------------------------------------------------
# the functions of nn.quant
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", ALGOS)
def test_weight_quantize_bit_equal(algo, dtype):
    w = _weight(0)
    jw = jnp.asarray(w).astype(jnp.dtype(dtype))
    tw = torch.tensor(w).to(getattr(torch, dtype))
    jqv, jsv = jq.weight_quantize(jw, algo)
    q, s = tq.weight_quantize(tw, algo)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    n_in = w.shape[0]
    assert tuple(q.shape) == (48, n_in // 2 if algo.endswith("int4")
                              else n_in)
    np.testing.assert_array_equal(q.numpy(), _np(jqv))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  _np(jsv).view(np.uint32))
    assert s[3] == 0 and not q[3].any()        # the zero column


def test_unpack_int4_all_bytes_match_jax():
    packed = np.arange(-128, 128, dtype=np.int16).astype(np.int8)
    packed = packed.reshape(16, 16)
    ours = tq._unpack_int4(torch.tensor(packed))
    ref = _np(jq._unpack_int4(jnp.asarray(packed)))
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert ours.dtype == torch.int8 and ours.min() == -8 and ours.max() == 7


@pytest.mark.parametrize("algo", ALGOS)
def test_weight_dequantize_matches_jax(algo):
    q, s = jq.weight_quantize(jnp.asarray(_weight(1)), algo)
    ref = _np(jq.weight_dequantize(q, s, algo, "float32"))
    ours = tq.weight_dequantize(torch.tensor(_np(q)), torch.tensor(_np(s)),
                                algo, "float32")
    np.testing.assert_array_equal(ours.numpy(), ref)


def _bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("xshape", [(5, 64), (2, 3, 64)], ids=["2d", "3d"])
@pytest.mark.parametrize("algo", ALGOS)
def test_weight_only_linear_plain_matches_jax(algo, xshape, bias, dtype):
    r = np.random.RandomState(2)
    x = r.randn(*xshape).astype(np.float32)
    b = r.randn(48).astype(np.float32) if bias else None
    q, s = jq.weight_quantize(jnp.asarray(_weight(3)), algo)
    wd = "int4" if algo.endswith("int4") else "int8"
    jdt = jnp.dtype(dtype)
    ref = _np(jq.weight_only_linear(
        jnp.asarray(x).astype(jdt), q,
        None if b is None else jnp.asarray(b).astype(jdt), s, wd))
    tdt = getattr(torch, dtype)
    ours = tq.weight_only_linear(
        torch.tensor(x).to(tdt), torch.tensor(_np(q)),
        None if b is None else torch.tensor(b).to(tdt),
        torch.tensor(_np(s)), wd)
    assert ours.dtype == tdt and tuple(ours.shape) == xshape[:-1] + (48,)
    got = ours.float().numpy()
    ref = ref.astype(np.float32)
    top = np.abs(ref).max()
    err = np.abs(got - ref).max()
    if dtype == "float32":
        assert err <= F32_TOL * top
    else:
        assert err <= _bf16_ulp(top)


def test_weight_only_layer_skips_autocast():
    """The JAX op sits outside the AMP hook: an f32 input stays f32."""
    lin = torch.nn.Linear(16, 8, bias=True)
    wl = tq.WeightOnlyLinear(lin)
    x = torch.randn(2, 16)
    with amp.auto_cast(level="O1"):
        y = wl(x)
    assert y.dtype == torch.float32
    assert wl.bias is lin.bias
    assert not wl.weight_quant.requires_grad
    assert not wl.weight_scale.requires_grad


# ---------------------------------------------------------------------------
# quantize_for_serving on llama_tiny
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fp_state():
    paddle.seed(11)
    jm = JaxLlama(jax_tiny())
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _pair(fp_state):
    """A fresh JAX llama_tiny and the port's, with the same weights."""
    jm = JaxLlama(jax_tiny())
    jm.set_state_dict(fp_state)
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_state_dict(tm, fp_state)
    return jm, tm


def _quantized_names(model, cls):
    return sorted(n for n, m in model.named_modules() if isinstance(m, cls)) \
        if isinstance(model, torch.nn.Module) else sorted(
            n for n, m in model.named_sublayers() if isinstance(m, cls))


@pytest.mark.parametrize("skip", [("lm_head",), ("lm_head", "mlp")],
                         ids=["head", "head_mlp"])
@pytest.mark.parametrize("algo", ALGOS)
def test_quantize_for_serving_swaps_like_jax(fp_state, algo, skip):
    jm, tm = _pair(fp_state)
    jq.quantize_for_serving(jm, algo, skip)
    tq.quantize_for_serving(tm, algo, skip)
    names = _quantized_names(tm, tq.WeightOnlyLinear)
    assert names == _quantized_names(jm, jq.WeightOnlyLinear)
    per_layer = 4 if "mlp" in skip else 7
    assert len(names) == per_layer * llama_tiny().num_layers
    assert not any(s in n for n in names for s in skip)
    jstate = {k: _np(v) for k, v in jm.state_dict().items()}
    tstate = export_jax_state_dict(tm)
    assert list(tstate) == list(jstate)
    for k, v in jstate.items():
        assert tstate[k].dtype == v.dtype, k
        np.testing.assert_array_equal(tstate[k], v, err_msg=k)


def test_int4_odd_in_features_warns_and_keeps_full_precision():
    m = torch.nn.Sequential(torch.nn.Linear(7, 4), torch.nn.Linear(4, 6))
    jm = jnn.Sequential(jnn.Linear(7, 4), jnn.Linear(4, 6))
    for mod, quant in ((m, tq), (jm, jq)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            quant.quantize_for_serving(mod, "weight_only_int4")
        assert any("odd in_features 7" in str(x.message) for x in w)
    assert type(m[0]) is torch.nn.Linear
    assert isinstance(m[1], tq.WeightOnlyLinear)
    assert isinstance(jm[1], jq.WeightOnlyLinear)


def test_unsupported_requests_raise():
    with pytest.raises(ValueError, match="weight_only_int8"):
        Config().enable_weight_only("llm.int8")
    with pytest.raises(ValueError, match="weight_only_int8"):
        JaxConfig().enable_weight_only("llm.int8")
    x = torch.zeros(2, 8)
    q, s = tq.weight_quantize(torch.ones(8, 4))
    with pytest.raises(NotImplementedError, match="group_size"):
        tq.weight_only_linear(x, q, None, s, group_size=64)
    with pytest.raises(NotImplementedError, match="group_size"):
        tq.weight_quantize(torch.ones(8, 4), group_size=64)
    assert tq.llm_int8_linear(x, q, None, s).shape == (2, 4)
    with pytest.raises(TypeError, match="weight_scale"):
        tq.llm_int8_linear(x, q)


def test_k9_wrapper_checks_raise():
    x = torch.zeros(2, 8)
    q, s = tq.weight_quantize(torch.ones(8, 4))
    with pytest.raises(TypeError, match="scale must be float32"):
        K9.weight_only_linear(x, q, s.to(torch.bfloat16))
    with pytest.raises(ValueError, match="even input dimension"):
        K9.weight_only_linear(torch.zeros(2, 7), q[:, :3], s, None, True)
    with pytest.raises(ValueError, match="covers"):
        K9.weight_only_linear(torch.zeros(2, 6), q, s)
    with pytest.raises(TypeError, match="int8"):
        K9.weight_only_linear(x, q.float(), s)
    with pytest.raises(ValueError, match="several devices"):
        K9.weight_only_linear(x, q, s.to("meta"))
    n = K9.weight_only_linear.launches
    K9.weight_only_linear(x, q, s)             # CPU: the plain version
    assert K9.weight_only_linear.launches == n


SMEM_CAP = 232448          # dynamic shared memory a block may take (227 KB)
K9_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4128, 200),
             (200, 72), (65536, 256))  # (K, N): the main path's three, a
# TMA edge, ragged, and a K whose gemv slices stage x in several windows


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_k9_routes_cover_k_and_fit(int4):
    """The wrapper's plan, from the shapes and the pointers' alignment:
    bf16 M > 16 takes the wgmma body wherever TMA can address the
    operands (K a multiple of 16 weights int8 / 32 int4, 16-byte-aligned
    x and weight) and the tile body elsewhere; bf16 M <= 16 the gemv
    body; f32 the fma body. The slices of gemv and fma cover K once in
    whole steps; gemv takes at most 8, one cluster a column block of
    128 (route_grid and route_cluster describe that launch), stages x in
    windows of at most 48 KB and launches one kernel; fma stays within
    96 KB of staged x a block and adds its slices in a second kernel.
    Every route's dynamic shared memory fits the 227 KB a block may
    take, and its grid covers M and N."""
    w = 32 if int4 else 16
    for M in (1, 3, 8, 9, 16, 17, 100, 300, 2048, 8192):
        for K, N in K9_SHAPES:
            for dt in (torch.bfloat16, torch.float32):
                r = K9.weight_only_route(M, N, K, int4, dt)
                assert K9.route_smem(r, int4) <= SMEM_CAP
                gx, gy, gz = K9.route_grid(r, M, N)
                if dt == torch.bfloat16 and M > 16:
                    want = "wgmma" if K % w == 0 else "tile"
                    assert r.body == want, (M, K, N, r)
                    assert r.rows == (256 if want == "wgmma" else 128)
                    assert K9.weight_only_route(M, N, K, int4, dt,
                                                False).body == "tile"
                    if r.body == "tile":
                        assert gx * 128 >= N and gy * 128 >= M and gz == 1
                    else:
                        assert gx == -(-M // 256) * -(-N // 128)
                        assert (gy, gz) == (1, 1)
                    continue
                if dt == torch.bfloat16:
                    assert r.body == "gemv" and r.rows == (8 if M <= 8
                                                           else 16)
                    step = 4 * w
                    # the cp.async ring (6 blocks of 4 16-byte pieces a
                    # thread), then the x window, whose room later takes
                    # the f32 partial sums
                    window = min(r.ks // step,
                                 48 * 1024 // (r.rows * step * 2))
                    smem = 6 * 4 * 128 * 16 + max(
                        r.rows * (window * step + 8) * 2, r.rows * 132 * 4)
                    assert window * r.rows * step * 2 <= 48 * 1024
                    assert 1 <= r.splits <= 8
                    assert gx * 128 >= N > (gx - 1) * 128 and gz == 1
                    assert K9.route_cluster(r) == (1, r.splits, 1)
                    assert K9.route_kernels(r) == 1
                else:
                    assert r.body == "fma" and r.rows in (1, 4, 8, 16)
                    step = 32 * w
                    smem = r.rows * (r.ks // w) * (w + 4) * 4
                    cols = 4 * (4 if r.rows >= 16 else 8)
                    assert gx * cols >= N and gz * r.rows >= M
                    assert smem <= 96 * 1024 or r.ks == step
                    assert K9.route_cluster(r) == (1, 1, 1)
                    assert K9.route_kernels(r) == (2 if r.splits > 1
                                                   else 1)
                assert gy == r.splits and K9.route_smem(r, int4) == smem
                assert r.rows >= min(M, 16) and r.ks % step == 0
                assert r.splits * r.ks >= K > (r.splits - 1) * r.ks
    # the decode shapes: the split count with the least waves x (k blocks
    # a slice + 8), a wave the blocks the SMs hold at the launch's shared
    # memory; at 16 rows the larger x window leaves 2 blocks an SM, so 8
    # slices of K = 11008 would need a second wave
    r = K9.weight_only_route(16, 4096, 11008, False, torch.bfloat16)
    assert (r.body, r.rows, r.splits, r.ks) == ("gemv", 16, 7, 1600)
    r = K9.weight_only_route(8, 4096, 4096, False, torch.bfloat16)
    assert (r.body, r.rows, r.splits, r.ks) == ("gemv", 8, 8, 512)
    r = K9.weight_only_route(8, 11008, 4096, False, torch.bfloat16)
    assert (r.body, r.rows, r.splits, r.ks) == ("gemv", 8, 4, 1024)
    r = K9.weight_only_route(8, 4096, 11008, False, torch.bfloat16)
    assert (r.body, r.rows, r.splits, r.ks) == ("gemv", 8, 8, 1408)
    r = K9.weight_only_route(8, 4096, 4096, False, torch.float32)
    assert (r.body, r.rows, r.splits, r.ks) == ("fma", 8, 4, 1024)
    # the TMA edge: 16 weights a row more than a multiple of 64 still
    # routes to wgmma; 8 more (int8: 8 bytes) does not
    assert K9.weight_only_route(300, 200, 4112, int4,
                                torch.bfloat16).body == ("tile" if int4
                                                         else "wgmma")
    assert K9.weight_only_route(300, 200, 4104, int4,
                                torch.bfloat16).body == "tile"


def _gemv_int8_group(word, i):
    """group_f32<false>: the 4 signed bytes of a word as floats, through
    the 2^23 magic number (byte ^ 0x80 in the low mantissa bits, minus
    2^23 + 128), k 4i .. 4i + 3 of the lane's 16 bytes."""
    u = int(word) ^ 0x80808080
    mag = np.array([0x4B000000 | ((u >> (8 * b)) & 0xFF) for b in range(4)],
                   np.uint32).view(np.float32)
    return mag - np.float32(8388736.0)


def _gemv_int4_pair(u):
    """pair_s4: the low nibbles of bytes 0 and 2 of u as bf16 (128 + (s ^
    8)), minus 136 (exact in bf16)."""
    bits = np.array([(((u >> s) & 0xF) ^ 0x8) | 0x4300 for s in (0, 16)],
                    np.uint32) << 16
    return bits.view(np.float32) - np.float32(136.0)


def _gemv_block_emulated(rows, x, int4):
    """What one warp's 16-row tile accumulates over one k block in
    gemv_block: every lane's A fragments (its 16 bytes of rows g and g + 8,
    converted as the kernel does) and B fragments (its x values, permuted
    as the kernel does) placed by mma.sync m16n8k16's layout (a0 = A[g][2t,
    2t + 1], a1 = A[g + 8][...], a2 = A[g][2t + 8, 2t + 9], a3 = A[g + 8]
    [...]; b0 = B[2t, 2t + 1][g], b1 = B[2t + 8, 2t + 9][g]) and
    multiplied step by step."""
    kb = 128 if int4 else 64
    d = np.zeros((16, 8))
    for step in range(kb // 16):
        a_mat, b_mat = np.zeros((16, 16)), np.zeros((16, 8))
        for lane in range(32):
            g, t = divmod(lane, 4)
            w0, w1 = (np.frombuffer(rows[r, 16 * t:16 * t + 16].tobytes(),
                                    "<u4") for r in (g, g + 8))
            xl = x[g, kb // 4 * t:kb // 4 * (t + 1)]  # lane-local k
            if int4:
                hs, e = divmod(step, 2)
                u0, u1 = int(w0[hs]) >> (8 * e), int(w1[hs]) >> (8 * e)
                a = [_gemv_int4_pair(u0), _gemv_int4_pair(u1),
                     _gemv_int4_pair(u0 >> 4), _gemv_int4_pair(u1 >> 4)]
                xc = xl[8 * hs:8 * hs + 8]
                b = [(xc[2 * e], xc[4 + 2 * e]),
                     (xc[2 * e + 1], xc[5 + 2 * e])]
            else:
                f0 = _gemv_int8_group(w0[step], step)
                f1 = _gemv_int8_group(w1[step], step)
                a = [f0[:2], f1[:2], f0[2:], f1[2:]]
                b = [xl[4 * step:4 * step + 2], xl[4 * step + 2:4 * step + 4]]
            a_mat[g, 2 * t:2 * t + 2] = a[0]
            a_mat[g + 8, 2 * t:2 * t + 2] = a[1]
            a_mat[g, 2 * t + 8:2 * t + 10] = a[2]
            a_mat[g + 8, 2 * t + 8:2 * t + 10] = a[3]
            b_mat[2 * t:2 * t + 2, g] = b[0]
            b_mat[2 * t + 8:2 * t + 10, g] = b[1]
        d += a_mat @ b_mat
    return d


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_k9_gemv_fragments_cover_the_block(int4):
    """The gemv body's fragment layout, modelled on the CPU: over one k
    block (64 bytes a row: 64 int8 or 128 int4 weights) the lanes' A
    fragments (the weights, converted exactly: int8 by group_f32's magic
    number, int4 as bf16 pairs straight from the nibbles) and B fragments
    (x, permuted to the same k) multiply to exactly W x^T of the tile,
    every byte value included."""
    r = np.random.RandomState(7)
    rows = r.randint(0, 256, (16, 64)).astype(np.uint8)
    rows.reshape(-1)[:256] = np.arange(256, dtype=np.uint8)
    x = r.randint(-9, 10, (8, 128 if int4 else 64)).astype(np.float64)
    q = torch.from_numpy(rows.view(np.int8).copy())
    w = (K9.unpack_int4(q) if int4 else q).numpy().astype(np.float64)
    np.testing.assert_array_equal(_gemv_block_emulated(rows, x, int4),
                                  w @ x.T)


def _wgmma_tile(block, M, N, bm=256, group=8):
    """The (m0, n0) output tile of wgmma block ``block``: the kernel's
    grouped raster (groups of 8 m tiles of 256 rows, m fastest inside a
    group)."""
    mt, nt = -(-M // bm), -(-N // 128)
    per = group * nt
    g0 = block // per * group
    gsz = min(mt - g0, group)
    local = block % per
    return (g0 + local % gsz) * bm, local // gsz * 128


@pytest.mark.parametrize("M,N", [(17, 72), (300, 200), (2048, 4096),
                                 (2048, 11008), (2100, 11008),
                                 (8192, 4096)])
def test_k9_wgmma_raster_covers_every_tile_once(M, N):
    """The wgmma body's grid (route_grid) with its grouped raster visits
    every 256 x 128 tile of the [M, N] output exactly once, and a group's
    blocks, launched together, read at most 2048 rows of x."""
    plan = K9.weight_only_route(M, N, 4096, False, torch.bfloat16)
    assert plan.body == "wgmma" and plan.rows == 256
    blocks = K9.route_grid(plan, M, N)[0]
    tiles = [_wgmma_tile(b, M, N) for b in range(blocks)]
    want = {(m, n) for m in range(0, M, 256) for n in range(0, N, 128)}
    assert len(tiles) == len(want) and set(tiles) == want
    nt = -(-N // 128)
    for first in range(0, blocks, 8 * nt):
        assert len({m for m, _ in tiles[first:first + 8 * nt]}) <= 8


# ---------------------------------------------------------------------------
# serving: Predictor.generate and the ServingEngine against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def quantized(fp_state):
    """Per algo, the JAX and port llama_tiny pair; each predictor built
    with enable_weight_only quantizes its model in place (a second one
    finds nothing left to swap)."""
    return {algo: _pair(fp_state) for algo in ALGOS}


def _ragged_ids():
    lens = [12, 7, 10]
    r = np.random.RandomState(5)
    ids = np.zeros((3, 12), np.int64)
    for b, n in enumerate(lens):
        ids[b, :n] = r.randint(1, 256, n)
    return ids, lens


@pytest.mark.parametrize("page", [None, 8], ids=["static", "paged"])
@pytest.mark.parametrize("algo", ALGOS)
def test_generate_matches_jax(quantized, algo, page):
    jm, tm = quantized[algo]
    jc = JaxConfig().set_model(jm).enable_weight_only(algo)
    tc = Config().set_model(tm).enable_weight_only(algo)
    if page:
        jc.enable_paged_kv(page)
        tc.enable_paged_kv(page)
    ids, lens = _ragged_ids()
    ref = _np(jax_predictor(jc).generate(paddle.to_tensor(ids),
                                         max_new_tokens=6, lengths=lens))
    pred = create_predictor(tc)
    assert pred.dtype == torch.float32 and pred.device.type == "cpu"
    ours = pred.generate(ids, max_new_tokens=6, lengths=lens).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert isinstance(tm.llama.layers[0].mlp.down_proj, tq.WeightOnlyLinear)
    assert type(tm.lm_head).__name__ == "ColumnParallelLinear"


@pytest.mark.parametrize("algo", ALGOS)
def test_serving_engine_matches_jax(quantized, algo):
    """tests/test_torch_serving.py's mixed_stream schedule: chunk
    boundaries off the page lattice, a stream longer than the batch."""
    jm, tm = quantized[algo]
    kw = dict(max_batch=2, prefill_chunk=16)
    je = JaxEngine(jax_predictor(JaxConfig().set_model(jm).enable_paged_kv(8)
                                 .enable_weight_only(algo)), **kw)
    te = ServingEngine(create_predictor(Config().set_model(tm)
                                        .enable_paged_kv(8)
                                        .enable_weight_only(algo)), **kw)
    r = np.random.RandomState(0)
    prompts = [r.randint(1, 256, (n,)) for n in (7, 4, 19, 33, 5)]

    def drive(eng):
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        done = eng.run()
        return [list(done[i].new_tokens) for i in rids]

    assert drive(te) == drive(je)
    for k in ("compiles", "cache_hits", "tokens"):
        assert getattr(te.stats, k) == getattr(je.stats, k), k


def test_convert_carries_quantized_state_both_ways(fp_state):
    """A quantized JAX llama_tiny's state loads into the quantized port
    model and exports back bit for bit; int8 stays int8."""
    for algo in ALGOS:
        jm, tm = _pair(fp_state)
        jq.quantize_for_serving(jm, algo, ("lm_head",))
        other = LlamaForCausalLM(llama_tiny(), device="cpu", seed=3)
        tq.quantize_for_serving(other, algo, ("lm_head",))
        jstate = {k: _np(v) for k, v in jm.state_dict().items()}
        load_jax_state_dict(other, jstate)
        q = other.llama.layers[1].self_attn.o_proj.weight_quant
        assert q.dtype == torch.int8
        back = export_jax_state_dict(other)
        assert set(back) == set(jstate)
        for k, v in jstate.items():
            assert back[k].dtype == v.dtype, k
            np.testing.assert_array_equal(back[k], v, err_msg=k)

"""The port's cache-based generation path held against the JAX package on
the CPU.

Kernel K6 (``decode_attention``, contiguous head-major cache) is compared
through its plain version with the JAX Pallas kernel in interpret mode
(1e-4) and with the JAX dense fallback ``_dense_ragged`` (2e-5). The
contiguous-cache Llama forward, ``LlamaForCausalLM.generate``,
``Predictor.generate`` (static and paged caches, ragged rows, EOS, the
bucket clamped to the cache), ``Predictor.run``, the fused inference
functions and ``FusedMultiTransformer`` run the same seeded numpy inputs
through both packages, with ``llama_tiny`` weights built by the JAX
package and carried across by ``convert.load_jax_state_dict``. Greedy
token streams must be identical; logits within 1e-4, caches within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.incubate.nn import FusedMultiTransformer as JaxFMT
from paddle_tpu.incubate.nn import functional as jif
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_predictor
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.ops.pallas import decode_attention as jda
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch.convert import export_jax_state_dict, load_jax_state_dict
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.incubate.nn import functional as tif
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.ops.kernels import decode_attention as K6

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5


def _np(t):
    return np.asarray(t._value if isinstance(t, Tensor) else t)


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = JaxLlama(jax_tiny())
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = tl.LlamaForCausalLM(tl.llama_tiny(), device="cpu")
    load_jax_state_dict(tm, state)
    return jm, tm


# ---------------------------------------------------------------------------
# K6: the plain version against the Pallas kernel and the dense fallback
# ---------------------------------------------------------------------------
K6_CASES = {  # (B, Sq, H, KV, D, M, offsets: int or per-row list)
    "scalar_sq1_mha": (2, 1, 4, 4, 128, 512, 300),
    "scalar_sq8_gqa8_2": (2, 8, 8, 2, 128, 512, 37),
    "rows_sq1_gqa8_2": (3, 1, 8, 2, 128, 512, [0, 200, 511]),
    "rows_sq8_mha": (3, 8, 4, 4, 128, 512, [5, 0, 504]),
    "rows_sq8_gqa8_2_m384": (2, 8, 8, 2, 128, 384, [130, 376]),
}


def _k6_inputs(B, Sq, H, KV, D, M, seed):
    r = np.random.RandomState(seed)
    q = r.randn(B, Sq, H, D).astype(np.float32)
    k = r.randn(B, KV, M, D).astype(np.float32)
    v = r.randn(B, KV, M, D).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_k6_plain_matches_pallas_interpret(case):
    B, Sq, H, KV, D, M, off = K6_CASES[case]
    q, k, v = _k6_inputs(B, Sq, H, KV, D, M, 1)
    t_off = off if np.ndim(off) == 0 else torch.tensor(off, dtype=torch.int32)
    ours = K6.decode_attention(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), t_off).numpy()
    ref = jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(off, jnp.int32), interpret=True)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", sorted(K6_CASES) + ["scalar_m100"])
def test_k6_plain_matches_dense_ragged(case):
    """M = 100 too: JAX's pick_block(100) is 0, so its Pallas kernel cannot
    take that cache and only the dense fallback is a reference."""
    B, Sq, H, KV, D, M, off = K6_CASES.get(case, (2, 8, 8, 2, 128, 100, 60))
    q, k, v = _k6_inputs(B, Sq, H, KV, D, M, 2)
    t_off = off if np.ndim(off) == 0 else torch.tensor(off, dtype=torch.int32)
    ours = K6.decode_attention(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), t_off).numpy()
    rows = np.broadcast_to(np.asarray(off, np.int32).reshape(-1), (B,))
    ref = jda._dense_ragged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(rows))
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=2e-5)
    assert K6.decode_attention_dense(torch.tensor(q), torch.tensor(k),
                                     torch.tensor(v), t_off).shape == q.shape


def test_k6_checks_raise():
    q = torch.zeros(2, 1, 4, 16)
    k = torch.zeros(2, 2, 10, 16)
    with pytest.raises(ValueError, match="offset must be"):
        K6.decode_attention(q, k, k, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError, match="dtype"):
        K6.decode_attention(q, k.double(), k.double(), 0)
    with pytest.raises(ValueError, match="does not fit"):
        K6.decode_attention(q, k[:1], k[:1], 0)


# ---------------------------------------------------------------------------
# the contiguous-cache Llama forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ragged", [False, True], ids=["scalar", "per_row"])
def test_contiguous_cache_forward_matches_jax(models, ragged):
    """Prefill at offset 0, then two decode steps at a scalar offset or at
    per-row offsets: logits within 1e-4, caches within 1e-5."""
    jm, tm = models
    cfg = jm.config
    B, S, M = 2, 12, 32
    r = np.random.RandomState(3)
    shape = (B, cfg.num_kv_heads, M, cfg.head_dim)
    jc = [(jnp.zeros(shape), jnp.zeros(shape))
          for _ in range(cfg.num_layers)]
    tc = tm._empty_caches(B, M)
    steps = [(r.randint(1, 256, (B, S)), 0)]
    for i in range(2):
        off = np.asarray([S + i, 7 + i], np.int32) if ragged else S + i
        steps.append((r.randint(1, 256, (B, 1)), off))
    for ids, off in steps:
        with paddle.no_grad():
            jl, jc = jm(Tensor(jnp.asarray(ids)), caches=jc,
                        offset=jnp.asarray(off) if np.ndim(off) else off)
        with torch.no_grad():
            tlg, tc = tm(torch.tensor(ids), caches=tc,
                         offset=torch.tensor(off) if np.ndim(off) else off)
        np.testing.assert_allclose(tlg.numpy(), _np(jl), rtol=0,
                                   atol=LOGIT_TOL)
        for (jk, jv), (tk, tv) in zip(jc, tc):
            np.testing.assert_allclose(tk.numpy(), _np(jk), rtol=0,
                                       atol=CACHE_TOL)
            np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=0,
                                       atol=CACHE_TOL)


def test_contiguous_cache_rejects_valid(models):
    tm = models[1]
    with pytest.raises(RuntimeError, match="only served over the paged"):
        tm(torch.ones(1, 2, dtype=torch.int64), caches=tm._empty_caches(1, 8),
           valid=torch.tensor([1]))


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------
def test_llama_generate_matches_jax(models):
    jm, tm = models
    ids = np.random.RandomState(4).randint(1, 256, (2, 9))
    ref = _np(jm.generate(Tensor(jnp.asarray(ids)), max_new_tokens=8))
    ours = tm.generate(torch.tensor(ids), max_new_tokens=8)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert tm.stats.compiles >= 2


def _predictors(models, page=None, max_length=None, **gen):
    jm, tm = models
    jc, tc = JaxConfig().set_model(jm), Config().set_model(tm)
    for c in (jc, tc):
        if page:
            c.enable_paged_kv(page)
        c.max_length = max_length
        for k, v in gen.items():
            setattr(c.generation, k, v)
    return jax_predictor(jc), create_predictor(tc)


RAGGED = [11, 24, 17]


def _ragged_ids(seed=5):
    ids = np.random.RandomState(seed).randint(1, 256, (3, max(RAGGED)))
    for b, n in enumerate(RAGGED):
        ids[b, n:] = 0
    return ids


@pytest.mark.parametrize("page", [None, 8], ids=["static", "paged"])
def test_predictor_generate_ragged_matches_jax(models, page):
    jp, tp = _predictors(models, page)
    ids = _ragged_ids()
    ref = _np(jp.generate(ids, max_new_tokens=6, lengths=RAGGED))
    ours = tp.generate(ids, max_new_tokens=6, lengths=RAGGED)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert (tp.stats.compiles, tp.stats.tokens) == (2, 18)


@pytest.mark.parametrize("page", [None, 8], ids=["static", "paged"])
def test_predictor_ragged_rows_equal_solo(models, page):
    """Each row of a ragged batch decodes exactly as it does alone."""
    _, tp = _predictors(models, page)
    ids = _ragged_ids()
    batch = tp.generate(ids, max_new_tokens=6, lengths=RAGGED).numpy()
    for b, n in enumerate(RAGGED):
        solo = tp.generate(ids[b:b + 1, :n], max_new_tokens=6).numpy()
        np.testing.assert_array_equal(batch[b, -6:], solo[0, -6:])


@pytest.mark.parametrize("page", [None, 8], ids=["static", "paged"])
def test_predictor_eos_freezes_rows_like_jax(models, page):
    jp, tp = _predictors(models, page)
    ids = _ragged_ids(6)
    free = tp.generate(ids, max_new_tokens=7, lengths=RAGGED).numpy()
    eos = int(free[1, -5])             # row 1 stops at its 3rd new token
    ref = _np(jp.generate(ids, max_new_tokens=7, lengths=RAGGED,
                          eos_token_id=eos))
    ours = tp.generate(ids, max_new_tokens=7, lengths=RAGGED,
                       eos_token_id=eos).numpy()
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours[1, -5:], [eos] * 5)
    np.testing.assert_array_equal(ours[1, :-5], free[1, :-5])


@pytest.mark.parametrize("page", [None, 8], ids=["static", "paged"])
def test_predictor_bucket_clamped_to_cache_like_jax(models, page):
    """max_length=100 and a 90-token prompt: the prefill bucket is 100,
    not 128, and the static cache is M = 100 (no multiple of 8)."""
    jp, tp = _predictors(models, page, max_length=100)
    ids = np.random.RandomState(7).randint(1, 256, (2, 90))
    ref = _np(jp.generate(ids, max_new_tokens=10))
    ours = tp.generate(ids, max_new_tokens=10)
    np.testing.assert_array_equal(ours.numpy(), ref)
    (_, key), = [k for k in tp.stats._seen if k[0] == "prefill"]
    assert key[1:3] == (100, 100)


def test_paged_caches_tables_match_jax(models):
    jp, tp = _predictors(models, 8)
    lengths = np.asarray(RAGGED, np.int32)
    jc, jP = jp._paged_caches(lengths, 6, 64, 8, jnp.float32)
    tc, tP = tp._paged_caches(lengths, 6, 64, 8, torch.float32)
    assert jP == tP == 16
    for (jk, _, jt), (tk, _, tt) in zip(jc, tc):
        np.testing.assert_array_equal(tt.numpy(), _np(jt))
        assert tuple(tk.shape) == tuple(jk.shape)


def test_predictor_run_matches_jax(models):
    jp, tp = _predictors(models)
    ids = np.random.RandomState(8).randint(1, 256, (2, 13))
    ref = jp.run([ids])
    ours = tp.run([ids])
    assert len(ours) == len(ref) == 1 and isinstance(ours[0], np.ndarray)
    np.testing.assert_allclose(ours[0], ref[0], rtol=0, atol=LOGIT_TOL)


def test_sampling_in_range_and_reproducible(models):
    """Temperature / top-k / top-p draw from a torch.Generator seeded with
    ``seed``. JAX's PRNG gives other numbers for the same seed, so the
    streams are not compared with the JAX package: they must be valid
    token ids and repeat for one seed."""
    tm = models[1]
    ids = torch.tensor(np.random.RandomState(9).randint(1, 256, (2, 6)))
    a = tm.generate(ids, max_new_tokens=6, temperature=0.8, top_k=20, seed=3)
    b = tm.generate(ids, max_new_tokens=6, temperature=0.8, top_k=20, seed=3)
    assert torch.equal(a, b) and ((a >= 0) & (a < 256)).all()
    for page in (None, 8):
        _, tp = _predictors(models, page, temperature=0.9, top_p=0.8,
                            seed=4)
        x = tp.generate(_ragged_ids(), max_new_tokens=5, lengths=RAGGED)
        y = tp.generate(_ragged_ids(), max_new_tokens=5, lengths=RAGGED)
        assert torch.equal(x, y) and ((x >= 0) & (x < 256)).all()


def test_generate_enforces_the_cache_length(models):
    tm = models[1]
    with pytest.raises(RuntimeError, match="exceeds the cache length"):
        tm.generate(torch.ones(1, 10, dtype=torch.int64), max_new_tokens=8,
                    max_length=16)
    _, tp = _predictors(models, max_length=16)
    with pytest.raises(RuntimeError, match="exceeds cache length"):
        tp.generate(np.ones((1, 10), np.int64), max_new_tokens=8)


# ---------------------------------------------------------------------------
# the fused inference functions and FusedMultiTransformer
# ---------------------------------------------------------------------------
def test_masked_multihead_attention_matches_jax():
    B, H, M, D = 3, 4, 24, 16
    r = np.random.RandomState(10)
    x = r.randn(B, 3 * H * D).astype(np.float32)
    bias = r.randn(3 * H * D).astype(np.float32)
    cache = r.randn(2, B, H, M, D).astype(np.float32)
    sl = np.asarray([[0], [9], [23]], np.int32)
    jo, jcache = jif.masked_multihead_attention(
        jnp.asarray(x), jnp.asarray(cache), bias=jnp.asarray(bias),
        sequence_lengths=jnp.asarray(sl))
    tcache = torch.tensor(cache)
    to, tc2 = tif.masked_multihead_attention(
        torch.tensor(x), tcache, bias=torch.tensor(bias),
        sequence_lengths=torch.tensor(sl))
    assert tc2 is tcache                     # written in place
    np.testing.assert_allclose(to.numpy(), _np(jo), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tcache.numpy(), _np(jcache), rtol=0,
                               atol=CACHE_TOL)
    with pytest.raises(RuntimeError, match="src_mask"):
        tif.masked_multihead_attention(torch.tensor(x), tcache,
                                       src_mask=torch.zeros(1))


def _fmt_weights(layout, L, h, H, f, seed):
    r = np.random.RandomState(seed)
    w = lambda *s: (0.2 * r.randn(*s)).astype(np.float32)
    D = h // H
    qkv = [w(3, H, D, h) if layout == "4d" else w(h, 3 * h)
           for _ in range(L)]
    return dict(
        ln_scales=[1 + w(h) for _ in range(L)], ln_biases=[w(h)] * L,
        qkv_weights=qkv, qkv_biases=[w(3 * h) for _ in range(L)],
        linear_weights=[w(h, h) for _ in range(L)],
        linear_biases=[w(h) for _ in range(L)],
        ffn_ln_scales=[1 + w(h) for _ in range(L)],
        ffn_ln_biases=[w(h) for _ in range(L)],
        ffn1_weights=[w(h, f) for _ in range(L)],
        ffn1_biases=[w(f) for _ in range(L)],
        ffn2_weights=[w(f, h) for _ in range(L)],
        ffn2_biases=[w(h) for _ in range(L)])


@pytest.mark.parametrize("pre_ln", [True, False], ids=["pre_ln", "post_ln"])
@pytest.mark.parametrize("layout", ["4d", "2d"])
def test_fused_multi_transformer_matches_jax(layout, pre_ln):
    """Both qkv weight layouts; no caches (causal attention), then a
    prefill and two decode steps through the caches."""
    L, B, h, H, f, M = 2, 2, 64, 4, 96, 16
    wts = _fmt_weights(layout, L, h, H, f, 11)
    kw = dict(pre_layer_norm=pre_ln, epsilon=1e-5,
              trans_qkvw=layout == "4d",
              num_heads=None if layout == "4d" else H)
    jw = {k: [jnp.asarray(a) for a in v] for k, v in wts.items()}
    tw = {k: [torch.tensor(a) for a in v] for k, v in wts.items()}
    r = np.random.RandomState(12)
    x = r.randn(B, 6, h).astype(np.float32)
    ref = jif.fused_multi_transformer(Tensor(jnp.asarray(x)), **jw, **kw)
    ours = tif.fused_multi_transformer(torch.tensor(x), **tw, **kw)
    np.testing.assert_allclose(ours.numpy(), _np(ref), rtol=0, atol=1e-4)
    shape = (B, H, M, h // H)
    jc = [(jnp.zeros(shape), jnp.zeros(shape)) for _ in range(L)]
    tc = [torch.zeros(2, *shape) for _ in range(L)]
    for step, (S, t) in enumerate([(6, 0), (1, 6), (1, 7)]):
        x = r.randn(B, S, h).astype(np.float32)
        jo, jc = jif.fused_multi_transformer(
            Tensor(jnp.asarray(x)), **jw, **kw, cache_kvs=jc, time_step=t)
        to, _ = tif.fused_multi_transformer(
            torch.tensor(x), **tw, **kw, cache_kvs=tc, time_step=t)
        np.testing.assert_allclose(to.numpy(), _np(jo), rtol=0, atol=1e-4)
        for (jk, jv), tcl in zip(jc, tc):
            np.testing.assert_allclose(tcl[0].numpy(), _np(jk), rtol=0,
                                       atol=1e-4)
            np.testing.assert_allclose(tcl[1].numpy(), _np(jv), rtol=0,
                                       atol=1e-4)


def test_block_multihead_attention_gqa_matches_jax():
    B, H, KV, D, page, npages, P = 3, 8, 2, 16, 8, 4, 16
    r = np.random.RandomState(13)
    qkv = r.randn(B, (H + 2 * KV) * D).astype(np.float32)
    kp = r.randn(P, KV, page, D).astype(np.float32)
    vp = r.randn(P, KV, page, D).astype(np.float32)
    tbl = r.permutation(P)[:B * npages].reshape(B, npages).astype(np.int32)
    dec = np.asarray([[3], [17], [31]], np.int32)
    enc = np.zeros((B, 1), np.int32)
    this = np.ones((B, 1), np.int32)
    jo, _, jk, jv = jif.block_multihead_attention(
        jnp.asarray(qkv), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(enc),
        jnp.asarray(dec), jnp.asarray(this), None, None, None, None,
        jnp.asarray(tbl), block_size=page)
    tk, tv = torch.tensor(kp), torch.tensor(vp)
    to, _, tk2, _ = tif.block_multihead_attention(
        torch.tensor(qkv), tk, tv, torch.tensor(enc), torch.tensor(dec),
        torch.tensor(this), None, None, None, None, torch.tensor(tbl),
        block_size=page)
    assert tk2 is tk
    np.testing.assert_allclose(to.numpy(), _np(jo), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), _np(jk), rtol=0, atol=CACHE_TOL)
    np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=0, atol=CACHE_TOL)
    with pytest.raises(RuntimeError, match="block_size"):
        tif.block_multihead_attention(
            torch.tensor(qkv), tk, tv, None, torch.tensor(dec), None, None,
            None, None, None, torch.tensor(tbl), block_size=16)


@pytest.fixture(scope="module")
def fmt_pair():
    paddle.seed(14)
    jl = JaxFMT(64, 4, 96, num_layers=2)
    state = {k: np.asarray(v._value) for k, v in jl.state_dict().items()}
    tl_ = FusedMultiTransformer(64, 4, 96, num_layers=2, device="cpu").eval()
    load_jax_state_dict(tl_, state)
    return jl, tl_, state


def test_fused_multi_transformer_layer_decode_matches_jax(fmt_pair):
    """Prefill + three decode steps through the caches against the JAX
    layer, and each step's output against the port's own no-cache
    forward over the whole sequence so far."""
    jl, tl_, _ = fmt_pair
    B, M = 2, 16
    r = np.random.RandomState(15)
    jc = jl.empty_caches(B, M)
    tc = tl_.empty_caches(B, M)
    seq = []
    with torch.no_grad():
        for S, t in [(5, 0), (1, 5), (1, 6), (1, 7)]:
            x = r.randn(B, S, 64).astype(np.float32)
            seq.append(x)
            with paddle.no_grad():
                jo, jc = jl(Tensor(jnp.asarray(x)), caches=jc, time_step=t)
            to, tc = tl_(torch.tensor(x), caches=tc, time_step=t)
            np.testing.assert_allclose(to.numpy(), _np(jo), rtol=0,
                                       atol=1e-4)
            full = tl_(torch.tensor(np.concatenate(seq, axis=1)))
            np.testing.assert_allclose(to.numpy(), full[:, -S:].numpy(),
                                       rtol=0, atol=1e-4)


def test_convert_round_trips_fused_multi_transformer(fmt_pair):
    """The layer's raw [in, out] parameters load untransposed and export
    back bit for bit; only nn.Linear weights are transposed."""
    _, tl_, state = fmt_pair
    assert tuple(tl_.qkv_weights_0.shape) == state["qkv_weights_0"].shape \
        == (64, 192)
    np.testing.assert_array_equal(tl_.qkv_weights[0].detach().numpy(),
                                  state["qkv_weights_0"])
    out = export_jax_state_dict(tl_)
    assert set(out) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(out[k], v)


def test_fused_multi_transformer_unported_knobs_raise():
    with pytest.raises(RuntimeError, match="ROADMAP"):
        FusedMultiTransformer(64, 4, 96, nranks=2, device="cpu")
    m = FusedMultiTransformer(64, 4, 96, dropout_rate=0.1, device="cpu")
    with pytest.raises(RuntimeError, match="dropout"):
        m(torch.zeros(1, 2, 64))
    assert m.eval()(torch.zeros(1, 2, 64)).shape == (1, 2, 64)

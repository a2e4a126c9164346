"""The port's graphed step bodies held against the JAX package on the CPU.

``Predictor.generate``'s decode step and ``ServingEngine``'s decode and
unified rounds are step bodies over static buffers, captured as CUDA
graphs per shape key on a card (``core/cuda_graphs.py``). On the CPU the
bodies run eagerly, and here they must commit the JAX package's token
streams bit for bit in fp32, with ``llama_tiny`` weights built by the
JAX package and carried across by ``convert.load_jax_state_dict``:
static and paged caches, ragged and non-ragged batches (the non-ragged
one now through the per-row tensor offsets), with EOS; and a second call
with the same key, which reuses the key's caches without zeroing them.
Also: ``write_cache``'s tensor-offset path against its int path, the
launch-counter registry that replays add to, sampling's written-out
multinomial draw, and the CPU behaviour of ``StepGraphs``. The card
tests are in tests/test_torch_cuda_graphs_card.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_predictor
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.core.compile_stats import CompileStats
from paddle_tpu_torch.core.cuda_graphs import StepGraphs, _EAGER, eager
from paddle_tpu_torch.inference import (Config, GenerationConfig,
                                        ServingEngine, _sample,
                                        create_predictor)
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import autotune as K7
from paddle_tpu_torch.ops.kernels import decode_attention as K5
from paddle_tpu_torch.ops.kernels import flash_attention as K1
from paddle_tpu_torch.ops.kernels import fused_adam as K8
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as K4
from paddle_tpu_torch.ops.kernels import rms_norm as K3


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = JaxLlama(jax_tiny())
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = tl.LlamaForCausalLM(tl.llama_tiny(), device="cpu")
    load_jax_state_dict(tm, state)
    return jm, tm


def _predictors(models, page):
    jm, tm = models
    jc, tc = JaxConfig().set_model(jm), Config().set_model(tm)
    if page:
        jc.enable_paged_kv(page_size=page)
        tc.enable_paged_kv(page_size=page)
    return jax_predictor(jc), create_predictor(tc)


def _ids(lengths, seed):
    ids = np.random.RandomState(seed).randint(1, 256, (len(lengths),
                                                       max(lengths)))
    for b, n in enumerate(lengths):
        ids[b, n:] = 0
    return ids


def _jax_tokens(jp, ids, **kw):
    return np.asarray(jp.generate(ids, **kw)._value)


# ---------------------------------------------------------------------------
# Predictor.generate: the decode step body against the JAX decode scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lengths", [[24, 24, 24], [11, 24, 17]],
                         ids=["uniform", "ragged"])
@pytest.mark.parametrize("page", [None, 8], ids=["static", "paged"])
def test_decode_step_body_matches_jax_with_eos(models, page, lengths):
    """A uniform batch decodes at per-row tensor offsets like a ragged
    one; with an EOS that stops row 1 at its third new token, every
    token equals the JAX package's."""
    jp, tp = _predictors(models, page)
    ids = _ids(lengths, 6)
    free = tp.generate(ids, max_new_tokens=7, lengths=lengths).numpy()
    eos = int(free[1, -5])
    ref = _jax_tokens(jp, ids, max_new_tokens=7, lengths=lengths,
                      eos_token_id=eos)
    ours = tp.generate(ids, max_new_tokens=7, lengths=lengths,
                       eos_token_id=eos).numpy()
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours[1, -5:], [eos] * 5)
    ragged = len(set(lengths)) > 1
    keys = [k for site, k in tp.stats._seen if site == "decode"]
    assert {k[6] for k in keys} == {None, eos}
    assert all(k[7] == ragged for k in keys)
    assert tp.stats.captures == {}     # no graph on the CPU


@pytest.mark.parametrize("page", [None, 8], ids=["static", "paged"])
def test_second_call_reuses_the_key_caches_unzeroed(models, page):
    """Two calls with one key: the second reuses the first's caches as
    they are. Its short rows' padded prefill writes (and, paged, the
    pages of its long row) land on slots that hold the first call's
    prompt and decoded tokens, and its tokens still equal JAX's."""
    jp, tp = _predictors(models, page)
    first, second = [30, 31, 29], [11, 31, 9]
    a_ids, b_ids = _ids(first, 12), _ids(second, 13)
    a = tp.generate(a_ids, max_new_tokens=6, lengths=first).numpy()
    (cache_key, caches), = tp._caches.items()
    k0 = caches[0][0].clone()
    if page:
        # row 1 of the second call takes pages 3..7, which hold rows 0
        # and 1 of the first call
        assert (k0[3:8] != 0).any()
    else:
        # slots 11..35 of row 0: the first call's prompt and decode
        # writes, where the second call's padded prefill writes land
        assert (k0[0, :, 11:36] != 0).all(-1).all()
    b = tp.generate(b_ids, max_new_tokens=6, lengths=second).numpy()
    (key2, caches2), = tp._caches.items()
    assert key2 == cache_key and caches2 is caches
    assert caches2[0][0].data_ptr() == caches[0][0].data_ptr()
    np.testing.assert_array_equal(
        a, _jax_tokens(jp, a_ids, max_new_tokens=6, lengths=first))
    np.testing.assert_array_equal(
        b, _jax_tokens(jp, b_ids, max_new_tokens=6, lengths=second))
    # one decode key, one set of step buffers
    assert tp.stats.keys("decode") == 1
    assert len(tp._graphs._entries) == 1


def test_decode_output_buffer_is_copied_out(models):
    """``generate`` returns its own tensor: a later call with the same key
    writes the key's output buffer, not the earlier result."""
    _, tp = _predictors(models, None)
    ids = _ids([9, 9], 3)
    a = tp.generate(ids, max_new_tokens=5)
    a_np = a.numpy().copy()
    tp.generate(_ids([9, 9], 4), max_new_tokens=5)
    np.testing.assert_array_equal(a.numpy(), a_np)


# ---------------------------------------------------------------------------
# an eager stand-in for capture: every later step replays the FIRST body
# ---------------------------------------------------------------------------
@pytest.fixture
def replay_first_body(monkeypatch):
    """On the CPU, a key's first step runs its body and keeps it, as a
    capture bakes the first call's body (closures, caches and generator
    included) into the graph; every later step of the key runs the kept
    body again, as a replay does, whatever body the caller passes then."""
    def step(self, site, key, body, generator=None):
        e = self._entries[(site, key)]
        if e.graph is None:
            body(e.bufs)
            e.graph = body
            self.stats.note_capture(site, 0.0, 0)
        else:
            e.graph(e.bufs)
            self.stats.replays[site] += 1

    monkeypatch.setattr(StepGraphs, "step", step)


@pytest.mark.parametrize("page", [None, 8], ids=["static", "paged"])
def test_replayed_first_body_commits_jax_tokens(models, replay_first_body,
                                               page):
    """Two calls with one decode key and other prompts (EOS on): the
    second call's steps all replay the first call's body, and both
    calls' tokens equal the JAX package's."""
    jp, tp = _predictors(models, page)
    lengths = [11, 24, 17]
    eos = int(tp.generate(_ids(lengths, 6), max_new_tokens=7,
                          lengths=lengths).numpy()[1, -5])
    for seed in (6, 7):
        ids = _ids(lengths, seed)
        ours = tp.generate(ids, max_new_tokens=7, lengths=lengths,
                           eos_token_id=eos).numpy()
        np.testing.assert_array_equal(
            ours, _jax_tokens(jp, ids, max_new_tokens=7, lengths=lengths,
                              eos_token_id=eos))
    # three calls: one without and two with the eos, 6 decode steps each
    assert tp.stats.captures == {"decode": 2}
    assert tp.stats.replays == {"decode": 5 + 11}


@pytest.mark.parametrize("chunked", [False, True], ids=["legacy", "chunked"])
def test_replayed_first_round_bodies_commit_jax_engine_tokens(
        models, replay_first_body, chunked):
    """A stream longer than the batch: finished rows are backfilled and
    the table, tokens and positions change under rounds that all replay
    the first round's body; the committed tokens equal the JAX engine's."""
    from paddle_tpu.inference import ServingEngine as JaxEngine

    jm, tm = models
    kw = dict(max_batch=2, prefill_chunk=16 if chunked else None)
    je = JaxEngine(jax_predictor(JaxConfig().set_model(jm)
                                 .enable_paged_kv(page_size=8)), **kw)
    te = ServingEngine(create_predictor(Config().set_model(tm)
                                        .enable_paged_kv(page_size=8)),
                       **kw)
    prompts = [np.random.RandomState(s).randint(1, 256, (L,))
               for s, L in enumerate([7, 19, 33, 5, 12])]
    out = []
    for eng in (je, te):
        rids = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, [4, 6, 3, 5, 2])]
        for _ in range(2):
            eng.step()
        rids.append(eng.submit(prompts[0][::-1].copy(), max_new_tokens=4))
        done = eng.run()
        out.append([list(done[r].new_tokens) for r in rids])
    assert out[0] == out[1]
    sites = ("unified", "serve_decode") if chunked else ("serve_decode",)
    assert te.stats.captures == {s: 1 for s in sites}
    assert all(te.stats.replays[s] == te.rounds[
        "decode" if s == "serve_decode" else s] - 1 for s in sites)


# ---------------------------------------------------------------------------
# write_cache: the tensor-offset path against the int path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("offset", [-3, 0, 5, 26, 29, 40])
@pytest.mark.parametrize("S", [1, 4])
def test_write_cache_tensor_offset_matches_int_path(offset, S):
    """The same bytes for every offset, the clamp into [0, M - S]
    included (M = 30)."""
    r = np.random.RandomState(offset + 10 * S)
    B, KV, M, D = 3, 2, 30, 8
    base = torch.tensor(r.randn(B, KV, M, D).astype(np.float32))
    new = torch.tensor(r.randn(B, S, KV, D).astype(np.float32))
    by_int, by_tensor = base.clone(), base.clone()
    tl.write_cache(by_int, new, offset)
    tl.write_cache(by_tensor, new, torch.full((B,), offset,
                                              dtype=torch.int32))
    assert torch.equal(by_int, by_tensor)
    o = min(max(offset, 0), M - S)
    assert torch.equal(by_int[:, :, o:o + S], new.transpose(1, 2))


def test_write_cache_per_row_offsets_match_int_path_row_by_row():
    r = np.random.RandomState(7)
    B, KV, M, D, S = 4, 2, 16, 8, 3
    offs = [0, 5, 13, 20]
    base = torch.tensor(r.randn(B, KV, M, D).astype(np.float32))
    new = torch.tensor(r.randn(B, S, KV, D).astype(np.float32))
    rows = base.clone()
    for b, o in enumerate(offs):
        tl.write_cache(rows[b:b + 1], new[b:b + 1], o)
    per_row = base.clone()
    tl.write_cache(per_row, new, torch.tensor(offs, dtype=torch.int32))
    assert torch.equal(rows, per_row)


# ---------------------------------------------------------------------------
# the launch-counter registry
# ---------------------------------------------------------------------------
def test_every_kernel_wrapper_is_registered():
    assert set(kernels.launch_counts()) == {
        K1.flash_attention_fwd, K1.flash_attention_bwd, K3.rms_norm,
        K4.ragged_paged_attention, K5.decode_attention,
        K5.paged_decode_attention, K8.fused_adam, K7.measure_flash_blocks}


def test_registry_adds_a_recorded_step_once_per_replay():
    """An eager stand-in for a capture: the block counts launches as a
    captured step's wrappers do (one ``+= 1`` a launch). The record keeps
    them and the counters go back (a capture runs nothing); each replay
    then adds the record once."""
    base = kernels.launch_counts()
    try:
        with kernels.recording_launches() as rec:
            for _ in range(5):             # one step of a 2-layer model
                K3.rms_norm.launches += 1
            for _ in range(2):
                K5.paged_decode_attention.launches += 1
        assert kernels.launch_counts() == base
        assert rec == {K3.rms_norm: 5, K5.paged_decode_attention: 2}
        for _ in range(7):
            kernels.add_launches(rec)
        now = kernels.launch_counts()
        assert now[K3.rms_norm] == base[K3.rms_norm] + 35
        assert now[K5.paged_decode_attention] == \
            base[K5.paged_decode_attention] + 14
        assert all(now[f] == base[f] for f in base
                   if f not in (K3.rms_norm, K5.paged_decode_attention))
    finally:
        for f, n in base.items():
            f.launches = n


def test_recording_restores_counters_when_the_block_raises():
    base = kernels.launch_counts()
    with pytest.raises(RuntimeError, match="capture failed"):
        with kernels.recording_launches():
            K3.rms_norm.launches += 3
            raise RuntimeError("capture failed")
    assert kernels.launch_counts() == base


# ---------------------------------------------------------------------------
# StepGraphs and sampling on the CPU
# ---------------------------------------------------------------------------
def test_step_graphs_on_the_cpu_run_the_body_on_the_key_buffers():
    stats = CompileStats()
    g = StepGraphs(torch.device("cpu"), stats)
    made = []

    def make():
        made.append(1)
        return torch.zeros(2)

    def body(buf):
        buf.add_(1)

    for key in ("a", "a", "b", "a"):
        g.buffers("site", key, make)
        g.step("site", key, body)
    assert len(made) == 2
    assert g.buffers("site", "a", make).tolist() == [3.0, 3.0]
    assert g.buffers("site", "b", make).tolist() == [1.0, 1.0]
    assert stats.captures == {} and stats.replays == {}


def test_eager_context_nests_and_resets():
    assert not _EAGER.get()
    with eager():
        assert _EAGER.get()
        with eager():
            assert _EAGER.get()
        assert _EAGER.get()
    assert not _EAGER.get()
    with pytest.raises(ValueError):
        with eager():
            raise ValueError
    assert not _EAGER.get()


def test_sample_draws_multinomials_numbers():
    """The written-out draw argmax(p / q), q ~ Exp(1), gives
    torch.multinomial's samples from the same generator state."""
    logits = torch.tensor(np.random.RandomState(2).randn(4, 300)
                          .astype(np.float32))
    for gen in (GenerationConfig(temperature=0.7),
                GenerationConfig(temperature=1.3, top_k=20),
                GenerationConfig(temperature=0.9, top_p=0.8)):
        g1 = torch.Generator().manual_seed(5)
        g2 = torch.Generator().manual_seed(5)
        for _ in range(4):
            ours = _sample(logits, gen, g1)
            lg = logits / gen.temperature
            if gen.top_k:
                kth = torch.topk(lg, gen.top_k, dim=-1).values[:, -1:]
                lg = torch.where(lg < kth, torch.full_like(lg, -1e30), lg)
            if gen.top_p < 1.0:
                srt = torch.sort(lg, dim=-1, descending=True).values
                cum = torch.cumsum(torch.softmax(srt, -1), -1)
                cut = torch.gather(srt, -1, (cum < gen.top_p).sum(
                    -1, keepdim=True))
                lg = torch.where(lg < cut, torch.full_like(lg, -1e30), lg)
            ref = torch.multinomial(torch.softmax(lg, -1), 1,
                                    generator=g2)[:, 0]
            assert torch.equal(ours, ref)


# ---------------------------------------------------------------------------
# ServingEngine: one set of static buffers per round key
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunked", [False, True], ids=["legacy", "chunked"])
def test_engine_rounds_keep_one_buffer_set_per_key(models, chunked):
    """A stream longer than the batch (finished rows backfilled) runs its
    rounds on one set of static buffers per noted key, and commits the
    JAX engine's tokens."""
    from paddle_tpu.inference import ServingEngine as JaxEngine

    jm, tm = models
    kw = dict(max_batch=2, prefill_chunk=16 if chunked else None)
    je = JaxEngine(jax_predictor(JaxConfig().set_model(jm)
                                 .enable_paged_kv(page_size=8)), **kw)
    te = ServingEngine(create_predictor(Config().set_model(tm)
                                        .enable_paged_kv(page_size=8)),
                       **kw)
    prompts = [np.random.RandomState(s).randint(1, 256, (L,))
               for s, L in enumerate([7, 19, 33, 5])]
    out = []
    for eng in (je, te):
        rids = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, [4, 6, 3, 5])]
        done = eng.run()
        out.append([list(done[r].new_tokens) for r in rids])
    assert out[0] == out[1]
    sites = ("unified", "serve_decode") if chunked else ("serve_decode",)
    assert sorted(s for s, _ in te._graphs._entries) == sorted(sites)
    for site in sites:
        assert te.stats.keys(site) == 1

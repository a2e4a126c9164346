"""The port's ServingEngine held against the JAX engine on the CPU.

The same ``llama_tiny`` weights (built by the JAX package, carried across
with ``convert.load_jax_state_dict``) serve the same arrival schedules —
those of tests/test_unified_ragged.py — through both engines. Every
request's committed tokens must be IDENTICAL, the engines must make the
same scheduling decisions (preemptions, launch-site shape keys, token
counts), and after warmup the port's launch-site shape lattice stays
flat across new length mixes.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.inference import create_predictor as jax_predictor
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.inference import Config, ServingEngine, create_predictor
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

PAGE = 8


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = JaxLlama(jax_tiny())
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_state_dict(tm, state)
    return jm, tm


def _engines(models, **kw):
    jm, tm = models
    je = JaxEngine(jax_predictor(JaxConfig().set_model(jm)
                                 .enable_paged_kv(page_size=PAGE)), **kw)
    te = ServingEngine(create_predictor(Config().set_model(tm)
                                        .enable_paged_kv(page_size=PAGE)),
                       **kw)
    return je, te


def _prompts(lens, seed):
    r = np.random.RandomState(seed)
    return [r.randint(1, 256, (L,)) for L in lens]


def _drive(eng, first, n_new, later=(), steps_before=0):
    rids = [eng.submit(p, max_new_tokens=n) for p, n in zip(first, n_new)]
    for _ in range(steps_before):
        eng.step()
    rids += [eng.submit(p, max_new_tokens=n) for p, n in later]
    done = eng.run()
    return [list(done[r].new_tokens) for r in rids]


def _jax_preemptions(eng):
    return sum(sp["name"] == "preempt" for t in eng.request_traces()
               for sp in t["spans"])


def _same_decisions(je, te):
    for k in ("compiles", "cache_hits", "tokens"):
        assert getattr(te.stats, k) == getattr(je.stats, k), k


SCHEDULES = {
    # chunk boundaries off the page lattice, prompts under and over Sc,
    # a stream longer than the batch
    "mixed_stream": (dict(max_batch=2, prefill_chunk=16),
                     ([7, 4, 19, 33, 5], 0), 6),
    # a budget below the chunk bucket splits feeds mid-chunk and mid-page
    "token_budget": (dict(max_batch=3, prefill_chunk=16,
                          prefill_token_budget=10), ([23, 9, 17], 1), 5),
    # pure prefill-chunk batches, no decode rows ever
    "prefill_only": (dict(max_batch=2, prefill_chunk=16), ([21, 34], 3), 1),
    # legacy per-arrival prefill (K5 at [1, Sb]) and fused decode steps
    "legacy_prefill": (dict(max_batch=2), ([7, 4, 19, 33, 5], 0), 6),
    "legacy_decode_chunk": (dict(max_batch=3, decode_chunk=3),
                            ([12, 30, 3, 17], 4), 7),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_engine(models, name):
    kw, (lens, seed), n_new = SCHEDULES[name]
    je, te = _engines(models, **kw)
    prompts = _prompts(lens, seed)
    ours = _drive(te, prompts, [n_new] * len(prompts))
    ref = _drive(je, prompts, [n_new] * len(prompts))
    assert ours == ref
    _same_decisions(je, te)


def test_arrival_mid_decode_matches_jax_engine(models):
    """A long prompt submitted while others decode feeds its chunks
    through the unified step while the decode rows keep advancing."""
    je, te = _engines(models, max_batch=3, prefill_chunk=16)
    a, b, c = _prompts([8, 5, 40], 2)
    args = ([a, b], [8, 8], [(c, 4)], 3)
    ours = _drive(te, *args)
    assert te.rounds["unified"] > 0 and te.rounds["decode"] > 0
    assert ours == _drive(je, *args)
    _same_decisions(je, te)


def test_long_prompt_coadmits_short_matches_jax_engine(models):
    """15 usable pages: the long request's footprint is 14 pages, so only
    chunked admission (first chunk's pages) lets the short one co-admit."""
    je, te = _engines(models, max_batch=2, pool_pages=15, prefill_chunk=16)
    long_p = _prompts([104], 10)[0]
    short_p = _prompts([8], 11)[0]
    te.submit(long_p, max_new_tokens=8)
    te.submit(short_p, max_new_tokens=8)
    te.step()
    assert te.num_active == 2 and not te.queue
    ours = [list(r.new_tokens) for _, r in sorted(te.run().items())]
    assert ours == _drive(je, [long_p, short_p], [8, 8])
    assert len(te._free_pages) == 15          # every page came back
    _same_decisions(je, te)


def test_page_starved_pool_preempts_like_jax_engine(models):
    """Two 6-page prompts in a 7-page pool: both co-admit, collide
    mid-prefill, and the youngest bounces back to the queue — the same
    number of times in both engines — and both still finish exactly."""
    je, te = _engines(models, max_batch=2, pool_pages=7, prefill_chunk=16)
    prompts = _prompts([40, 40], 12)
    ours = _drive(te, prompts, [8, 8])
    assert ours == _drive(je, prompts, [8, 8])
    assert te.rounds["preempted"] >= 1
    assert te.rounds["preempted"] == _jax_preemptions(je)
    assert len(te._free_pages) == 7
    _same_decisions(je, te)


def test_shape_lattice_flat_after_warmup(models):
    """After one warmup mix, new length mixes add no launch-site shape
    key (the property a CUDA-graph capture per shape will rely on)."""
    je, te = _engines(models, max_batch=4, prefill_chunk=16)
    warm = _prompts([7, 40], 5)
    _drive(te, warm, [5, 5])
    _drive(je, warm, [5, 5])
    n_warm = te.stats.compiles
    assert n_warm > 0
    for i, mix in enumerate([(3, 9, 21), (33, 5), (30, 2, 14, 8), (13,)]):
        ps = _prompts(list(mix), 6 + i)
        assert _drive(te, ps, [5] * len(ps)) == _drive(je, ps, [5] * len(ps))
    assert te.stats.compiles == n_warm, te.stats.as_dict()
    assert te.stats.cache_hits > 0
    _same_decisions(je, te)


def test_pools_and_generator_live_on_the_model_device(models):
    je, te = _engines(models, max_batch=2, prefill_chunk=16)
    assert all(k.device.type == "cpu" and v.device.type == "cpu"
               for k, v in te.pools)
    assert te._generator.device.type == "cpu"
    # pool: bucket(B * npages + 1, lo=8) = bucket(33) = 64 pages; chunk:
    # bucket(16, lo=page) — the JAX engine's lattice exactly
    assert (te.P, te.Sc, te.npages) == (je.P, je.Sc, je.npages) == (64, 16, 16)
    assert tuple(te.pools[0][0].shape) == tuple(je.pools[0][0].shape)


def test_eos_stops_rows_like_jax_engine(models):
    je, te = _engines(models, max_batch=2, prefill_chunk=16)
    prompts = _prompts([7, 19, 5], 0)
    free = _drive(JaxEngine(jax_predictor(
        JaxConfig().set_model(models[0]).enable_paged_kv(page_size=PAGE)),
        max_batch=2, prefill_chunk=16), prompts, [6] * 3)
    eos = free[1][2]                    # stops request 1 at its 3rd token
    outs = []
    for eng in (te, je):
        rids = [eng.submit(p, max_new_tokens=6, eos_token_id=eos)
                for p in prompts]
        done = eng.run()
        outs.append([list(done[r].new_tokens) for r in rids])
    assert outs[0] == outs[1]
    assert outs[0][1] == free[1][:3]


def test_sample_greedy_and_stochastic_modes():
    import torch

    from paddle_tpu_torch.inference import GenerationConfig, _sample

    lg = torch.tensor([[0.5, 2.0, 2.0, -1.0], [3.0, 1.0, 0.0, 3.0]],
                      dtype=torch.bfloat16)
    # greedy: float32 argmax, first index on ties (jnp.argmax's rule)
    assert _sample(lg, GenerationConfig()).tolist() == [1, 0]
    g = torch.Generator().manual_seed(0)
    gen = GenerationConfig(temperature=0.7, top_k=2)
    picks = {int(_sample(lg[:1].float(), gen, g)) for _ in range(64)}
    assert picks == {1, 2}              # only the top-2 logits survive
    gen = GenerationConfig(temperature=1.0, top_p=0.5)
    big = torch.tensor([[10.0, 0.0, 0.0, 0.0]])
    assert {int(_sample(big, gen, g)) for _ in range(16)} == {0}

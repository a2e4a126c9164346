"""The port's prefix cache and speculative decoding held against the JAX
engine on the CPU.

The same ``llama_tiny`` and ``llama_tiny_draft`` weights (built by the
JAX package, carried across with ``convert.load_jax_state_dict``) serve
the schedules of tests/test_serving_prefix_spec.py through both engines,
in fp32. Every request's committed tokens must be IDENTICAL, and so must
the prefix-cache counters (lookups, hits, copy-on-writes, reclaims,
registrations, skipped and fed tokens), the speculative counters
(proposed, accepted, verify steps, committed) and the launch-site shape
keys each engine noted.
"""
from collections import Counter

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.inference import create_predictor as jax_predictor
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.models.llama import llama_tiny_draft as jax_tiny_draft
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.core.enforce import PreconditionNotMetError
from paddle_tpu_torch.inference import Config, ServingEngine, create_predictor
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           llama_tiny_draft)

PAGE = 8
PFX_KEYS = ("lookups", "hits", "cow", "reclaimed", "registered",
            "skipped_tokens", "fed_tokens")
SPEC_KEYS = ("proposed", "accepted", "rounds", "committed")


def _pair(jax_cfg, torch_cfg, seed):
    paddle.seed(seed)
    jm = JaxLlama(jax_cfg)
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(torch_cfg, device="cpu")
    load_jax_state_dict(tm, state)
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return {"target": _pair(jax_tiny(), llama_tiny(), 11),
            "draft": _pair(jax_tiny_draft(), llama_tiny_draft(), 13)}


def _preds(models, name):
    jm, tm = models[name]
    return (jax_predictor(JaxConfig().set_model(jm)
                          .enable_paged_kv(page_size=PAGE)),
            create_predictor(Config().set_model(tm)
                             .enable_paged_kv(page_size=PAGE)))


def _engines(models, draft=None, **kw):
    """The JAX and the port's engine with the same settings; ``draft`` is
    None, "draft" (llama_tiny_draft) or "self" (the target drafts for
    itself)."""
    jp, tp = _preds(models, "target")
    if draft == "self":
        jkw, tkw = dict(draft_predictor=jp), dict(draft_predictor=tp)
    elif draft == "draft":
        jd, td = _preds(models, "draft")
        jkw, tkw = dict(draft_predictor=jd), dict(draft_predictor=td)
    else:
        jkw = tkw = {}
    return JaxEngine(jp, **kw, **jkw), ServingEngine(tp, **kw, **tkw)


def _keys(stats):
    """The noted (site, shape key) pairs, dtypes named as numpy names."""
    def norm(v):
        return v.replace("torch.", "") if isinstance(v, str) else v

    return {(site, tuple(norm(v) for v in key)) for site, key in stats._seen}


def _same_counters(je, te):
    jp, tp = je.prefix_cache_stats(), te.prefix_cache_stats()
    assert {k: tp[k] for k in PFX_KEYS} == {k: jp[k] for k in PFX_KEYS}
    js, ts = je.spec_stats(), te.spec_stats()
    assert {k: ts[k] for k in SPEC_KEYS} == {k: js[k] for k in SPEC_KEYS}
    for k in ("compiles", "cache_hits", "tokens"):
        assert getattr(te.stats, k) == getattr(je.stats, k), k
    assert _keys(te.stats) == _keys(je.stats)


def _sys_prompt(pages, seed=5):
    return np.random.RandomState(seed).randint(1, 256, (pages * PAGE,))


def _with_tail(sysp, tail, seed):
    r = np.random.RandomState(seed)
    return np.concatenate([sysp, r.randint(1, 256, (tail,))])


def _jax_preemptions(eng):
    return sum(sp["name"] == "preempt" for t in eng.request_traces()
               for sp in t["spans"])


# -- schedules: each drives one engine and returns its committed streams --
def _shared_prefix(eng):
    sysp = _sys_prompt(4)                       # 32 tokens, Sc = 16
    r0 = eng.submit(_with_tail(sysp, 0, 1), max_new_tokens=4)
    eng.run()                                   # the donor registers pages
    r1 = eng.submit(_with_tail(sysp, 8, 2), max_new_tokens=4)
    done = eng.run()
    return [list(done[r].new_tokens) for r in (r0, r1)]


def _cow(eng):
    sysp = _sys_prompt(3)
    r0 = eng.submit(sysp, max_new_tokens=10)
    for _ in range(4):                          # the donor reaches decode
        eng.step()
    r1 = eng.submit(sysp.copy(), max_new_tokens=10)
    done = eng.run()
    return [list(done[r].new_tokens) for r in (r0, r1)]


def _preempt_sharer(eng):
    sysp = _sys_prompt(3)                       # 3 cached pages
    rids = [eng.submit(sysp, max_new_tokens=4)]
    eng.run()                                   # donor -> 3 idle pages
    cold = np.random.RandomState(9).randint(1, 256, (40,))
    rids.append(eng.submit(cold, max_new_tokens=4))          # elder, cold
    rids.append(eng.submit(_with_tail(sysp, 8, 3), max_new_tokens=4))
    rids.append(eng.submit(_with_tail(sysp, 8, 4), max_new_tokens=4))
    done = eng.run()
    return [list(done[r].new_tokens) for r in rids]


def _lru(eng):
    out = []
    for i in range(4):                          # sequential: the cache fills
        rid = eng.submit(_sys_prompt(3, seed=20 + i), max_new_tokens=4)
        out.append(list(eng.run()[rid].new_tokens))
    return out


def _stream(prompts, n_new):
    def drive(eng):
        rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
        done = eng.run()
        return [list(done[r].new_tokens) for r in rids]
    return drive


def _spec_prompts(seed, lens):
    r = np.random.RandomState(seed)
    return [r.randint(1, 256, (L,)) for L in lens]


PFX = dict(prefill_chunk=16, prefix_cache=True, debug_invariants=True)
SPEC = dict(max_batch=3, prefill_chunk=16, debug_invariants=True)

SCHEDULES = {
    # a request sharing a 4-page prefix feeds ONE chunk from the cached
    # frontier (8 tokens) instead of three
    "shared_prefix": (None, dict(max_batch=2, **PFX), _shared_prefix),
    # a full-prompt hit refeeds into a shared page while the donor decodes
    "cow": (None, dict(max_batch=2, **PFX), _cow),
    # two sharers of the donor's pages; page starvation preempts the
    # younger mid-prefill
    "preempt_sharer": (None, dict(max_batch=3, pool_pages=8, **PFX),
                       _preempt_sharer),
    # distinct prompts fill the pool with idle cached pages
    "lru_reclaim": (None, dict(max_batch=2, pool_pages=8, **PFX), _lru),
    # a distinct draft model and the target drafting for itself
    "spec_draft": ("draft", dict(spec_tokens=3, **SPEC),
                   _stream(_spec_prompts(3, [7, 12, 21, 5, 9]), 10)),
    "spec_self": ("self", dict(spec_tokens=3, **SPEC),
                  _stream(_spec_prompts(4, [7, 12, 9]), 12)),
}


def _check_shared_prefix(te, je, out):
    s = te.prefix_cache_stats()
    assert s["hits"] == 4 and s["skipped_tokens"] >= 32
    # the sharer fed one 8-token chunk: fed + skipped == prompt tokens
    assert s["fed_tokens"] == 32 + 8
    assert s["fed_tokens"] + s["skipped_tokens"] == 32 + 40


def _check_cow(te, je, out):
    assert te.prefix_cache_stats()["cow"] >= 1
    assert out[0] == out[1]          # the donor's stream is untouched


def _check_preempt(te, je, out):
    assert te.rounds["preempted"] >= 1
    assert te.rounds["preempted"] == _jax_preemptions(je)


def _check_lru(te, je, out):
    assert te.prefix_cache_stats()["reclaimed"] >= 1


def _check_spec_draft(te, je, out):
    s = te.spec_stats()
    assert s["rounds"] > 0 and s["tokens_per_step"] >= 1.0


def _check_spec_self(te, je, out):
    s = te.spec_stats()
    assert s["accept_rate"] > 0.9
    assert s["tokens_per_step"] > 2.0


CHECKS = {"shared_prefix": _check_shared_prefix, "cow": _check_cow,
          "preempt_sharer": _check_preempt, "lru_reclaim": _check_lru,
          "spec_draft": _check_spec_draft, "spec_self": _check_spec_self}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_engine(models, name):
    draft, kw, drive = SCHEDULES[name]
    je, te = _engines(models, draft=draft, **kw)
    ours = drive(te)
    assert ours == drive(je)
    _same_counters(je, te)
    te.check_invariants()
    CHECKS[name](te, je, ours)


@pytest.mark.parametrize("draft", ["draft", "self"])
def test_greedy_spec_commits_plain_tokens(models, draft):
    """The acceptance gate: speculative decoding commits exactly the
    plain engine's greedy tokens (the port's plain engine and the JAX
    speculative engine)."""
    prompts = _spec_prompts(3, [7, 12, 21, 5, 9])
    _, plain = _engines(models, **SPEC)
    je, te = _engines(models, draft=draft, spec_tokens=3, **SPEC)
    ref = _stream(prompts, 10)(plain)
    assert _stream(prompts, 10)(te) == ref == _stream(prompts, 10)(je)
    assert te.rounds["unified_spec"] > 0 and te.rounds["decode"] == 0
    assert te.rounds["draft_propose"] > 0 and te.rounds["draft_chunk"] > 0


def test_requires_chunked_mode(models):
    _, tp = _preds(models, "target")
    with pytest.raises(PreconditionNotMetError, match="chunked"):
        ServingEngine(tp, max_batch=2, prefix_cache=True)


def test_spec_requires_greedy_and_chunked(models):
    _, tp = _preds(models, "target")
    with pytest.raises(PreconditionNotMetError, match="chunked"):
        ServingEngine(tp, max_batch=2, draft_predictor=tp, spec_tokens=2)
    cfg = Config().set_model(models["target"][1]).enable_paged_kv(PAGE)
    cfg.generation.temperature = 0.7
    hot = create_predictor(cfg)
    with pytest.raises(PreconditionNotMetError, match="greedy"):
        ServingEngine(hot, max_batch=2, prefill_chunk=16,
                      draft_predictor=hot, spec_tokens=2)
    with pytest.raises(PreconditionNotMetError, match="BOTH"):
        ServingEngine(tp, max_batch=2, prefill_chunk=16, spec_tokens=2)


def test_invariant_holds_across_lifecycle(models):
    """admit / finish / preempt / shed / reclaim keep free + idle + live
    an exact partition of the pool (checked after every transition), in
    step with the JAX engine."""
    sysp = _sys_prompt(3)
    je, te = _engines(models, max_batch=2, pool_pages=8, max_queue=3, **PFX)
    outs = []
    for eng in (te, je):
        rids = [eng.submit(_with_tail(sysp, 2 + i, 30 + i),
                           max_new_tokens=3) for i in range(6)]
        eng.run()
        outs.append([(eng.finished[r].shed_reason,
                      list(eng.finished[r].new_tokens)) for r in rids])
    assert outs[0] == outs[1]
    assert any(reason == "queue_full" for reason, _ in outs[0])
    te.check_invariants()
    free = len(te._free_pages) + len(te._lru)
    live = sum(1 for pg in range(te.P - 1) if te._refcount[pg])
    assert free + live == te.P - 1
    _same_counters(je, te)


def test_invariant_catches_double_free(models):
    """The checker is not a tautology: a page on the free list twice
    (a simulated double free) must raise."""
    _, tp = _preds(models, "target")
    eng = ServingEngine(tp, max_batch=2, prefill_chunk=16, prefix_cache=True)
    eng.check_invariants()
    eng._free_pages.append(eng._free_pages[0])
    with pytest.raises(PreconditionNotMetError, match="invariant"):
        eng.check_invariants()


def test_debug_env_turns_invariants_on(models, monkeypatch):
    _, tp = _preds(models, "target")
    monkeypatch.setenv("PADDLE_TPU_SERVING_DEBUG", "1")
    assert ServingEngine(tp, max_batch=2, prefill_chunk=16).debug
    monkeypatch.setenv("PADDLE_TPU_SERVING_DEBUG", "0")
    assert not ServingEngine(tp, max_batch=2, prefill_chunk=16).debug


def test_shape_lattice_flat_after_warmup_both_features(models):
    """Prefix cache and speculation together: after one warmup mix (cold
    prompt, shared prefix, full hit with copy-on-write, decode), a varied
    stream notes no new shape key, and every stream and counter equals
    the JAX engine's."""
    sysp = _sys_prompt(2)
    je, te = _engines(models, draft="draft", max_batch=3, spec_tokens=3,
                      **PFX)
    warm = [(_with_tail(sysp, 5, 1), 6), (_with_tail(sysp, 9, 2), 6),
            (sysp.copy(), 4)]
    later = [(_with_tail(sysp, 3 + i, 40 + i), 4 + (i % 3))
             for i in range(6)] + [(sysp.copy(), 3)]
    outs, n_warm = [], []
    for eng in (te, je):
        for p, n in warm:
            eng.submit(p, max_new_tokens=n)
        eng.run()
        n_warm.append(eng.stats.compiles)
        rids = [eng.submit(p, max_new_tokens=n) for p, n in later]
        done = eng.run()
        outs.append([list(done[r].new_tokens) for r in rids])
    assert outs[0] == outs[1]
    assert te.stats.compiles == n_warm[0] == n_warm[1] == je.stats.compiles
    sites = Counter(site for site, _ in te.stats._seen)
    assert {"unified_spec", "draft_propose", "draft_chunk",
            "page_copy"} <= set(sites)
    assert te.prefix_cache_stats()["hits"] > 0
    assert te.prefix_cache_stats()["cow"] >= 1
    _same_counters(je, te)


def test_replayed_first_bodies_commit_jax_engine_tokens(models, monkeypatch):
    """An eager stand-in for capture (as in tests/test_torch_cuda_graphs.py):
    a key's first step keeps its body and every later step of the key
    runs that body again, as a replay does. With the prefix cache and a
    draft, every verify, proposal and draft-feed round after the first
    replays the first one's body, across shared pages and a copy-on-write;
    the tokens still equal the JAX engine's, so each body reads only its
    static buffers."""
    from paddle_tpu_torch.core.cuda_graphs import StepGraphs

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
    sysp = _sys_prompt(3)
    je, te = _engines(models, draft="draft", max_batch=2, spec_tokens=3,
                      **PFX)
    prompts = [_with_tail(sysp, 5, 1), _with_tail(sysp, 11, 2), sysp.copy(),
               _with_tail(sysp, 2, 3)]

    def drive(eng):
        rids = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts[:2], [7, 5])]
        for _ in range(3):
            eng.step()
        rids += [eng.submit(p, max_new_tokens=n)
                 for p, n in zip(prompts[2:], [6, 8])]
        done = eng.run()
        return [list(done[r].new_tokens) for r in rids]

    assert drive(te) == drive(je)
    for site in ("unified_spec", "draft_propose", "draft_chunk"):
        assert te.stats.captures[site] == 1
        assert te.stats.replays[site] == te.rounds[site] - 1 > 0
    assert te.prefix_cache_stats()["cow"] >= 1
    _same_counters(je, te)


def test_cow_copies_every_pool_and_leaves_the_donor_page(models):
    """The page a full-prompt hit refeeds into is copied in every target
    and draft pool before the write, and the shared original keeps its
    bits to the end of the run (the refeed wrote into the copy)."""
    import torch

    _, te = _engines(models, draft="draft", max_batch=2, spec_tokens=3,
                     **PFX)
    copies = []
    copy_page = te._copy_page

    def watched(src, dst):
        copy_page(src, dst)
        if src == dst:
            return                    # the constructor's no-op copy
        pools = [p for kv in te.pools + te.draft_pools for p in kv]
        assert all(torch.equal(p[dst], p[src]) for p in pools)
        copies.append((src, [p[src].clone() for p in pools]))

    te._copy_page = watched
    _cow(te)
    assert len(copies) == te.prefix_cache_stats()["cow"] >= 1
    pools = [p for kv in te.pools + te.draft_pools for p in kv]
    for src, rows in copies:
        assert all(torch.equal(p[src], r) for p, r in zip(pools, rows))

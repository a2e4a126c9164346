"""The port's load shedding and host spill held against the JAX engine on
the CPU, and the serving options that are not ported raising.

The serving cases of tests/test_fault_tolerance.py (queue-full and
deadline shedding, health) and tests/test_host_offload.py (spill to the
host, fault back, the cap) run through both engines from the same
``llama_tiny`` (and ``llama_tiny_draft``) weights in fp32: the committed
tokens, the shed reasons, ``health()``, and ``spill_stats()``'s counts and
bytes must be equal, and the host tier must hold the same hashes.
"""
import time

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


def _engines(models, draft=False, **kw):
    jp, tp = _preds(models, "target")
    jkw = tkw = {}
    if draft:
        jd, td = _preds(models, "draft")
        jkw = dict(draft_predictor=jd, spec_tokens=2)
        tkw = dict(draft_predictor=td, spec_tokens=2)
    return JaxEngine(jp, **kw, **jkw), ServingEngine(tp, **kw, **tkw)


def _results(eng, rids):
    return [(eng.finished[r].shed_reason, list(eng.finished[r].new_tokens))
            for r in rids]


# -- shedding (tests/test_fault_tolerance.py, TestServingDegradation) -----
@pytest.mark.parametrize("chunk", [None, 16], ids=["legacy", "chunked"])
def test_queue_full_sheds_at_submit(models, chunk):
    je, te = _engines(models, max_batch=2, max_queue=2, prefill_chunk=chunk)
    outs = []
    for eng in (te, je):
        r = np.random.RandomState(0)
        rids = [eng.submit(r.randint(1, 256, (5,)), max_new_tokens=4)
                for _ in range(6)]
        # 2 queued (+0 active yet): the rest shed at once
        shed = [rid for rid in rids if rid in eng.finished
                and eng.finished[rid].shed]
        assert len(shed) == 4
        assert eng.health() == "degraded"
        eng.run()
        outs.append(_results(eng, rids))
    assert outs[0] == outs[1]
    assert [reason for reason, _ in outs[0]] == [None] * 2 + \
        ["queue_full"] * 4
    assert all(toks for reason, toks in outs[0] if reason is None)
    assert all(not toks for reason, toks in outs[0] if reason)
    shed = [te.finished[r] for r in te.finished if te.finished[r].shed]
    assert all(r.t_finish > 0 and r.t_first_token == 0.0 for r in shed)


@pytest.mark.parametrize("chunk", [None, 16], ids=["legacy", "chunked"])
def test_deadline_sheds_before_prefill(models, chunk):
    je, te = _engines(models, max_batch=2, admission_deadline_s=0.0,
                      prefill_chunk=chunk)
    for eng in (te, je):
        rid = eng.submit(np.random.RandomState(1).randint(1, 256, (5,)),
                         max_new_tokens=4)
        late = eng.submit(np.arange(1, 6), max_new_tokens=2,
                          deadline_s=60.0)       # its own, looser deadline
        time.sleep(0.01)
        eng.run()
        assert eng.finished[rid].shed_reason == "deadline"
        assert not eng.finished[rid].new_tokens   # never prefilled
        assert not eng.finished[late].shed
    assert list(te.finished[late].new_tokens) == \
        list(je.finished[late].new_tokens)
    assert te.stats.tokens == je.stats.tokens


def test_health_degraded_then_ok_after_window(models):
    je, te = _engines(models, max_batch=2, max_queue=1,
                      degraded_window_s=0.2, prefill_chunk=16)
    for eng in (te, je):
        assert eng.health() == "ok"
        for _ in range(3):
            eng.submit(np.arange(1, 5), max_new_tokens=2)
        assert eng.health() == "degraded"      # queue at its bound, 2 shed
        eng.queue.clear()                      # only the shed keeps it
        assert eng.health() == "degraded"
        time.sleep(0.25)                       # past the window
        assert eng.health() == "ok"


def test_unbounded_engine_stays_ok(models):
    je, te = _engines(models, max_batch=2)
    assert te.health() == je.health() == "ok"
    assert te.max_queue is je.max_queue is None


# -- host spill (tests/test_host_offload.py, TestServingSpill) ------------
SPILL = dict(max_batch=2, pool_pages=8, prefill_chunk=16, prefix_cache=True,
             debug_invariants=True)


def _spill_prompts(base, n):
    return [np.random.RandomState(base + i).randint(1, 256, (3 * PAGE,))
            for i in range(n)]


@pytest.mark.parametrize("draft", [False, True], ids=["plain", "spec"])
def test_spill_fault_parity_and_ledger(models, draft):
    """4 x 3 pages through an 8-page pool spill reclaimed pages to the
    host; resubmitting the first prompt faults them back as prefix hits.
    Tokens, spill counts and transfer bytes equal the JAX engine's."""
    je, te = _engines(models, draft=draft, host_spill_pages=8, **SPILL)
    prompts = _spill_prompts(20, 4)
    outs, stats = [], []
    for eng in (te, je):
        toks = []
        for p in prompts:
            rid = eng.submit(p, max_new_tokens=4)
            toks.append(list(eng.run()[rid].new_tokens))
        sp = eng.spill_stats()
        hits0 = eng.prefix_cache_stats()["hits"]
        rid = eng.submit(prompts[0], max_new_tokens=4)
        toks.append(list(eng.run()[rid].new_tokens))
        outs.append(toks)
        stats.append((sp, eng.spill_stats(),
                      eng.prefix_cache_stats()["hits"] - hits0))
    assert outs[0] == outs[1]
    assert outs[0][-1] == outs[0][0]            # faulted pages serve exactly
    assert stats[0] == stats[1]
    sp, sp2, new_hits = stats[0]
    assert sp["spilled"] >= 1 and sp["host_pages"] >= 1
    # closed form: a page's rows across every pool and layer
    page_bytes = sum(2 * kp[0].numel() * kp.element_size()
                     for kp, _ in te.pools)
    if draft:
        page_bytes += sum(2 * kp[0].numel() * kp.element_size()
                          for kp, _ in te.draft_pools)
    assert sp["transfer_bytes"]["d2h"] == page_bytes * sp["spilled"]
    assert sp2["faulted"] >= 1 and new_hits > 0
    assert sp2["transfer_bytes"]["h2d"] == page_bytes * sp2["faulted"]
    assert list(te._spilled) == list(je._spilled)
    te.check_invariants()


def test_spill_capacity_drops_oldest(models):
    je, te = _engines(models, host_spill_pages=2, **SPILL)
    for eng in (te, je):
        for p in _spill_prompts(40, 4):
            eng.submit(p, max_new_tokens=2)
            eng.run()
    sp = te.spill_stats()
    assert sp == je.spill_stats()
    assert sp["host_pages"] <= 2 and sp["dropped"] >= 1
    # the survivors are the newest spills, in the JAX engine's order
    assert list(te._spilled) == list(je._spilled)
    assert set(te._spilled).isdisjoint(te._hash_page)
    te.check_invariants()


def test_spill_requires_prefix_cache(models):
    _, tp = _preds(models, "target")
    with pytest.raises(PreconditionNotMetError, match="prefix"):
        ServingEngine(tp, pool_pages=8, host_spill_pages=4)


# -- the options the port once refused, served now -----------------------
@pytest.mark.parametrize("kw", [dict(trace_ring=64), dict(mem_ledger=True),
                                dict(phase="prefill"), dict(phase="decode"),
                                dict(pool_pages="auto")],
                         ids=["trace_ring", "mem_ledger", "phase_prefill",
                              "phase_decode", "pool_auto"])
def test_unported_engine_options_raise(models, kw):
    """Each option builds the engine the JAX package builds with it: the
    same pool, phase and ring bound, and nothing raises any more (a
    decode replica refuses submit in both packages)."""
    jp, tp = _preds(models, "target")
    je = JaxEngine(jp, max_batch=2, prefill_chunk=16, **kw)
    te = ServingEngine(tp, max_batch=2, prefill_chunk=16, **kw)
    assert te.P == je.P and te.phase == je.phase
    assert te.traces._ring.maxlen == je.traces._ring.maxlen
    assert te._mem_on == je._mem_on
    if kw.get("phase") == "decode":
        for eng in (te, je):
            with pytest.raises(Exception, match="decode"):
                eng.submit(np.arange(1, 5), max_new_tokens=2)
        return
    outs = []
    for eng in (te, je):
        rid = eng.submit(np.arange(1, 5), max_new_tokens=2)
        if kw.get("phase") == "prefill":
            for _ in range(4):
                eng.step()
            assert eng.migratable() == [rid]     # parked for export
            outs.append(list(eng.slots[0].req.new_tokens))
        else:
            outs.append(list(eng.run()[rid].new_tokens))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kw", [
    dict(trace_id="0af7651916cd43dd8448eb211c80319c"),
    dict(parent_span_id="b7ad6b7169203331")],
    ids=["trace_id", "parent_span_id"])
def test_unported_submit_options_raise(models, kw):
    """submit's trace identity is adopted as the JAX engine adopts it."""
    jp, tp = _preds(models, "target")
    te = ServingEngine(tp, max_batch=2, prefill_chunk=16)
    je = JaxEngine(jp, max_batch=2, prefill_chunk=16)
    ctx = []
    for eng in (te, je):
        rid = eng.submit(np.arange(1, 5), max_new_tokens=2, **kw)
        eng.run()
        c = eng.trace_context(rid)
        for key, v in kw.items():
            assert c[key] == v
        assert len(c["trace_id"]) == 32 and len(c["span_id"]) == 16
        ctx.append(list(eng.finished[rid].new_tokens))
    assert ctx[0] == ctx[1]

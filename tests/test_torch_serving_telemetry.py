"""The port's serving telemetry held against the JAX engine's on the CPU.

The same ``llama_tiny`` weights (and ``llama_tiny_draft``'s for
speculation), built by the JAX package and carried across with
``convert.load_jax_state_dict``, serve the schedules of
tests/test_torch_serving*.py through both engines in fp32, each engine
on a fresh registry. Then, exactly:

- every request's spans, in order, with their meta (queued / prefill /
  prefill_chunk / decode_round / decode / e2e; shed and preempt
  instants; the times differ and are not compared);
- the serving series of the registry: histogram counts (TTFT, TPOT,
  stages, rounds), the lifecycle, token, chunk, stall, prefix and shed
  counters, the compile counters and the final gauges (no sum, bucket
  or other time-valued series);
- submit's traceparent adoption and its two parse-error reasons;
- the spill tier's offload gauges;
- ``/healthz`` and ``/metrics`` through ``serve_metrics(0)``, and every
  live name inside the port's (the JAX package's) ``schema.json``.
"""
import json
import os
import time
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.inference import create_predictor as jax_predictor
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.models.llama import llama_tiny_draft as jax_tiny_draft
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.inference import Config, ServingEngine, create_predictor
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           llama_tiny_draft)
from paddle_tpu_torch.observability import spans as tspans
from paddle_tpu_torch.observability.catalog import SCHEMA_PATH

PAGE = 8
# the series compared: the serving set's, the compile counters and the
# spill tier's gauges
PREFIXES = ("paddle_tpu_serving_", "paddle_tpu_compile",
            "paddle_tpu_offload_")


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
    """Both engines on fresh registries (their instruments bind at
    construction)."""
    jobs.reset_registry()
    obs.reset_registry()
    jp, tp = _preds(models, "target")
    jkw = tkw = {}
    if draft:
        jd, td = _preds(models, "draft")
        jkw, tkw = dict(draft_predictor=jd), dict(draft_predictor=td)
    return JaxEngine(jp, **kw, **jkw), ServingEngine(tp, **kw, **tkw)


def _plain(meta):
    """A span's meta without its float values (times)."""
    return {k: v for k, v in (meta or {}).items()
            if not isinstance(v, float)}


def _spans(eng):
    """Every finished trace: rid, its meta, its spans' names and meta."""
    return [(t["rid"], _plain(t["meta"]),
             [(sp["name"], _plain(sp.get("meta"))) for sp in t["spans"]])
            for t in eng.request_traces()]


def _series(snap):
    """{name: {labels: value or count}} of the compared series."""
    out = {}
    for name, entry in snap["metrics"].items():
        if not name.startswith(PREFIXES) or not entry["series"]:
            continue
        key = "count" if entry["type"] == "histogram" else "value"
        out[name] = {tuple(sorted(s["labels"].items())): s[key]
                     for s in entry["series"]}
    return out


def _same_telemetry(je, te):
    assert _spans(te) == _spans(je)
    mine = _series(te.metrics_snapshot())
    ref = _series(je.metrics_snapshot())
    assert mine == ref
    return mine


def _prompts(lens, seed):
    r = np.random.RandomState(seed)
    return [r.randint(1, 256, (L,)) for L in lens]


def _stream(lens, seed, n_new, later=(), steps_before=0):
    def drive(eng):
        rids = [eng.submit(p, max_new_tokens=n_new)
                for p in _prompts(lens, seed)]
        for _ in range(steps_before):
            eng.step()
        rids += [eng.submit(p, max_new_tokens=n_new)
                 for p in _prompts(list(later), seed + 100)]
        done = eng.run()
        return [list(done[r].new_tokens) for r in rids]
    return drive


def _sys_prompt(pages, seed=5):
    return np.random.RandomState(seed).randint(1, 256, (pages * PAGE,))


def _shared_prefix(eng):
    sysp = _sys_prompt(4)
    r0 = eng.submit(sysp, max_new_tokens=4)
    eng.run()
    tail = np.random.RandomState(2).randint(1, 256, (8,))
    r1 = eng.submit(np.concatenate([sysp, tail]), max_new_tokens=4)
    done = eng.run()
    return [list(done[r].new_tokens) for r in (r0, r1)]


def _cow(eng):
    sysp = _sys_prompt(3)
    r0 = eng.submit(sysp, max_new_tokens=10)
    for _ in range(4):
        eng.step()
    r1 = eng.submit(sysp.copy(), max_new_tokens=10)
    done = eng.run()
    return [list(done[r].new_tokens) for r in (r0, r1)]


def _lru(eng):
    out = []
    for i in range(4):
        rid = eng.submit(_sys_prompt(3, seed=20 + i), max_new_tokens=4)
        out.append(list(eng.run()[rid].new_tokens))
    return out


PFX = dict(prefill_chunk=16, prefix_cache=True)
SCHEDULES = {
    "mixed_stream": (False, dict(max_batch=2, prefill_chunk=16),
                     _stream([7, 4, 19, 33, 5], 0, 6)),
    "token_budget": (False, dict(max_batch=3, prefill_chunk=16,
                                 prefill_token_budget=10),
                     _stream([23, 9, 17], 1, 5)),
    "arrival_mid_decode": (False, dict(max_batch=3, prefill_chunk=16),
                           _stream([8, 5], 2, 8, later=[40],
                                   steps_before=3)),
    "page_starved": (False, dict(max_batch=2, pool_pages=7,
                                 prefill_chunk=16),
                     _stream([40, 40], 12, 8)),
    "legacy_prefill": (False, dict(max_batch=2),
                       _stream([7, 4, 19, 33, 5], 0, 6)),
    "legacy_decode_chunk": (False, dict(max_batch=3, decode_chunk=3),
                            _stream([12, 30, 3, 17], 4, 7)),
    "shared_prefix": (False, dict(max_batch=2, **PFX), _shared_prefix),
    "cow": (False, dict(max_batch=2, **PFX), _cow),
    "lru_reclaim": (False, dict(max_batch=2, pool_pages=8, **PFX), _lru),
    "spec_draft": (True, dict(max_batch=3, prefill_chunk=16,
                              spec_tokens=3),
                   _stream([7, 12, 21, 5, 9], 3, 10)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_spans_and_metrics_match_jax(models, name):
    draft, kw, drive = SCHEDULES[name]
    je, te = _engines(models, draft=draft, **kw)
    ours = drive(te)
    assert ours == drive(je)
    series = _same_telemetry(je, te)
    done = [r for r in te.finished.values() if not r.shed]
    n_multi = sum(len(r.new_tokens) > 1 for r in done)
    assert series["paddle_tpu_serving_ttft_seconds"][()] == len(done)
    assert series["paddle_tpu_serving_tpot_seconds"][()] == n_multi
    stage = series["paddle_tpu_serving_request_stage_seconds"]
    assert stage[(("stage", "e2e"),)] == len(done)
    tokens = series["paddle_tpu_serving_tokens_total"]
    assert sum(tokens.values()) == sum(len(r.new_tokens) for r in done)
    assert series["paddle_tpu_serving_active_slots"][()] == 0
    if name == "page_starved":
        assert any(n == "preempt" for _, _, sps in _spans(te)
                   for n, _ in sps)


@pytest.mark.parametrize("chunk", [None, 16], ids=["legacy", "chunked"])
def test_shed_instants_match_jax(models, chunk):
    """queue_full at submit and deadline at admission: a shed instant on
    the trace, a shed counter, no TTFT and no stage observation."""
    je, te = _engines(models, max_batch=2, max_queue=2,
                      admission_deadline_s=30.0, prefill_chunk=chunk)
    for eng in (te, je):
        rids = [eng.submit(p, max_new_tokens=3)
                for p in _prompts([5, 6, 7, 8], 9)]
        late = eng.submit(np.arange(1, 6), max_new_tokens=2,
                          deadline_s=0.0)
        time.sleep(0.01)
        eng.run()
        assert eng.finished[late].shed_reason in ("deadline", "queue_full")
        del rids
    series = _same_telemetry(je, te)
    shed = series["paddle_tpu_serving_shed_total"]
    assert sum(shed.values()) == 3
    instants = [(rid, meta) for rid, meta, sps in _spans(te)
                for n, meta in sps if n == "shed"]
    assert len(instants) == 3
    doc = te.export_request_traces()
    assert sum(e["ph"] == "i" and e["name"] == "shed"
               for e in doc["traceEvents"]) == 3


def test_traceparent_adoption_matches_jax(models):
    je, te = _engines(models, max_batch=2, prefill_chunk=16)
    tid = "0af7651916cd43dd8448eb211c80319c"
    sid = "b7ad6b7169203331"
    cases = [dict(trace_id=f"00-{tid}-{sid}-01"),
             dict(trace_id=tid, parent_span_id=sid),
             dict(trace_id="00-zz-bad-header"),
             dict(trace_id="00-" + "0" * 32 + f"-{sid}-01"),
             dict(trace_id="nothex"), {}]
    for eng in (te, je):
        rids = [eng.submit(np.arange(1, 6), max_new_tokens=2, **kw)
                for kw in cases]
        eng.run()
        ctx = [eng.trace_context(r) for r in rids]
        assert ctx[0]["trace_id"] == tid and \
            ctx[0]["parent_span_id"] == sid
        assert ctx[1]["trace_id"] == tid and \
            ctx[1]["parent_span_id"] == sid
        for c in ctx[2:]:
            assert len(c["trace_id"]) == 32 and c["trace_id"] != tid
        for c in ctx:
            # the header for the next hop names this request's root span
            assert tspans.parse_traceparent(c["traceparent"]) == \
                (c["trace_id"], c["span_id"])
            assert eng.finished[rids[0]].traceparent == \
                eng.trace_context(rids[0])["traceparent"]
        assert eng.trace_context(10 ** 6) is None
    series = _same_telemetry(je, te)
    assert series["paddle_tpu_serving_trace_parse_errors_total"] == {
        (("reason", "malformed_traceparent"),): 2.0,
        (("reason", "invalid_trace_id"),): 1.0}
    # the Chrome export carries the identity on every event
    events = te.export_request_traces()["traceEvents"]
    assert any(e.get("args", {}).get("trace_id") == tid for e in events)


def test_spans_roundtrip_and_chrome_export(tmp_path):
    """The copied spans module against the JAX one: header grammar,
    validation and the Chrome document of the same traces."""
    from paddle_tpu.observability import spans as jspans

    for h in ("00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
              "00-zz", "00-" + "0" * 32 + "-b7ad6b7169203331-01",
              " 00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-01 "):
        try:
            want = jspans.parse_traceparent(h)
        except ValueError:
            with pytest.raises(ValueError):
                tspans.parse_traceparent(h)
        else:
            assert tspans.parse_traceparent(h) == want
    docs = []
    for mod in (tspans, jspans):
        ring = mod.SpanRing(maxlen=2)
        for rid in range(3):
            tr = mod.RequestTrace(rid, meta={"k": rid},
                                  trace_id="ab" * 16)
            tr.span_id = "cd" * 8
            tr.begin("queued", 1.0 + rid)
            tr.end("queued", 1.5 + rid)
            tr.add("shed", 2.0 + rid, 2.0 + rid, {"reason": "x"})
            for sp in tr.spans:
                sp.span_id = "ef" * 8
            ring.add(tr)
        assert len(ring) == 2                       # the bound holds
        docs.append(ring.to_chrome_trace(str(tmp_path / mod.__name__)))
    assert docs[0] == docs[1]
    assert json.loads((tmp_path / tspans.__name__).read_text()) == docs[0]


def test_trace_ring_bounds_finished_traces(models):
    je, te = _engines(models, max_batch=2, prefill_chunk=16, trace_ring=3)
    for eng in (te, je):
        for p in _prompts([5, 6, 7, 8, 9], 4):
            eng.submit(p, max_new_tokens=2)
        eng.run()
        assert [t["rid"] for t in eng.request_traces()] == [2, 3, 4]
    assert _spans(te) == _spans(je)


def test_healthz_and_scrape_through_serve_metrics(models):
    """/healthz carries the engine's health component (degraded while it
    sheds) and /metrics the stage histogram's count."""
    je, te = _engines(models, max_batch=2, max_queue=1, prefill_chunk=16,
                      degraded_window_s=60.0)
    del je
    with obs.serve_metrics(0) as srv:
        url = f"http://127.0.0.1:{srv.port}"

        def get(path):
            with urllib.request.urlopen(url + path, timeout=10) as r:
                return r.read().decode()

        doc = json.loads(get("/healthz"))
        assert {"component": "serving", "status": "ok"} in \
            doc["components"]
        for p in _prompts([5, 6, 7], 3):
            te.submit(p, max_new_tokens=2)
        te.run()
        doc = json.loads(get("/healthz"))
        assert doc["status"] == "degraded"
        assert {"component": "serving", "status": "degraded"} in \
            doc["components"]
        assert doc["snapshot_age_seconds"] is not None
        text = obs.parse_prometheus_text(get("/metrics"))
        assert text["paddle_tpu_serving_request_stage_seconds_count"][
            (("stage", "e2e"),)] == 1.0
        assert text["paddle_tpu_serving_shed_total"][
            (("reason", "queue_full"),)] == 2.0


def test_spill_gauges_match_jax(models):
    """The host tier's offload gauges: cumulative bytes by direction,
    host bytes and resident pages, equal to the JAX engine's and to
    spill_stats()."""
    je, te = _engines(models, max_batch=2, pool_pages=8, prefill_chunk=16,
                      prefix_cache=True, host_spill_pages=8)
    prompts = [np.random.RandomState(20 + i).randint(1, 256, (3 * PAGE,))
               for i in range(4)]
    for eng in (te, je):
        for p in prompts + prompts[:1]:
            rid = eng.submit(p, max_new_tokens=4)
            eng.run()
            del rid
    series = _same_telemetry(je, te)
    sp = te.spill_stats()
    got = series["paddle_tpu_offload_transfer_bytes"]
    assert got[(("component", "kv_page"), ("direction", "d2h"))] == \
        sp["transfer_bytes"]["d2h"]
    assert got[(("component", "kv_page"), ("direction", "h2d"))] == \
        sp["transfer_bytes"]["h2d"]
    assert series["paddle_tpu_offload_spilled_pages"][()] == \
        sp["host_pages"]
    assert series["paddle_tpu_offload_host_bytes"][
        (("component", "kv_page"),)] == sp["host_bytes"]


def test_live_snapshot_names_inside_schema(models):
    """Every series a served schedule leaves in the registry is a name
    of the copied schema.json, with its kind and labels."""
    je, te = _engines(models, max_batch=2, prefill_chunk=16,
                      prefix_cache=True, mem_ledger=True)
    del je
    _shared_prefix(te)
    schema = json.loads(open(SCHEMA_PATH).read())
    snap = te.metrics_snapshot()["metrics"]
    live = {n: e for n, e in snap.items() if e["series"]}
    assert "paddle_tpu_serving_ttft_seconds" in live
    assert "paddle_tpu_mem_argument_bytes" in live
    for name, entry in live.items():
        assert name in schema, name
        assert schema[name]["type"] == entry["type"], name
        assert list(schema[name]["labels"]) == list(entry["labels"]), name


def test_timeseries_sampler_from_env(models, tmp_path, monkeypatch):
    from paddle_tpu_torch.observability import timeseries as ts

    monkeypatch.setenv("PADDLE_TPU_TIMESERIES_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_TIMESERIES_S", "30")
    _, tp = _preds(models, "target")
    eng = ServingEngine(tp, max_batch=2, prefill_chunk=16)
    try:
        assert eng.sampler is not None
        eng.submit(np.arange(1, 9), max_new_tokens=3)
        eng.run()
        eng.sampler.sample_now()
        recs = ts.read_journal(os.path.join(str(tmp_path), ts.JOURNAL_NAME))
        pts = ts.query(recs, "paddle_tpu_serving_requests_total",
                       {"event": "evicted"})
        assert pts and pts[-1][1] >= 1
    finally:
        ts.detach()

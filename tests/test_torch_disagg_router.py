"""Disaggregated prefill/decode serving in the port (``inference/disagg.py``,
``inference/router.py``) held against a unified fleet and against the
JAX package's fleet on the CPU, the cases of tests/test_disagg_router.py
that apply on one process.

The same ``llama_tiny`` weights (built by the JAX package, carried
across with ``convert.load_jax_state_dict``), fp32, page 8:

- a bursty Poisson trace through 1 prefill + 1 decode replica commits
  exactly the streams of a unified 2-replica fleet and of the JAX
  package's phase-split fleet;
- migration bytes equal ``ceil(L / page) * page_bytes + table_row_bytes``
  on the migrator, the migration counter and the comm ledger's
  ``migrate`` axis, and equal the JAX fleet's;
- the wire format: one [2 * layers, kv_heads, page, head_dim] payload a
  page, a crc32 each; a flipped byte is caught, and an injected
  corruption is retried on a fresh replica with the trace id kept;
- decode backpressure parks rows and every request finishes;
- prefix affinity, degraded and collector-vetoed replicas;
- the HTTP door on 127.0.0.1:0; a decode replica refuses submit;
- no new launch-site shape key after warmup on either replica kind.
"""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import Router as JaxRouter
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.inference import create_predictor as jax_predictor
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.inference import (Config, KVMigrator,
                                        MigrationCorruptError, Router,
                                        RouterServer, ServingEngine,
                                        create_predictor)
from paddle_tpu_torch.inference.disagg import (MIGRATE_AXES,
                                               migration_nbytes,
                                               pack_migration,
                                               unpack_migration)
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.observability.catalog import serving_metrics
from paddle_tpu_torch.observability.spans import (format_traceparent,
                                                  make_span_id,
                                                  make_trace_id)

PAGE = 8


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = JaxLlama(jax_tiny())
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_state_dict(tm, state)
    return jm, tm


def _engine(models, phase=None, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_chunk", 16)
    kw.setdefault("pool_pages", 32)
    pred = create_predictor(
        Config().set_model(models[1]).enable_paged_kv(page_size=PAGE))
    return ServingEngine(pred, phase=phase, **kw)


def _jax_engine(models, phase=None, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_chunk", 16)
    kw.setdefault("pool_pages", 32)
    pred = jax_predictor(
        JaxConfig().set_model(models[0]).enable_paged_kv(page_size=PAGE))
    return JaxEngine(pred, phase=phase, **kw)


def _poisson_trace(n, rate=1.5, seed=5):
    """Bursty Poisson arrivals: [(arrival_step, prompt, n_new)]."""
    r = np.random.RandomState(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += r.exponential(1.0 / rate)
        out.append((int(t), r.randint(1, 256, (int(r.randint(4, 30)),)),
                    int(r.randint(2, 7))))
    return out


def _drive(router, trace):
    """Feed the arrival trace into the router on its step clock; drain;
    returns {trace index: ServingRequest}."""
    gids = {}
    step = i = 0
    while i < len(trace) or router.pending:
        while i < len(trace) and trace[i][0] <= step:
            _, prompt, n_new = trace[i]
            gids[i] = router.submit(prompt, max_new_tokens=n_new)
            i += 1
        router.step()
        step += 1
        assert step < 5000, "fleet wedged"
    return {k: router.result(g) for k, g in gids.items()}


def _page_bytes(eng):
    mcfg = eng.pred._model.config
    return 2 * mcfg.num_layers * mcfg.num_kv_heads * PAGE * mcfg.head_dim * 4


def _streams(res):
    return {k: list(r.new_tokens) for k, r in res.items()}


# ---------------------------------------------------------------------------
# the phase-split fleet == the unified fleet == the JAX fleet
# ---------------------------------------------------------------------------
def test_bursty_trace_bit_identical_exact_bytes_flat_lattice(models):
    trace = _poisson_trace(10)
    base = _drive(Router([("u0", _engine(models)),
                          ("u1", _engine(models))]), trace)

    peng = _engine(models, phase="prefill")
    deng = _engine(models, phase="decode")
    rt = Router([("prefill0", peng), ("decode0", deng)])
    m = serving_metrics()
    mig0 = m["migration_bytes"].value()
    comm0 = m["comm_bytes"].value(axis="migrate", op="ppermute")
    # warm both replica kinds through the whole path, then pin
    warm = rt.submit(np.arange(1, 20), max_new_tokens=4)
    rt.run()
    assert rt.result(warm) is not None
    pw, dw = peng.stats.compiles, deng.stats.compiles
    got = _drive(rt, trace)

    jrt = JaxRouter([("prefill0", _jax_engine(models, phase="prefill")),
                     ("decode0", _jax_engine(models, phase="decode"))])
    jrt.submit(np.arange(1, 20), max_new_tokens=4)
    jrt.run()
    jgot = _drive(jrt, trace)

    assert _streams(got) == _streams(base) == _streams(jgot)
    assert rt.migrator.migrated == len(trace) + 1
    pb = _page_bytes(peng)
    want = sum((-(-len(p) // PAGE)) * pb + peng.npages * 4
               for _, p, _ in trace)
    want += (-(-19 // PAGE)) * pb + peng.npages * 4        # the warmup
    assert rt.migrator.wire_bytes == want == jrt.migrator.wire_bytes
    assert m["migration_bytes"].value() - mig0 == want
    assert m["comm_bytes"].value(axis="migrate", op="ppermute") - comm0 \
        == want
    # no new launch-site shape key after warmup on either replica kind
    assert peng.stats.compiles == pw
    assert deng.stats.compiles == dw
    assert peng.rounds["decode"] == 0 and deng.rounds["unified"] == 0
    assert m["phase_slots"].value(phase="prefill") == 0
    assert m["phase_slots"].value(phase="decode") == 0
    # one timing a migration, split into its three parts
    t = rt.migrator.timings
    assert len(t) == rt.migrator.migrated
    assert sum(x["wire_bytes"] for x in t) == want
    assert all(x["d2h_s"] >= 0 and x["crc_s"] >= 0 and x["h2d_s"] >= 0
               for x in t)


def test_migration_wire_format_crc_roundtrip(models):
    peng = _engine(models, phase="prefill")
    jeng = _jax_engine(models, phase="prefill")
    pkgs = []
    for eng in (peng, jeng):
        eng.submit(np.arange(1, 18), max_new_tokens=3)
        steps = 0
        while not eng.migratable():
            eng.step()
            steps += 1
            assert steps < 200
        pkgs.append(eng.export_request(eng.migratable()[0]))
    pkg, jpkg = pkgs
    mcfg = models[1].config
    assert [a.shape for a in pkg["pages"]] == \
        [(2 * mcfg.num_layers, mcfg.num_kv_heads, PAGE,
          mcfg.head_dim)] * (-(-17 // PAGE))
    # the committed KV equals the JAX replica's, page for page
    for a, b in zip(pkg["pages"], jpkg["pages"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    assert pkg["new_tokens"] == jpkg["new_tokens"]
    assert peng.num_active == 0 and peng.check_invariants() is None
    wire = pack_migration(pkg)
    assert wire["wire_bytes"] == migration_nbytes(pkg)
    assert len(wire["page_crc32"]) == len(wire["pages"])
    assert unpack_migration(wire) is wire
    bad = dict(wire)
    tampered = [a.copy() for a in wire["pages"]]
    tampered[-1].view(np.uint8).reshape(-1)[0] ^= 0xFF
    bad["pages"] = tampered
    with pytest.raises(MigrationCorruptError):
        unpack_migration(bad)
    # an import writes the same bytes back into another pool
    deng = _engine(models, phase="decode")
    rid = deng.import_request(wire)
    s = next(s for s in deng.slots if s is not None)
    for j, arr in enumerate(wire["pages"]):
        pg = s.pages[j]
        got = np.stack([t[pg].numpy() for kv in deng.pools for t in kv])
        np.testing.assert_array_equal(got, arr)
    assert deng.trace_context(rid)["parent_span_id"] == pkg["parent_span_id"]


def test_crc_corruption_detected_and_retried_fresh_replica(models):
    """A corrupted frame loses nothing: the router resubmits the request
    to the other prefill replica with the same trace, and the stream is
    still the unified one."""
    solo = _engine(models)
    srid = solo.submit(np.arange(1, 22), max_new_tokens=5)
    want = list(solo.run()[srid].new_tokens)

    p0 = _engine(models, phase="prefill")
    p1 = _engine(models, phase="prefill")
    deng = _engine(models, phase="decode")
    rt = Router([("p0", p0), ("p1", p1), ("d0", deng)])

    class _CorruptOnce(KVMigrator):
        def _transmit(self, wire):
            if not getattr(self, "tampered", False):
                self.tampered = True
                pages = [a.copy() for a in wire["pages"]]
                pages[0].view(np.uint8).reshape(-1)[3] ^= 0xFF
                wire = dict(wire, pages=pages)
            return wire

    rt.migrator = _CorruptOnce(rt.migrator.decode)
    m = serving_metrics()
    crc0 = m["migrations"].value(result="crc_error")
    retry0 = m["router_requests"].value(replica="p1", decision="retry")
    tp = format_traceparent(make_trace_id(), make_span_id())
    gid = rt.submit(np.arange(1, 22), max_new_tokens=5, traceparent=tp)
    req = rt.run(max_steps=2000)[gid]
    assert list(req.new_tokens) == want
    assert m["migrations"].value(result="crc_error") - crc0 == 1
    assert m["router_requests"].value(replica="p1", decision="retry") \
        - retry0 == 1
    assert req.trace_id == tp.split("-")[1]


def test_decode_backpressure_parks_rows_until_capacity(models):
    solo = _engine(models)
    prompts = [np.arange(1 + i, 15 + i) for i in range(5)]
    want = []
    for p in prompts:
        rid = solo.submit(p, max_new_tokens=6)
        want.append(list(solo.run()[rid].new_tokens))
    peng = _engine(models, phase="prefill")
    deng = _engine(models, phase="decode", max_batch=1)
    rt = Router([("p0", peng), ("d0", deng)])
    m = serving_metrics()
    refused0 = m["migrations"].value(result="refused")
    gids = [rt.submit(p, max_new_tokens=6) for p in prompts]
    res = rt.run(max_steps=3000)
    assert [list(res[g].new_tokens) for g in gids] == want
    assert m["migrations"].value(result="refused") > refused0


def test_trace_stitches_across_prefill_migrate_decode(models):
    peng = _engine(models, phase="prefill")
    deng = _engine(models, phase="decode")
    rt = Router([("p0", peng), ("d0", deng)])
    tid = make_trace_id()
    tp = format_traceparent(tid, make_span_id())
    gid = rt.submit(np.arange(1, 20), max_new_tokens=4, traceparent=tp)
    req = rt.run()[gid]
    assert req.trace_id == tid
    pevents = peng.export_request_traces()["traceEvents"]
    devents = deng.export_request_traces()["traceEvents"]
    assert any(e["args"].get("trace_id") == tid for e in pevents)
    assert any(e["args"].get("trace_id") == tid for e in devents)
    assert any(e["name"] == "migrate_out" for e in pevents)
    assert any(e["name"] == "migrate_in" for e in devents)
    pspan = next(e["args"]["span_id"] for e in pevents
                 if e["args"].get("trace_id") == tid)
    assert req.parent_span_id == pspan


# ---------------------------------------------------------------------------
# the front door: health -> affinity -> least-loaded, the HTTP surface
# ---------------------------------------------------------------------------
def test_prefix_affinity_steers_to_warm_replica(models):
    e0 = _engine(models, prefix_cache=True)
    e1 = _engine(models, prefix_cache=True)
    rt = Router([("r0", e0), ("r1", e1)])
    m = serving_metrics()
    aff0 = m["router_requests"].value(replica="r0", decision="affinity")
    sysp = np.arange(1, 1 + 2 * PAGE)
    rt.submit(sysp, max_new_tokens=2)              # cold: least-loaded
    rt.run()
    assert e0.finished and not e1.finished
    g1 = rt.submit(np.concatenate([sysp, np.arange(200, 206)]),
                   max_new_tokens=2)
    rt.run()
    assert rt.result(g1) is not None
    assert m["router_requests"].value(replica="r0", decision="affinity") \
        - aff0 == 1
    assert e0.prefix_cache_stats()["hits"] >= 1


def test_degraded_replica_skipped_until_fleet_wide(models):
    e0, e1 = _engine(models), _engine(models)
    rt = Router([("r0", e0), ("r1", e1)])
    e0.health = lambda: "degraded"
    gid = rt.submit(np.arange(1, 10), max_new_tokens=2)
    rt.run()
    assert rt.result(gid) is not None
    assert e1.finished and not e0.finished
    assert rt.healthz()["status"] == "degraded"
    e1.health = lambda: "degraded"                  # shedding beats nothing
    gid2 = rt.submit(np.arange(1, 10), max_new_tokens=2)
    rt.run()
    assert rt.result(gid2) is not None


def test_collector_overlay_filters_remote_degraded(models):
    class _Overlay:
        def __init__(self, bad):
            self.bad = set(bad)

        def member_health(self, name):
            return {"status": "degraded" if name in self.bad else "ok",
                    "reason": "stale"}

    e0, e1 = _engine(models), _engine(models)
    rt = Router([("r0", e0), ("r1", e1)], collector=_Overlay(["r0"]))
    gid = rt.submit(np.arange(1, 12), max_new_tokens=2)
    rt.run()
    assert rt.result(gid) is not None
    assert e1.finished and not e0.finished
    hz = rt.healthz()
    assert hz["status"] == "degraded"
    assert hz["replicas"]["r0"]["health"] == "degraded"


def test_http_front_door_round_trip(models):
    solo = _engine(models)
    srid = solo.submit(np.arange(1, 14), max_new_tokens=3)
    want = list(solo.run()[srid].new_tokens)
    peng = _engine(models, phase="prefill")
    deng = _engine(models, phase="decode")
    rt = Router([("p0", peng), ("d0", deng)])
    tp = format_traceparent(make_trace_id(), make_span_id())
    out = {}
    with RouterServer(rt) as srv:
        assert srv.url.startswith("http://127.0.0.1:")

        def client():
            req = urllib.request.Request(
                srv.url + "/v1/generate",
                data=json.dumps({"prompt": list(range(1, 14)),
                                 "max_new_tokens": 3}).encode(),
                headers={"Content-Type": "application/json",
                         "traceparent": tp})
            with urllib.request.urlopen(req, timeout=60) as r:
                out["resp"] = json.loads(r.read())

        t = threading.Thread(target=client, daemon=True)
        t.start()
        deadline = time.monotonic() + 60
        while not rt.pending:          # the handler only enqueues
            assert time.monotonic() < deadline
            time.sleep(0.005)
        srv.serve_pending()
        t.join(timeout=30)
        assert not t.is_alive()
        hz = json.loads(urllib.request.urlopen(srv.url + "/healthz",
                                               timeout=30).read())
        st = json.loads(urllib.request.urlopen(srv.url + "/stats",
                                               timeout=30).read())
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(srv.url + "/nope", timeout=30)
    assert out["resp"]["tokens"] == want
    assert out["resp"]["trace_id"] == tp.split("-")[1]
    assert out["resp"]["shed_reason"] is None
    assert hz["status"] == "ok" and set(hz["replicas"]) == {"p0", "d0"}
    assert st["migrated"] == 1


def test_decode_replica_refuses_direct_submission(models):
    deng = _engine(models, phase="decode")
    with pytest.raises(Exception, match="decode"):
        deng.submit(np.arange(1, 10), max_new_tokens=2)


def test_fleet_preconditions(models):
    with pytest.raises(Exception, match="decode"):
        Router([("p0", _engine(models, phase="prefill"))])
    with pytest.raises(Exception, match="prefill"):
        _engine(models, phase="prefill", prefill_chunk=None)
    with pytest.raises(Exception, match="phase"):
        _engine(models, phase="both")
    assert MIGRATE_AXES == ("migrate",)


def test_malformed_and_invalid_trace_ids_count(models):
    eng = _engine(models)
    m = serving_metrics()
    c0 = m["trace_parse_errors"].value(reason="malformed_traceparent")
    c1 = m["trace_parse_errors"].value(reason="invalid_trace_id")
    r0 = eng.submit(np.arange(1, 10), max_new_tokens=2,
                    trace_id="00-zz-bad-header")
    r1 = eng.submit(np.arange(1, 10), max_new_tokens=2, trace_id="nothex")
    done = eng.run()
    assert all(len(done[r].trace_id) == 32 for r in (r0, r1))
    assert m["trace_parse_errors"].value(
        reason="malformed_traceparent") - c0 == 1
    assert m["trace_parse_errors"].value(reason="invalid_trace_id") \
        - c1 == 1


def test_prefix_hash_entries_gauge_tracks_table(models):
    eng = _engine(models, prefix_cache=True)
    eng.submit(np.arange(1, 1 + 3 * PAGE), max_new_tokens=2)
    eng.run()
    m = serving_metrics()
    assert m["prefix_hash_entries"].value() == len(eng._hash_page) >= 3

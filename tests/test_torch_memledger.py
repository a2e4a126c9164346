"""The port's memory ledger (``observability/memledger.py``) and the
comm ledger's core (``observability/commledger.py``) held against the
JAX package's on the CPU.

- The serving engine with ``mem_ledger=True``: the same launch sites get
  a ledger as in the JAX engine; ``kv_pool_bytes == page_bytes x
  pool_pages`` exactly and the resident state equal to the JAX engine's
  ``memory_summary``; argument / output / alias bytes at their closed
  forms; temporaries reported as not measured off the card; the shape
  lattice flat after warmup and the tokens those of the ledger-off run.
- ``pool_pages="auto"``: the geometric default on the CPU, as in JAX;
  ``suggest_pool_pages`` on the JAX test's devices.
- ``ParallelEngine(mem_ledger=True)``: ``state_accounting()`` equal byte
  for byte to the JAX ``account_engine`` at degree 1 (and to
  ``closed_form_state_bytes``), the analytic model equal to the JAX
  cost model, the step ledger's byte classes at their closed forms.
- The roofline: "unknown" off the card; the H100's verdict from its
  peak table.
- The comm ledger: closed-form wire bytes and noted records equal to the
  JAX module's; what waits on items 8-10 raises naming its item.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.auto_tuner.cost_model import \
    estimate_memory_gb as jax_estimate
from paddle_tpu.distributed.engine import ParallelEngine as JEngine
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.inference import create_predictor as jax_predictor
from paddle_tpu.models import gpt as jg
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.observability import commledger as jcl
from paddle_tpu.observability import memledger as jml
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.distributed.engine import ParallelEngine
from paddle_tpu_torch.inference import Config, ServingEngine, create_predictor
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.observability import commledger as tcl
from paddle_tpu_torch.observability import memledger as ml
from paddle_tpu_torch.optimizer import AdamW

PAGE = 8
F32 = 4


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny())
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_state_dict(tm, state)
    return jm, tm


def _engines(models, **kw):
    jm, tm = models
    return (JaxEngine(jax_predictor(JaxConfig().set_model(jm)
                                    .enable_paged_kv(page_size=PAGE)), **kw),
            ServingEngine(create_predictor(Config().set_model(tm)
                                           .enable_paged_kv(page_size=PAGE)),
                          **kw))


def _serve(eng, seed=0):
    """The JAX test's warmup mix, then its streamed mixes; returns the
    compile count after warmup and the tokens."""
    r = np.random.RandomState(seed)
    out = []
    for L in (7, 12):
        eng.submit(r.randint(1, 256, (L,)), max_new_tokens=6)
    out += [list(q.new_tokens) for q in eng.run().values()]
    warm = eng.stats.compiles
    for L in (24, 17, 11, 9, 5):
        eng.submit(r.randint(1, 256, (L,)), max_new_tokens=6)
    done = eng.run()
    return warm, [list(done[k].new_tokens) for k in sorted(done)]


# ---------------------------------------------------------------------------
# the serving engine's ledgers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(max_batch=4, decode_chunk=2),
                                dict(max_batch=4, prefill_chunk=16)],
                         ids=["legacy_decode_chunk", "chunked"])
def test_serving_sites_and_pool_closed_form(models, kw):
    je, te = _engines(models, mem_ledger=True, **kw)
    warm, toks = _serve(te)
    jwarm, jtoks = _serve(je)
    assert toks == jtoks
    # the lattice stays flat with the ledger on, as in the JAX engine
    assert te.stats.compiles == warm and je.stats.compiles == jwarm
    assert set(te._mem_ledgers) == set(je._mem_ledgers)
    mine, ref = te.memory_summary(), je.memory_summary()
    # the live watermark is the CUDA allocator's on a card; off it the
    # port measures none (the JAX package sums its live CPU arrays)
    assert mine["state"].pop("live_peak_bytes") == 0
    ref["state"].pop("live_peak_bytes")
    assert mine["state"] == ref["state"]
    st = mine["state"]
    cfg = llama_tiny()
    assert st["kv_pool_bytes"] == st["page_bytes"] * st["pool_pages"]
    assert st["page_bytes"] == (2 * cfg.num_layers * cfg.num_kv_heads
                                * PAGE * cfg.head_dim * F32)
    assert set(mine["executables"]) == set(ref["executables"])
    json.dumps(mine)
    # byte classes: params + pools + the site's static inputs read; the
    # pools (+ its outputs) written; the pools updated in place
    params = st["params_bytes"]
    pools = st["kv_pool_bytes"]
    B, npages = te.B, te.npages
    site = ("decode",) if "decode_chunk" in kw else ("unified", te.Sc)
    led = te.memory_ledger(site)
    assert led.alias_bytes == pools
    if site == ("decode",):
        ins = B * 8 + B * 4 + B * npages * 4           # tok, pos, tbl
        outs = B * te.chunk * 8
    else:
        ins = B * te.Sc * 8 + 2 * B * 4 + B * (npages + 1) * 4
        outs = B * 8
    assert led.argument_bytes == params + pools + ins
    assert led.output_bytes == pools + outs
    assert led.peak_bytes == led.argument_bytes + led.output_bytes \
        - led.alias_bytes
    assert led.temp_bytes == 0 and "not measured" in led.note
    rep = te.roofline_report()
    assert rep.program == "decode" and rep.bound == "unknown"
    assert set(rep.seconds) == set(ml.RESOURCES)


def test_decode_roofline_counts_the_bytes_a_round_moves(models,
                                                       monkeypatch):
    """The decode roofline's HBM traffic is what each decode round moves:
    at each of its steps the weights once, every row's pages up to its
    new token (a free row: its one trash page) and one token's K and V a
    row written; not the decode ledger's bytes, which count the whole
    pool as read and written."""
    from paddle_tpu_torch.observability import flops

    _, tm = models
    B, c, L, N = 4, 2, 13, 7
    te = ServingEngine(create_predictor(Config().set_model(tm)
                                        .enable_paged_kv(page_size=PAGE)),
                       max_batch=B, decode_chunk=c, mem_ledger=True)
    te.submit(np.arange(1, L + 1), max_new_tokens=N)
    te.run()
    cfg = llama_tiny()
    page_bytes = 2 * cfg.num_layers * cfg.num_kv_heads * PAGE \
        * cfg.head_dim * F32
    weights = sum(p.numel() * p.element_size() for p in tm.parameters())
    want = []
    for pos in (L, L + 2, L + 4):     # the last token's position a round
        pages = sum(-(-(pos + i) // PAGE) for i in range(1, c + 1)) \
            + (B - 1) * c
        want.append(c * (weights + B * page_bytes // PAGE)
                    + pages * page_bytes)
    assert list(te._decode_bytes) == want
    assert te.rounds["decode"] == 3
    led = te.memory_ledger(("decode",))
    pools = te.memory_summary()["state"]["kv_pool_bytes"]
    assert led.traffic_bytes >= weights + 2 * pools   # the pool, twice
    monkeypatch.setattr(flops, "peak_flops_per_chip",
                        lambda device: flops.PEAK_BY_CARD["h100"])
    rep = te.roofline_report()
    assert rep.seconds["hbm"] == pytest.approx(np.median(want) / 3.35e12)
    assert rep.seconds["compute"] == pytest.approx(
        2.0 * cfg.num_params() * B * c / 989e12)


def test_ledger_gauges_and_tokens_unchanged(models):
    """The ledger only observes: the same tokens as a ledger-off engine,
    its gauges published under each site's program name."""
    from paddle_tpu_torch import observability as obs

    _, off = _engines(models, max_batch=4, prefill_chunk=16)
    _, on = _engines(models, max_batch=4, prefill_chunk=16,
                     mem_ledger=True)
    assert _serve(off)[1] == _serve(on)[1]
    assert off.memory_ledger(("unified", 16)) is None
    snap = obs.get_registry().snapshot()["metrics"]
    progs = {s["labels"]["program"]
             for s in snap["paddle_tpu_mem_argument_bytes"]["series"]}
    assert {"unified_16", "decode"} <= progs
    # no allocator statistics off the card: no live gauge invented
    assert on.memory_summary()["state"]["live_peak_bytes"] == 0


def test_auto_pool_falls_back_on_cpu(models):
    je, te = _engines(models, max_batch=4)
    ja, ta = _engines(models, max_batch=4, pool_pages="auto")
    assert ta.P == ja.P == te.P == je.P


def test_suggest_pool_pages_on_the_jax_cases():
    class Dev:
        def memory_stats(self):
            return {"bytes_limit": 1000}

    class NoStats:
        def memory_stats(self):
            return None

    for dev in (Dev(), NoStats()):
        for args in ((50, 300), (50, 899), (50, 0), (0, 0)):
            assert ml.suggest_pool_pages(dev, *args) == \
                jml.suggest_pool_pages(dev, *args)
    assert ml.suggest_pool_pages(Dev(), 50, 300) == 12
    assert ml.suggest_pool_pages(torch.device("cpu"), 50, 0) is None


def test_suggest_pool_pages_reads_the_cards_free_memory(monkeypatch):
    """On a card: free memory (the allocator's cached blocks included)
    less the margin of the total, so a second engine sees the first's
    pool. The card's figures are stubbed here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (5000, 10000))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: 700)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda dev=None: 500)
    cuda = torch.device("cuda", 0)
    # (5000 + 200 - 0.1 * 10000 - 100) // 100 = 41
    assert ml.suggest_pool_pages(cuda, 100, 100) == 41
    assert ml.suggest_pool_pages(cuda, 5000, 0) is None


# ---------------------------------------------------------------------------
# the train engine: state accounting against the JAX engine at degree 1
# ---------------------------------------------------------------------------
B, S, LR = 2, 16, 3e-3


def _ids(vocab):
    ids = np.random.RandomState(7).randint(0, vocab, (B, S + 1))
    return ids[:, :-1], ids[:, 1:]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_accounting_equals_jax_account_engine(dtype):
    paddle.seed(3)
    jcfg = jg.gpt_tiny(dtype=dtype)
    jmodel = jg.GPTForCausalLM(jcfg)
    jcrit = jg.GPTPretrainingCriterion(jcfg)
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jmodel.parameters(),
                                  multi_precision=dtype != "float32")
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1}
    hcg = jfleet.init(is_collective=True, strategy=strategy)
    jeng = JEngine(jmodel, jopt, hcg.mesh, mem_ledger=True)
    jstep = jeng.train_step(lambda m, b: jcrit(m(b["x"]), b["y"]))
    x, y = _ids(jcfg.vocab_size)
    float(jstep({"x": paddle.to_tensor(x), "y": paddle.to_tensor(y)}))

    cfg = tg.gpt_tiny(dtype=dtype)
    model = tg.GPTForCausalLM(cfg, device="cpu", seed=3)
    crit = tg.GPTPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=LR, parameters=model.named_parameters(),
                multi_precision=dtype != "float32")
    eng = ParallelEngine(model, opt, mem_ledger=True)
    assert eng.memory_ledger() is None              # before any step
    step = eng.train_step(lambda m, b: crit(m(b["x"]), b["y"]))
    float(step({"x": x, "y": y}))

    mine, ref = eng.state_accounting(), jeng.state_accounting()
    assert mine.components == ref.components
    assert mine.analytic_bytes == ref.analytic_bytes
    assert mine.drift == pytest.approx(ref.drift, rel=1e-12)
    closed = ml.closed_form_state_bytes(eng)
    assert closed == jml.closed_form_state_bytes(jeng)
    assert all(mine.components[k] == v for k, v in closed.items())
    assert set(mine.groups) == set(ref.groups)
    # the step's ledger: what it reads, writes and updates in place
    led = eng.memory_ledger()
    own = closed["params"] + closed["optimizer_state"] \
        + closed["master_weights"]
    batch = 2 * B * S * 8                                # x, y int64
    assert led.argument_bytes == own + batch
    assert led.alias_bytes == own
    assert led.output_bytes == own + 4                  # the f32 loss
    assert led.temp_bytes == 0 and "not measured" in led.note
    rep = eng.roofline_report()
    assert rep.bound == "unknown" and rep.program == "train"
    assert set(rep.seconds) == set(ml.RESOURCES)


@pytest.mark.parametrize("cfg", [
    ({"hidden_size": 2048, "num_layers": 24, "vocab_size": 50304},
     {"sharding_degree": 1, "micro_batch_size": 1}, 1, 8192, 2),
    ({"hidden_size": 64, "num_layers": 2}, {"mp_degree": 2,
                                             "sharding_stage": 3,
                                             "sharding_degree": 2},
     4, 128, 4),
    ({"hidden_size": 512, "num_layers": 4}, {"offload": {"optimizer": True},
                                              "quant_comm": {"dtype": "int8"}},
     2, 64, 2)], ids=["gpt_1p3b", "stage3_mp2", "offload_quant"])
def test_estimate_memory_gb_is_the_cost_models(cfg):
    model, c, gb, seq, db = cfg
    assert ml.estimate_memory_gb(model, c, gb, seq, dtype_bytes=db) == \
        jax_estimate(model, c, gb, seq, dtype_bytes=db)


def test_temp_probe_is_off_the_card_on_the_cpu():
    assert ml.TempProbe("cpu").temp_bytes() is None
    assert ml.live_bytes("cpu") == 0
    led = ml.analyze("x", reads=[torch.zeros(4)], writes=[],
                     temp_bytes=None)
    assert led.argument_bytes == 16 and "not measured" in led.note
    # one storage read twice counts once
    t = torch.zeros(8)
    assert ml.analyze("y", reads=[t, t], writes=[]).argument_bytes == 32


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------
H100 = "NVIDIA H100 80GB HBM3"


def test_roofline_h100_verdicts():
    rep = ml.roofline(step_seconds=0.01, flops_per_step=989e12 * 1e-3,
                      hbm_traffic_bytes=3.35e12 * 5e-3, device=H100)
    assert rep.bound == "hbm-bound"
    assert rep.seconds["hbm"] == pytest.approx(5e-3)
    assert rep.headroom_pct["compute"] == pytest.approx(80.0)
    assert rep.util_pct["hbm"] == pytest.approx(50.0)
    rep = ml.roofline(step_seconds=0.01, flops_per_step=989e12 * 8e-3,
                      hbm_traffic_bytes=3.35e12 * 1e-3,
                      exposed_ici_seconds=1e-3, device=H100)
    assert rep.bound == "compute-bound"
    assert rep.seconds["ici"] == pytest.approx(1e-3)
    json.dumps(rep.to_dict())


def test_roofline_cpu_is_unknown():
    for mod, dev in ((ml, torch.device("cpu")),
                     (jml, __import__("jax").devices()[0])):
        rep = mod.roofline(step_seconds=0.01, flops_per_step=1e12,
                           hbm_traffic_bytes=1e9, wire_bytes=1e9,
                           exposed_ici_seconds=0.5, device=dev)
        assert rep.bound == "unknown"
        assert rep.headroom_pct == {r: 0.0 for r in ml.RESOURCES}


# ---------------------------------------------------------------------------
# the comm ledger's core
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", ["psum", "pmax", "all_gather",
                                "reduce_scatter", "all_to_all", "ppermute"])
@pytest.mark.parametrize("p", [1, 2, 8])
def test_wire_bytes_closed_forms(op, p):
    assert tcl.wire_bytes(op, 4096.0, p) == jcl.wire_bytes(op, 4096.0, p)


def test_capture_records_equal_jax():
    leds = []
    for mod in (tcl, jcl):
        assert not mod.active()
        with mod.capture() as led:
            assert mod.active()
            mod.note("ppermute", ("migrate",), (2, 4, 8, 16),
                     np.dtype("uint16"), p=2)
            mod.note("psum", ("dp",), (128,), np.float32, p=4)
        mod.note("psum", ("dp",), (128,), np.float32, p=4)   # no capture
        leds.append(led)
    mine, ref = leds
    assert [(r.op, r.axes, r.shape, r.payload_bytes, r.wire_bytes)
            for r in mine.records] == \
        [(r.op, r.axes, r.shape, r.payload_bytes, r.wire_bytes)
         for r in ref.records]
    assert mine.totals() == ref.totals()
    assert mine.summary() == ref.summary()
    assert mine.bytes_for(axis="migrate") == 2 * 4 * 8 * 16 * 2
    # a torch dtype prices like its numpy twin
    with tcl.capture() as led:
        tcl.note("ppermute", ("migrate",), (3, 5), torch.bfloat16, p=2)
    assert led.records[0].payload_bytes == 30


@pytest.mark.parametrize("fn, item", [
    ("quant_wire", "item 10"),
    ("ablate", "item 11"), ("build_report", "item 11"),
    ("replay_callable", "item 11")])
def test_unported_ledger_functions_name_their_item(fn, item):
    with pytest.raises(NotImplementedError, match=item):
        getattr(tcl, fn)(1)


def test_scan_trips_stamps_records_as_the_jax_ledger_does():
    import paddle_tpu.observability.commledger as jcl

    def book(cl):
        with cl.capture() as led:
            cl.note("psum", ("dp",), (4, 8), np.float32, p=2)
            with cl.scan_trips(3):
                cl.note("all_gather", ("sharding",), (16,), np.float32, p=4)
                with cl.scan_trips(2):
                    cl.note("ppermute", ("pp",), (2, 8), np.float32, p=2)
            cl.note("psum", ("dp",), (4,), np.float32, p=2)
        return led

    mine, ref = book(tcl), book(jcl)
    assert [r.trips for r in mine.records] == [1, 3, 6, 1]
    assert [r.trips for r in mine.records] == [r.trips for r in ref.records]
    assert mine.totals() == ref.totals()

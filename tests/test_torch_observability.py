"""The port's training telemetry (``paddle_tpu_torch.observability`` and
``ParallelEngine``'s wiring) held against the JAX package's on the CPU.

Checked, from the same inputs on both sides: the registry's Prometheus
text after the same updates to every catalog set, and the port's
``schema.json`` equal to the JAX file; goodput ``summarize`` over the
same journals; the health monitor's events over the same injected loss /
grad-norm / step-time series (explicit step times, never the wall
clock); the failpoint grammar; ``flops.mfu`` and the H100's peak figures.
Then the port's engine: gauges zero before the first step and one step
behind after it (the JAX ``TestFirstStepLag``), goodput's compile /
step_compute / restore attribution, per-engine health windows, a
scaler-skipped step kept out of the detector, one scrape of ``/metrics``
over loopback, and the knob errors citing the roadmap.
"""
import ast
import json
import math
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import failpoints as jfp
from paddle_tpu.observability import catalog as jcat
from paddle_tpu.observability import flops as jflops
from paddle_tpu.observability import goodput as jgp
from paddle_tpu.observability import healthmon as jhm
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.distributed import failpoints as fp
from paddle_tpu_torch.distributed.engine import ParallelEngine
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.observability import catalog as tcat
from paddle_tpu_torch.observability import flops as tflops
from paddle_tpu_torch.observability import goodput as tgp
from paddle_tpu_torch.observability import healthmon as thm
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.optimizer import AdamW

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean():
    for mod in (tgp, jgp):
        mod.detach()
    fp.clear()
    jfp.clear()
    yield
    for mod in (tgp, jgp):
        mod.detach()
    fp.clear()
    jfp.clear()


# ---------------------------------------------------------------------------
# registry and schema
# ---------------------------------------------------------------------------
_SETS = ("train_metrics", "health_metrics", "ckpt_metrics",
         "goodput_metrics", "timeseries_metrics", "serving_metrics")


def _drive(cat, metrics_mod, name):
    """The same updates to one catalog set: every counter and gauge
    twice (with each label set), every histogram over a fixed series."""
    reg = metrics_mod.MetricsRegistry()
    inst = getattr(cat, name)(reg)
    for i, (key, m) in enumerate(sorted(inst.items())):
        labels = {ln: f"v{j}" for j, ln in enumerate(m.labelnames)}
        if m.kind == "histogram":
            for x in (0.003, 0.07, 0.4, 2.5, 40.0):
                m.observe(x * (i + 1), **labels)
        elif m.kind == "counter":
            m.inc(3 + i, **labels)
            m.inc(0.5, **labels)
        else:
            m.set(1.25 * i - 2.0, **labels)
            m.set(7.5 + i, **labels)
    return reg


@pytest.mark.parametrize("name", _SETS)
def test_registry_prometheus_text_matches_jax(name):
    mine = _drive(tcat, tmetrics, name)
    ref = _drive(jcat, jmetrics, name)
    assert mine.prometheus_text() == ref.prometheus_text()
    assert mine.schema() == ref.schema()
    back = tmetrics.parse_prometheus_text(mine.prometheus_text())
    assert back == jmetrics.parse_prometheus_text(ref.prometheus_text())


def test_schema_json_is_the_jax_file_and_the_catalog():
    mine = json.loads(Path(tcat.SCHEMA_PATH).read_text())
    assert mine == json.loads(Path(jcat.SCHEMA_PATH).read_text())
    # the port reads its own copy, not the JAX package's
    assert Path(tcat.SCHEMA_PATH).parent == REPO / \
        "paddle_tpu_torch" / "observability"
    r = tmetrics.MetricsRegistry()
    for fn in ("train_metrics", "serving_metrics", "fleet_metrics"):
        getattr(tcat, fn)(r)
    assert r.schema() == mine


# ---------------------------------------------------------------------------
# goodput: the same journal, the same summary
# ---------------------------------------------------------------------------
def _journal(kind):
    t = 1000.0
    recs = [{"ev": "run", "ts": t, "pid": 1, "resumed": False}]
    segs = [("compile", 2.5), ("step_compute", 0.25), ("step_compute",
                                                      0.25),
            ("ckpt_stall", 1.0), ("step_compute", 0.25)]
    for seg, d in segs:
        recs.append({"ev": "b", "seg": seg, "ts": t, "step": 1})
        recs.append({"ev": "e", "seg": seg, "t0": t, "t1": t + d})
        t += d + 0.125
    if kind in ("bg", "restart"):
        recs.append({"ev": "e", "seg": "ckpt_async", "t0": t - 1.5,
                     "t1": t + 0.5, "bg": 1})
    if kind == "restart":
        recs.append({"ev": "b", "seg": "ckpt_stall", "ts": t})
        recs.append({"ev": "e", "seg": "recovery_restart", "t0": t,
                     "t1": t + 30.0})
        recs.append({"ev": "run", "ts": t + 30.0, "pid": 2,
                     "resumed": True})
        recs.append({"ev": "e", "seg": "restore", "t0": t + 30.0,
                     "t1": t + 33.0})
        recs.append({"ev": "h", "kind": "loss_spike", "ts": t + 34.0})
    return recs


@pytest.mark.parametrize("kind", ["plain", "bg", "restart"])
def test_goodput_summarize_matches_jax(kind):
    recs = _journal(kind)
    mine = tgp.summarize(recs)
    assert mine == jgp.summarize(recs)
    assert mine["goodput_pct"] > 0


def test_goodput_journal_written_by_jax_reads_in_port(tmp_path):
    """A journal the JAX ledger wrote (nested segments, an overlapped
    write, a dangling tail) summarizes the same in the port, and the
    port's ledger resumes it as a restart."""
    led = jgp.GoodputLedger(str(tmp_path / "goodput.jsonl"))
    led.begin("step_compute")
    led.begin("compile")
    led.end()
    led.end()
    led.record_overlapped("ckpt_async", 1.0, 2.0)
    led.begin("ckpt_stall")                         # ... killed here
    recs = tgp.read_journal(str(tmp_path / "goodput.jsonl"))
    assert tgp.summarize(recs) == jgp.summarize(recs)
    assert tgp.GoodputLedger(
        str(tmp_path / "goodput.jsonl")).summary()["restarts"] == 1


# ---------------------------------------------------------------------------
# health monitor: the same series, the same events
# ---------------------------------------------------------------------------
def _series(kind):
    """(observations, failpoint spec): explicit step times throughout."""
    obsv = []
    for i in range(24):
        o = {"loss": 4.0 * 0.97 ** i + 0.01 * (i % 3),
             "grad_norm": 1.5 + 0.03 * (i % 4),
             "step_seconds": 0.2 + 0.002 * (i % 5), "step": i}
        obsv.append(o)
    spec = None
    if kind == "loss_spike":
        spec = "health.loss_spike=corrupt@15"
        obsv = obsv[:15]
    elif kind == "grad_norm_spike":
        obsv[12]["grad_norm"] = 400.0
    elif kind == "step_time_stall":
        obsv[14]["step_seconds"] = 3.0
    elif kind == "nonfinite":
        obsv[5]["loss"] = float("nan")
    return obsv, spec


def _events(hm, fpmod, kind):
    mon = hm.HealthMonitor(warmup=8, flight_on_spike=False)
    obsv, spec = _series(kind)
    out = []
    if spec:
        fpmod.configure(spec)
    try:
        for o in obsv:
            out += mon.observe(**o)
    finally:
        fpmod.clear()
    strip = ("ts", "flight_record")
    return [{k: v for k, v in e.items() if k not in strip} for e in out]


@pytest.mark.parametrize("kind", ["smooth", "loss_spike", "grad_norm_spike",
                                  "step_time_stall", "nonfinite"])
def test_health_events_match_jax(kind):
    obs.reset_registry()
    mine = _events(thm, fp, kind)
    ref = _events(jhm, jfp, kind)
    assert json.dumps(mine, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)
    want = {"smooth": [], "loss_spike": ["loss_spike"],
            "grad_norm_spike": ["grad_norm_spike"],
            "step_time_stall": ["step_time_stall"],
            "nonfinite": ["loss_nonfinite"]}[kind]
    assert [e["kind"] for e in mine] == want


def test_single_process_pod_skew():
    rep = thm.HealthMonitor().observe_pod_skew(0.25)
    assert (rep["step_time_skew"], rep["slowest_host"]) == (0.0, 0.0)
    assert rep["host_step_seconds"] == [0.25]


# ---------------------------------------------------------------------------
# failpoints and flops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["a.site=raise@3", "a.site=corrupt",
                                  "a.site=hang:0.01", "novalue",
                                  "a=explode", "a=raise@0"])
def test_failpoint_grammar_matches_jax(spec):
    def run(mod):
        mod.clear()
        try:
            mod.configure(spec)
        except ValueError:
            return "rejected"
        out = []
        for _ in range(3):
            try:
                out.append(mod.hit("a.site", b"0123456789"))
            except mod.FailpointError:
                out.append("raised")
        mod.clear()
        return out

    assert run(fp) == run(jfp)
    assert fp.KNOWN_SITES == jfp.KNOWN_SITES and fp.ENV_VAR == jfp.ENV_VAR


@pytest.mark.parametrize("preset", ["gpt_tiny", "gpt_1p3b"])
def test_mfu_matches_jax(preset):
    jcfg, tcfg = getattr(jgpt, preset)(), getattr(tg, preset)()
    n = tflops.params_from_config(tcfg)
    assert n == jflops.params_from_config(jcfg)
    for tps, peak in ((8192 / 0.157, 989e12), (1234.5, 459e12)):
        assert tflops.mfu(n, tps, 1, peak, config=tcfg) == \
            jflops.mfu(n, tps, 1, peak, config=jcfg)
    # the formula PERF.md states: (6 N + 12 L h S) tokens/s / peak
    want = (6 * n + 12 * tcfg.num_layers * tcfg.hidden_size
            * tcfg.max_position_embeddings) * 5e4 / 989e12
    assert math.isclose(tflops.mfu(n, 5e4, 1, 989e12, config=tcfg), want,
                        rel_tol=1e-12)


def test_peak_is_the_h100s_and_zero_elsewhere():
    assert tflops.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == \
        (989e12, 3.35e12)
    assert tflops.peak_flops_per_chip("NVIDIA A100-SXM4-80GB") == (0.0, 0.0)
    assert tflops.peak_flops_per_chip(torch.device("cpu")) == (0.0, 0.0)
    assert tflops.mfu(10 ** 6, 1e4, 1, 0.0) == 0.0


# ---------------------------------------------------------------------------
# the engine's wiring
# ---------------------------------------------------------------------------
def _engine(seed=3, steps_cfg=None):
    cfg = tg.GPTConfig(vocab_size=64, hidden_size=16, num_layers=1,
                       num_heads=2, max_position_embeddings=16)
    model = tg.GPTForCausalLM(cfg, device="cpu", seed=seed)
    crit = tg.GPTPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    eng = ParallelEngine(model, opt)
    step = eng.train_step(lambda m, b: crit(m(b["x"]), b["y"]))
    ids = np.random.RandomState(0).randint(0, 64, (2, 9))
    return eng, step, {"x": ids[:, :-1], "y": ids[:, 1:]}


def test_gauges_zero_before_any_step():
    obs.reset_registry()
    eng, _, _ = _engine()
    assert eng._metrics["grad_norm"].value() == 0.0
    assert eng._metrics["loss"].value() == 0.0
    eng._flush_pending_scalars()          # nothing pending: a no-op
    assert eng._metrics["grad_norm"].value() == 0.0


def test_first_step_lags_then_flushes():
    obs.reset_registry()
    eng, step, batch = _engine()
    loss = float(step(batch))
    # the first step's scalars are pending; the gauges still hold zero
    assert len(eng._pending) == 1
    assert eng._metrics["loss"].value() == 0.0
    assert eng._metrics["grad_norm"].value() == 0.0
    m = eng.metrics_snapshot()["metrics"]
    assert m["paddle_tpu_train_loss"]["series"][0]["value"] == loss
    assert m["paddle_tpu_train_grad_norm"]["series"][0]["value"] > 0
    assert not eng._pending
    before = eng._metrics["grad_norm"].value()
    eng._flush_pending_scalars()
    assert eng._metrics["grad_norm"].value() == before
    # a later step's entry publishes the step before it
    l2 = float(step(batch))
    l3 = float(step(batch))
    assert eng._metrics["loss"].value() == l2 != l3
    snap = eng.metrics_snapshot()["metrics"]
    assert snap["paddle_tpu_train_loss"]["series"][0]["value"] == l3
    assert snap["paddle_tpu_train_steps_total"]["series"][0]["value"] == 3
    assert snap["paddle_tpu_train_tokens_total"]["series"][0]["value"] \
        == 3 * 16
    assert eng._metrics["tokens_per_sec"].value() > 0
    assert eng._metrics["mfu"].value() == 0.0        # no peak on a CPU
    compiles = {s["labels"]["site"]: s["value"] for s in
                snap["paddle_tpu_compiles_total"]["series"]}
    assert compiles == {"train_engine": 1.0}


def test_goodput_compile_step_compute_and_restore(tmp_path):
    obs.reset_registry()
    led = tgp.attach_dir(str(tmp_path))
    eng, step, batch = _engine()
    for _ in range(3):
        float(step(batch))
    ck = str(tmp_path / "ck")
    eng.save_checkpoint(ck)
    eng.restore_checkpoint(ck)
    float(step(batch))               # the first step after a restore
    float(step(batch))
    recs = [r for r in tgp.read_journal(str(tmp_path / tgp.JOURNAL_NAME))
            if r["ev"] == "e"]
    assert [r["seg"] for r in recs] == ["compile", "step_compute",
                                        "step_compute", "restore",
                                        "compile", "step_compute"]
    begins = [r.get("step") for r in tgp.read_journal(
        str(tmp_path / tgp.JOURNAL_NAME)) if r["ev"] == "b"
        and r["seg"] in ("compile", "step_compute")]
    assert begins == [1, 2, 3, 4, 5]
    s = led.summary()
    assert s["segments"]["restore"] > 0 and s["goodput_pct"] > 0
    m = eng.metrics_snapshot()["metrics"]
    assert m["paddle_tpu_goodput_pct"]["series"][0]["value"] > 0
    assert eng.stats.compiles == 1


def test_health_windows_are_per_engine_and_fed_by_the_engine():
    """Each engine owns its monitor: a second run's losses never enter
    the first run's window (no wall-clock judgment involved)."""
    obs.reset_registry()
    eng_a, step_a, batch_a = _engine(seed=5)
    la = [float(step_a(batch_a)) for _ in range(3)]
    eng_b, step_b, batch_b = _engine(seed=6)
    lb = [float(step_b(batch_b)) for _ in range(3)]
    eng_a.metrics_snapshot()
    eng_b.metrics_snapshot()
    assert eng_a._health is not eng_b._health
    wa = list(eng_a._health._signals["loss"].window._buf)
    wb = list(eng_b._health._signals["loss"].window._buf)
    assert wa == la and wb == lb
    m = eng_b.metrics_snapshot()["metrics"]
    assert "paddle_tpu_health_loss_zscore" in m
    assert m["paddle_tpu_health_degraded"]["series"][0]["value"] == 0.0
    assert eng_b.pod_step_skew()["step_time_skew"] == 0.0
    assert eng_b.pod_throughput()["processes"] == 1.0


def test_scaler_skipped_step_is_not_an_anomaly():
    from paddle_tpu_torch.amp import GradScaler

    obs.reset_registry()
    torch.manual_seed(4)
    model = torch.nn.Linear(8, 8)
    from paddle_tpu_torch.optimizer import Adam

    opt = Adam(learning_rate=0.05, parameters=model.parameters())
    eng = ParallelEngine(model, opt)
    scaler = GradScaler(init_loss_scaling=2.0 ** 8,
                        decr_every_n_nan_or_inf=1)
    step = eng.train_step(lambda m, b: torch.mean((m(b["x"]) - b["y"]) ** 2),
                          scaler=scaler)
    r = np.random.RandomState(0)
    x = r.randn(4, 8).astype("float32")
    y = r.randn(4, 8).astype("float32")
    float(step({"x": x, "y": y}))
    bad = x.copy()
    bad[0, 0] = np.inf
    step({"x": bad, "y": y})
    float(step({"x": x, "y": y}))
    eng.metrics_snapshot()
    assert scaler.last_found_inf is False
    assert eng._health.event_count() == 0
    assert eng._health.status() == "ok"


def test_metrics_scrape_over_loopback_has_the_train_names():
    obs.reset_registry()
    eng, step, batch = _engine()
    float(step(batch))
    float(step(batch))
    eng.metrics_snapshot()
    with obs.serve_metrics(0) as srv:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics") as resp:
            text = resp.read().decode()
    typed = {ln.split()[2] for ln in text.splitlines()
             if ln.startswith("# TYPE ")}
    train = {m.name for m in tcat.train_metrics(
        tmetrics.MetricsRegistry()).values()}
    schema = json.loads(Path(tcat.SCHEMA_PATH).read_text())
    assert train <= set(schema) and train <= typed
    rows = tmetrics.parse_prometheus_text(text)
    assert rows["paddle_tpu_train_steps_total"][()] == 2.0


def test_telemetry_changes_nothing(tmp_path):
    """The same losses, bit for bit, with goodput and a sampler attached
    as without."""
    obs.reset_registry()
    eng_a, step_a, batch = _engine(seed=5)
    gold = [float(step_a(batch)) for _ in range(3)]
    obs.reset_registry()
    tgp.attach_dir(str(tmp_path))
    eng_b, step_b, batch = _engine(seed=5)
    assert [float(step_b(batch)) for _ in range(3)] == gold


@pytest.mark.parametrize("knob, item", [("mem_ledger", "item 11"),
                                        ("quant_comm", "item 10")])
def test_knob_errors_cite_their_item(knob, item):
    """A knob still waiting on its item raises citing it; item 11's
    memory ledger is ported, so mem_ledger builds an engine with it on."""
    model = tg.GPTForCausalLM(tg.gpt_tiny(), device="cpu")
    if knob == "mem_ledger":
        eng = ParallelEngine(model, AdamW(parameters=model.parameters()),
                             **{knob: True})
        assert eng._mem_on and eng.memory_ledger() is None
        return
    with pytest.raises(NotImplementedError, match=item):
        ParallelEngine(model, AdamW(parameters=model.parameters()),
                       **{knob: True})


# ---------------------------------------------------------------------------
# package rules: no JAX, no ml_dtypes, nothing of the JAX package
# ---------------------------------------------------------------------------
def _port_files():
    return sorted((REPO / "paddle_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", [p for p in _port_files()
                                  if "observability" in p.parts
                                  or "checkpoint" in p.parts
                                  or p.name in ("engine.py",
                                                "failpoints.py",
                                                "resume.py",
                                                "chip_smoke.py")],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_telemetry_modules_import_no_jax_nor_ml_dtypes(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        bad += [n for n in names if n.split(".")[0] in (
            "jax", "jaxlib", "ml_dtypes", "paddle_tpu")]
    assert not bad, f"{path}: forbidden imports {bad}"

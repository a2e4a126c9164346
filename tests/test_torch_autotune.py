"""K7, the measured K1 tile search, held against the JAX package on the CPU.

``AlgoCache`` and ``autotune`` of ``paddle_tpu_torch.ops.kernels.autotune``
run the same scenarios with the same fake measures as
tests/test_autotune.py does for ``paddle_tpu.ops.pallas.autotune``, and
must give the same choices, the same measurements and the same cache
file. ``_select_blocks`` (the port's counterpart of the tile choice in the
JAX ``_prep``) is driven with the card's parts stubbed: the device check,
the build's tile list, the card's name and the capture check. No CUDA
kernel runs here; tests/test_torch_cuda_kernels.py and chip_smoke.py run
the search on the card.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu
import paddle_tpu.ops.pallas.autotune as JAT
from paddle_tpu.core import flags as jflags
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCrit
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.distributed.engine import ParallelEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import autotune as TAT
from paddle_tpu_torch.ops.kernels import flash_attention as TFA
from paddle_tpu_torch.optimizer import AdamW

MODULES = {"jax": JAT, "port": TAT}
CARD = "NVIDIA H100 80GB HBM3"
TILES = ((128, 128), (64, 64), (64, 128), (128, 64), (192, 64))


@pytest.fixture(autouse=True)
def fresh_state():
    """Both packages' process caches and autotune flags restored after
    each test."""
    saved = (JAT._cache, TAT._cache, list(TAT.search_log),
             jflags._get("use_autotune"), tflags._get("use_autotune"))
    yield
    JAT._cache, TAT._cache = saved[0], saved[1]
    TAT.search_log[:] = saved[2]
    jflags.set_flags({"use_autotune": saved[3]})
    tflags.set_flags({"use_autotune": saved[4]})


def _argmin_scenario(mod, path):
    cache = mod.AlgoCache(path)
    times = {(128, 128): 3.0, (256, 256): 1.0, (512, 512): 2.0}
    calls = []

    def measure(c):
        calls.append(c)
        return times[c]

    seen = [mod.autotune("k1", list(times), measure, cache), len(calls)]
    # a hit makes no measurement
    seen += [mod.autotune("k1", list(times), measure, cache), len(calls)]
    # persisted: a new cache over the same file skips the search too
    seen += [mod.autotune("k1", list(times), measure, mod.AlgoCache(path)),
             len(calls), list(calls)]
    with open(path) as f:
        seen.append(json.load(f))
    return seen


def test_argmin_hit_and_persistence_match_jax(tmp_path):
    jax_seen = _argmin_scenario(JAT, str(tmp_path / "jax.json"))
    port_seen = _argmin_scenario(TAT, str(tmp_path / "port.json"))
    assert port_seen == jax_seen
    assert port_seen[:6] == [(256, 256), 3, (256, 256), 3, (256, 256), 3]
    assert port_seen[-1] == {"k1": [256, 256]}
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()


@pytest.mark.parametrize("bad", ["raise", "inf"])
def test_infeasible_candidates_are_skipped(bad):
    def measure(c):
        if c == "bad":
            if bad == "raise":
                raise ValueError("no compile")
            return float("inf")
        return {"a": 2.0, "b": 1.0}[c]

    for mod in MODULES.values():
        assert mod.autotune("k", ["bad", "a", "b"], measure,
                            mod.AlgoCache(None)) == "b"


def test_no_feasible_candidate_raises():
    def raise_(c):
        raise ValueError()

    for mod in MODULES.values():
        with pytest.raises(RuntimeError, match="no feasible candidate"):
            mod.autotune("none", ["bad"], raise_, mod.AlgoCache(None))
        with pytest.raises(RuntimeError, match="no feasible candidate"):
            mod.autotune("none", ["x", "y"], lambda c: float("inf"),
                         mod.AlgoCache(None))


def test_a_cuda_fault_is_not_an_infeasible_candidate():
    """The port's one departure: a launch error on the card propagates,
    where the JAX contract would score it infeasible and go on."""
    def measure(c):
        if c == "faulty":
            raise _build.LaunchError("flash_attention_fwd: CUDA launch "
                                     "failed with error 700")
        return 1.0

    with pytest.raises(_build.LaunchError):
        TAT.autotune("k", ["ok", "faulty"], measure, TAT.AlgoCache(None))
    assert JAT.autotune("k", ["ok", "faulty"], measure,
                        JAT.AlgoCache(None)) == "ok"


def test_empty_environment_value_opts_out_of_persistence(monkeypatch,
                                                         tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", "")
    monkeypatch.setenv("PADDLE_TPU_TORCH_AUTOTUNE_CACHE", "")
    for mod in MODULES.values():
        mod._cache = None
        assert mod._default_path() is None
        cache = mod.get_cache()
        assert mod.get_cache() is cache
        assert mod.autotune("k", [(1, 1), (2, 2)],
                            lambda c: float(c[0]), cache) == (1, 1)
        assert cache.size() == 1
    assert list(tmp_path.iterdir()) == []


def test_cache_paths(monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("PADDLE_TPU_AUTOTUNE_CACHE", raising=False)
    monkeypatch.delenv("PADDLE_TPU_TORCH_AUTOTUNE_CACHE", raising=False)
    assert JAT._default_path() == str(tmp_path / ".cache" / "paddle_tpu" /
                                      "autotune.json")
    assert TAT._default_path() == str(
        tmp_path / ".cache" / "paddle_tpu_torch" / "autotune.json")
    # each package reads its own variable only
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", str(tmp_path / "j.json"))
    assert TAT._default_path() == str(
        tmp_path / ".cache" / "paddle_tpu_torch" / "autotune.json")
    monkeypatch.setenv("PADDLE_TPU_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "t.json"))
    assert TAT._default_path() == str(tmp_path / "t.json")
    TAT._cache = None
    TAT.get_cache().put("k", (64, 128))
    assert json.loads((tmp_path / "t.json").read_text()) == {"k": [64, 128]}
    assert TAT.set_cache(None) is not None and TAT._cache is None


@pytest.mark.parametrize("content", ["{not json", "", "[1, 2"])
def test_corrupt_file_is_ignored(tmp_path, content):
    path = tmp_path / "algo.json"
    for mod in MODULES.values():
        path.write_text(content)
        cache = mod.AlgoCache(str(path))
        assert cache.size() == 0 and cache.get("k") is None
        cache.put("k", (128, 64))
        assert mod.AlgoCache(str(path)).get("k") == (128, 64)


# -- _select_blocks, the tile choice of the port's K1 wrapper -----------------
def _stub_card(monkeypatch, capturing=False):
    monkeypatch.setattr(TFA, "_on_card", lambda t: True)
    monkeypatch.setattr(TFA, "fwd_tiles", lambda D, dtype: TILES)
    monkeypatch.setattr(TFA, "_card", lambda device: CARD)
    monkeypatch.setattr(TFA, "_capturing", lambda: capturing)


def _qk(B=1, Sq=256, Skv=256, H=2, KV=2, D=128, dtype=torch.bfloat16):
    r = np.random.RandomState(0)
    return (torch.tensor(r.randn(B, Sq, H, D)).to(dtype),
            torch.tensor(r.randn(B, Skv, KV, D)).to(dtype))


def _no_measure(*a, **k):
    raise AssertionError("the search measured on a cache hit")


def test_flag_on_consults_the_cache_without_launching(monkeypatch):
    """The counterpart of tests/test_autotune.py
    test_flash_autotune_flag_consults_cache."""
    _stub_card(monkeypatch)
    real = TAT.measure_flash_blocks
    monkeypatch.setattr(TAT, "measure_flash_blocks",
                        lambda *a, **k: _no_measure)
    q, k = _qk()
    cache = TAT.AlgoCache(None)
    cache.put(TFA._autotune_key(q, k, True), (64, 128))
    TAT.set_cache(cache)
    tflags.set_flags({"FLAGS_use_autotune": True})
    before = (TFA.flash_attention_fwd.launches, real.launches,
              len(TAT.search_log))
    assert TFA._select_blocks(q, k, True, None) == (64, 128)
    assert (TFA.flash_attention_fwd.launches, real.launches,
            len(TAT.search_log)) == before


def test_flag_on_miss_searches_and_caches(monkeypatch, tmp_path):
    _stub_card(monkeypatch)
    times = dict(zip(TILES, [3.0, 2.5, 1.5, 2.0, 4.0]))
    made = []

    def fake_measure_flash_blocks(q_shape, kv_len, kv_heads, dtype, causal):
        made.append((q_shape, kv_len, kv_heads, dtype, causal))
        return lambda cand: times[cand]

    monkeypatch.setattr(TAT, "measure_flash_blocks",
                        fake_measure_flash_blocks)
    path = str(tmp_path / "algo.json")
    TAT.set_cache(TAT.AlgoCache(path))
    tflags.set_flags({"use_autotune": True})
    q, k = _qk(B=2, Sq=300, Skv=500, H=4, KV=2)
    assert TFA._select_blocks(q, k, False, None) == (64, 128)
    assert made == [((2, 300, 4, 128), 500, 2, torch.bfloat16, False)]
    key = TFA._autotune_key(q, k, False)
    assert json.loads(open(path).read()) == {key: [64, 128]}
    rec = TAT.search_log[-1]
    assert rec["key"] == key and rec["choice"] == (64, 128)
    assert rec["times"] == times and rec["seconds"] >= 0
    # a later call, and a later process over the file, measure nothing
    monkeypatch.setattr(TAT, "measure_flash_blocks",
                        lambda *a, **kw: _no_measure)
    assert TFA._select_blocks(q, k, False, None) == (64, 128)
    TAT.set_cache(TAT.AlgoCache(path))
    assert TFA._select_blocks(q, k, False, None) == (64, 128)


@pytest.mark.parametrize("why", ["flag_off", "cpu_tensor", "segment_ids",
                                 "one_tile", "no_keys"])
def test_default_tile_without_a_search(monkeypatch, why):
    monkeypatch.setattr(TAT, "measure_flash_blocks",
                        lambda *a, **k: _no_measure)
    TAT.set_cache(TAT.AlgoCache(None))
    tflags.set_flags({"use_autotune": why != "flag_off"})
    if why != "cpu_tensor":
        _stub_card(monkeypatch)
    if why == "one_tile":
        monkeypatch.setattr(TFA, "fwd_tiles", lambda D, dtype: TILES[:1])
    q, k = _qk(Skv=0 if why == "no_keys" else 256)
    qseg = torch.zeros(1, 256, dtype=torch.int32) \
        if why == "segment_ids" else None
    assert TFA._select_blocks(q, k, True, qseg) is None
    assert TAT.get_cache().size() == 0


def test_a_miss_during_capture_raises(monkeypatch):
    _stub_card(monkeypatch, capturing=True)
    monkeypatch.setattr(TAT, "measure_flash_blocks",
                        lambda *a, **k: _no_measure)
    TAT.set_cache(TAT.AlgoCache(None))
    tflags.set_flags({"use_autotune": True})
    q, k = _qk()
    with pytest.raises(RuntimeError, match="run this shape eagerly"):
        TFA._select_blocks(q, k, True, None)
    # a hit is served during a capture
    TAT.get_cache().put(TFA._autotune_key(q, k, True), (128, 64))
    assert TFA._select_blocks(q, k, True, None) == (128, 64)


def _jax_key(monkeypatch, shape, skv, dtype, causal):
    """The key the JAX ``_prep`` hands to ``autotune``."""
    seen = []

    def fake_autotune(key, cands, measure):
        seen.append(key)
        return cands[0]

    monkeypatch.setattr(JAT, "autotune", fake_autotune)
    monkeypatch.setattr(JAT, "measure_flash_blocks", lambda *a: None)
    jflags.set_flags({"use_autotune": True})
    q = jnp.zeros(shape, dtype)
    k = jnp.zeros((shape[0], skv) + shape[2:], dtype)
    JFA._prep(q, k, causal, None, False, None, None)
    return seen[0]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal", [True, False])
def test_key_extends_the_jax_key(monkeypatch, dtype, causal):
    shape, skv = (2, 512, 4, 128), 1024
    jkey = _jax_key(monkeypatch, shape, skv, getattr(jnp, dtype), causal)
    _stub_card(monkeypatch)
    q, k = _qk(B=2, Sq=512, Skv=skv, H=4, KV=4,
               dtype=getattr(torch, dtype))
    tkey = TFA._autotune_key(q, k, causal)
    assert tkey.split(":")[:5] == jkey.split(":")
    assert tkey == (f"{jkey}:kv4:{CARD}:"
                    f"{_build.build_hash('flash_attention')}")
    # GQA changes the port's key only
    _, k2 = _qk(B=2, Sq=512, Skv=skv, H=4, KV=2,
                dtype=getattr(torch, dtype))
    assert TFA._autotune_key(q, k2, causal) != tkey


# -- the slice on the CPU: training with FLAGS_use_autotune on ----------------
def test_training_with_the_flag_on_matches_jax(monkeypatch):
    """Both packages train llama_tiny 3 steps with FLAGS_use_autotune on:
    on the CPU neither searches (the JAX ``_prep`` skips the search under
    interpret, the port's ``_select_blocks`` on CPU tensors), and the
    losses agree within 1e-5 relative, as tests/test_torch_train.py holds
    them with the flag off."""
    monkeypatch.setattr(JAT, "autotune", _no_measure)
    monkeypatch.setattr(TAT, "autotune", _no_measure)
    paddle_tpu.set_flags({"FLAGS_use_autotune": True})
    tflags.set_flags({"FLAGS_use_autotune": True})
    paddle_tpu.seed(21)
    cfg = jax_tiny()
    jm = JaxLlama(cfg)
    init = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    ids = np.random.RandomState(13).randint(0, cfg.vocab_size, (2, 33))
    x, y = ids[:, :-1], ids[:, 1:]
    opt_kw = dict(learning_rate=3e-4, weight_decay=0.01,
                  multi_precision=True)
    jopt = paddle_tpu.optimizer.AdamW(
        parameters=jm.parameters(),
        grad_clip=paddle_tpu.nn.ClipGradByGlobalNorm(1.0), **opt_kw)
    jcrit = JaxCrit(cfg)
    jlosses = []
    for _ in range(3):
        loss = jcrit(jm(paddle_tpu.to_tensor(x)), paddle_tpu.to_tensor(y))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jlosses.append(float(loss))
    tm = tl.LlamaForCausalLM(tl.llama_tiny(), device="cpu", seed=99)
    load_jax_state_dict(tm, init)
    topt = AdamW(parameters=tm.named_parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0), **opt_kw)
    crit = tl.LlamaPretrainingCriterion(tm.config)
    step = ParallelEngine(tm, topt).train_step(
        lambda m, b: crit(m(b["x"]), b["y"]))
    n = TAT.measure_flash_blocks.launches
    tlosses = [float(step({"x": x, "y": y})) for _ in range(3)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=0)
    assert TAT.measure_flash_blocks.launches == n

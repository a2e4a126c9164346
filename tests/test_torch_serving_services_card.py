"""The serving path's run-time services on the card: the memory ledger,
``pool_pages="auto"`` and the phase-split fleet with CUDA graphs; and
the train engine's memory ledger.

    python -m pytest tests/test_torch_serving_services_card.py -m cuda -q

Without a card every test here skips with a reason (decided inside the
``cuda`` fixture, never at import). A reduced Llama in fp32 with TF32
off: with ``mem_ledger=True`` the engine captures the same graphs, once,
commits the tokens of a ledger-off engine and measures each graphed
site's temporaries; a second engine's ``pool_pages="auto"`` sees the
first engine's pool; a phase-split fleet (1 prefill + 1 decode replica)
commits the unified fleet's streams, moves every committed page bit for
bit, and captures no graph after its warmup. A ``ParallelEngine`` with
``mem_ledger=True`` measures its step's temporaries on the allocator
and accounts its state at the closed form. The CPU tests of the same
code are tests/test_torch_memledger.py and
tests/test_torch_disagg_router.py.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import (Config, Router, ServingEngine,
                                        create_predictor)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import memledger as ml

pytestmark = pytest.mark.cuda

PAGE = 16


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs, the allocator's "
                    "statistics and the port's kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def model(cuda):
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=2, intermediate_size=512,
                      max_position_embeddings=512, dtype="float32")
    return LlamaForCausalLM(cfg, device=cuda, seed=1)


def _engine(model, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_chunk", 64)
    pred = create_predictor(Config().set_model(model).enable_paged_kv(PAGE))
    return ServingEngine(pred, **kw)


def _prompts(seed, lens=(40, 130, 75, 9, 200)):
    r = np.random.RandomState(seed)
    return [r.randint(1, 512, (L,)) for L in lens]


def _serve(eng, seed):
    rids = [eng.submit(p, max_new_tokens=8) for p in _prompts(seed)]
    done = eng.run()
    return [list(done[r].new_tokens) for r in rids]


def test_ledger_on_same_tokens_flat_captures(model):
    off, on = _engine(model), _engine(model, mem_ledger=True)
    assert _serve(off, 0) == _serve(on, 0)
    caps = dict(on.stats.captures)
    assert caps == {"unified": 1, "serve_decode": 1}
    assert _serve(off, 1) == _serve(on, 1)
    assert dict(on.stats.captures) == caps           # no new capture
    assert on.stats.replays["unified"] > 0
    pools = sum(t.numel() * t.element_size() for kv in on.pools
                for t in kv)
    for site in (("unified", 64), ("decode",)):
        led = on.memory_ledger(site)
        assert led.alias_bytes == pools and led.temp_bytes > 0
        assert "temp_bytes not measured" not in led.note
    st = on.memory_summary()["state"]
    assert st["kv_pool_bytes"] == st["page_bytes"] * st["pool_pages"]
    assert st["live_peak_bytes"] > 0
    assert on.roofline_report().bound != "unknown"


def test_auto_pool_sees_the_other_engines_pool(model, cuda):
    page_bytes = _engine(model)._page_bytes()
    before = ml.suggest_pool_pages(cuda, page_bytes, 0)
    big = _engine(model, pool_pages=4096)
    after = ml.suggest_pool_pages(cuda, page_bytes, 0)
    assert before - after >= 4096 - 8     # the big pool is taken off
    auto = _engine(model, pool_pages="auto")
    assert auto.P == _engine(model).P     # the geometric cap still binds
    del big


def test_split_fleet_equals_unified_flat_captures(model):
    uni = Router([("u0", _engine(model)), ("u1", _engine(model))])
    gids = [uni.submit(p, max_new_tokens=8) for p in _prompts(2)]
    res = uni.run()
    want = [list(res[g].new_tokens) for g in gids]

    p0, d0 = _engine(model, phase="prefill"), _engine(model, phase="decode")
    rt = Router([("p0", p0), ("d0", d0)])
    rt.submit(np.arange(1, 40), max_new_tokens=4)          # warmup
    rt.run()
    caps = (dict(p0.stats.captures), dict(d0.stats.captures))
    assert caps == ({"unified": 1}, {"serve_decode": 1})
    gids = [rt.submit(p, max_new_tokens=8) for p in _prompts(2)]
    res = rt.run()
    assert [list(res[g].new_tokens) for g in gids] == want
    assert (dict(p0.stats.captures), dict(d0.stats.captures)) == caps
    assert rt.migrator.migrated == len(gids) + 1

    # one page moved bit for bit
    p0.submit(np.arange(1, 60), max_new_tokens=4)
    while not p0.migratable():
        p0.step()
    s = next(s for s in p0.slots if s is not None)
    before = [torch.stack([t[pg] for kv in p0.pools for t in kv]).cpu()
              for pg in s.pages[:-(-59 // PAGE)]]
    pkg = p0.export_request(p0.migratable()[0])
    d0.import_request(pkg)
    s = next(s for s in d0.slots if s is not None)
    after = [torch.stack([t[pg] for kv in d0.pools for t in kv]).cpu()
             for pg in s.pages[:len(before)]]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_train_engine_ledger(cuda):
    from paddle_tpu_torch.distributed.engine import ParallelEngine
    from paddle_tpu_torch.models import gpt as tg
    from paddle_tpu_torch.optimizer import AdamW

    cfg = tg.gpt_tiny(dtype="bfloat16")
    model = tg.GPTForCausalLM(cfg, device=cuda, seed=3)
    crit = tg.GPTPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=3e-3, parameters=model.named_parameters(),
                multi_precision=True)
    eng = ParallelEngine(model, opt, mem_ledger=True)
    step = eng.train_step(lambda m, b: crit(m(b["x"]), b["y"]))
    B, S = 2, 32
    ids = np.random.RandomState(7).randint(0, cfg.vocab_size, (B, S + 1))
    for _ in range(2):
        assert np.isfinite(float(step({"x": ids[:, :-1], "y": ids[:, 1:]})))
    closed = ml.closed_form_state_bytes(eng)
    assert closed["optimizer_state"] > 0 and closed["master_weights"] > 0
    acct = eng.state_accounting()
    assert all(acct.components[k] == v for k, v in closed.items())
    own = closed["params"] + closed["optimizer_state"] \
        + closed["master_weights"]
    led = eng.memory_ledger()
    assert led.alias_bytes == own
    assert led.argument_bytes == own + 2 * B * S * 8     # x, y int64
    assert "temp_bytes not measured" not in led.note
    assert led.temp_bytes > 0
    assert eng._metrics["mem_live"].value() >= own
    assert eng.roofline_report().bound != "unknown"

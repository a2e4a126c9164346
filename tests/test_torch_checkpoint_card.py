"""Checkpoints and the engine's telemetry on the card.

    python -m pytest tests/test_torch_checkpoint_card.py -m cuda -q

Without a card every test here skips with a reason (decided inside the
``cuda`` fixture, never at import). gpt_tiny in bf16 with hidden and
attention dropout 0.1 (the mma bodies' ``kDrop`` instances, K8) through
``ParallelEngine`` on the card: a resume from a checkpoint reproduces
the uninterrupted run bit for bit (losses, parameters, masters, moments,
both dropout generators); an async save followed at once by a step that
updates everything in place commits the state before the step; the
step's scalars reach the host behind a CUDA event, one step late, and
``metrics_snapshot`` publishes them all; the allocator gauges are there.
The CPU tests of the same code, held against the JAX package, are in
tests/test_torch_checkpoint.py and tests/test_torch_observability.py.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.distributed.checkpoint import wait_async_saves
from paddle_tpu_torch.distributed.engine import ParallelEngine
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW, lr

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine's CUDA path (pinned "
                    "copies behind events, the port's kernels)")
    return torch.device("cuda")


def _engine(seed):
    cfg = tg.gpt_tiny(dtype="bfloat16", hidden_dropout=0.1,
                      attention_dropout=0.1)
    model = tg.GPTForCausalLM(cfg, seed=seed)
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=8),
                            warmup_steps=2, start_lr=1e-4, end_lr=1e-3)
    opt = AdamW(learning_rate=sched, multi_precision=True,
                grad_clip=ClipGradByGlobalNorm(1.0),
                parameters=model.parameters())
    crit = tg.GPTPretrainingCriterion(cfg)
    eng = ParallelEngine(model, opt)
    step = eng.train_step(lambda m, b: crit(m(b["x"]), b["y"]))

    def run(i):
        ids = np.random.RandomState(100 + i).randint(0, cfg.vocab_size,
                                                     (4, 129))
        return float(step({"x": ids[:, :-1], "y": ids[:, 1:]}))

    return model, opt, eng, run


def _state(model, opt):
    out = {f"p.{n}": p.detach().clone() for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        out[f"m.{n}"] = opt._master_weights[id(p)].clone()
        for k, v in opt._states[id(p)].items():
            out[f"{k}.{n}"] = v.clone()
    out["hidden"] = model.gpt.embeddings.dropout.generator.get_state()
    out["attention"] = model.gpt.layers[0].attn._attn_gen.get_state()
    return out


def _equal(a, b):
    return [k for k in a if not torch.equal(a[k], b[k])]


def test_resume_is_bit_exact_on_the_card(cuda, tmp_path):
    model, opt, eng, run = _engine(0)
    gold = []
    for i in range(6):
        gold.append(run(i))
        if i == 2:
            eng.save_checkpoint(str(tmp_path / "c3"))
    model2, opt2, eng2, run2 = _engine(1)
    assert eng2.restore_checkpoint(str(tmp_path / "c3"))["step"] == 3
    assert [run2(i) for i in range(3, 6)] == gold[3:]
    assert _equal(_state(model, opt), _state(model2, opt2)) == []
    assert opt._lr.state_dict() == opt2._lr.state_dict()


def test_async_save_then_an_in_place_step_on_the_card(cuda, tmp_path):
    model, opt, eng, run = _engine(0)
    run(0)
    before = _state(model, opt)
    eng.save_checkpoint(str(tmp_path / "ck"), async_save=True)
    run(1)                       # K8 updates everything in place
    wait_async_saves()
    assert _equal(before, _state(model, opt))
    model2, opt2, eng2, _ = _engine(1)
    eng2.restore_checkpoint(str(tmp_path / "ck"))
    assert _equal(before, _state(model2, opt2)) == []


def test_scalars_reach_the_host_behind_an_event(cuda):
    obs.reset_registry()
    model, opt, eng, run = _engine(0)
    losses = [run(i) for i in range(3)]
    # each step's float(loss) synchronized, so every record but the
    # last was published at the next step's entry
    assert len(eng._pending) == 1
    rec = eng._pending[0]
    assert rec.event is not None and rec.host.is_pinned()
    assert eng._metrics["loss"].value() == losses[1]
    m = eng.metrics_snapshot()["metrics"]
    assert not eng._pending
    assert m["paddle_tpu_train_loss"]["series"][0]["value"] == losses[2]
    assert m["paddle_tpu_train_grad_norm"]["series"][0]["value"] > 0
    stats = {r["labels"]["stat"]: r["value"] for r in
             m["paddle_tpu_device_memory_bytes"]["series"]}
    assert set(stats) == {"bytes_in_use", "peak_bytes_in_use",
                          "bytes_limit"}
    assert 0 < stats["bytes_in_use"] <= stats["peak_bytes_in_use"] \
        <= stats["bytes_limit"]
    assert eng._metrics["mfu"].value() >= 0.0

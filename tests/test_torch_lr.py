"""The port's LR schedulers against the JAX package's on the CPU.

Each of the 13 schedulers runs 30 steps on both sides: the learning
rates must be equal exactly (both are float64 Python arithmetic), and a
``state_dict`` taken mid-way must restore the same sequence. Then a
5-step ``llama_tiny`` AdamW run under a warmup-and-cosine schedule,
through the port's ``ParallelEngine.train_step`` (which steps the
schedule once a train step, as the JAX engine does), must give losses
within 1e-5 relative of the JAX eager loop that steps it by hand.
"""
import math

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCrit
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.distributed.engine import ParallelEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 30

SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12, 20],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, gamma=0.07),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.93),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, gamma=0.3),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=12,
                                                   end_lr=0.001, power=2.0,
                                                   cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, warmup_steps=8,
                                             start_lr=0.0, end_lr=0.1),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=7, gamma=0.5),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, milestones=[4, 9, 21],
                                                 gamma=0.3),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.97 ** e),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.1, T_max=17,
                                                             eta_min=1e-4),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=25),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                     step_size_down=6, mode="triangular2"),
    "LinearWarmup(CosineAnnealingDecay)": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=20, eta_min=1e-3),
        warmup_steps=5, start_lr=1e-4, end_lr=0.1),
}


def _trace(sched, n=STEPS):
    out = []
    for _ in range(n):
        out.append(sched())
        sched.step()
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_jax_exactly(name):
    mine = _trace(SCHEDULERS[name](tlr))
    ref = _trace(SCHEDULERS[name](jlr))
    assert mine == ref
    assert all(isinstance(v, float) and math.isfinite(v) for v in mine)


@pytest.mark.parametrize("name", ["CosineAnnealingDecay", "StepDecay",
                                  "CyclicLR",
                                  "LinearWarmup(CosineAnnealingDecay)"])
def test_state_dict_round_trip(name):
    a = SCHEDULERS[name](tlr)
    _trace(a, 11)
    b = SCHEDULERS[name](tlr)
    b.set_state_dict(a.state_dict())
    assert b.state_dict() == a.state_dict()
    assert _trace(b, 10) == _trace(a, 10)


def test_optimizer_reads_and_saves_the_schedule():
    model = tl.LlamaForCausalLM(tl.llama_tiny(), device="cpu")
    sched = tlr.StepDecay(0.1, step_size=2, gamma=0.5)
    opt = AdamW(learning_rate=sched, parameters=model.parameters())
    assert opt.get_lr() == 0.1
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.2)
    sched.step()
    sched.step()
    assert opt.get_lr() == 0.05
    assert opt.state_dict()["LR_Scheduler"] == sched.state_dict()
    opt2 = AdamW(learning_rate=0.3, parameters=model.parameters())
    opt2.set_lr_scheduler(tlr.StepDecay(0.1, step_size=2, gamma=0.5))
    opt2.set_state_dict(opt.state_dict())
    assert opt2.get_lr() == 0.05
    with pytest.raises(TypeError, match="LRScheduler"):
        opt2.set_lr_scheduler(lambda: 0.1)


def _warmup_cosine(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(3e-3, T_max=4),
                          warmup_steps=2, start_lr=1e-4, end_lr=3e-3)


def test_llama_tiny_adamw_under_a_schedule_matches_jax():
    paddle.seed(4)
    cfg = jax_tiny()
    jm = JaxLlama(cfg)
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    ids = np.random.RandomState(8).randint(0, cfg.vocab_size, (2, 33))
    x, y = ids[:, :-1], ids[:, 1:]
    sched = _warmup_cosine(jlr)
    jopt = paddle.optimizer.AdamW(learning_rate=sched, weight_decay=0.01,
                                  parameters=jm.parameters())
    ref = []
    for _ in range(5):
        loss = JaxCrit(cfg)(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        sched.step()
        ref.append(float(loss))

    tm = tl.LlamaForCausalLM(tl.llama_tiny(), device="cpu")
    load_jax_state_dict(tm, state)
    tsched = _warmup_cosine(tlr)
    opt = AdamW(learning_rate=tsched, weight_decay=0.01,
                parameters=tm.named_parameters())
    crit = tl.LlamaPretrainingCriterion()
    step = ParallelEngine(tm, opt).train_step(
        lambda m, b: crit(m(b["x"]), b["y"]))
    mine = [float(step({"x": x, "y": y})) for _ in range(5)]
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=0)
    assert tsched.last_epoch == sched.last_epoch == 5
    assert opt.get_lr() == sched()

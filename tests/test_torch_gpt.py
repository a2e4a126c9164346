"""The port's GPT (``paddle_tpu_torch.models.gpt``) held against the JAX
package's on the CPU, fp32.

Weights are built by the JAX package (``gpt_tiny``, an untied
``gpt_tiny`` and a narrow config with head dim 64) and carried across by
``convert.load_jax_state_dict``. Checked: the forward logits (1e-5); a
5-step AdamW trajectory at lr 1e-3 as ``tests/test_gpt.py`` trains
(losses within 1e-5 relative at every step, parameters after step 5
within 1e-4), eagerly and through ``ParallelEngine.train_step``;
``GPTPretrainingCriterion`` with a ``loss_mask``; the cached forward
(a prefill, then 4 single-token steps, 1e-5); ``num_params`` and every
``gpt_*`` preset; and the raises (MoE, mp, sep). Dropout is 0 here: the
JAX masks come from ``jax.random`` (tests/test_torch_dropout.py holds
the port's own masks).

The parameter gate, 1e-4, holds for every element whose first gradient
(the JAX run's) is at least 1e-6 in magnitude. Below that the two
packages' f32 gradients differ by more than 1% (their summation orders
differ by ~2e-8 at these sizes) and Adam's g / (|g| + eps) turns that
into a different step of up to lr; those few elements (2 of 0.6 M in
the narrow config, measured) are held within lr = 1e-3, one step.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jg
from paddle_tpu_torch.convert import (export_jax_state_dict,
                                      load_jax_state_dict)
from paddle_tpu_torch.distributed.engine import ParallelEngine
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.optimizer import AdamW

LOGIT_TOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4
LR = 1e-3
TINY_GRAD = 1e-6
STEPS = 5

NARROW = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
              max_position_embeddings=128)
CONFIGS = {
    "gpt_tiny": ("gpt_tiny", {}, (4, 16)),
    "untied_tiny": ("gpt_tiny", {"tie_word_embeddings": False}, (4, 16)),
    "narrow_d64": (None, NARROW, (2, 48)),
}


def _cfgs(name):
    preset, kw, shape = CONFIGS[name]
    if preset is None:
        return jg.GPTConfig(**kw), tg.GPTConfig(**kw), shape
    return getattr(jg, preset)(**kw), getattr(tg, preset)(**kw), shape


def _batch(vocab, B, S, seed=0):
    ids = np.random.RandomState(seed).randint(0, vocab, (B, S + 1))
    return ids[:, :-1], ids[:, 1:]


def _state(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_run(request):
    """The JAX eager loop of tests/test_gpt.py: initial weights, first
    logits, losses and final weights."""
    jcfg, tcfg, (B, S) = _cfgs(request.param)
    paddle.seed(42)
    model = jg.GPTForCausalLM(jcfg)
    crit = jg.GPTPretrainingCriterion(jcfg)
    init = _state(model)
    x, y = _batch(jcfg.vocab_size, B, S)
    xt, yt = paddle.to_tensor(x), paddle.to_tensor(y)
    logits = np.asarray(model(xt)._value)
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=model.parameters())
    losses, grad0 = [], None
    for _ in range(STEPS):
        loss = crit(model(xt), yt)
        loss.backward()
        if grad0 is None:
            grad0 = {n: np.asarray(p.grad._value)
                     for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return dict(tcfg=tcfg, init=init, logits=logits, losses=losses,
                final=_state(model), grad0=grad0, batch=(x, y))


def _port(run):
    model = tg.GPTForCausalLM(run["tcfg"], device="cpu", seed=7)
    load_jax_state_dict(model, run["init"])
    opt = AdamW(learning_rate=LR, parameters=model.named_parameters())
    return model, tg.GPTPretrainingCriterion(run["tcfg"]), opt


def _check(run, model, losses):
    np.testing.assert_allclose(losses, run["losses"], rtol=LOSS_RTOL, atol=0)
    assert losses[-1] < losses[0]
    mine = export_jax_state_dict(model)
    assert set(mine) == set(run["final"])
    for k, ref in run["final"].items():
        err = np.abs(mine[k] - ref)
        tiny = np.abs(run["grad0"][k]) < TINY_GRAD
        assert err[~tiny].max(initial=0.0) <= PARAM_TOL, k
        assert err[tiny].max(initial=0.0) <= LR, k


def test_weights_carry_across_and_logits_match(jax_run):
    model, _, _ = _port(jax_run)
    # the tied embedding is one parameter, exported once
    exported = export_jax_state_dict(model)
    assert set(exported) == set(jax_run["init"])
    for k, v in jax_run["init"].items():
        np.testing.assert_array_equal(exported[k], v, err_msg=k)
    model.eval()
    with torch.no_grad():
        logits = model(torch.tensor(jax_run["batch"][0])).numpy()
    np.testing.assert_allclose(logits, jax_run["logits"], rtol=0,
                               atol=LOGIT_TOL)


def test_eager_loop_matches_jax(jax_run):
    model, crit, opt = _port(jax_run)
    x, y = (torch.tensor(a) for a in jax_run["batch"])
    losses = []
    for _ in range(STEPS):
        loss = crit(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    _check(jax_run, model, losses)


def test_engine_train_step_matches_jax(jax_run):
    model, crit, opt = _port(jax_run)
    eng = ParallelEngine(model, opt)
    step = eng.train_step(lambda m, b: crit(m(b["x"]), b["y"]))
    x, y = jax_run["batch"]
    losses = [float(step({"x": x, "y": y})) for _ in range(STEPS)]
    _check(jax_run, model, losses)
    assert (eng.stats.compiles, eng.stats.cache_hits) == (1, STEPS - 1)


def test_criterion_loss_mask_matches_jax():
    r = np.random.RandomState(3)
    logits = r.randn(2, 7, 11).astype(np.float32)
    labels = r.randint(0, 11, (2, 7))
    for mask in (r.rand(2, 7) > 0.4, np.zeros((2, 7), bool), None):
        jm = None if mask is None else paddle.to_tensor(
            mask.astype(np.float32))
        ref = float(jg.GPTPretrainingCriterion()(
            paddle.to_tensor(logits), paddle.to_tensor(labels), jm))
        tm = None if mask is None else torch.tensor(mask)
        got = float(tg.GPTPretrainingCriterion()(
            torch.tensor(logits), torch.tensor(labels), tm))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["gpt_tiny", "narrow_d64"])
def test_cached_forward_matches_jax(name):
    """A prefill of 12 tokens over empty caches, then 4 single-token steps
    at their positions: logits and the concatenated caches."""
    jcfg, tcfg, _ = _cfgs(name)
    paddle.seed(5)
    jm = jg.GPTForCausalLM(jcfg)
    tm = tg.GPTForCausalLM(tcfg, device="cpu")
    load_jax_state_dict(tm, _state(jm))
    tm.eval()
    B, P, n, D = 2, 12, tcfg.num_heads, tcfg.head_dim
    ids = np.random.RandomState(8).randint(0, tcfg.vocab_size, (B, P + 4))
    empty = np.zeros((B, 0, n, D), np.float32)
    jc = [(paddle.to_tensor(empty), paddle.to_tensor(empty))
          for _ in range(tcfg.num_layers)]
    tc = [(torch.tensor(empty), torch.tensor(empty))
          for _ in range(tcfg.num_layers)]
    pos = 0
    for chunk in (ids[:, :P],) + tuple(ids[:, P + i:P + i + 1]
                                       for i in range(4)):
        jl, jc = jm(paddle.to_tensor(chunk), caches=jc, position_offset=pos)
        with torch.no_grad():
            tl, tc = tm(torch.tensor(chunk), caches=tc, position_offset=pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl._value), rtol=0,
                                   atol=LOGIT_TOL)
        pos += chunk.shape[1]
    for (jk, jv), (tk, tv) in zip(jc, tc):
        assert tk.shape == (B, P + 4, n, D)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk._value),
                                   rtol=0, atol=LOGIT_TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv._value),
                                   rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("preset", ["gpt_tiny", "gpt_125m", "gpt_350m",
                                    "gpt_1p3b", "gpt_13b"])
def test_configs_and_num_params_match_jax(preset):
    j, t = getattr(jg, preset)(), getattr(tg, preset)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.head_dim, t.num_params()) == (j.head_dim, j.num_params())
    kw = dict(hidden_dropout=0.1, attention_dropout=0.1, dtype="bfloat16")
    assert dataclasses.asdict(getattr(tg, preset)(**kw)) == \
        dataclasses.asdict(getattr(jg, preset)(**kw))


def test_gpt_1p3b_counts_1p316b_parameters():
    assert tg.gpt_1p3b().num_params() == 1_315_819_520
    assert dataclasses.asdict(tg.GPTConfig()) == \
        dataclasses.asdict(jg.GPTConfig())


def test_parameter_count_matches_the_built_model():
    m = tg.GPTForCausalLM(tg.gpt_tiny(), device="cpu")
    assert sum(p.numel() for p in m.parameters()) == m.config.num_params()
    u = tg.GPTForCausalLM(tg.gpt_tiny(tie_word_embeddings=False),
                          device="cpu")
    assert sum(p.numel() for p in u.parameters()) == \
        u.config.num_params() + 256 * 64


def test_unported_variants_raise():
    """MoE and context parallelism raise (item 10). Tensor parallelism is
    ported (tests/test_torch_hybrid_gpt.py): an mp group that is not a
    distributed Group is refused."""
    class Group:
        nranks = 2

    with pytest.raises(RuntimeError, match="item 10"):
        tg.GPTForCausalLM(tg.gpt_tiny(num_experts=4), device="cpu")
    with pytest.raises(TypeError, match="distributed Group"):
        tg.GPTForCausalLM(tg.gpt_tiny(), device="cpu", mp_group=Group())
    with pytest.raises(RuntimeError, match="item 10"):
        tg.GPTForCausalLM(tg.gpt_tiny(), device="cpu", sep_group=Group())
    with pytest.raises(TypeError, match="distributed Group"):
        tg.GPTPretrainingCriterion(mp_group=Group())(
            torch.zeros(1, 2, 4), torch.zeros(1, 2, dtype=torch.long))


def test_dropout_train_mode_draws_and_eval_does_not():
    """With dropout on, train-mode forwards differ (each call draws new
    masks) and a model rebuilt from the same seed replays them; eval mode
    drops nothing and equals the dropout-free model."""
    cfg = tg.gpt_tiny(hidden_dropout=0.1, attention_dropout=0.1)
    x = torch.tensor(_batch(256, 2, 16)[0])
    a = tg.GPTForCausalLM(cfg, device="cpu", seed=3)
    b = tg.GPTForCausalLM(cfg, device="cpu", seed=3)
    plain = tg.GPTForCausalLM(tg.gpt_tiny(), device="cpu", seed=3)
    with torch.no_grad():
        first, second = a(x), a(x)
        assert not torch.equal(first, second)
        assert torch.equal(b(x), first) and torch.equal(b(x), second)
        assert torch.equal(a.eval()(x), plain.eval()(x))

"""The port's Llama training step held against the JAX package on the CPU.

Weights are built by the JAX package and carried across by
``paddle_tpu_torch.convert.load_jax_state_dict``; both packages then
train 5 steps in fp32 on the same batch with
``AdamW(lr=3e-4, weight_decay=0.01, multi_precision=True,
grad_clip=ClipGradByGlobalNorm(1.0))``: the JAX package in its eager
form (``loss.backward(); opt.step(); opt.clear_grad()``, as
tests/test_llama.py runs it), the port both in that form and through
``ParallelEngine.train_step``. Losses must agree within 1e-5 relative at
every step and the parameters after step 5 within 1e-4 (read back by
``convert.export_jax_state_dict``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCrit
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu_torch.convert import (export_jax_state_dict,
                                      load_jax_state_dict)
from paddle_tpu_torch.distributed.engine import ParallelEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4
STEPS = 5

NARROW = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
              num_kv_heads=2, intermediate_size=512,
              max_position_embeddings=128)
CONFIGS = {
    "llama_tiny": (jax_tiny, tl.llama_tiny, {}, (2, 32)),
    "narrow_h256_gqa": (lambda **kw: JaxConfig(**NARROW, **kw),
                        lambda **kw: tl.LlamaConfig(**NARROW, **kw), {},
                        (2, 64)),
    "tied_tiny": (jax_tiny, tl.llama_tiny, {"tie_word_embeddings": True},
                  (2, 32)),
}


def _batch(vocab, B, S):
    ids = np.random.RandomState(13).randint(0, vocab, (B, S + 1))
    return ids[:, :-1], ids[:, 1:]


def _opt_kw():
    return dict(learning_rate=3e-4, weight_decay=0.01, multi_precision=True)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_run(request):
    """The JAX eager loop: initial weights, losses, final weights."""
    jcfg, tcfg, kw, (B, S) = CONFIGS[request.param]
    paddle.seed(21)
    cfg = jcfg(**kw)
    model = JaxLlama(cfg)
    crit = JaxCrit(cfg)
    init = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    opt = paddle.optimizer.AdamW(
        parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0), **_opt_kw())
    x, y = _batch(cfg.vocab_size, B, S)
    losses = []
    for _ in range(STEPS):
        loss = crit(model(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    final = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    return dict(name=request.param, tcfg=tcfg(**kw), init=init,
                losses=losses, final=final, batch=(x, y))


def _port(run):
    model = tl.LlamaForCausalLM(run["tcfg"], device="cpu", seed=99)
    load_jax_state_dict(model, run["init"])
    opt = AdamW(parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), **_opt_kw())
    return model, tl.LlamaPretrainingCriterion(run["tcfg"]), opt


def _check(run, model, losses):
    np.testing.assert_allclose(losses, run["losses"], rtol=LOSS_RTOL,
                               atol=0)
    assert losses[-1] < losses[0]
    mine = export_jax_state_dict(model)
    assert set(mine) == set(run["final"])
    for k, ref in run["final"].items():
        np.testing.assert_allclose(mine[k], ref, rtol=0, atol=PARAM_TOL,
                                   err_msg=k)


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
    # one batch signature: one "compile", the rest hits
    assert (eng.stats.compiles, eng.stats.cache_hits) == (1, STEPS - 1)
    assert opt.grad_norm is not None and float(opt.grad_norm) > 0
    assert all(p.grad is None for p in model.parameters())


def test_loss_mask_and_ignore_index_match_jax():
    paddle.seed(3)
    cfg = jax_tiny()
    jm = JaxLlama(cfg)
    tm = tl.LlamaForCausalLM(tl.llama_tiny(), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v._value)
                             for k, v in jm.state_dict().items()})
    x, y = _batch(cfg.vocab_size, 2, 16)
    y = y.copy()
    y[0, :5] = -100
    mask = (np.random.RandomState(1).rand(2, 16) > 0.3).astype(np.float32)
    with paddle.no_grad():
        jl = JaxCrit(cfg)(jm(paddle.to_tensor(x)), paddle.to_tensor(y),
                          paddle.to_tensor(mask))
    with torch.no_grad():
        tl_ = tl.LlamaPretrainingCriterion()(tm(torch.tensor(x)),
                                             torch.tensor(y),
                                             torch.tensor(mask))
    np.testing.assert_allclose(float(tl_), float(jl), rtol=LOSS_RTOL)


class TestEnginePolicy:
    def test_cuda_less_engine_over_default_device_model_raises(
            self, monkeypatch):
        """A model built with device=None is on CUDA; without a card the
        chain raises, naming the CPU option, before any step runs."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model = tl.LlamaForCausalLM(tl.llama_tiny())
            ParallelEngine(model, AdamW(parameters=model.parameters()))

    @pytest.mark.parametrize("knob", ["comm_overlap", "offload",
                                      "quant_comm", "mem_ledger",
                                      "sharding_stage"])
    def test_degree_above_one_raises(self, knob):
        model = tl.LlamaForCausalLM(tl.llama_tiny(), device="cpu")
        opt = AdamW(parameters=model.parameters())
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ParallelEngine(model, opt, **{knob: 3 if knob ==
                                          "sharding_stage" else True})

    def test_mesh_and_scaler_raise(self):
        class Mesh:
            size = 8

        model = tl.LlamaForCausalLM(tl.llama_tiny(), device="cpu")
        opt = AdamW(parameters=model.parameters())
        with pytest.raises(NotImplementedError, match="item 8"):
            ParallelEngine(model, opt, Mesh())
        # the scaler is ported; what still raises is a scaler that is
        # not an amp.GradScaler
        with pytest.raises(TypeError, match="GradScaler"):
            ParallelEngine(model, opt).train_step(lambda m, b: 0,
                                                  scaler=object())


class TestOptimizer:
    def test_state_dict_names_and_master_weights(self):
        model = tl.LlamaForCausalLM(tl.llama_tiny(dtype="bfloat16"),
                                    device="cpu")
        opt = AdamW(parameters=model.named_parameters(),
                    multi_precision=True)
        ids = torch.randint(0, 256, (1, 8))
        tl.LlamaPretrainingCriterion()(model(ids), ids).backward()
        opt.step()
        sd = opt.state_dict()
        assert sd["step_count"] == 1
        name = "llama.layers.0.mlp.up_proj.weight"
        assert sd[f"{name}.moment1"].dtype == torch.float32
        master = sd[f"{name}.master_weight"]
        assert master.dtype == torch.float32
        p = dict(model.named_parameters())[name]
        assert torch.equal(master.to(torch.bfloat16), p.detach())

    def test_state_dtype_and_decay_exemption(self):
        """bf16 moments with f32 math; apply_decay_param_fun exempts the
        norms from decay (with grads of 0 a decayed weight moves)."""
        model = tl.LlamaForCausalLM(tl.llama_tiny(), device="cpu")
        opt = AdamW(learning_rate=0.1, weight_decay=0.5,
                    parameters=model.named_parameters(),
                    state_dtype="bfloat16",
                    apply_decay_param_fun=lambda n: "norm" not in n)
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        before = {n: p.detach().clone()
                  for n, p in model.named_parameters()}
        opt.step()
        for n, p in model.named_parameters():
            moved = not torch.equal(p.detach(), before[n])
            assert moved == ("norm" not in n), n
        assert opt.state_dict()[
            "llama.norm.weight.moment1"].dtype == torch.bfloat16

    def test_unported_options_raise(self):
        model = tl.LlamaForCausalLM(tl.llama_tiny(), device="cpu")
        # LR schedulers are ported; a callable that is not an
        # LRScheduler still raises
        with pytest.raises(TypeError, match="LRScheduler"):
            AdamW(learning_rate=lambda: 0.1, parameters=model.parameters())
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            AdamW(parameters=model.parameters(), lazy_mode=True)

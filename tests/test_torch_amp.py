"""The port's AMP against the JAX package's on the CPU.

- The four schedules of tests/test_amp_engine.py through the port's
  ``ParallelEngine.train_step(scaler=...)``, each beside the JAX engine at
  degree 1 on the same weights and batches: a clean scaled run equals an
  unscaled one (rtol 2e-5) and the JAX losses; an injected inf leaves
  parameters and moments bit-unchanged, decays the scale and sets
  ``last_found_inf``; the scale grows after n good steps; the eager
  ``GradScaler`` finds the overflow and skips the step.
- ``auto_cast`` (O1) on ``llama_tiny``: the dtypes that come out (hidden
  states, logits, loss) are the JAX package's and the loss is within
  2e-2.
- ``decorate`` (O2) plus a ``GradScaler``: 5 engine steps of the MLP
  within 2e-2 of the JAX engine's, with f32 master weights.
- ``llama_tiny`` training under O1, and under O2 with a scaler: the JAX
  package's backward raises under ``auto_cast`` there, so the port's 5
  steps are held against its own f32 steps (2e-2).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet
from paddle_tpu.distributed.engine import ParallelEngine as JaxEngine
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCrit
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.distributed.engine import ParallelEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.nn import functional as TF

NAMES = ["fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"]


def _init_degree_1():
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1}
    return fleet.init(is_collective=True, strategy=strategy)


def _jax_mlp(seed):
    class MLP(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = paddle.nn.Linear(8, 16)
            self.fc2 = paddle.nn.Linear(16, 8)

        def forward(self, x):
            return self.fc2(paddle.nn.functional.relu(self.fc1(x)))

    paddle.seed(seed)
    return MLP()


class PortMLP(torch.nn.Module):
    def __init__(self, jm):
        super().__init__()
        state = jm.state_dict()
        self.p = torch.nn.ParameterList(
            [torch.nn.Parameter(torch.tensor(np.asarray(state[n]._value)))
             for n in NAMES])

    def forward(self, x):
        w1, b1, w2, b2 = self.p
        return TF.linear(torch.relu(TF.linear(x, w1, b1)), w2, b2)


def _jax_loss(model, batch):
    return paddle.mean((model(batch["x"]) - batch["y"]) ** 2)


def _port_loss(model, batch):
    return torch.mean((model(batch["x"]) - batch["y"]) ** 2)


def _pair(seed, opt_cls, lr, scaler_kw):
    """(JAX step, JAX model, JAX opt, JAX scaler) and the port's, on the
    same weights."""
    _init_degree_1()
    jm = _jax_mlp(seed)
    tm = PortMLP(jm)
    jopt = getattr(paddle.optimizer, opt_cls)(learning_rate=lr,
                                              parameters=jm.parameters())
    topt_ = getattr(topt, opt_cls)(learning_rate=lr,
                                   parameters=tm.parameters())
    js = paddle.amp.GradScaler(**scaler_kw) if scaler_kw is not None \
        else None
    ts = amp.GradScaler(**scaler_kw) if scaler_kw is not None else None
    jstep = JaxEngine(jm, jopt).train_step(_jax_loss, scaler=js)
    tstep = ParallelEngine(tm, topt_).train_step(_port_loss, scaler=ts)
    return (jstep, jm, jopt, js), (tstep, tm, topt_, ts)


def _batch(seed, rows):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, 8)).astype(np.float32),
            rng.standard_normal((rows, 8)).astype(np.float32))


def _run(step, x, y, jax_side):
    if jax_side:
        return float(step({"x": paddle.to_tensor(x),
                           "y": paddle.to_tensor(y)}))
    return float(step({"x": x, "y": y}))


def test_scaler_parity_on_clean_data():
    x, y = _batch(0, 4)
    losses = {}
    for use_scaler in (False, True):
        kw = {"init_loss_scaling": 2.0 ** 10} if use_scaler else None
        (jstep, *_), (tstep, *_) = _pair(7, "Adam", 0.05, kw)
        losses[("jax", use_scaler)] = [_run(jstep, x, y, True)
                                       for _ in range(4)]
        losses[("port", use_scaler)] = [_run(tstep, x, y, False)
                                        for _ in range(4)]
    np.testing.assert_allclose(losses[("port", False)],
                               losses[("port", True)], rtol=2e-5, atol=2e-6)
    for s in (False, True):
        np.testing.assert_allclose(losses[("port", s)], losses[("jax", s)],
                                   rtol=2e-5)


def test_scaler_skips_on_inf_and_decays_scale():
    (jstep, _, _, js), (tstep, tm, opt, ts) = _pair(
        11, "Adam", 0.05, {"init_loss_scaling": 2.0 ** 8,
                           "decr_every_n_nan_or_inf": 1})
    x, y = _batch(1, 4)
    bad_x = x.copy()
    bad_x[0, 0] = np.inf
    l0 = _run(tstep, x, y, False)
    assert not ts.last_found_inf
    before = [p.detach().clone() for p in tm.parameters()]
    moments = [{k: v.clone() for k, v in opt._states[id(p)].items()}
               for p in tm.parameters()]
    _run(tstep, bad_x, y, False)
    assert ts.last_found_inf
    for p, b in zip(tm.parameters(), before):
        assert torch.equal(p.detach(), b)
    for p, st in zip(tm.parameters(), moments):
        for k, v in st.items():
            assert torch.equal(opt._states[id(p)][k], v), k
    assert ts.get_loss_scaling() == pytest.approx(2.0 ** 7)
    l2 = _run(tstep, x, y, False)
    assert not ts.last_found_inf
    assert np.isfinite(l2) and l2 < l0
    for p, b in zip(tm.parameters(), before):
        assert not torch.equal(p.detach(), b)
    # the JAX engine on the same schedule
    ref = [_run(jstep, a, y, True) for a in (x, bad_x, x)]
    np.testing.assert_allclose([l0, l2], [ref[0], ref[2]], rtol=2e-5)
    assert js.last_found_inf is False
    assert js.get_loss_scaling() == ts.get_loss_scaling()
    assert js.state_dict() == ts.state_dict()


def test_scaler_growth_after_n_good_steps():
    (jstep, _, _, js), (tstep, _, _, ts) = _pair(
        5, "SGD", 0.01, {"init_loss_scaling": 64.0, "incr_every_n_steps": 3})
    x, y = _batch(2, 2)
    mine = [_run(tstep, x, y, False) for _ in range(3)]
    ref = [_run(jstep, x, y, True) for _ in range(3)]
    np.testing.assert_allclose(mine, ref, rtol=2e-5)
    assert ts.get_loss_scaling() == pytest.approx(128.0)
    assert ts.state_dict()["good_steps"] == 0
    assert ts.state_dict() == js.state_dict()


def test_eager_scaler_found_inf_still_works():
    jm = _jax_mlp(3)
    tm = PortMLP(jm)
    opt = topt.SGD(learning_rate=0.1, parameters=tm.parameters())
    scaler = amp.GradScaler(init_loss_scaling=8.0, decr_every_n_nan_or_inf=1)
    x = torch.full((2, 8), float("inf"))
    loss = torch.mean((tm(x) - torch.zeros(2, 8)) ** 2)
    scaler.scale(loss).backward()
    w0 = tm.p[0].detach().clone()
    scaler.step(opt)
    assert torch.equal(tm.p[0].detach(), w0)
    assert scaler.get_loss_scaling() == pytest.approx(4.0)


class TestAutoCast:
    def test_cast_inputs_follows_the_lists(self):
        a = torch.ones(2, 2)
        assert amp.cast_inputs("linear", a)[0].dtype == torch.float32
        with amp.auto_cast():
            assert amp.cast_inputs("linear", a)[0].dtype == torch.bfloat16
            # black-listed and unlisted ops are left alone
            assert amp.cast_inputs("softmax_with_cross_entropy",
                                   a)[0].dtype == torch.float32
            assert amp.cast_inputs("flash_attn_varlen",
                                   a)[0].dtype == torch.float32
        with amp.auto_cast(custom_white_list=["flash_attn_varlen"],
                           custom_black_list=["linear"], dtype="float16"):
            assert amp.cast_inputs("flash_attn_varlen",
                                   a)[0].dtype == torch.float16
            assert amp.cast_inputs("linear", a)[0].dtype == torch.float32
        assert not amp.enabled()
        assert amp.white_list() == paddle.amp.white_list()
        assert amp.black_list() == paddle.amp.black_list()

    def test_device_support_queries(self):
        assert amp.is_bfloat16_supported("cpu")
        assert amp.is_float16_supported("cpu")

    @pytest.mark.parametrize("tied", [False, True])
    def test_o1_llama_tiny_matches_jax(self, tied):
        paddle.seed(9)
        cfg = jax_tiny(tie_word_embeddings=tied)
        jm = JaxLlama(cfg)
        tm = tl.LlamaForCausalLM(tl.llama_tiny(tie_word_embeddings=tied),
                                 device="cpu")
        load_jax_state_dict(tm, {k: np.asarray(v._value)
                                 for k, v in jm.state_dict().items()})
        ids = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 17))
        x, y = ids[:, :-1], ids[:, 1:]
        with paddle.no_grad(), paddle.amp.auto_cast():
            jh = jm.llama(paddle.to_tensor(x))
            jl = jm(paddle.to_tensor(x))
            jloss = JaxCrit(cfg)(jl, paddle.to_tensor(y))
        with torch.no_grad(), amp.auto_cast():
            th = tm.llama(torch.tensor(x))
            tlg = tm(torch.tensor(x))
            tloss = tl.LlamaPretrainingCriterion()(tlg, torch.tensor(y))
        for j, t in ((jh, th), (jl, tlg), (jloss, tloss)):
            assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        assert str(tlg.dtype) == "torch.bfloat16"
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)


def test_o2_decorate_with_scaler_matches_jax():
    """The MLP decorated to bf16 trains 5 engine steps under a scaler and
    ``auto_cast(level="O2")`` on both sides."""
    _init_degree_1()
    jm = _jax_mlp(12)
    tm = PortMLP(jm)
    x, y = _batch(5, 4)
    jopt = paddle.optimizer.AdamW(learning_rate=0.02, weight_decay=0.01,
                                  parameters=jm.parameters())
    jm, jopt = paddle.amp.decorate(jm, jopt, level="O2")

    def jloss(m, b):
        with paddle.amp.auto_cast(level="O2"):
            return _jax_loss(m, b)

    jstep = JaxEngine(jm, jopt).train_step(
        jloss, scaler=paddle.amp.GradScaler(init_loss_scaling=2.0 ** 10))
    ref = [_run(jstep, x, y, True) for _ in range(5)]

    opt = topt.AdamW(learning_rate=0.02, weight_decay=0.01,
                     parameters=tm.parameters())
    tm, opt = amp.decorate(tm, opt, level="O2")

    def tloss(m, b):
        with amp.auto_cast(level="O2"):
            return _port_loss(m, b)

    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10)
    step = ParallelEngine(tm, opt).train_step(tloss, scaler=scaler)
    mine = [_run(step, x, y, False) for _ in range(5)]
    np.testing.assert_allclose(mine, ref, rtol=2e-2)
    assert mine[-1] < mine[0] and not scaler.last_found_inf
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    sd = opt.state_dict()
    assert all(sd[f"param_{i}.master_weight"].dtype == torch.float32
               for i in range(len(NAMES)))


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_llama_tiny_trains_under_amp(level):
    """The JAX package cannot train Llama under ``auto_cast``: its hook's
    casts leave bf16 gradients for f32 values and the backward raises
    (ROADMAP.md queue 3). The port's casts are autograd ops, so it
    trains; 5 steps (O2: decorated, f32 masters, a scaler) stay within
    2e-2 of the same steps in f32, and the rope tables stay f32."""
    paddle.seed(12)
    state = {k: np.asarray(v._value)
             for k, v in JaxLlama(jax_tiny()).state_dict().items()}
    ids = np.random.RandomState(4).randint(0, 256, (2, 33))
    batch = {"x": ids[:, :-1], "y": ids[:, 1:]}
    crit = tl.LlamaPretrainingCriterion()
    runs = {}
    for mode in ("f32", level):
        tm = tl.LlamaForCausalLM(tl.llama_tiny(), device="cpu")
        load_jax_state_dict(tm, state)
        opt = topt.AdamW(learning_rate=3e-3, weight_decay=0.01,
                         parameters=tm.named_parameters())
        scaler = None
        if mode == "O2":
            tm, opt = amp.decorate(tm, opt, level="O2")
            scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10)

        def loss_fn(m, b, on=mode != "f32"):
            with amp.auto_cast(enable=on, level=level):
                return crit(m(b["x"]), b["y"])

        step = ParallelEngine(tm, opt).train_step(loss_fn, scaler=scaler)
        runs[mode] = [float(step(batch)) for _ in range(5)]
        if mode == "O2":
            assert all(m.dtype == torch.float32
                       for m in opt._master_weights.values())
            assert tm.llama.layers[0].self_attn.rope_cos.dtype == \
                torch.float32
    np.testing.assert_allclose(runs[level], runs["f32"], rtol=2e-2)
    assert runs[level][-1] < runs[level][0]

"""The port's activation recomputation (``fleet.recompute``,
``fleet.utils.recompute_sequential``) against the JAX package and against
its own plain runs, on the CPU.

- The JAX tests' cases from the JAX weights: ``recompute(model, x)`` and
  ``recompute(lambda h: model(h), x)`` give the JAX recompute's loss and
  every parameter gradient (1e-6 / 1e-5, the JAX test's); inside the
  engine at dp 2 (gloo processes) the losses and parameters equal the
  JAX engine's recompute run (1e-5); a masked mean over the dp split
  inside the recomputed block equals its plain run (1e-6).
- ``recompute_sequential`` in segments equals the JAX one and the plain
  stack.
- Randomness: a ``gpt_tiny`` decoder layer with hidden and attention
  dropout 0.1 under ``recompute`` gives the plain layer's loss and
  gradients bit for bit, and leaves every generator (the model's hidden
  and attention generators, the default ones) where the plain step
  leaves it; replayed with ``preserve_rng_state=False`` its gradients
  differ (the replay draws other masks), so the check can fail.
- AMP: a block run under ``amp.auto_cast`` (O1) and differentiated
  outside it replays its forward's casts: bit-equal to the plain run.
"""
import os
import sys

import numpy as np
import pytest
import torch
from torch import nn

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet
from paddle_tpu.distributed.engine import ParallelEngine
from paddle_tpu.distributed.fleet import recompute as jrecompute
from paddle_tpu.distributed.fleet.utils.recompute import \
    recompute_sequential as jrecompute_sequential
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.distributed.engine import _model_generators
from paddle_tpu_torch.distributed.fleet import recompute
from paddle_tpu_torch.distributed.fleet.utils import recompute_sequential
from paddle_tpu_torch.models import gpt as tg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "workers"))
from torch_dist_worker import run_world  # noqa: E402


def _np(t):
    return np.asarray(t._value)


class _JMLP(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = paddle.nn.Linear(16, 32)
        self.fc2 = paddle.nn.Linear(32, 16)

    def forward(self, x):
        return self.fc2(paddle.nn.functional.relu(self.fc1(x)))


class _MLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(16, 32)
        self.fc2 = nn.Linear(32, 16)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _port(state):
    m = _MLP()
    load_jax_state_dict(m, state)
    return m


def _jax_grads(model, x, closure):
    xin = paddle.to_tensor(x)
    out = jrecompute((lambda h: model(h)) if closure else model, xin)
    loss = paddle.mean(out ** 2)
    loss.backward()
    return float(loss), {n: _np(p.grad) for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def ref():
    fleet._fleet_state.update(initialized=False, hcg=None, strategy=None)
    paddle.seed(9)
    m = _JMLP()
    state = {k: _np(v) for k, v in m.state_dict().items()}
    x = np.random.RandomState(2).randn(4, 16).astype("float32")
    out = {"state": state, "x": x, "plain": _jax_grads(m, x, False)}
    m2 = _JMLP()
    m2.set_state_dict(state)
    out["closure"] = _jax_grads(m2, x, True)
    # recompute_sequential over four layers in two segments
    seq = paddle.nn.Sequential(paddle.nn.Linear(16, 32), paddle.nn.ReLU(),
                               paddle.nn.Linear(32, 16), paddle.nn.Tanh())
    out["seq_state"] = {k: _np(v) for k, v in seq.state_dict().items()}
    y = jrecompute_sequential({"segments": 2}, seq, paddle.to_tensor(x))
    loss = paddle.mean(y ** 2)
    loss.backward()
    out["seq"] = (float(loss), {n: _np(p.grad)
                                for n, p in seq.named_parameters()})
    # inside the engine at dp 2 (tests/test_sharding_sp.py)
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 1, "pp_degree": 1}
    mesh = fleet.init(is_collective=True, strategy=s).mesh

    class RematMLP(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.block = _JMLP()

        def forward(self, xx):
            return jrecompute(self.block, xx)

    rm = RematMLP()
    rm.block.set_state_dict(state)
    np.random.seed(0)
    xe = np.random.randn(8, 16).astype("float32")
    ye = np.random.randn(8, 16).astype("float32")
    step = ParallelEngine(rm, paddle.optimizer.Adam(
        learning_rate=0.1, parameters=rm.parameters()), mesh).train_step(
        lambda mm, b: paddle.mean((mm(b["x"]) - b["y"]) ** 2))
    b = {"x": paddle.to_tensor(xe), "y": paddle.to_tensor(ye)}
    out["engine"] = ([float(step(b)) for _ in range(2)],
                     {k: _np(v) for k, v in rm.block.state_dict().items()})
    out["engine_batch"] = (xe, ye)
    fleet._fleet_state.update(initialized=False, hcg=None, strategy=None)
    return out


@pytest.mark.parametrize("closure", [False, True])
def test_recompute_matches_the_jax_recompute(ref, closure):
    loss_j, grads_j = ref["closure" if closure else "plain"]
    m = _port(ref["state"])
    x = torch.tensor(ref["x"])
    out = recompute((lambda h: m(h)) if closure else m, x)
    loss = torch.mean(out ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-6)
    for n, p in m.named_parameters():
        assert p.grad is not None, n
        g = p.grad.numpy()
        want = grads_j[n].T if n.endswith("weight") else grads_j[n]
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def test_recompute_sequential_in_segments(ref):
    seq = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 16),
                        nn.Tanh())
    load_jax_state_dict(seq, ref["seq_state"])
    plain = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 16),
                          nn.Tanh())
    plain.load_state_dict(seq.state_dict())
    x = torch.tensor(ref["x"])
    losses = []
    for model, rc in ((seq, True), (plain, False)):
        y = recompute_sequential({"segments": 2}, model, x) if rc \
            else model(x)
        loss = torch.mean(y ** 2)
        loss.backward()
        losses.append(float(loss.detach()))
    loss_j, grads_j = ref["seq"]
    np.testing.assert_allclose(losses[0], loss_j, rtol=1e-6)
    assert losses[0] == losses[1]
    for (n, p), (_, q) in zip(seq.named_parameters(),
                              plain.named_parameters()):
        assert torch.equal(p.grad, q.grad), n
        want = grads_j[n].T if n.endswith("weight") else grads_j[n]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-5,
                                   atol=1e-6, err_msg=n)


@pytest.fixture(scope="module")
def engine_world(ref, tmp_path_factory):
    xe, ye = ref["engine_batch"]
    return run_world(2, "recompute", tmp_path_factory.mktemp("recompute"),
                     x=xe.tolist(), y=ye.tolist(),
                     state={k: v.tolist() for k, v in ref["state"].items()})


def test_recompute_inside_the_engine_at_dp_2(ref, engine_world):
    losses_j, final_j = ref["engine"]
    for got in engine_world:
        np.testing.assert_allclose(got["losses"], losses_j, rtol=1e-5)
        for k, v in final_j.items():
            np.testing.assert_allclose(got["final"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_masked_loss_under_recompute_at_dp_2(engine_world):
    """A masked mean across the dp split, computed inside the recomputed
    block: the replay re-enters the forward's SPMD region (the engine's
    backward runs after it closed), so it takes the global denominator
    as its forward did and the run equals the plain one."""
    for got in engine_world:
        plain, remat = got["masked_plain"], got["masked_recompute"]
        np.testing.assert_allclose(remat["losses"], plain["losses"],
                                   rtol=1e-6, atol=1e-7)
        for k, v in plain["final"].items():
            np.testing.assert_allclose(remat["final"][k], v, rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def _gpt_layer_step(mode):
    """One forward and backward of gpt_tiny's embeddings, two decoder
    layers (each plain or under recompute) and its head, dropout 0.1:
    (loss, gradients, every generator's state after)."""
    cfg = tg.gpt_tiny(hidden_dropout=0.1, attention_dropout=0.1)
    m = tg.GPTForCausalLM(cfg, device="cpu", seed=3)
    torch.manual_seed(11)
    x = torch.randint(0, 256, (2, 16),
                      generator=torch.Generator().manual_seed(0))
    h = m.gpt.embeddings(x)
    for layer in m.gpt.layers:
        if mode == "plain":
            h = layer(h)
        else:
            h = recompute(layer, h, preserve_rng_state=mode == "recompute")
    # a draw from the default generator between forward and backward
    loss = (m._logits(m.gpt.final_ln(h)) ** 2).mean() \
        + 0 * torch.rand(())
    loss.backward()
    gens = dict(_model_generators(m), default=torch.default_generator)
    return (loss.detach(), {n: p.grad for n, p in m.named_parameters()},
            {k: g.get_state() for k, g in gens.items()})


def test_dropout_layer_replays_the_forward_masks_bit_for_bit():
    loss_p, grads_p, gens_p = _gpt_layer_step("plain")
    loss_r, grads_r, gens_r = _gpt_layer_step("recompute")
    assert torch.equal(loss_p, loss_r)
    for n in grads_p:
        assert torch.equal(grads_p[n], grads_r[n]), n
    assert set(gens_p) == set(gens_r) and len(gens_p) == 3
    for k in gens_p:
        assert torch.equal(gens_p[k], gens_r[k]), k
    # without the forward's generator states the replay draws other masks
    _, grads_n, _ = _gpt_layer_step("no_rng")
    assert not all(torch.equal(grads_p[n], grads_n[n]) for n in grads_p)


def test_amp_o1_recompute_equals_the_plain_run():
    cfg = tg.gpt_tiny()
    results = []
    for rc, on in ((False, True), (True, True), (False, False)):
        m = tg.GPTForCausalLM(cfg, device="cpu", seed=5)
        x = torch.randint(0, 256, (2, 16),
                          generator=torch.Generator().manual_seed(1))
        with amp.auto_cast(enable=on, level="O1", dtype="bfloat16"):
            h = m.gpt.embeddings(x)
            for layer in m.gpt.layers:
                h = recompute(layer, h) if rc else layer(h)
            loss = (m._logits(m.gpt.final_ln(h)).float() ** 2).mean()
        loss.backward()      # outside auto_cast: the replay restores it
        results.append((loss.detach(),
                        {n: p.grad for n, p in m.named_parameters()}))
    (lp, gp), (lr, gr), (lf, gf) = results
    assert torch.equal(lp, lr)
    for n in gp:
        assert torch.equal(gp[n], gr[n]), n
    # the casts act: the f32 run's gradients are other numbers
    assert not all(torch.equal(gp[n], gf[n]) for n in gp)
    assert not amp.enabled()

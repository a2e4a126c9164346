"""The port's other optimizers and clips against the JAX package's on the CPU.

The 8 -> 16 -> 8 MLP of tests/test_amp_engine.py (biases, relu, mean
squared error) is built by the JAX package, its weights carried to a
port module of the same layout, and both train 5 eager steps
(``loss.backward(); opt.step(); opt.clear_grad()``) on one seeded batch.
Losses and final parameters must agree within 1e-5, and the optimizer
state must carry the JAX package's slot names.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import regularizer as jreg
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.nn import functional as TF

STEPS = 5
NAMES = ["fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"]

# name -> (optimizer class name, kwargs given the regularizer module,
# clip or None given the clip module)
CASES = {
    "SGD": ("SGD", lambda r: dict(learning_rate=0.1,
                                  weight_decay=r.L1Decay(0.01)), None),
    "Momentum": ("Momentum", lambda r: dict(
        learning_rate=0.05, momentum=0.8, use_nesterov=True,
        weight_decay=0.01), None),
    "Adagrad": ("Adagrad", lambda r: dict(
        learning_rate=0.1, weight_decay=r.L2Decay(1e-3),
        initial_accumulator_value=0.1), None),
    "RMSProp": ("RMSProp", lambda r: dict(
        learning_rate=0.01, rho=0.9, momentum=0.5, centered=True), None),
    "Adadelta": ("Adadelta", lambda r: dict(learning_rate=1.0, rho=0.9,
                                            weight_decay=1e-3), None),
    "Adamax": ("Adamax", lambda r: dict(learning_rate=0.05,
                                        weight_decay=1e-3), None),
    "ASGD": ("ASGD", lambda r: dict(learning_rate=0.1, batch_num=3), None),
    "Rprop": ("Rprop", lambda r: dict(learning_rate=0.01,
                                      learning_rate_range=(1e-4, 0.05),
                                      etas=(0.5, 1.2)), None),
    "Lamb": ("Lamb", lambda r: dict(learning_rate=0.05,
                                    lamb_weight_decay=0.01), None),
    "LarsMomentum": ("LarsMomentum", lambda r: dict(
        learning_rate=0.5, momentum=0.9, lars_coeff=0.01,
        exclude_from_weight_decay=["bias"]), None),
    "ClipGradByNorm+AdamW": ("AdamW", lambda r: dict(learning_rate=0.02),
                             lambda c: c.ClipGradByNorm(0.05)),
    "ClipGradByValue+Momentum": ("Momentum", lambda r: dict(
        learning_rate=0.1), lambda c: c.ClipGradByValue(0.02)),
}


class PortMLP(torch.nn.Module):
    """The JAX MLP's layout: weights [in, out], Paddle's linear."""

    def __init__(self, state):
        super().__init__()
        self.p = torch.nn.ParameterList(
            [torch.nn.Parameter(torch.tensor(state[n])) for n in NAMES])

    def named(self):
        return list(zip(NAMES, self.p))

    def forward(self, x):
        w1, b1, w2, b2 = self.p
        return TF.linear(torch.relu(TF.linear(x, w1, b1)), w2, b2)


def _jax_mlp():
    class MLP(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = paddle.nn.Linear(8, 16)
            self.fc2 = paddle.nn.Linear(16, 8)

        def forward(self, x):
            return self.fc2(paddle.nn.functional.relu(self.fc1(x)))

    return MLP()


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_steps_match_jax(case):
    cls, kw, clip = CASES[case]
    paddle.seed(6)
    jm = _jax_mlp()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    for n, p in zip(NAMES, jm.parameters()):
        p.name = n            # LarsMomentum matches names; state_dict keys
    rng = np.random.RandomState(2)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    y = rng.standard_normal((4, 8)).astype(np.float32)

    jopt = getattr(paddle.optimizer, cls)(
        parameters=jm.parameters(),
        grad_clip=clip(paddle.nn) if clip else None, **kw(jreg))
    ref = []
    for _ in range(STEPS):
        loss = paddle.mean((jm(paddle.to_tensor(x)) - paddle.to_tensor(y))
                           ** 2)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        ref.append(float(loss))

    tm = PortMLP(state)
    opt = getattr(topt, cls)(parameters=tm.named(),
                             grad_clip=clip(tclip) if clip else None,
                             **kw(treg))
    xt, yt = torch.tensor(x), torch.tensor(y)
    mine = []
    for _ in range(STEPS):
        loss = torch.mean((tm(xt) - yt) ** 2)
        loss.backward()
        opt.step()
        opt.clear_grad()
        mine.append(float(loss.detach()))
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=0)
    assert mine[-1] != mine[0]
    final = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    for n, p in tm.named():
        np.testing.assert_allclose(p.detach().numpy(), final[n], rtol=0,
                                   atol=1e-5, err_msg=n)
    assert set(opt.state_dict()) == set(jopt.state_dict())

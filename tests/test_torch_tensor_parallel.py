"""The port's tensor-parallel layers at mp 2 and mp 4 (gloo processes on
the CPU) against the JAX package: the three cases of
``tests/test_tensor_parallel.py``, forward and backward.

1. A ColumnParallelLinear -> ReLU -> RowParallelLinear MLP built from the
   JAX model's weights (``convert.load_jax_state_dict`` slices them per
   rank): the loss, the input gradient and every parameter gradient
   (gathered) against the unsharded JAX model, then one SGD step through
   ``ParallelEngine`` against the JAX engine at the same mp degree and
   the unsharded step (the JAX test's 1e-5 / 2e-5 tolerances).
2. VocabParallelEmbedding: the output and the weight gradient under a
   cotangent against the JAX embedding, and the output against the JAX
   engine's ``eval_step`` at the same mp degree.
3. parallel_cross_entropy over ``_c_split`` logits: the loss and the
   logits' gradient against the JAX cross entropy (and the loss against
   the JAX mp path).
"""
import os
import sys

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet
from paddle_tpu.distributed.engine import ParallelEngine
from paddle_tpu.distributed.fleet.layers import mpu

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "workers"))
from torch_dist_worker import run_world  # noqa: E402

DEGREES = (2, 4)


class _MLP(paddle.nn.Layer):
    def __init__(self, parallel):
        super().__init__()
        if parallel:
            self.fc1 = mpu.ColumnParallelLinear(16, 32, gather_output=False)
            self.fc2 = mpu.RowParallelLinear(32, 16, input_is_parallel=True)
        else:
            self.fc1 = paddle.nn.Linear(16, 32)
            self.fc2 = paddle.nn.Linear(32, 16)

    def forward(self, x):
        return self.fc2(paddle.nn.functional.relu(self.fc1(x)))


def _np(t):
    return np.asarray(t._value)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's side: the unsharded models, their losses and
    gradients, and its engine at dp 1 x mp n."""
    fleet._fleet_state.update(initialized=False, hcg=None, strategy=None)
    paddle.seed(7)
    golden = _MLP(False)
    state = {k: _np(v) for k, v in golden.state_dict().items()}
    r = np.random.RandomState(0)
    x = r.randn(8, 16).astype("float32")
    y = r.randn(8, 16).astype("float32")
    xt = paddle.to_tensor(x, stop_gradient=False)
    loss = paddle.mean((golden(xt) - paddle.to_tensor(y)) ** 2)
    loss.backward()
    out = dict(state=state, x=x, y=y, loss=float(loss),
               input_grad=_np(xt.grad),
               grads={n: _np(p.grad) for n, p in golden.named_parameters()})
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=golden.parameters())
    opt.step()
    out["after"] = {k: _np(v) for k, v in golden.state_dict().items()}

    paddle.seed(11)
    emb = paddle.nn.Embedding(64, 16)
    out["emb"] = _np(emb.weight)
    out["ids"] = np.random.RandomState(1).randint(0, 64, (8, 5))
    out["emb_cot"] = np.random.RandomState(4).randn(8, 5, 16).astype(
        "float32")
    e = emb(paddle.to_tensor(out["ids"]))
    (e * paddle.to_tensor(out["emb_cot"])).sum().backward()
    out["emb_out"], out["emb_grad"] = _np(e), _np(emb.weight.grad)

    out["logits"] = np.random.RandomState(2).randn(8, 32).astype("float32")
    out["labels"] = np.random.RandomState(3).randint(0, 32, (8,))
    out["ce_cot"] = np.random.RandomState(5).randn(8).astype("float32")
    lt = paddle.to_tensor(out["logits"], stop_gradient=False)
    ce = paddle.nn.functional.cross_entropy(
        lt, paddle.to_tensor(out["labels"]), reduction="none")
    (ce.reshape([8]) * paddle.to_tensor(out["ce_cot"])).sum().backward()
    out["ce"], out["ce_grad"] = _np(ce).reshape(8), _np(lt.grad)

    out["engine"] = {}
    for n in DEGREES:
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": 1, "mp_degree": n, "pp_degree": 1}
        hcg = fleet.init(is_collective=True, strategy=s)
        model = _MLP(True)
        model.set_state_dict(state)
        opt = paddle.optimizer.SGD(learning_rate=0.1,
                                   parameters=model.parameters())
        step = ParallelEngine(model, opt, hcg.mesh).train_step(
            lambda m, b: paddle.mean((m(b["x"]) - b["y"]) ** 2))
        loss_d = float(step({"x": paddle.to_tensor(x),
                             "y": paddle.to_tensor(y)}))
        after = {k: _np(v) for k, v in model.state_dict().items()}

        class E(paddle.nn.Layer):
            def __init__(self):
                super().__init__()
                self.emb = mpu.VocabParallelEmbedding(64, 16)

            def forward(self, ids):
                return self.emb(ids)

        em = E()
        em.set_state_dict({"emb.weight": out["emb"]})
        eng = ParallelEngine(em, paddle.optimizer.SGD(
            parameters=em.parameters()), hcg.mesh)
        emb_out = _np(eng.eval_step(lambda m, b: m(b["ids"]))(
            {"ids": paddle.to_tensor(out["ids"])}))

        class CE(paddle.nn.Layer):
            def __init__(self):
                super().__init__()
                self.w = self.create_parameter((1,))

            def forward(self, logits, labels):
                from paddle_tpu.distributed.fleet.layers.mpu import mp_ops

                return mpu.parallel_cross_entropy(mp_ops._c_split(logits),
                                                  labels)

        cm = CE()
        eng = ParallelEngine(cm, paddle.optimizer.SGD(
            parameters=cm.parameters()), hcg.mesh)
        ce_mp = _np(eng.eval_step(lambda m, b: m(b["logits"], b["labels"]))(
            {"logits": paddle.to_tensor(out["logits"]),
             "labels": paddle.to_tensor(out["labels"])})).reshape(8)
        out["engine"][n] = dict(loss=loss_d, after=after, emb_out=emb_out,
                                ce=ce_mp)
    fleet._fleet_state.update(initialized=False, hcg=None, strategy=None)
    return out


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    keys = ("x", "y", "emb", "ids", "emb_cot", "logits", "labels", "ce_cot")
    params = {k: ref[k].tolist() for k in keys}
    params["mlp_state"] = {k: v.tolist() for k, v in ref["state"].items()}
    return {n: run_world(n, "tensor_parallel",
                         tmp_path_factory.mktemp(f"mp{n}"), **params)
            for n in DEGREES}


@pytest.mark.parametrize("n", DEGREES)
def test_column_row_parallel_forward_backward_parity(ref, ranks, n):
    eng = ref["engine"][n]
    for res in ranks[n]:
        np.testing.assert_allclose(res["mlp_loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(res["mlp_input_grad"], ref["input_grad"],
                                   rtol=1e-5, atol=1e-6)
        for k, g in ref["grads"].items():
            np.testing.assert_allclose(res["mlp_grads"][k], g, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(res["mlp_step_loss"], eng["loss"],
                                   rtol=1e-5)
        for k in ref["after"]:
            np.testing.assert_allclose(res["mlp_after"][k], eng["after"][k],
                                       rtol=2e-5, atol=2e-6, err_msg=k)
            np.testing.assert_allclose(res["mlp_after"][k], ref["after"][k],
                                       rtol=2e-5, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("n", DEGREES)
def test_vocab_parallel_embedding_parity(ref, ranks, n):
    for res in ranks[n]:
        np.testing.assert_allclose(res["emb_out"], ref["emb_out"], rtol=1e-5)
        np.testing.assert_allclose(res["emb_out"], ref["engine"][n]["emb_out"],
                                   rtol=1e-5)
        np.testing.assert_allclose(res["emb_grad"], ref["emb_grad"],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", DEGREES)
def test_parallel_cross_entropy_parity(ref, ranks, n):
    for res in ranks[n]:
        got = res["ce"].reshape(8)
        np.testing.assert_allclose(got, ref["ce"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, ref["engine"][n]["ce"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res["ce_grad"], ref["ce_grad"], rtol=1e-5,
                                   atol=1e-6)
    assert [r["mp_rank"] for r in ranks[n]] == list(range(n))

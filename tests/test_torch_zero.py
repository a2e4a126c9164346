"""The port's ZeRO (``engine._ZeroPlan``, ``grad_buckets``, ``sharding``,
``DygraphShardingOptimizer``) against the JAX package, on gloo processes
on the CPU: the flat MLP of tests/test_zero_stage3.py (16 -> 32 -> 16,
Adam lr 0.1, batch [8, 16], 3 steps) from the JAX model's weights.

- The plan's shard dims (in the JAX layout) equal the JAX ``_ZeroPlan``'s.
- At dp 2 x sharding 2 and at sharding 4, stages 1 (``os``), 2 (``os_g``)
  and 3 (``p_g_os`` with ``sharding_stage`` 3): losses within 2e-4
  (relative) of the JAX ``_flat_engine`` and parameters within 1e-5 of
  it; the port's stage 3 is bit-equal to its stage 2.
- Model-state bytes a rank: measured (``memledger.account_engine``) equal
  to the plan's closed form; stage 3's stored parameters at exactly 1/n
  of stage 2's; the sharding group's all-gather bytes at (n - 1) x the
  stored shard bytes, one gather a bucket (or a parameter with the
  release knob off).
- ``BucketPlan``: as many buckets as the JAX plan at each
  ``comm_buffer_size_MB`` of tests/test_grad_buckets.py, one digest on
  every rank, ``comm_overlap`` on bit-equal to off, the gauge.
- ``group_sharded_parallel`` at the three levels at dp 2 x sharding 4
  against plain Adam on the whole batch (tests/test_sharding_sp.py's
  tolerances), an eager ``fleet.distributed_optimizer`` loop over the
  sharding axis too, and ``save_group_sharded_model`` read back by the
  JAX ``paddle.load``.
"""
import os
import sys

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import fleet
from paddle_tpu.distributed.engine import ParallelEngine as JEngine

import paddle_tpu_torch.distributed as tdist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "workers"))
from torch_dist_worker import run_world  # noqa: E402

LOSS_RTOL = 2e-4
PARAM_ATOL = 1e-5
TOPOLOGIES = {"dp2sh2": (2, 2), "sh4": (1, 4)}
STAGES = {1: ("os", 2), 2: ("os_g", 2), 3: ("p_g_os", 3)}
BUFFERS = (0.0005, 1e-6, 1e3)


def _reset():
    fleet._fleet_state.update(initialized=False, hcg=None, strategy=None)


def _jmlp():
    class MLP(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = paddle.nn.Linear(16, 32)
            self.fc2 = paddle.nn.Linear(32, 16)

        def forward(self, x):
            return self.fc2(paddle.nn.functional.relu(self.fc1(x)))

    return MLP()


def _data():
    np.random.seed(0)
    x = np.random.randn(8, 16).astype("float32")
    y = np.random.randn(8, 16).astype("float32")
    return x, y


def _jax_flat(stage=2, level="os_g", dp=2, sh=4, overlap=True, mb=0.0005,
              steps=3):
    """The JAX tests/test_zero_stage3.py ``_flat_engine``: losses, final
    weights, the plan's dims and the bucket count."""
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {
        "dp_degree": dp, "sharding_degree": sh,
        "sharding_configs": {"comm_overlap": overlap,
                             "comm_buffer_size_MB": mb,
                             "sharding_stage": stage}}
    _reset()
    hcg = fleet.init(is_collective=True, strategy=strategy)
    paddle.seed(3)
    model = _jmlp()
    opt = paddle.optimizer.Adam(learning_rate=0.1,
                                parameters=model.parameters())
    if level:
        model, opt, _ = jdist.group_sharded_parallel(model, opt, level)
    eng = JEngine(model, opt, hcg.mesh)
    step = eng.train_step(
        lambda m, b: paddle.mean((m(b["x"]) - b["y"]) ** 2))
    x, y = _data()
    b = {"x": paddle.to_tensor(x), "y": paddle.to_tensor(y)}
    losses = [float(step(b)) for _ in range(steps)]
    final = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    plan = {n: eng._zero.entries[id(p)][0]
            for n, p in model.named_parameters()
            if eng._zero.entry(p) is not None}
    nb = eng._bucket_plan.num_buckets if eng._bucket_plan is not None else 0
    _reset()
    return {"losses": losses, "final": final, "plan": plan, "buckets": nb}


def _golden(state, steps=3):
    """Plain Adam on the whole batch in the JAX package (the
    tests/test_sharding_sp.py golden run)."""
    _reset()
    model = _jmlp()
    model.set_state_dict(state)
    opt = paddle.optimizer.Adam(learning_rate=0.1,
                                parameters=model.parameters())
    x, y = _data()
    losses = []
    for _ in range(steps):
        loss = paddle.mean((model(paddle.to_tensor(x))
                            - paddle.to_tensor(y)) ** 2)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return {"losses": losses, "final": {k: np.asarray(v._value) for k, v in
                                        model.state_dict().items()}}


@pytest.fixture(scope="module")
def ref():
    _reset()
    paddle.seed(3)
    state = {k: np.asarray(v._value) for k, v in _jmlp().state_dict().items()}
    out = {"state": state, "golden": _golden(state), "jax": {},
           "buckets": {}}
    for name, (dp, sh) in TOPOLOGIES.items():
        for st, (level, stage) in STAGES.items():
            out["jax"][(name, st)] = _jax_flat(stage, level, dp, sh)
    for mb in BUFFERS:
        out["buckets"][mb] = _jax_flat(2, "os_g", 2, 2, mb=mb,
                                       steps=1)["buckets"]
    return out


def _runs():
    runs = {}
    for st, (level, stage) in STAGES.items():
        runs[f"s{st}"] = {"level": level, "stage": stage, "steps": 3}
    runs["s2_off"] = {"level": "os_g", "stage": 2, "steps": 3,
                      "overlap": False}
    runs["s3_perparam"] = {"level": "p_g_os", "stage": 3, "steps": 3,
                           "release": False}
    for i, mb in enumerate(BUFFERS):
        runs[f"mb{i}"] = {"level": "os_g", "stage": 2, "steps": 1,
                          "buffer_mb": mb}
    return runs


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    x, y = _data()
    state = {k: v.tolist() for k, v in ref["state"].items()}
    out = {}
    for name, (dp, sh) in TOPOLOGIES.items():
        out[name] = run_world(dp * sh, "zero", tmp_path_factory.mktemp(name),
                              dp=dp, sh=sh, state=state, x=x.tolist(),
                              y=y.tolist(), runs=_runs())
    save_dir = str(tmp_path_factory.mktemp("saved"))
    levels = {lv: {"level": lv, "stage": 3 if lv == "p_g_os" else 2,
                   "steps": 3} for lv in ("os", "os_g", "p_g_os")}
    levels["eager"] = {"level": "os", "steps": 3, "eager": True}
    levels["eager_p_g_os"] = {"level": "p_g_os", "steps": 3, "eager": True}
    levels["p_g_os"]["save"] = True
    out["levels"] = run_world(8, "zero", tmp_path_factory.mktemp("levels"),
                              dp=2, sh=4, state=state, x=x.tolist(),
                              y=y.tolist(), runs=levels, save_dir=save_dir)
    out["save_dir"] = save_dir
    return out


def _close(final, want, atol=PARAM_ATOL, rtol=0.0):
    assert set(final) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(final[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_plan_dims_equal_the_jax_plan(ref, ranks, topology):
    for st in STAGES:
        want = ref["jax"][(topology, st)]["plan"]
        assert want
        for res in ranks[topology]:
            assert res[f"s{st}"]["plan"] == want


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
@pytest.mark.parametrize("st", sorted(STAGES))
def test_losses_and_params_match_the_jax_engine(ref, ranks, topology, st):
    jx = ref["jax"][(topology, st)]
    for res in ranks[topology]:
        got = res[f"s{st}"]
        np.testing.assert_allclose(got["losses"], jx["losses"],
                                   rtol=LOSS_RTOL)
        _close(got["final"], jx["final"])


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_stage3_bit_equal_to_stage2_and_overlap_off(ranks, topology):
    for res in ranks[topology]:
        s2 = res["s2"]
        for other in ("s3", "s2_off", "s3_perparam", "s1"):
            assert res[other]["losses"] == s2["losses"], other
            for k, v in s2["final"].items():
                np.testing.assert_array_equal(res[other]["final"][k], v,
                                              err_msg=f"{other} {k}")


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_state_bytes_at_one_over_n(ranks, topology):
    n = TOPOLOGIES[topology][1]
    for res in ranks[topology]:
        s2, s3 = res["s2"], res["s3"]
        for r in (s2, s3):
            assert r["measured"] == r["closed"]
        assert s3["stored"] and s2["stored"] == []
        # every MLP parameter is a plan entry: the params at 1/n
        assert s3["measured"]["params"] * n == s2["measured"]["params"]
        assert s3["measured"]["optimizer_state"] == \
            s2["measured"]["optimizer_state"]
        assert s2["measured"]["optimizer_state"] * n == \
            2 * 4 * (16 * 32 + 32 + 32 * 16 + 16)


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_stage3_gather_bytes_and_ops(ranks, topology):
    n = TOPOLOGIES[topology][1]
    for res in ranks[topology]:
        on, off = res["s3"], res["s3_perparam"]
        for r in (on, off):
            assert r["gather"][0] == (n - 1) * r["shard_bytes"]
        assert off["gather"][1] == len(on["stored"])
        assert on["gather"][1] == on["buckets"] < len(on["stored"])
        assert on["scatter"] == on["buckets"]


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_bucket_plan_against_the_jax_plan(ref, ranks, topology):
    for i, mb in enumerate(BUFFERS):
        digests = {res[f"mb{i}"]["digest"] for res in ranks[topology]}
        assert len(digests) == 1
        for res in ranks[topology]:
            assert res[f"mb{i}"]["buckets"] == ref["buckets"][mb]
            assert res[f"mb{i}"]["gauge"] == float(ref["buckets"][mb])
    res = ranks[topology][0]
    assert res["mb1"]["buckets"] > res["mb2"]["buckets"]
    assert res["s2_off"]["buckets"] == 0 and res["s2_off"]["gauge"] == 0.0


@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os", "eager",
                                   "eager_p_g_os"])
def test_group_sharded_levels_match_plain_adam(ref, ranks, level):
    gold = ref["golden"]
    for res in ranks["levels"]:
        got = res[level]
        if level.startswith("eager"):
            # the eager step's plan is the engine's at the same level
            engine = res["p_g_os" if level == "eager_p_g_os" else "os"]
            assert got["plan"] == engine["plan"]
            assert got["stored"] == engine["stored"]
        else:
            np.testing.assert_allclose(got["losses"], gold["losses"],
                                       rtol=1e-4, atol=1e-6)
        _close(got["final"], gold["final"], atol=1e-5, rtol=1e-4)


def test_saved_model_reads_back_in_the_jax_package(ranks):
    path = os.path.join(ranks["save_dir"], "model.pdmodel")
    got = paddle.load(path)
    final = ranks["levels"][0]["p_g_os"]["final"]
    assert set(got) == set(final)
    for k, v in final.items():
        np.testing.assert_array_equal(np.asarray(got[k]._value
                                                 if hasattr(got[k], "_value")
                                                 else got[k]), v)
    opt = paddle.load(os.path.join(ranks["save_dir"], "model.pdopt"))
    assert opt["step_count"] == 3
    shapes = {k: tuple(np.asarray(getattr(v, "_value", v)).shape)
              for k, v in opt.items() if k.endswith(".moment1")}
    # every moment whole (the port's [out, in] layout): gathered shards
    assert shapes == {"fc1.weight.moment1": (32, 16),
                      "fc1.bias.moment1": (32,),
                      "fc2.weight.moment1": (16, 32),
                      "fc2.bias.moment1": (16,)}


def test_levels_and_knobs_that_raise():
    class M(paddle.nn.Layer):
        pass

    with pytest.raises(ValueError) as theirs:
        jdist.group_sharded_parallel(M(), None, "zero9")
    import torch

    lin = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError) as mine:
        tdist.group_sharded_parallel(lin, None, "zero9")
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(NotImplementedError, match="item 9.1"):
        tdist.group_sharded_parallel(lin, None, "os", offload=True)
    from paddle_tpu_torch.distributed.engine import ParallelEngine

    with pytest.raises(NotImplementedError, match="item 9.1"):
        ParallelEngine(lin, None, None, offload=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        ParallelEngine(lin, None, None, quant_comm={"dtype": "int8"})

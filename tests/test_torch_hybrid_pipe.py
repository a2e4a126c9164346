"""The gpt13b smoke topology of tests/test_zero_stage3.py on the port:
``GPTForCausalLMPipe`` at mp 2 x pp 2 x sharding 2 with two virtual
stages (8 gloo processes on the CPU), ZeRO through
``fleet.distributed_optimizer`` and ``sharding_configs`` (comm_overlap,
a 0.001 MB bucket), 3 steps of AdamW (lr 1e-3) from the JAX pipeline's
weights, against the JAX ``_gpt_pipe(2)`` / ``_gpt_pipe(3)`` outputs.

- Losses within 2e-4 (relative) of the JAX runs and of the port's
  degree 1; parameters by ``tests/test_torch_gpt.py``'s gate.
- The port's stage 3 bit-equal to its stage 2, and stage 2 with
  ``comm_overlap`` off bit-equal to it on; the tied copies bit-equal.
- The ZeRO plan's dims equal the JAX plan's (its stacked rows skipped);
  model-state bytes: stage 3's plan entries at 1/2 of stage 2's.
- With clip 1.0, against the port's degree 1 only: the JAX engine clips
  by each rank's own norm (ROADMAP.md queue 3), the port by the norm of
  every element counted once over mp x pp x sharding and the tied pair;
  ``ClipGradByNorm`` at stage 3 by each tensor's norm over its shards.
- A loss scaler through the schedule: equal to the unscaled run.

The JAX run's ``mp_async_allreduce`` is a scheduling knob the port does
not take (ROADMAP.md queue 1, item 10); it changes no value.
"""
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet
from paddle_tpu.models import GPTForCausalLMPipe as JGPTPipe
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JCriterion

from paddle_tpu_torch.convert import export_jax_state_dict, load_jax_state_dict
from paddle_tpu_torch.distributed.engine import ParallelEngine
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm, ClipGradByNorm
from paddle_tpu_torch.optimizer import AdamW

from test_zero_stage3 import _gpt_pipe  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "workers"))
from torch_dist_worker import run_world  # noqa: E402

LOSS_RTOL = 2e-4
PARAM_TOL = 1e-4
TINY_GRAD = 1e-6
LR = 1e-3
CFG = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=4,
           max_position_embeddings=32)
VPP = 2
# a per-tensor clip that acts on most tensors of this model's gradients
CLIP_NORM = 0.05


def _reset():
    fleet._fleet_state.update(initialized=False, hcg=None, strategy=None)


def _flat(state):
    """[vpp, L / vpp, ...] stacked arrays as [L, ...]."""
    return {k: (v.reshape((-1,) + v.shape[2:]) if k.startswith("blocks__")
                else v) for k, v in state.items()}


def _batch():
    ids = np.random.RandomState(0).randint(0, 128, (8, 17))
    return ids[:, :-1], ids[:, 1:]


def _port_degree1(state, clip, kind=ClipGradByGlobalNorm):
    m = tg.GPTForCausalLMPipe(tg.GPTConfig(**CFG), num_stages=1,
                              device="cpu")
    load_jax_state_dict(m, _flat(state))
    crit = tg.GPTPretrainingCriterion()
    opt = AdamW(learning_rate=LR, parameters=m.named_parameters(),
                grad_clip=kind(clip) if clip else None)
    step = ParallelEngine(m, opt, None).train_step(
        lambda mm, b: crit(mm(b["x"]), b["y"]))
    b = {k: torch.tensor(a) for k, a in zip("xy", _batch())}
    return {"losses": [float(step(b)) for _ in range(3)],
            "final": export_jax_state_dict(m)}


@pytest.fixture(scope="module")
def ref():
    _, m0, _, _, _ = _gpt_pipe(2, steps=0)
    state = {k: np.asarray(v._value) for k, v in m0.state_dict().items()}
    out = {"state": state}
    for stage in (2, 3):
        dm, model, _, _, losses = _gpt_pipe(stage)
        eng = dm._engine
        names = {id(p): n for n, p in model.named_parameters()}
        out[stage] = {
            "losses": losses,
            "final": {k: np.asarray(v._value)
                      for k, v in model.state_dict().items()},
            "plan": {names[pid]: e[0] for pid, e in eng._zero.entries.items()
                     if pid in names}}
    _reset()
    # the first gradient at degree 1, for the parameter gate
    jm = JGPTPipe(JGPTConfig(**CFG), num_stages=1)
    jm.set_state_dict(_flat(state))
    x, y = _batch()
    JCriterion()(jm(paddle.to_tensor(x)), paddle.to_tensor(y)).backward()
    out["grad0"] = {n: np.asarray(p.grad._value).reshape(state[n].shape)
                    for n, p in jm.named_parameters()}
    out["port1"] = _port_degree1(state, None)
    out["port1_clip"] = _port_degree1(state, 1.0)
    out["port1_clip_norm"] = _port_degree1(state, CLIP_NORM, ClipGradByNorm)
    return out


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    x, y = _batch()
    hybrid = {"dp_degree": 1, "mp_degree": 2, "pp_degree": 2,
              "sharding_degree": 2,
              "pp_configs": {"num_virtual_pipeline_stages": VPP}}
    common = {"lr": LR, "steps": 3, "overlap": True, "buffer_mb": 0.001}
    runs = {"s2": dict(common, stage=2, eval=True),
            "s3": dict(common, stage=3),
            "s2_off": dict(common, stage=2, overlap=False),
            "clip": dict(common, stage=2, clip=1.0),
            "clip_norm": dict(common, stage=3, clip=CLIP_NORM,
                              clip_kind="norm"),
            "s2_amp": dict(common, stage=2, amp=True),
            "s3_amp": dict(common, stage=3, amp=True)}
    return run_world(
        8, "pipe", tmp_path_factory.mktemp("hybrid_pipe"), hybrid=hybrid,
        pipeline={"accumulate_steps": 2, "micro_batch_size": 2}, cfg=CFG,
        state={k: v.tolist() for k, v in ref["state"].items()},
        x=x.tolist(), y=y.tolist(), runs=runs, runs_first="s2")


def _gate(mine, final, grad0, lr):
    assert set(mine) == set(final)
    for k, want in final.items():
        got = np.asarray(mine[k]).reshape(want.shape)
        err = np.abs(got - want)
        tiny = np.abs(grad0[k].reshape(want.shape)) < TINY_GRAD
        assert err[~tiny].max(initial=0.0) <= PARAM_TOL, k
        assert err[tiny].max(initial=0.0) <= lr, k


@pytest.mark.parametrize("stage", [2, 3])
def test_losses_and_params_match_the_jax_pipe(ref, ranks, stage):
    jx = ref[stage]
    for res in ranks:
        got = res[f"s{stage}"]
        np.testing.assert_allclose(got["losses"], jx["losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], ref["port1"]["losses"],
                                   rtol=LOSS_RTOL)
        _gate(got["final"], jx["final"], ref["grad0"], LR)
        _gate(got["final"], ref["port1"]["final"], ref["grad0"], LR)


def test_stage3_and_overlap_off_bit_equal_to_stage2(ranks):
    for res in ranks:
        s2 = res["s2"]
        for other in ("s3", "s2_off"):
            assert res[other]["losses"] == s2["losses"], other
            for k, v in s2["final"].items():
                np.testing.assert_array_equal(res[other]["final"][k], v,
                                              err_msg=f"{other} {k}")
        assert s2["tied_equal"] and res["s3"]["tied_equal"]


def test_loss_scaler_through_the_schedule(ranks):
    """A GradScaler (2^10) seeds the last stage's backward; the scaled
    gradients cross the stages and the ZeRO sync, and the update unscales
    them: stage 3 bit-equal to stage 2, both equal to the unscaled run
    (a power of two scales and unscales f32 exactly)."""
    for res in ranks:
        assert res["s3_amp"]["losses"] == res["s2_amp"]["losses"]
        np.testing.assert_allclose(res["s2_amp"]["losses"],
                                   res["s2"]["losses"], rtol=1e-6)
        for k, v in res["s2"]["final"].items():
            np.testing.assert_allclose(res["s2_amp"]["final"][k], v,
                                       rtol=0, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("run", ["clip", "clip_norm"])
def test_clip_against_degree1(ref, ranks, run):
    """The global norm counts every element once over mp x pp x sharding
    and the tied pair; a per-tensor norm (ClipGradByNorm, at stage 3)
    sums each tensor's squares over its mp and ZeRO shards."""
    d1 = ref["port1_" + run]
    # the clip acts: the run leaves the unclipped one
    assert d1["losses"][-1] != ref["port1"]["losses"][-1]
    for res in ranks:
        got = res[run]
        np.testing.assert_allclose(got["losses"], d1["losses"],
                                   rtol=LOSS_RTOL)
        _gate(got["final"], d1["final"], ref["grad0"], LR)


def test_plan_and_state_bytes(ref, ranks):
    want = ref[2]["plan"]
    for res in ranks:
        got = res["s2"]["plan"]
        assert got and set(got) <= set(want)
        assert all(got[k] == want[k] for k in got)
        s2, s3 = res["s2"]["state_bytes"], res["s3"]["state_bytes"]
        assert s3["optimizer_state"] == s2["optimizer_state"]
        assert s3["params"] < s2["params"]
    # every name the JAX plan covers is covered on some rank
    assert set().union(*(set(r["s2"]["plan"]) for r in ranks)) == set(want)


def test_weights_load_and_export_round_trip(ranks):
    """Each rank loads the rows of its chunks of the JAX [vpp, L / vpp,
    ...] arrays with its mp slice, and the export gathers the JAX state
    back bit for bit."""
    for res in ranks:
        assert res["round_trip"]
        shapes = res["local_shapes"]
        # stage s holds blocks s and 2 + s, each qkv the rank's half
        for i in (res["coords"]["pp"], 2 + res["coords"]["pp"]):
            assert shapes[f"blocks.{i}.attn.qkv_proj.weight"] == (48, 32)


def test_eval_and_bubble(ref, ranks):
    for res in ranks:
        assert np.isfinite(res["s2"]["eval"])
        assert res["s2"]["eval"] < ref["port1"]["losses"][0]
        assert res["s2"]["bubble"] == (2 - 1) / (VPP * 2 + 2 - 1)

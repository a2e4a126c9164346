"""gpt_tiny under the port's hybrid parallelism, against the JAX package:
``fleet.init`` + ``ParallelEngine`` at mp 2 and at dp 2 x mp 2 (gloo
processes on the CPU), 3 steps of SGD (lr 0.05, as tests/test_gpt.py)
and of AdamW with clip 1.0 (lr 1e-3), from the JAX model's weights
(``convert.load_jax_state_dict`` slicing them per rank), the global batch
[8, 16] split over dp.

- Losses within the JAX test's own 2e-4 (relative) of the JAX engine at
  the same degrees and of degree 1.
- Parameters (gathered by ``export_jax_state_dict``) by
  ``tests/test_torch_gpt.py``'s gate against degree 1 (1e-4 where the
  first degree-1 gradient is at least 1e-6 in magnitude, lr elsewhere),
  and against the JAX engine at the same degrees where no clip acts.
- The sharded load and the gathered export round-trip the JAX weights
  bit for bit; each rank holds its slice.
- The throughput telemetry counts the job once: every rank's tokens/s is
  the job's rate (each takes the global batch), its MFU puts the job's
  FLOPs over every card of the mesh, and ``pod_throughput`` returns the
  mean of the ranks' readings, not their sum.

SGD with clip 1.0 is held to degree 1 only: the port clips by the global
norm over the mp group, while the JAX engine's clip runs inside
``shard_map`` on each rank's own gradients (its mp 2 run leaves degree 1
by 3.6e-3 at step 2; ROADMAP.md queue 3).
"""
import os
import sys

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet
from paddle_tpu.distributed.engine import ParallelEngine
from paddle_tpu.models import (GPTForCausalLM, GPTPretrainingCriterion,
                               gpt_tiny)
from paddle_tpu.nn import ClipGradByGlobalNorm

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "workers"))
from torch_dist_worker import PEAK_FLOPS, run_world  # noqa: E402

LOSS_RTOL = 2e-4
PARAM_TOL = 1e-4
TINY_GRAD = 1e-6
RUNS = {"sgd": ("sgd", 0.05, None), "adamw_clip": ("adamw", 1e-3, 1.0),
        "sgd_clip": ("sgd", 0.05, 1.0)}
DEGREES = {"mp2": (1, 2), "dp2mp2": (2, 2)}


def _batch():
    ids = np.random.RandomState(0).randint(0, 256, (8, 17))
    return ids[:, :-1], ids[:, 1:]


def _jax_run(state, run, mesh_degrees=None):
    """The JAX engine's losses and final weights for one run."""
    kind, lr, clip = RUNS[run]
    mesh = None
    if mesh_degrees is not None:
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": mesh_degrees[0],
                            "mp_degree": mesh_degrees[1], "pp_degree": 1}
        mesh = fleet.init(is_collective=True, strategy=s).mesh
    else:
        fleet._fleet_state.update(initialized=False, hcg=None, strategy=None)
    model = GPTForCausalLM(gpt_tiny())
    model.set_state_dict(state)
    opt = (paddle.optimizer.SGD if kind == "sgd" else
           paddle.optimizer.AdamW)(
        learning_rate=lr, parameters=model.parameters(),
        grad_clip=ClipGradByGlobalNorm(clip) if clip else None)
    crit = GPTPretrainingCriterion()
    step = ParallelEngine(model, opt, mesh).train_step(
        lambda m, b: crit(m(b["x"]), b["y"]))
    x, y = _batch()
    b = {"x": paddle.to_tensor(x), "y": paddle.to_tensor(y)}
    losses = [float(step(b)) for _ in range(3)]
    final = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    fleet._fleet_state.update(initialized=False, hcg=None, strategy=None)
    return losses, final


@pytest.fixture(scope="module")
def ref():
    fleet._fleet_state.update(initialized=False, hcg=None, strategy=None)
    paddle.seed(42)
    model = GPTForCausalLM(gpt_tiny())
    state = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    x, y = _batch()
    loss = GPTPretrainingCriterion()(model(paddle.to_tensor(x)),
                                     paddle.to_tensor(y))
    loss.backward()
    grad0 = {n: np.asarray(p.grad._value) for n, p in
             model.named_parameters()}
    out = {"state": state, "grad0": grad0, "degree1": {}, "jax": {}}
    for run in RUNS:
        out["degree1"][run] = _jax_run(state, run)
    for name, deg in DEGREES.items():
        out["jax"][name] = {run: _jax_run(state, run, deg)
                            for run in ("sgd", "adamw_clip")}
    return out


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    x, y = _batch()
    out = {}
    for name, (dp, mp) in DEGREES.items():
        out[name] = run_world(
            dp * mp, "hybrid_gpt", tmp_path_factory.mktemp(name), dp=dp,
            mp=mp, x=x.tolist(), y=y.tolist(), runs=RUNS,
            state={k: v.tolist() for k, v in ref["state"].items()})
    return out


def _gate(mine, final, grad0, lr):
    assert set(mine) == set(final)
    for k, want in final.items():
        err = np.abs(mine[k] - want)
        tiny = np.abs(grad0[k]) < TINY_GRAD
        assert err[~tiny].max(initial=0.0) <= PARAM_TOL, k
        assert err[tiny].max(initial=0.0) <= lr, k


@pytest.mark.parametrize("degrees", sorted(DEGREES))
@pytest.mark.parametrize("run", ["sgd", "adamw_clip"])
def test_losses_and_params_match_the_jax_engine(ref, ranks, degrees, run):
    lr = RUNS[run][1]
    d1_losses, d1_final = ref["degree1"][run]
    jx_losses, jx_final = ref["jax"][degrees][run]
    for res in ranks[degrees]:
        got = res[run]
        np.testing.assert_allclose(got["losses"], jx_losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], d1_losses, rtol=LOSS_RTOL)
        assert got["losses"][-1] < got["losses"][0]
        _gate(got["final"], d1_final, ref["grad0"], lr)
        if RUNS[run][2] is None:
            # with a clip the JAX engine's mp run takes each rank's own
            # norm (module docstring): its parameters are held apart
            _gate(got["final"], jx_final, ref["grad0"], lr)


@pytest.mark.parametrize("degrees", sorted(DEGREES))
def test_clip_is_the_global_norm(ref, ranks, degrees):
    """SGD with clip 1.0 (the clip acts: gpt_tiny's first norm is above
    1): mp 2 and dp 2 x mp 2 equal degree 1, and every rank reports the
    same global norm."""
    d1_losses, d1_final = ref["degree1"]["sgd_clip"]
    assert not np.allclose(d1_losses, ref["degree1"]["sgd"][0], rtol=1e-3)
    norms = set()
    for res in ranks[degrees]:
        got = res["sgd_clip"]
        np.testing.assert_allclose(got["losses"], d1_losses, rtol=LOSS_RTOL)
        _gate(got["final"], d1_final, ref["grad0"], RUNS["sgd_clip"][1])
        norms.add(got["grad_norm"])
    assert len(norms) == 1


@pytest.mark.parametrize("degrees", sorted(DEGREES))
def test_sharded_load_and_export_round_trip(ref, ranks, degrees):
    dp, mp = DEGREES[degrees]
    for r, res in enumerate(ranks[degrees]):
        assert res["round_trip"]
        assert res["coords"]["mp"] == r % mp and res["coords"]["dp"] == r // mp
        shapes = res["local_shapes"]
        full = ref["state"]
        # the port's [out, in] layout: column rows, row columns, vocab rows
        assert shapes["gpt.embeddings.word_embeddings.weight"] == (
            full["gpt.embeddings.word_embeddings.weight"].shape[0] // mp, 64)
        assert shapes["gpt.layers.0.attn.qkv_proj.weight"] == (192 // mp, 64)
        assert shapes["gpt.layers.0.attn.qkv_proj.bias"] == (192 // mp,)
        assert shapes["gpt.layers.0.attn.out_proj.weight"] == (64, 64 // mp)
        assert shapes["gpt.layers.0.attn.out_proj.bias"] == (64,)
        assert shapes["gpt.layers.0.mlp.fc2.weight"] == (64, 256 // mp)
        assert shapes["gpt.embeddings.position_embeddings.weight"] == (128,
                                                                       64)


@pytest.mark.parametrize("degrees", sorted(DEGREES))
def test_throughput_telemetry_counts_the_job_once(ranks, degrees):
    dp, mp = DEGREES[degrees]
    tel = [res["telemetry"] for res in ranks[degrees]]
    mean = sum(t["tokens_per_sec"] for t in tel) / len(tel)
    for t in tel:
        assert t["processes"] == dp * mp
        assert t["local_tokens_per_sec"] == t["tokens_per_sec"] > 0
        assert t["pod_tokens_per_sec"] == pytest.approx(mean, rel=1e-12)
        want = t["flops_per_token"] * t["tokens_per_sec"] / (
            dp * mp * PEAK_FLOPS)
        assert t["mfu"] == pytest.approx(want, rel=1e-12)

"""llama_tiny under the port's tensor parallelism, against the JAX
package: ``fleet.init`` + ``ParallelEngine`` at mp 2 and at dp 2 x mp 2
(gloo processes on the CPU), from the JAX model's weights
(``convert.load_jax_state_dict`` slicing them per rank; GQA at 4 heads /
2 KV heads: one KV head a rank at mp 2), the global batch [8, 16].

- AdamW (lr 1e-3, 3 steps): losses within the JAX test's 2e-4 (relative)
  of the JAX engine at the same degrees and of degree 1; the gathered
  parameters by ``tests/test_torch_gpt.py``'s gate against both. With
  clip 1.0, against degree 1 only (the JAX engine's clip under a mesh is
  each rank's own norm: ROADMAP.md queue 3).
- A loss mask (SGD, 2 steps): the masked mean over the whole batch, as
  the JAX ``_masked_mean_over_splits`` gives it at dp 2.
- The tied head at mp 2 (``_c_identity`` before the product).
- The seeded initialisation gathered equals degree 1's bit for bit; the
  sharded load and the gathered export round-trip bit for bit.
- ``train_step`` / ``eval_step`` with ``batch_specs`` (a replicated
  per-position weight beside dp-split ids and labels; the logits
  gathered over dp and the vocab's mp shards) equal the JAX engine's
  with the same specs.
- The cached forwards and ``generate`` raise under an mp group.
"""
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from jax.sharding import PartitionSpec as JP
from paddle_tpu.distributed import fleet
from paddle_tpu.distributed.engine import ParallelEngine
from paddle_tpu.models import (LlamaForCausalLM, LlamaPretrainingCriterion,
                               llama_tiny)
from paddle_tpu.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.convert import export_jax_state_dict
from paddle_tpu_torch.models import llama as tl

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "workers"))
from torch_dist_worker import run_world  # noqa: E402

LOSS_RTOL = 2e-4
PARAM_TOL = 1e-4
TINY_GRAD = 1e-6
DEGREES = {"mp2": (1, 2), "dp2mp2": (2, 2)}
# run: (optimizer, lr, clip, tied, masked, steps), as the ranks run them
RUNS = {"adamw": ("adamw", 1e-3, None, False, False, 3),
        "adamw_clip": ("adamw", 1e-3, 1.0, False, False, 3),
        "masked": ("sgd", 0.05, None, False, True, 2),
        "tied": ("sgd", 0.05, None, True, False, 2)}
# the JAX engine at each degree: the runs without a clip
JAX_RUNS = {"mp2": ("adamw", "tied"), "dp2mp2": ("adamw", "masked")}


def _data():
    r = np.random.RandomState(0)
    ids = r.randint(0, 256, (8, 17))
    mask = (r.rand(8, 16) < 0.6).astype("float32")
    mask[0] = 0.0           # a row with no token: its dp block counts less
    w = (r.rand(16) < 0.7).astype("float32")
    return ids[:, :-1], ids[:, 1:], mask, w


def _reset():
    fleet._fleet_state.update(initialized=False, hcg=None, strategy=None)


def _mesh(degrees):
    if degrees is None:
        _reset()
        return None
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": degrees[0], "mp_degree": degrees[1],
                        "pp_degree": 1}
    return fleet.init(is_collective=True, strategy=s).mesh


def _np(t):
    return np.asarray(t._value)


def _jax_model(state, tied=False):
    m = LlamaForCausalLM(llama_tiny(tie_word_embeddings=tied))
    m.set_state_dict(state)
    return m


def _jax_run(states, run, degrees=None):
    kind, lr, clip, tied, masked, steps = RUNS[run]
    mesh = _mesh(degrees)
    m = _jax_model(states["tied" if tied else "untied"], tied)
    opt = (paddle.optimizer.SGD if kind == "sgd" else
           paddle.optimizer.AdamW)(
        learning_rate=lr, parameters=m.parameters(),
        grad_clip=ClipGradByGlobalNorm(clip) if clip else None)
    crit = LlamaPretrainingCriterion()
    step = ParallelEngine(m, opt, mesh).train_step(
        lambda mm, b: crit(mm(b["x"]), b["y"],
                           b["mask"] if masked else None))
    x, y, mask, _ = _data()
    b = {"x": paddle.to_tensor(x), "y": paddle.to_tensor(y),
         "mask": paddle.to_tensor(mask)}
    losses = [float(step(b)) for _ in range(steps)]
    final = {k: _np(v) for k, v in m.state_dict().items()}
    _reset()
    return losses, final


def _jax_specs(state, degrees):
    """The JAX engine with the ranks' batch specs: eval logits gathered
    over dp and mp, then 2 SGD steps with the replicated weight."""
    mesh = _mesh(degrees)
    m = _jax_model(state)
    eng = ParallelEngine(m, paddle.optimizer.SGD(
        learning_rate=0.05, parameters=m.parameters()), mesh)
    x, y, _, w = _data()
    b = {"w": paddle.to_tensor(w), "x": paddle.to_tensor(x),
         "y": paddle.to_tensor(y)}
    specs = (JP(), JP("dp"), JP("dp"))
    crit = LlamaPretrainingCriterion()
    logits = _np(eng.eval_step(lambda mm, bb: mm(bb["x"]),
                               batch_specs=specs)(
        b, out_spec=JP("dp", None, "mp")))
    step = eng.train_step(
        lambda mm, bb: crit(mm(bb["x"]), bb["y"],
                            paddle.expand_as(bb["w"][None], bb["y"])),
        batch_specs=specs)
    losses = [float(step(b)) for _ in range(2)]
    final = {k: _np(v) for k, v in m.state_dict().items()}
    _reset()
    return logits, losses, final


@pytest.fixture(scope="module")
def ref():
    _reset()
    paddle.seed(42)
    states = {"untied": {k: _np(v) for k, v in
                         LlamaForCausalLM(llama_tiny()).state_dict().items()},
              "tied": {k: _np(v) for k, v in LlamaForCausalLM(llama_tiny(
                  tie_word_embeddings=True)).state_dict().items()}}
    x, y, _, _ = _data()
    m = _jax_model(states["untied"])
    LlamaPretrainingCriterion()(m(paddle.to_tensor(x)),
                                paddle.to_tensor(y)).backward()
    out = {"states": states, "degree1": {}, "jax": {},
           "grad0": {n: _np(p.grad) for n, p in m.named_parameters()}}
    for run in RUNS:
        out["degree1"][run] = _jax_run(states, run)
    for name, runs in JAX_RUNS.items():
        out["jax"][name] = {run: _jax_run(states, run, DEGREES[name])
                            for run in runs}
    out["specs"] = _jax_specs(states["untied"], DEGREES["dp2mp2"])
    out["init7"] = export_jax_state_dict(tl.LlamaForCausalLM(
        tl.llama_tiny(), device="cpu", seed=7))
    return out


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    x, y, mask, w = _data()
    out = {}
    for name, (dp, mp) in DEGREES.items():
        out[name] = run_world(
            dp * mp, "hybrid_llama", tmp_path_factory.mktemp(name), dp=dp,
            mp=mp, x=x.tolist(), y=y.tolist(), mask=mask.tolist(),
            w=w.tolist(),
            state={k: v.tolist() for k, v in ref["states"]["untied"].items()},
            state_tied={k: v.tolist()
                        for k, v in ref["states"]["tied"].items()})
    return out


def _gate(mine, final, grad0, lr):
    assert set(mine) == set(final)
    for k, want in final.items():
        err = np.abs(mine[k] - want)
        tiny = np.abs(grad0[k]) < TINY_GRAD if k in grad0 else \
            np.zeros(want.shape, bool)
        assert err[~tiny].max(initial=0.0) <= PARAM_TOL, k
        assert err[tiny].max(initial=0.0) <= lr, k


@pytest.mark.parametrize("degrees", sorted(DEGREES))
@pytest.mark.parametrize("run", sorted(RUNS))
def test_losses_and_params_match_degree_1_and_the_jax_engine(
        ref, ranks, degrees, run):
    lr = RUNS[run][1]
    d1_losses, d1_final = ref["degree1"][run]
    jx = ref["jax"][degrees].get(run)
    for res in ranks[degrees]:
        got = res[run]
        np.testing.assert_allclose(got["losses"], d1_losses, rtol=LOSS_RTOL)
        assert got["losses"][-1] < got["losses"][0]
        _gate(got["final"], d1_final, ref["grad0"], lr)
        if jx is not None:
            np.testing.assert_allclose(got["losses"], jx[0], rtol=LOSS_RTOL)
            _gate(got["final"], jx[1], ref["grad0"], lr)


def test_the_loss_mask_counts_the_whole_batch(ref):
    """The mask leaves a row empty, so the dp blocks' token counts differ:
    the JAX engine at dp 2 takes the mean over the whole batch, which is
    degree 1's."""
    np.testing.assert_allclose(ref["jax"]["dp2mp2"]["masked"][0],
                               ref["degree1"]["masked"][0], rtol=LOSS_RTOL)


@pytest.mark.parametrize("degrees", sorted(DEGREES))
def test_seeded_init_and_sharded_round_trip(ref, ranks, degrees):
    dp, mp = DEGREES[degrees]
    for r, res in enumerate(ranks[degrees]):
        assert set(res["init"]) == set(ref["init7"])
        for k, v in ref["init7"].items():
            assert np.array_equal(res["init"][k], v), k
        assert res["round_trip"]
        assert res["coords"]["mp"] == r % mp and res["coords"]["dp"] == r // mp
        shapes = res["local_shapes"]
        # the port's [out, in]: q/k/v, gate/up and lm_head by rows (k and v
        # one KV head of 16 a rank), o/down by columns, the vocab by rows
        assert shapes["llama.layers.0.self_attn.q_proj.weight"] == (
            64 // mp, 64)
        assert shapes["llama.layers.0.self_attn.k_proj.weight"] == (
            32 // mp, 64)
        assert shapes["llama.layers.0.self_attn.o_proj.weight"] == (
            64, 64 // mp)
        assert shapes["llama.layers.0.mlp.up_proj.weight"] == (128 // mp, 64)
        assert shapes["llama.layers.0.mlp.down_proj.weight"] == (
            64, 128 // mp)
        assert shapes["llama.embed_tokens.weight"] == (256 // mp, 64)
        assert shapes["lm_head.weight"] == (256 // mp, 64)
        assert shapes["llama.norm.weight"] == (64,)


def test_batch_specs_match_the_jax_engine(ref, ranks):
    logits, losses, final = ref["specs"]
    for res in ranks["dp2mp2"]:
        np.testing.assert_allclose(res["eval_logits"], logits, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res["specs"]["losses"], losses,
                                   rtol=LOSS_RTOL)
        _gate(res["specs"]["final"], final, ref["grad0"], 0.05)
        assert res["eval_stats"] == (2, 1)


@pytest.mark.parametrize("degrees", sorted(DEGREES))
def test_cached_paths_raise_under_mp(ranks, degrees):
    for res in ranks[degrees]:
        for name, msg in res["raised"].items():
            assert msg is not None and "tensor parallelism" in msg, name


def test_degree_1_port_init_is_the_reference(ref):
    """The seeded degree-1 port model the ranks are held to: its own
    weights, drawn once (a second build gives the same bits)."""
    again = export_jax_state_dict(tl.LlamaForCausalLM(
        tl.llama_tiny(), device="cpu", seed=7))
    assert all(np.array_equal(again[k], v) for k, v in ref["init7"].items())
    assert not np.array_equal(again["llama.embed_tokens.weight"],
                              export_jax_state_dict(tl.LlamaForCausalLM(
                                  tl.llama_tiny(), device="cpu", seed=8))[
                                  "llama.embed_tokens.weight"])
    assert torch.get_default_dtype() == torch.float32

"""The port's sequence parallelism (``fleet.utils.sequence_parallel_utils``)
against the JAX package, on gloo processes on the CPU.

- Each SP primitive (``scatter``, ``gather``, ``all_gather``,
  ``reduce_scatter``) at mp 2 and mp 4, on each rank's own input and
  cotangent: the output and the input gradient against the JAX
  primitive's collective pairing (``mp_ops``' custom-vjp function that
  ``sequence_parallel_utils`` calls) under ``shard_map`` on the JAX CPU
  mesh, to 1e-6. Outside an mp group every primitive is the identity.
- The JAX test's ``SPBlock`` (sequence scattered, norm on a shard, column
  / row sequence-parallel linears, sequence gathered) with ``LayerNorm``
  and with ``LlamaRMSNorm`` (K3's plain version on the CPU), 3 Adam steps
  at dp 2 x mp 2 through ``ParallelEngine``: losses and parameters
  against the dense block at degree 1 and the JAX engine at the same
  degrees (1e-4, the JAX test's); the marked parameters bit-equal on
  every rank (their gradients summed over mp by the engine); a step's
  booked bytes at their closed form. The same block in an eager loop
  through ``fleet.distributed_model`` / ``distributed_optimizer`` (Paddle's
  SP recipe) matches the dense block too, its marked gradients equal on
  every rank after each ``opt.step()``.
- ``register_sequence_parallel_allreduce_hooks`` returns the marked
  parameters; ``mp_async_allreduce`` raises, citing item 10.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet
from paddle_tpu.distributed.engine import ParallelEngine, _shard_map
from paddle_tpu.distributed.fleet.layers.mpu import mp_ops as jmp
from paddle_tpu.distributed.fleet.utils import sequence_parallel_utils as jspu
from paddle_tpu.models.llama import LlamaRMSNorm as JRMSNorm

from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.fleet.utils import \
    sequence_parallel_utils as spu

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "workers"))
from torch_dist_worker import SP_OPS, run_world  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
# the JAX primitive behind each SP op, and how a rank's input is laid out
# (B, S, F) for a sequence of S at mp n: the local shard in, or the whole
JAX_OPS = {"scatter": (jmp.slice_allgather_bwd, False),
           "gather": (jmp.allgather_slice_bwd, True),
           "all_gather": (jmp.allgather_reducescatter_bwd, True),
           "reduce_scatter": (jmp.reducescatter_allgather_bwd, False)}
B, S, F = 2, 8, 6


def _reset():
    fleet._fleet_state.update(initialized=False, hcg=None, strategy=None)


def _prim_cases(n):
    """Per-rank inputs and cotangents, and the JAX outputs and input
    gradients, for each op at mp n."""
    r = np.random.RandomState(n)
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(n), ("mp",))
    cases = {}
    for op in SP_OPS:
        fn, sharded_in = JAX_OPS[op]
        s_in = S // n if sharded_in else S
        s_out = S if sharded_in else S // n
        x = r.randn(n, B, s_in, F).astype("float32")
        g = r.randn(n, B, s_out, F).astype("float32")

        def f(xs, gs, fn=fn):
            out, vjp = jax.vjp(lambda a: fn(a, ("mp",), 1), xs[0])
            return out[None], vjp(gs[0])[0][None]

        out, dx = _shard_map(f, mesh, (JP("mp"), JP("mp")),
                             (JP("mp"), JP("mp")))(x, g)
        cases[op] = {"x": x, "g": g, "out": np.asarray(out),
                     "dx": np.asarray(dx)}
    return cases


class _JaxSPBlock(paddle.nn.Layer):
    """tests/test_sharding_sp.py's SPBlock, with its norm a choice."""

    def __init__(self, norm, dense=False, d=16, h=32):
        super().__init__()
        self.dense = dense
        self.norm = (paddle.nn.LayerNorm(d) if norm == "layer_norm"
                     else JRMSNorm(d, epsilon=1e-5))
        if dense:
            self.fc1 = paddle.nn.Linear(d, h)
            self.fc2 = paddle.nn.Linear(h, d)
            return
        self.fc1 = jspu.ColumnSequenceParallelLinear(
            d, h, gather_output=False, seq_axis=1)
        self.fc2 = jspu.RowSequenceParallelLinear(
            h, d, input_is_parallel=True, seq_axis=1)
        for p in self.norm.parameters():
            jspu.mark_as_sequence_parallel_parameter(p)

    def forward(self, x):
        if not self.dense:
            x = jspu.scatter(x, axis=1)
        x = paddle.nn.functional.relu(self.fc1(self.norm(x)))
        x = self.fc2(x)
        return x if self.dense else jspu.gather(x, axis=1)


def _data():
    r = np.random.RandomState(1)
    return (r.randn(4, 8, 16).astype("float32"),
            r.randn(4, 8, 16).astype("float32"))


def _jax_train(state, norm, mesh=None):
    m = _JaxSPBlock(norm, dense=mesh is None)
    m.set_state_dict(state)
    opt = paddle.optimizer.Adam(learning_rate=0.1,
                                parameters=m.parameters())
    x, y = _data()
    b = {"x": paddle.to_tensor(x), "y": paddle.to_tensor(y)}
    step = ParallelEngine(m, opt, mesh).train_step(
        lambda mm, bb: paddle.mean((mm(bb["x"]) - bb["y"]) ** 2))
    losses = [float(step(b)) for _ in range(3)]
    return losses, {k: np.asarray(v._value)
                    for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def ref():
    _reset()
    out = {"prims": {n: _prim_cases(n) for n in (2, 4)}, "state": {},
           "dense": {}, "jax": {}}
    for norm in ("layer_norm", "rms_norm"):
        paddle.seed(5)
        m = _JaxSPBlock(norm, dense=True)
        out["state"][norm] = {k: np.asarray(v._value)
                              for k, v in m.state_dict().items()}
        out["dense"][norm] = _jax_train(out["state"][norm], norm)
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2, "pp_degree": 1}
    mesh = fleet.init(is_collective=True, strategy=s).mesh
    for norm in ("layer_norm", "rms_norm"):
        out["jax"][norm] = _jax_train(out["state"][norm], norm, mesh)
    _reset()
    return out


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    x, y = _data()
    out = {}
    for dp, mp in ((1, 4), (2, 2)):
        prims = {op: {"x": c["x"].tolist(), "g": c["g"].tolist()}
                 for op, c in ref["prims"][mp].items()}
        out[(dp, mp)] = run_world(
            dp * mp, "sequence_parallel",
            tmp_path_factory.mktemp(f"dp{dp}mp{mp}"), dp=dp, mp=mp,
            prims=prims, x=x.tolist(), y=y.tolist(),
            state={norm: {k: v.tolist() for k, v in st.items()}
                   for norm, st in ref["state"].items()})
    return out


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("op", SP_OPS)
def test_primitive_matches_the_jax_op(ref, ranks, op, mp):
    res = ranks[(1, 4)] if mp == 4 else ranks[(2, 2)]
    want = ref["prims"][mp][op]
    for rank, got in enumerate(res):
        r = rank % mp
        np.testing.assert_allclose(got["prims"][op][0], want["out"][r],
                                   **TOL)
        np.testing.assert_allclose(got["prims"][op][1], want["dx"][r], **TOL)
        assert got["alias"]


def test_primitives_are_identities_outside_an_mp_group():
    tfleet._fleet_state.__init__()
    x = torch.randn(4, 6)
    for op in SP_OPS:
        assert getattr(spu, op)(x, axis=0) is x
    for alias in (spu.ScatterOp, spu.GatherOp, spu.AllGatherOp,
                  spu.ReduceScatterOp):
        assert alias.apply(x) is x
    assert spu.identity_in_sequence_parallel(x) is x


@pytest.mark.parametrize("norm", ["layer_norm", "rms_norm"])
def test_sp_block_matches_dense_and_the_jax_engine(ref, ranks, norm):
    d_losses, d_final = ref["dense"][norm]
    j_losses, j_final = ref["jax"][norm]
    np.testing.assert_allclose(j_losses, d_losses, rtol=1e-4, atol=1e-6)
    for res in ranks[(2, 2)]:
        got = res[norm]
        np.testing.assert_allclose(got["losses"], d_losses, rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(got["losses"], j_losses, rtol=1e-4,
                                   atol=1e-6)
        for k in d_final:
            np.testing.assert_allclose(got["final"][k], d_final[k],
                                       rtol=1e-4, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(got["final"][k], j_final[k],
                                       rtol=1e-4, atol=1e-5, err_msg=k)
        assert got["marked_equal"]
        shapes = got["local_shapes"]
        assert shapes["fc1.weight"] == (16, 16)     # [32 / mp, 16]
        assert shapes["fc2.weight"] == (16, 16)     # [16, 32 / mp]
        assert shapes["fc2.bias"] == (16,)


@pytest.mark.parametrize("norm", ["layer_norm", "rms_norm"])
def test_sp_block_through_distributed_optimizer(ref, ranks, norm):
    """HybridParallelOptimizer.step() sums the marked gradients over mp
    as the engine does: without that sum each mp rank would update its
    norm and row bias from its own sequence shard and drift apart."""
    d_losses, d_final = ref["dense"][norm]
    for res in ranks[(2, 2)]:
        got = res[norm]["eager"]
        assert got["grads_equal"] == [True] * 3
        assert got["marked_equal"]
        np.testing.assert_allclose(got["losses"], d_losses, rtol=1e-4,
                                   atol=1e-6)
        for k in d_final:
            np.testing.assert_allclose(got["final"][k], d_final[k],
                                       rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("norm", ["layer_norm", "rms_norm"])
def test_hooks_return_the_marked_parameters(ranks, norm):
    want = ["fc2.bias", "norm.bias", "norm.weight"] if norm == \
        "layer_norm" else ["fc2.bias", "norm.weight"]
    for res in ranks[(2, 2)]:
        assert res[norm]["hooks"] == want


@pytest.mark.parametrize("norm", ["layer_norm", "rms_norm"])
def test_a_step_books_its_closed_form(ranks, norm):
    """A dp block [2, 8, 16] f32, sequence 4 a rank: on mp, all_gather
    3 x the shard (fc1's input, the backward of fc2's reduce-scatter, the
    final gather) and reduce_scatter 2 x the whole (fc2's output, the
    backward of fc1's gather), psum the marked gradients (the engine's
    sum over mp) and the shards' squared sum of the reported grad norm
    (4); on dp each local gradient once; the loss's mean."""
    shard, whole = 2 * 4 * 16 * 4, 2 * 8 * 16 * 4
    marked = (16 + 16 + (16 if norm == "layer_norm" else 0)) * 4
    local = (16 * 16 + 16 + 16 * 16) * 4 + marked
    want = {"mp/all_gather": 3 * shard, "mp/reduce_scatter": 2 * whole,
            "mp/psum": marked + 4, "dp/psum": local, "world/psum": 4}
    for res in ranks[(2, 2)]:
        assert res[norm]["booked"] == want


def test_mp_async_allreduce_raises_citing_item_10():
    st = tfleet.DistributedStrategy()
    st.hybrid_configs = {"mp_configs": {"mp_async_allreduce": True}}
    tfleet.init(is_collective=True, strategy=st)
    try:
        with pytest.raises(NotImplementedError, match="item 10"):
            spu.ColumnSequenceParallelLinear(16, 32, device="cpu")
        with pytest.raises(NotImplementedError, match="item 10"):
            spu.RowSequenceParallelLinear(32, 16, device="cpu")
    finally:
        tfleet._fleet_state.__init__()


def test_weight_attr_raises_citing_item_2_2():
    for cls in (spu.ColumnSequenceParallelLinear,
                spu.RowSequenceParallelLinear):
        with pytest.raises(NotImplementedError, match="item 2.2"):
            cls(16, 32, weight_attr=object(), device="cpu")

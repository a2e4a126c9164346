"""The port's bucketed ``DataParallel`` Reducer
(``paddle_tpu_torch.distributed.parallel``) against the JAX package's:
the cases of ``tests/test_dp_reducer.py`` in one process (a world of one:
the averaging is the identity, the buckets and fires are counted), each
gradient held to the JAX DataParallel's on the same weights and batch;
and at 2 ranks of gloo processes, each rank on its half of the batch,
the averaged gradients against the JAX model's on the whole batch.
"""
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed.parallel import DataParallel as JDataParallel

from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.distributed.parallel import DataParallel, Reducer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "workers"))
from torch_dist_worker import _seq, run_world  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_model(seed):
    paddle.seed(seed)
    return jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 4))


def _state(m):
    return {k: np.asarray(v._value) for k, v in m.state_dict().items()}


def _port(seed):
    m = _seq()
    load_jax_state_dict(m, _state(_jax_model(seed)))
    return m


def _batch(seed, n=4):
    r = np.random.RandomState(seed)
    return r.randn(n, 8).astype("float32"), r.randn(n, 4).astype("float32")


def _jax_grads(seed, batches, wrap=None, no_sync_first=False):
    """The JAX DataParallel's (or plain model's) gradients after a
    backward of each batch's mean squared error."""
    m = _jax_model(seed)
    f = JDataParallel(m, comm_buffer_size=wrap) if wrap else m
    for i, (x, y) in enumerate(batches):
        loss = paddle.mean((f(paddle.to_tensor(x)) - paddle.to_tensor(y))
                           ** 2)
        if no_sync_first and i == 0:
            with f.no_sync():
                loss.backward()
        else:
            loss.backward()
    return {n: np.asarray(p.grad._value) for n, p in m.named_parameters()}


def _mse(f, x, y):
    return torch.mean((f(torch.tensor(x)) - torch.tensor(y)) ** 2)


def test_bucket_partitioning_respects_budget():
    m = _port(0)
    r1 = Reducer(m.parameters(), comm_buffer_size_mb=1e-9)
    assert r1.num_buckets == len([p for p in m.parameters()
                                  if p.requires_grad])
    assert Reducer(m.parameters(), comm_buffer_size_mb=1e3).num_buckets == 1


@pytest.mark.parametrize("budget", [1e-9, 1000])
def test_fused_reduce_grads_match_plain_backward(budget):
    """Per-parameter buckets, then one bucket: the JAX DataParallel's
    gradients and one fused reduction a bucket."""
    x, y = _batch(0)
    ref = _jax_grads(3, [(x, y)], wrap=budget)
    m = _port(3)
    dp = DataParallel(m, comm_buffer_size=budget)
    _mse(dp, x, y).backward()
    assert dp._reducer.fused_reduce_count == dp._reducer.num_buckets
    assert dp._reducer.num_buckets == (1 if budget == 1000 else 4)
    for n, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.T.numpy() if p.dim() == 2
                                   else p.grad.numpy(), ref[n], err_msg=n,
                                   **TOL)


def test_no_sync_skips_reduction():
    x, y = _batch(1)
    m = _port(4)
    dp = DataParallel(m, comm_buffer_size=1000)
    with dp.no_sync():
        _mse(dp, x, y).backward()
    assert dp._reducer.fused_reduce_count == 0
    assert all(p.grad is not None for p in m.parameters())


def test_reducer_preserves_accumulated_grads():
    """no_sync accumulation, then a synced backward: the fire replaces
    only this pass's provisional part, keeping the earlier accumulation
    (as tests/test_dp_reducer.py holds the JAX Reducer to)."""
    r = np.random.RandomState(2)
    x1, x2 = (r.randn(4, 8).astype("float32") for _ in range(2))
    y = r.randn(4, 4).astype("float32")
    ref = _jax_grads(5, [(x1, y), (x2, y)], wrap=1000, no_sync_first=True)
    m = _port(5)
    dp = DataParallel(m, comm_buffer_size=1000)
    with dp.no_sync():
        _mse(dp, x1, y).backward()
    _mse(dp, x2, y).backward()
    for n, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.T.numpy() if p.dim() == 2
                                   else p.grad.numpy(), ref[n], err_msg=n,
                                   **TOL)


def test_find_unused_parameters_degrades_to_per_param():
    m = _port(6)
    r = Reducer(m.parameters(), find_unused_parameters=True)
    assert r.num_buckets == len([p for p in m.parameters()
                                 if p.requires_grad])


def test_tied_parameter_reduced_once():
    """A parameter used twice in one backward delivers two partial
    gradients: summed before its bucket fires, landing exactly once."""
    m = _port(7)
    dp = DataParallel(m, comm_buffer_size=1000)
    x, y = _batch(3)
    plain = _port(7)
    (_mse(plain, x, y) + _mse(plain, 2 * x, y)).backward()
    (_mse(dp, x, y) + _mse(dp, 2 * x, y)).backward()
    for (n, p), q in zip(m.named_parameters(), plain.parameters()):
        np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(),
                                   err_msg=n, **TOL)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    x, y = _batch(9, n=8)
    return x, y, run_world(
        2, "reducer", tmp_path_factory.mktemp("dp2"), x=x.tolist(),
        y=y.tolist(), state={k: v.tolist() for k, v in
                             _state(_jax_model(8)).items()})


@pytest.mark.parametrize("key", ["one_bucket", "per_param", "accumulated"])
def test_two_ranks_average_to_the_whole_batch(two_ranks, key):
    """Each rank backpropagates its half of an 8-row batch; the averaged
    gradients are the JAX model's on all 8 rows. The accumulated run: a
    no_sync backward of the rank's half (its own gradient kept), then a
    synced one (the average added): own half + whole batch."""
    x, y, ranks = two_ranks
    ref = _jax_grads(8, [(x, y)])
    for r, res in enumerate(ranks):
        want = ref
        if key == "accumulated":
            own = _jax_grads(8, [(x[4 * r:4 * r + 4], y[4 * r:4 * r + 4])])
            want = {n: own[n] + ref[n] for n in ref}
        for n, g in want.items():
            got = res[key][n]
            np.testing.assert_allclose(got.T if got.ndim == 2 else got, g,
                                       err_msg=f"rank {r} {n}", **TOL)
    assert ranks[0]["one_bucket_fires"] == (1, 1)
    assert ranks[0]["per_param_fires"] == (4, 4)
    assert ranks[0]["no_sync_fires"] == 0

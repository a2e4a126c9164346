"""The port's collectives (``paddle_tpu_torch.distributed.collective``)
at worlds 1, 2 and 4 of gloo processes on the CPU, held against the JAX
package's collectives on its 8-virtual-device mesh
(``tests/test_collective_api.py``'s cases: the product with negatives
and zeros, all-gather on an axis other than 0, ``split_group``, send /
recv, the object collectives; and every other collective of the API).

Each world runs once for this file (``tests/workers/torch_dist_worker.py``
through the port's launcher, a FileStore under tmp_path, one torch
thread a rank, a gloo timeout); each case below reads its results. The
JAX side runs each collective under ``shard_map`` on the same per-rank
inputs: rank r's block of a global array sharded over the mesh axis.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "workers"))
from torch_dist_worker import run_world  # noqa: E402

PROD_CASES = [[2.0, -3.0, 4.0, -5.0], [2.0, -3.0, 4.0, 5.0],
              [2.0, 0.0, 4.0, -5.0]]
WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: run_world(n, "collective", tmp_path_factory.mktemp(f"w{n}"),
                         prod_cases=PROD_CASES) for n in WORLDS}


def _x(r):
    return np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r


def _spmd(n, fn, blocks, out_spec=None):
    """The JAX package's collective ``fn`` over an n-device mesh axis "x",
    device r holding blocks[r]: each device's output, stacked."""
    from paddle_tpu.distributed.engine import _shard_map

    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    g = jdist.new_group(axis_names=("x",), nranks=n)

    def wrapped(v):
        with jdist.spmd_region():
            out = fn(paddle.Tensor(v[0], stop_gradient=True), g)
            val = out._value if hasattr(out, "_value") else out
            return val[None]

    stacked = np.stack(blocks)
    return np.asarray(jax.jit(_shard_map(
        wrapped, mesh, (P("x"),), P("x")))(stacked))


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("op", ["sum", "max", "min", "avg"])
def test_all_reduce_matches_jax(worlds, n, op):
    codes = {"sum": jdist.ReduceOp.SUM, "max": jdist.ReduceOp.MAX,
             "min": jdist.ReduceOp.MIN, "avg": jdist.ReduceOp.AVG}
    ref = _spmd(n, lambda t, g: jdist.all_reduce(t, op=codes[op], group=g),
                [_x(r) for r in range(n)])
    for r, res in enumerate(worlds[n]):
        np.testing.assert_allclose(res["all_reduce_" + op], ref[r],
                                   rtol=1e-6)


@pytest.mark.parametrize("case", range(len(PROD_CASES)))
def test_reduce_prod_negatives_and_zeros(worlds, case):
    """The JAX test's three products at world 4: 120, -120 and 0."""
    vals = PROD_CASES[case]
    ref = _spmd(4, lambda t, g: jdist.all_reduce(
        t, op=jdist.ReduceOp.PROD, group=g),
        [np.array([v], np.float32) for v in vals])
    for r, res in enumerate(worlds[4]):
        np.testing.assert_allclose(res[f"prod{case}"], ref[r], rtol=1e-5,
                                   atol=1e-6)
    assert float(worlds[4][0][f"prod{case}"][0]) == float(np.prod(vals))


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("axis", [0, 1])
def test_all_gather_any_axis(worlds, n, axis):
    ref = _spmd(n, lambda t, g: jdist.all_gather([], t, group=g, axis=axis),
                [_x(r) for r in range(n)])
    for r, res in enumerate(worlds[n]):
        np.testing.assert_array_equal(res[f"all_gather_axis{axis}"], ref[r])
        # the list entries are the members' tensors, in rank order
        parts = res["all_gather_parts"]
        assert len(parts) == n
        for i, p in enumerate(parts):
            np.testing.assert_array_equal(p, _x(i))


@pytest.mark.parametrize("n", WORLDS)
def test_reduce_scatter_and_all_to_all_match_jax(worlds, n):
    blocks = [np.arange(2 * n * 3, dtype=np.float32).reshape(2 * n, 3) + r
              for r in range(n)]
    rs = _spmd(n, lambda t, g: jdist.reduce_scatter(t, group=g), blocks)
    a2a = _spmd(n, lambda t, g: jdist.all_to_all(t, group=g), blocks)
    for r, res in enumerate(worlds[n]):
        np.testing.assert_array_equal(res["reduce_scatter"], rs[r])
        np.testing.assert_array_equal(res["reduce_scatter_list"], rs[r])
        np.testing.assert_array_equal(res["all_to_all"], a2a[r])
        np.testing.assert_array_equal(res["alltoall_single"], a2a[r])
        np.testing.assert_array_equal(
            np.concatenate(res["all_to_all_list"]), a2a[r])


@pytest.mark.parametrize("n", WORLDS)
def test_broadcast_scatter_ppermute_pmean(worlds, n):
    """broadcast from the last rank and scatter from rank 0 (global
    ranks: the world group's indices are the JAX axis indices), a ring
    ppermute and t_pmean, against the JAX package's."""
    blocks = [_x(r) for r in range(n)]
    bc = _spmd(n, lambda t, g: jdist.broadcast(t, src=n - 1, group=g),
               blocks)
    perm = [(i, (i + 1) % n) for i in range(n)]
    pp = _spmd(n, lambda t, g: jdist.collective.ppermute(t, perm, group=g),
               blocks)
    mean = _spmd(n, lambda t, g: jdist.collective.all_reduce_mean_value(
        t, group=g), blocks)
    for r, res in enumerate(worlds[n]):
        np.testing.assert_array_equal(res["broadcast"], bc[r])
        np.testing.assert_array_equal(res["ppermute"], pp[r])
        np.testing.assert_allclose(res["t_pmean"], mean[r], rtol=1e-6)
        np.testing.assert_array_equal(res["scatter"], _x(0) * (r + 1))


@pytest.mark.parametrize("n", (2, 4))
def test_split_group_reduces_over_its_members(worlds, n):
    """split_group(world, 2): contiguous pairs, as the JAX split of the
    world axis; an all-reduce sums over the pair only."""
    from paddle_tpu.distributed.engine import _shard_map

    jdist.collective._world.initialized = False
    jdist.init_parallel_env(Mesh(np.array(jax.devices()[:n]), ("world",)))
    sub = jdist.split_group(jdist.get_group(0), 2)
    mesh = jdist.collective.get_world_mesh()
    axes = jdist.get_group(0).axis_names

    def wrapped(v):
        with jdist.spmd_region():
            return jdist.all_reduce(paddle.Tensor(v, stop_gradient=True),
                                    group=sub)._value

    ref = np.asarray(jax.jit(_shard_map(wrapped, mesh, (P(axes),),
                                        P(axes)))(np.arange(n,
                                                            dtype=np.float32)))
    for r, res in enumerate(worlds[n]):
        ranks, val = res["split_group"]
        assert ranks == [r // 2 * 2, r // 2 * 2 + 1]
        np.testing.assert_array_equal(val, [ref[r]])


@pytest.mark.parametrize("n", WORLDS)
def test_send_recv(worlds, n):
    """World 1: the self send / recv loopback of the JAX test; more ranks:
    a batch_isend_irecv ring, each rank receiving its left neighbour's."""
    if n == 1:
        t = paddle.to_tensor(np.arange(4, dtype=np.float32))
        jdist.isend(t, dst=0)
        got = paddle.to_tensor(np.zeros(4, dtype=np.float32))
        jdist.irecv(got, src=0).wait()
        np.testing.assert_array_equal(np.asarray(got._value),
                                      np.arange(4, dtype=np.float32))
    for r, res in enumerate(worlds[n]):
        np.testing.assert_array_equal(res["p2p"], _x((r - 1) % n))


@pytest.mark.parametrize("n", WORLDS)
def test_object_collectives(worlds, n):
    if n == 1:
        out = jdist.all_gather_object([], {"r": 0})
        objs = [{"a": 1}]
        jdist.broadcast_object_list(objs, src=0)
        assert out == worlds[1][0]["all_gather_object"] == [{"r": 0}]
        assert objs == [{"a": 1}]
    for r, res in enumerate(worlds[n]):
        assert res["all_gather_object"] == [{"r": i} for i in range(n)]
        assert res["broadcast_object_list"] == [{"from": 0}]
        assert res["gather_object"] == ([10 * i for i in range(n)]
                                        if r == 0 else None)
        assert res["scatter_object_list"] == [2 * r, 2 * r + 1]
        if r == 0:
            assert len(res["gather"]) == n
            for i, t in enumerate(res["gather"]):
                np.testing.assert_array_equal(t, _x(i))
        else:
            assert res["gather"] is None


@pytest.mark.parametrize("n", WORLDS)
def test_collectives_book_the_comm_ledger(worlds, n):
    """An all-reduce and an all-gather of a [2, 3] f32 tensor: the JAX
    ledger's kinds and closed-form wire bytes on the "world" group; no
    host hop on CPU tensors. A world of one started by init_parallel_env
    has a process group, so its collectives run (and book, at 0 wire
    bytes)."""
    from paddle_tpu.observability import commledger as jcl

    for r, res in enumerate(worlds[n]):
        assert res["world"] == (r, n, "gloo")
        assert res["ledger"] == [
            ("psum", "world", n, 24, jcl.wire_bytes("psum", 24, n), 0),
            ("all_gather", "world", n, 24,
             jcl.wire_bytes("all_gather", 24, n), 0)]


@pytest.mark.parametrize("n", WORLDS)
def test_captures_stay_on_their_thread_and_reach_the_backward(worlds, n):
    """A capture books its own thread's collectives only, and those of a
    backward that autograd runs on another thread (a CUDA backward runs
    on autograd's device thread): an mp primitive's all-reduce of the
    gradient, and DataParallel's bucketed gradient all-reduce."""
    for res in worlds[n]:
        assert res["thread_ledgers"] == {
            "this_thread": ["psum"], "other_thread": [],
            "mp_backward": ["psum"], "dp_backward": ["psum"],
            "xg_grad": True}


def test_ranks_sharing_a_card_raise_without_gloo(monkeypatch):
    """Two local ranks on one card: init_parallel_env() (and
    backend="nccl") refuses before touching the card; a CUDA request
    with no card raises; neither falls back to the CPU."""
    from paddle_tpu_torch.distributed import collective as C

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="share 1 card"):
        C.init_parallel_env()
    with pytest.raises(RuntimeError, match="NCCL refuses"):
        C.init_parallel_env(backend="nccl")
    assert not C.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available"):
        C.init_parallel_env(backend="gloo")
    assert not C.is_initialized()


def test_world_of_one_is_identity_without_a_process_group():
    """No init_parallel_env: the world group has no process group, and
    every collective is the identity (the JAX package's world of 1)."""
    from paddle_tpu_torch.distributed import collective as C

    x = torch.arange(6.0).reshape(2, 3)
    g = C.get_group(0)
    assert g.process_group is None and g.nranks == 1
    for f in (C.t_psum, C.t_pmean, C.t_pmax, C.t_pmin, C.t_all_gather,
              C.t_psum_scatter, C.t_all_to_all):
        assert torch.equal(f(x, g), x)
    assert torch.equal(C.all_reduce(x.clone()), x)
    assert C.all_gather_object([], 5) == [5]

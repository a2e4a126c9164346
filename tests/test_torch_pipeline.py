"""The port's pipeline parallelism against the JAX package: ``SegmentLayers``
and ``PipelineLayer``'s partition, the 1F1B / interleaved 1F1B schedule,
and ``GPTForCausalLMPipe`` trained through ``fleet.distributed_model``
(``PipelineParallel.train_batch``) on gloo processes on the CPU.

- ``SegmentLayers``' parts, stages and chunks equal the JAX package's over
  a grid of (layers, pp, vpp) and both methods; the named-knob errors
  name the JAX checks' knobs.
- The schedule: each stage runs every (microbatch, chunk) forward and
  backward once, its warmup is the closed form, at most warmup + 1
  activations are alive on a stage, and the stages' orders together run
  to the end when each receive waits for its send (a simulation).
- A 4-layer GPT pipe (vocab 128, hidden 32, 4 heads, batch [8, 16],
  accumulate_steps 4) at pp 2, pp 2 x vpp 2, pp 4 and mp 2 x pp 2, from
  the JAX
  pipeline's weights (each rank loads its chunks, the mp slice on top;
  the export gathers them back bit for bit), 3 steps of AdamW
  (lr 1e-3): losses within 2e-4 (relative) of the JAX pipeline at the
  same degrees and of the port's degree 1; parameters by
  ``tests/test_torch_gpt.py``'s gate; the tied embedding's two copies
  bit-equal; ``eval_batch`` against the JAX ``eval_batch``; activation
  recompute bit-equal to the plain run; a masked loss keeps the whole
  batch's denominator.
- The dropout streams repeat under a seed and differ across blocks and
  microbatches (the JAX package seeds each scan tick instead: ROADMAP.md
  queue 3).
"""
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet
from paddle_tpu.distributed.fleet.meta_parallel import (
    LayerDesc as JLayerDesc, PipelineLayer as JPipelineLayer,
    SegmentLayers as JSegmentLayers)
from paddle_tpu.models import GPTForCausalLMPipe as JGPTPipe
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JCriterion

from paddle_tpu_torch.convert import export_jax_state_dict, load_jax_state_dict
from paddle_tpu_torch.distributed.engine import ParallelEngine
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, SegmentLayers)
from paddle_tpu_torch.distributed.fleet.meta_parallel import \
    pipeline_parallel as tpp
from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
    import pp_layers
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.optimizer import AdamW

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "workers"))
from torch_dist_worker import run_world  # noqa: E402

LOSS_RTOL = 2e-4
PARAM_TOL = 1e-4
TINY_GRAD = 1e-6
LR = 1e-3
STEPS = 3
M = 4
CFG = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=4,
           max_position_embeddings=32)
# name: (pp, vpp, mp)
DEGREES = {"pp2": (2, 1, 1), "pp2vpp2": (2, 2, 1), "pp4": (4, 1, 1),
           "mp2pp2": (2, 1, 2)}


def _reset():
    fleet._fleet_state.update(initialized=False, hcg=None, strategy=None)


def _batch():
    ids = np.random.RandomState(0).randint(0, 128, (8, 17))
    return ids[:, :-1], ids[:, 1:]


def _mask():
    # rows keep different token counts: a mean of microbatch means would
    # not be the batch's mean
    r = np.random.RandomState(5)
    keep = (r.rand(8, 16) < np.linspace(0.9, 0.2, 8)[:, None]) * 1.0
    keep[:, 0] = 1.0
    return keep


def _stacked(state, vpp):
    """The JAX pipeline's state at ``vpp`` virtual stages: each stacked
    ``blocks__*`` array [L, ...] as [vpp, L / vpp, ...]."""
    if vpp == 1:
        return dict(state)
    return {k: (v.reshape((vpp, v.shape[0] // vpp) + v.shape[1:])
                if k.startswith("blocks__") else v) for k, v in state.items()}


def _jax_run(state, pp, vpp, mp):
    """The JAX pipeline at (pp, vpp, mp): losses, final weights, eval
    loss."""
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {
        "dp_degree": 1, "mp_degree": mp, "pp_degree": pp,
        "pp_configs": {"num_virtual_pipeline_stages": vpp}}
    strategy.pipeline_configs = {"accumulate_steps": M,
                                 "micro_batch_size": 8 // M}
    _reset()
    fleet.init(is_collective=True, strategy=strategy)
    model = JGPTPipe(JGPTConfig(**CFG))
    model.set_state_dict(_stacked(state, vpp))
    dm = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(paddle.optimizer.AdamW(
        learning_rate=LR, parameters=model.parameters()))
    x, y = (paddle.to_tensor(a) for a in _batch())
    losses = [float(dm.train_batch([x, y], opt)) for _ in range(STEPS)]
    ev = float(dm.eval_batch([x, y]))
    final = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    _reset()
    return {"losses": losses, "final": final, "eval": ev}


def _port_degree1(state, masked=False):
    """The port's one-stage pipe through ParallelEngine on one process."""
    m = tg.GPTForCausalLMPipe(tg.GPTConfig(**CFG), num_stages=1,
                              device="cpu")
    load_jax_state_dict(m, state)
    crit = tg.GPTPretrainingCriterion()
    opt = AdamW(learning_rate=LR, parameters=m.named_parameters())
    step = ParallelEngine(m, opt, None).train_step(
        lambda mm, b: crit(mm(b["x"]), b["y"],
                           b["mask"] if masked else None))
    x, y = (torch.tensor(a) for a in _batch())
    b = {"x": x, "y": y, "mask": torch.tensor(_mask(), dtype=torch.float32)}
    losses = [float(step(b)) for _ in range(STEPS)]
    with torch.no_grad():
        logits = m(x).numpy()
    return {"losses": losses, "final": export_jax_state_dict(m),
            "logits": logits}


@pytest.fixture(scope="module")
def ref():
    _reset()
    paddle.seed(11)
    model = JGPTPipe(JGPTConfig(**CFG), num_stages=1)
    state = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    x, y = _batch()
    loss = JCriterion()(model(paddle.to_tensor(x)), paddle.to_tensor(y))
    loss.backward()
    grad0 = {n: np.asarray(p.grad._value)
             for n, p in model.named_parameters()}
    out = {"state": state, "grad0": grad0,
           "jax": {name: _jax_run(state, *deg)
                   for name, deg in DEGREES.items()},
           "port1": _port_degree1(state),
           "port1_masked": _port_degree1(state, masked=True)}
    return out


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    x, y = _batch()
    out = {}
    for name, (pp, vpp, mp) in DEGREES.items():
        runs = {"adamw": {"lr": LR, "steps": STEPS, "eval": True},
                "recompute": {"lr": LR, "steps": STEPS, "recompute": 1}}
        if name == "pp2vpp2":
            runs["masked"] = {"lr": LR, "steps": STEPS, "masked": True}
        state = _stacked(ref["state"], vpp)
        out[name] = run_world(
            pp * mp, "pipe", tmp_path_factory.mktemp(name),
            hybrid={"pp_degree": pp, "mp_degree": mp,
                    "pp_configs": {"num_virtual_pipeline_stages": vpp}},
            pipeline={"accumulate_steps": M, "micro_batch_size": 8 // M},
            cfg=CFG, state={k: v.tolist() for k, v in state.items()},
            x=x.tolist(), y=y.tolist(), mask=_mask().tolist(), runs=runs,
            runs_first="adamw")
    return out


def _gate(mine, final, grad0, lr):
    assert set(mine) == set(final)
    for k, want in final.items():
        got = np.asarray(mine[k]).reshape(want.shape)
        err = np.abs(got - want)
        tiny = np.abs(grad0[k].reshape(want.shape)) < TINY_GRAD
        assert err[~tiny].max(initial=0.0) <= PARAM_TOL, k
        assert err[tiny].max(initial=0.0) <= lr, k


# ---------------------------------------------------------------------------
# the partition
# ---------------------------------------------------------------------------
class _TBlock(torch.nn.Module):
    pass


class _JBlock(paddle.nn.Layer):
    pass


_TBlock.__name__ = _JBlock.__name__ = "Block"


class _TOther(torch.nn.Module):
    pass


class _JOther(paddle.nn.Layer):
    pass


def _descs(desc_cls, block, other, n):
    # an entry of another class first and last: the layer: method cuts
    # at the blocks only
    return [desc_cls(other)] + [desc_cls(block) for _ in range(n)] + \
        [desc_cls(other)]


GRID = [(L, pp, vpp) for L in (4, 6, 8, 12, 24) for pp in (1, 2, 3, 4)
        for vpp in (1, 2, 3) if L >= pp * vpp and (vpp == 1 or pp > 1)]


@pytest.mark.parametrize("L,pp,vpp", GRID)
@pytest.mark.parametrize("method", ["uniform", "layer:Block"])
def test_segment_layers_match_the_jax_package(L, pp, vpp, method):
    mine = SegmentLayers(_descs(LayerDesc, _TBlock, _TOther, L), pp, method,
                         vpp if vpp > 1 else None)
    theirs = JSegmentLayers(_descs(JLayerDesc, _JBlock, _JOther, L), pp,
                            method, vpp if vpp > 1 else None)
    if method != "uniform" and L % (pp * vpp):
        for seg in (mine, theirs):
            with pytest.raises(Exception, match="divisible"):
                seg.do_segment()
        return
    assert mine.do_segment() == theirs.do_segment()
    parts = range(pp * vpp)
    assert [mine.part_stage(j) for j in parts] == \
        [theirs.part_stage(j) for j in parts]
    assert [mine.part_chunk(j) for j in parts] == \
        [theirs.part_chunk(j) for j in parts]


@pytest.mark.parametrize("pp,vpp", [(2, 1), (2, 2), (4, 1), (2, 3)])
def test_pipeline_layer_owns_the_round_robin_chunks(pp, vpp):
    L = 12
    K = L // (pp * vpp)
    owned = []
    for s in range(pp):
        pl = PipelineLayer([LayerDesc(torch.nn.Identity) for _ in range(L)],
                           num_stages=pp, num_virtual_pipeline_stages=vpp,
                           stage_id=s)
        jl = JPipelineLayer([JLayerDesc(paddle.nn.Identity)
                             for _ in range(L)], num_stages=pp,
                            num_virtual_pipeline_stages=vpp)
        assert pl.segment_parts == jl.segment_parts
        assert pl.segment_part_stages == jl.segment_part_stages
        assert pl.segment_part_chunks == jl.segment_part_chunks
        assert pl.get_num_stages() == pp
        assert pl.get_num_virtual_stages() == vpp
        for v in range(vpp):
            want = list(range(v * L // vpp + s * K, v * L // vpp + (s + 1) * K))
            assert pl.chunk_blocks[v] == want
        assert sorted(int(k) for k in pl.blocks) == sorted(
            sum(pl.chunk_blocks, []))
        owned += sum(pl.chunk_blocks, [])
    assert sorted(owned) == list(range(L))


def _message(fn):
    with pytest.raises(Exception) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["indivisible", "vpp_without_pp",
                                  "recompute_interval"])
def test_errors_name_the_jax_knobs(case):
    kw = {"indivisible": dict(n=6, num_stages=2,
                              num_virtual_pipeline_stages=2),
          "vpp_without_pp": dict(n=4, num_stages=1,
                                 num_virtual_pipeline_stages=2),
          "recompute_interval": dict(n=4, num_stages=2,
                                     recompute_interval=2)}[case]
    n = kw.pop("n")
    mine = _message(lambda: PipelineLayer(
        [LayerDesc(torch.nn.Identity) for _ in range(n)], stage_id=0, **kw))
    theirs = _message(lambda: JPipelineLayer(
        [JLayerDesc(paddle.nn.Identity) for _ in range(n)], **kw))
    knobs = {"indivisible": ["pp_degree", "num_virtual_pipeline_stages",
                             "num_layers"],
             "vpp_without_pp": ["pp_degree", "num_virtual_pipeline_stages"],
             "recompute_interval": ["recompute_interval"]}[case]
    for k in knobs:
        assert k in theirs and k in mine, (k, mine)


def test_accumulate_steps_not_multiple_of_pp_names_the_knobs():
    msg = _message(lambda: tpp.schedule(2, 0, 3, 2))
    assert "accumulate_steps" in msg and "(3)" in msg and "pp_degree" in msg


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------
SCHEDULES = [(S, Mb, V) for S in (2, 3, 4) for Mb in (1, 2, 4, 8)
             for V in (1, 2, 3) if V == 1 or Mb % S == 0]


def _simulate(S, Mb, V):
    """Run every stage's order, a step at a time, where a forward of
    virtual stage vs waits for vs - 1's forward of its microbatch and a
    backward for vs + 1's backward; True when every stage ends."""
    orders = [list(tpp.schedule(S, s, Mb, V)) for s in range(S)]
    done = set()
    pos = [0] * S
    last = S * V - 1
    progress = True
    while progress:
        progress = False
        for s in range(S):
            if pos[s] == len(orders[s]):
                continue
            kind, m, v = orders[s][pos[s]]
            vs = v * S + s
            if kind == "F":
                ready = vs == 0 or ("F", m, vs - 1) in done
            else:
                ready = ("F", m, vs) in done and (
                    vs == last or ("B", m, vs + 1) in done)
            if ready:
                done.add((kind, m, vs))
                pos[s] += 1
                progress = True
    return all(pos[s] == len(orders[s]) for s in range(S))


@pytest.mark.parametrize("S,Mb,V", SCHEDULES)
def test_schedule_against_its_closed_form(S, Mb, V):
    for s in range(S):
        ops = tpp.schedule(S, s, Mb, V)
        fwd = [(m, v) for k, m, v in ops if k == "F"]
        bwd = [(m, v) for k, m, v in ops if k == "B"]
        every = sorted((m, v) for m in range(Mb) for v in range(V))
        assert sorted(fwd) == every and sorted(bwd) == every
        warm = (min(S - s - 1, Mb) if V == 1
                else min((S - s - 1) * 2 + (V - 1) * S, Mb * V))
        assert tpp.warmup_count(S, s, Mb, V) == warm
        lead = 0
        while lead < len(ops) and ops[lead][0] == "F":
            lead += 1
        assert lead == min(warm + 1, Mb * V)
        assert tpp.peak_live(ops) == min(warm + 1, Mb * V)
        # each backward follows its own forward; the chunks of a
        # microbatch run forward in order and backward in reverse
        seen = set()
        for k, m, v in ops:
            if k == "F":
                seen.add((m, v))
            else:
                assert (m, v) in seen
        if V == 1:
            # Paddle's 1F1B: the k-th forward and backward on microbatch k
            assert fwd == [(m, 0) for m in range(Mb)]
            assert bwd == [(m, 0) for m in range(Mb)]
    assert _simulate(S, Mb, V)


def test_pipeline_over_nccl_raises_citing_its_item():
    """NCCL ignores p2p tags: the schedule refuses an NCCL pp group."""
    class Group:
        backend, nranks = "nccl", 2

    class Hcg:
        def get_pipe_parallel_world_size(self):
            return 2

        def get_pipe_parallel_group(self):
            return Group()

    pp = tpp.PipelineParallel.__new__(tpp.PipelineParallel)
    object.__setattr__(pp, "_hcg", Hcg())
    with pytest.raises(NotImplementedError, match="item 8.1"):
        pp._peers()


def test_bubble_closed_form():
    for S, Mb, V in SCHEDULES:
        assert tpp.bubble(S, Mb, V) == (S - 1) / (V * Mb + S - 1)


# ---------------------------------------------------------------------------
# GPT pipe training against the JAX pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("degrees", sorted(DEGREES))
def test_losses_and_params_match_the_jax_pipeline(ref, ranks, degrees):
    jx = ref["jax"][degrees]
    d1 = ref["port1"]
    for res in ranks[degrees]:
        got = res["adamw"]
        np.testing.assert_allclose(got["losses"], jx["losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], d1["losses"],
                                   rtol=LOSS_RTOL)
        assert got["losses"][-1] < got["losses"][0]
        _gate(got["final"], jx["final"], ref["grad0"], LR)
        _gate(got["final"], d1["final"], ref["grad0"], LR)


@pytest.mark.parametrize("degrees", sorted(DEGREES))
def test_every_rank_holds_its_chunks_and_round_trips(ref, ranks, degrees):
    pp, vpp, _ = DEGREES[degrees]
    L = CFG["num_layers"]
    K = L // (pp * vpp)
    for res in ranks[degrees]:
        s = res["coords"]["pp"]
        assert res["round_trip"]
        shapes = res["local_shapes"]
        blocks = sorted({int(k.split(".")[1]) for k in shapes
                         if k.startswith("blocks.")})
        want = sorted(v * L // vpp + s * K + i for v in range(vpp)
                      for i in range(K))
        assert blocks == want
        assert any(k.startswith("prologue.") for k in shapes) == (s == 0) \
            or pp == 1
        has_head = any(k.startswith("epilogue.") for k in shapes)
        assert has_head == (s == pp - 1)


@pytest.mark.parametrize("degrees", sorted(DEGREES))
def test_tied_copies_equal_and_eval(ref, ranks, degrees):
    """eval_batch's loss against the JAX eval_batch; without the loss the
    last stage's logits (its vocab shard under mp) against degree 1's
    forward at its final weights, None on the other stages."""
    pp, _, mp = DEGREES[degrees]
    want = ref["port1"]["logits"]
    for res in ranks[degrees]:
        assert res["adamw"]["tied_equal"]
        np.testing.assert_allclose(res["adamw"]["eval"],
                                   ref["jax"][degrees]["eval"],
                                   rtol=LOSS_RTOL)
        got = res["adamw"]["eval_logits"]
        if res["coords"]["pp"] != pp - 1:
            assert got is None
            continue
        v = want.shape[-1] // mp
        r = res["coords"]["mp"]
        np.testing.assert_allclose(got, want[..., r * v:(r + 1) * v],
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("degrees", sorted(DEGREES))
def test_recompute_is_bit_equal_and_schedule_ran(ranks, degrees):
    pp, vpp, _ = DEGREES[degrees]
    for res in ranks[degrees]:
        s = res["coords"]["pp"]
        assert res["recompute"]["losses"] == res["adamw"]["losses"]
        for k, v in res["adamw"]["final"].items():
            np.testing.assert_array_equal(res["recompute"]["final"][k], v)
        assert [tuple(o) for o in res["adamw"]["schedule"]] == \
            tpp.schedule(pp, s, M, vpp)
        assert res["adamw"]["bubble"] == (pp - 1) / (vpp * M + pp - 1)


def test_masked_loss_keeps_the_batch_denominator(ref, ranks):
    d1 = ref["port1_masked"]
    for res in ranks["pp2vpp2"]:
        got = res["masked"]
        np.testing.assert_allclose(got["losses"], d1["losses"],
                                   rtol=LOSS_RTOL)
        _gate(got["final"], d1["final"], ref["grad0"], LR)


# ---------------------------------------------------------------------------
# staged p2p (ranks sharing a card stage p2p through pinned memory)
# ---------------------------------------------------------------------------
def test_staged_p2p_task_books_its_parts(monkeypatch):
    """A staged p2p task holds its host buffer until ``wait``, then books
    the wait for its transfer as gloo seconds and the copy back as
    host-to-device seconds (``staging_stats``); an unstaged task books
    nothing, and a second ``wait`` does nothing."""
    from paddle_tpu_torch.distributed import collective as C

    clock = iter(range(100))
    monkeypatch.setattr(C.time, "perf_counter", lambda: float(next(clock)))
    monkeypatch.setattr(C, "_world", C._World())

    class Work:
        waited = False

        def wait(self):
            self.waited = True

    work, buf, landed = Work(), torch.zeros(6), []
    task = C._Task(torch.zeros(6), work, lambda: landed.append(1), buf,
                   staged=True)
    assert task._buf is buf and not landed
    task.wait()
    assert work.waited and landed == [1] and task._buf is None
    st = C.staging_stats()
    assert (st["d2h_seconds"], st["gloo_seconds"], st["h2d_seconds"],
            st["seconds"]) == (0.0, 1.0, 1.0, 2.0)
    C._Task(torch.zeros(6), Work(), lambda: landed.append(2)).wait()
    task.wait()
    assert landed == [1, 2] and C.staging_stats()["seconds"] == 2.0


# ---------------------------------------------------------------------------
# dropout streams
# ---------------------------------------------------------------------------
def test_dropout_seed_unique_over_blocks_and_microbatches():
    seeds = {pp_layers.dropout_seed(7, b, m) for b in range(-2, 48)
             for m in range(64)}
    assert len(seeds) == 50 * 64
    assert pp_layers.dropout_seed(7, 3, 5) == pp_layers.dropout_seed(7, 3, 5)
    assert pp_layers.dropout_seed(7, 3, 5) != pp_layers.dropout_seed(8, 3, 5)


def test_dropout_masks_repeat_and_differ():
    cfg = tg.GPTConfig(**dict(CFG, hidden_dropout=0.3))

    def chunk_out(seed, mb, model=None):
        m = model or tg.GPTForCausalLMPipe(cfg, num_stages=1, device="cpu",
                                           seed=seed)
        m.train()
        ids = torch.tensor(_batch()[0][:2])
        with torch.no_grad():
            return m.run_chunk(0, ids, mb)

    a = chunk_out(3, 0)
    assert torch.equal(a, chunk_out(3, 0))           # repeats under a seed
    assert not torch.equal(a, chunk_out(3, 1))       # differs by microbatch
    assert not torch.equal(a, chunk_out(4, 0))       # and by seed
    # two blocks with one weight set see different masks on one input
    m = tg.GPTForCausalLMPipe(cfg, num_stages=1, device="cpu", seed=3)
    m.blocks["1"].load_state_dict(m.blocks["0"].state_dict())
    m.train()
    x = torch.randn(2, 16, CFG["hidden_size"])
    with torch.no_grad():
        outs = [m._block(i, x) for i in (0, 1)]
    assert not torch.equal(outs[0], outs[1])
    m.eval()
    with torch.no_grad():
        outs = [m._block(i, x) for i in (0, 1)]
    assert torch.equal(outs[0], outs[1])

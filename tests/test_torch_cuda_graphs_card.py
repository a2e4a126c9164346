"""CUDA graphs of the port's step bodies against their eager runs, on the
card.

    python -m pytest tests/test_torch_cuda_graphs_card.py -m cuda -q

Without a card every test here skips with a reason (decided inside the
``cuda`` fixture, never at import). A reduced Llama in fp32 with TF32 off
runs ``Predictor.generate`` (static and paged caches, ragged rows) and a
``ServingEngine`` (legacy and chunked rounds, arrivals mid-run, a stream
longer than the batch) graphed and under ``eager()``: the token streams
must be equal bit for bit, greedy, top-k/top-p sampled from one seed and
with an EOS, and so must the kernel launch counts, counted through the
replays. A second call with a key captures no new graph, a replay after
the host changed the table (a finished row backfilled) reads the new
table, and a capture that fails raises. The CPU tests of the same code
are in tests/test_torch_cuda_graphs.py.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.compile_stats import CompileStats
from paddle_tpu_torch.core.cuda_graphs import StepGraphs, eager
from paddle_tpu_torch.inference import Config, ServingEngine, create_predictor
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import rms_norm as K3

pytestmark = pytest.mark.cuda

LENS = [40, 130, 75]
N_NEW = 10
SAMPLED = dict(temperature=0.9, top_k=40, top_p=0.9, seed=7)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the port's kernels "
                    "run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def model(cuda):
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=2, intermediate_size=512,
                      max_position_embeddings=512, dtype="float32")
    return LlamaForCausalLM(cfg, device=cuda, seed=1)


def _ids(lens, seed):
    r = np.random.RandomState(seed)
    ids = np.zeros((len(lens), max(lens)), np.int64)
    for b, n in enumerate(lens):
        ids[b, :n] = r.randint(1, 512, n)
    return ids


def _counted(fn):
    """fn()'s result and the kernel launches it counted, by wrapper."""
    n0 = kernels.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {f.__name__: n - n0[f]
                 for f, n in kernels.launch_counts().items() if n != n0[f]}


def _predictor(model, page):
    conf = Config().set_model(model)
    if page:
        conf.enable_paged_kv(page)
    return create_predictor(conf)


@pytest.mark.parametrize("mode", ["greedy", "sampled", "eos"])
@pytest.mark.parametrize("page", [None, 16], ids=["static", "paged"])
def test_generate_graphed_equals_eager(model, page, mode):
    pred = _predictor(model, page)

    def gen(**kw):
        return pred.generate(_ids(LENS, 3), max_new_tokens=N_NEW,
                             lengths=LENS, **kw).cpu().numpy()

    kw = {"greedy": {}, "sampled": SAMPLED}.get(mode)
    if kw is None:
        with eager():
            free = gen()
        kw = {"eos_token_id": int(free[1, -6])}   # row 1 stops at token 5
    first, n_first = _counted(lambda: gen(**kw))
    assert pred.stats.captures["decode"] == 1
    assert pred.stats.replays["decode"] == N_NEW - 2
    second, n_second = _counted(lambda: gen(**kw))
    assert pred.stats.captures["decode"] == 1       # no new graph
    assert pred.stats.replays["decode"] == 2 * N_NEW - 3
    with eager():
        ref, n_ref = _counted(lambda: gen(**kw))
    assert pred.stats.replays["decode"] == 2 * N_NEW - 3
    np.testing.assert_array_equal(first, ref)
    np.testing.assert_array_equal(second, ref)
    assert n_first == n_second == n_ref
    assert n_ref[K3.rms_norm.__name__] == \
        (2 * model.config.num_layers + 1) * N_NEW
    if mode == "eos":
        assert (ref[1, -6:] == kw["eos_token_id"]).all()


def _serve(model, mode, chunked, gen_kw):
    conf = Config().set_model(model).enable_paged_kv(16)
    conf.max_length = 512
    for k, v in gen_kw.items():
        setattr(conf.generation, k, v)
    eng = ServingEngine(create_predictor(conf), max_batch=2,
                        prefill_chunk=64 if chunked else None)
    prompts = [np.random.RandomState(s).randint(1, 512, (L,))
               for s, L in enumerate([30, 150, 70, 9, 100])]
    n_new = [3, 12, 6, 8, 5]

    def run():
        rids = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts[:3], n_new[:3])]
        for _ in range(3):
            eng.step()
        rids += [eng.submit(p, max_new_tokens=n)
                 for p, n in zip(prompts[3:], n_new[3:])]
        done = eng.run()
        return [list(done[r].new_tokens) for r in rids]

    if mode == "eager":
        with eager():
            return _counted(run) + (eng,)
    return _counted(run) + (eng,)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("chunked", [False, True], ids=["legacy", "chunked"])
def test_serve_graphed_equals_eager(model, chunked, sampled):
    """Five requests over two slots, two arriving mid-run: rows finish and
    are backfilled between replays, so the replayed rounds read tables,
    tokens and positions the host changed after the capture."""
    gen_kw = SAMPLED if sampled else {}
    toks, n, eng = _serve(model, "graphed", chunked, gen_kw)
    ref, n_ref, _ = _serve(model, "eager", chunked, gen_kw)
    assert toks == ref
    assert n == n_ref
    sites = ("unified", "serve_decode") if chunked else ("serve_decode",)
    for site in sites:
        assert eng.stats.captures[site] == eng.stats.keys(site) == 1
    assert eng.stats.replays["serve_decode"] == eng.rounds["decode"] - 1
    if chunked:
        assert eng.stats.replays["unified"] == eng.rounds["unified"] - 1


def test_replay_reads_a_backfilled_table(model):
    """A legacy engine with one slot: each request is prefilled eagerly,
    then decoded by replays of the one graph captured for the first
    request, after the previous request's row was evicted and the slot's
    table row rewritten with other pages. The tokens equal an eager
    engine's on the same requests."""
    prompts = [np.random.RandomState(20 + i).randint(1, 512, (L,))
               for i, L in enumerate([50, 20, 90])]
    out = {}
    for mode in ("graphed", "eager"):
        conf = Config().set_model(model).enable_paged_kv(16)
        conf.max_length = 512
        eng = ServingEngine(create_predictor(conf), max_batch=1)
        tables = []
        decode_round = eng._decode_round

        def watched():
            tables.append(tuple(eng.tables[0]))
            decode_round()

        eng._decode_round = watched
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        if mode == "eager":
            with eager():
                done = eng.run()
        else:
            done = eng.run()
            assert eng.stats.captures["serve_decode"] == 1
            assert eng.stats.replays["serve_decode"] == \
                eng.rounds["decode"] - 1
            assert len(set(tables)) == 3       # one table row a request
        out[mode] = [done[r].new_tokens for r in rids]
    assert out["graphed"] == out["eager"]


@pytest.fixture(scope="module")
def draft_model(cuda):
    cfg = LlamaConfig(vocab_size=512, hidden_size=128, num_layers=1,
                      num_heads=2, num_kv_heads=1, intermediate_size=256,
                      max_position_embeddings=512, dtype="float32")
    return LlamaForCausalLM(cfg, device=cuda, seed=2)


def _engine(model, **kw):
    conf = Config().set_model(model).enable_paged_kv(16)
    conf.max_length = 512
    return ServingEngine(create_predictor(conf), max_batch=2,
                         prefill_chunk=64, prefix_cache=True,
                         debug_invariants=True, **kw)


SYS = np.random.RandomState(30).randint(1, 512, (64,))   # 4 pages of 16


def _shared_prefix_run(eng):
    """A 64-token system prompt: the first request is it plus a tail, the
    later ones share it (one a full hit, whose refeed copies a page)."""
    tails = [np.random.RandomState(31 + i).randint(1, 512, (L,))
             for i, L in enumerate([20, 0, 45, 7])]
    prompts = [np.concatenate([SYS, t]) for t in tails]
    rids = [eng.submit(prompts[0], max_new_tokens=9)]
    for _ in range(3):
        eng.step()
    rids += [eng.submit(p, max_new_tokens=n)
             for p, n in zip(prompts[1:], [7, 11, 5])]
    done = eng.run()
    return [list(done[r].new_tokens) for r in rids]


def test_spec_prefix_graphs_replay_equal_eager(model, draft_model):
    """The verify step (unified_spec), the draft's proposal steps
    (draft_propose) and its chunk feed (draft_chunk) replay their graphs
    with the eager run's tokens and launches, over shared pages and a
    copy-on-write; the committed tokens equal the plain engine's."""
    spec = dict(draft_predictor=create_predictor(
        Config().set_model(draft_model).enable_paged_kv(16)), spec_tokens=3)
    eng = _engine(model, **spec)
    toks, n = _counted(lambda: _shared_prefix_run(eng))
    ref_eng = _engine(model, **spec)
    with eager():
        ref, n_ref = _counted(lambda: _shared_prefix_run(ref_eng))
    plain_eng = _engine(model)
    with eager():
        plain = _shared_prefix_run(plain_eng)
    assert toks == ref == plain
    assert n == n_ref
    for site in ("unified_spec", "draft_propose", "draft_chunk"):
        assert eng.stats.captures[site] == eng.stats.keys(site) == 1
        assert eng.stats.replays[site] == eng.rounds[site] - 1 > 0
        assert ref_eng.stats.replays[site] == 0
    assert eng.rounds["decode"] == eng.rounds["unified"] == 0
    assert eng.prefix_cache_stats()["cow"] >= 1
    assert eng.prefix_cache_stats()["hits"] >= 3 * 4
    eng.check_invariants()


def test_cow_between_replays_keeps_graphs_valid(model):
    """A copy-on-write after the unified and decode graphs were captured
    writes the pools in place between two replays: the later replays
    read the copied page and the tokens equal an eager engine's."""
    eng = _engine(model)
    seen = []
    copy_page = eng._copy_page

    def watched(src, dst):
        if src != dst:            # not the constructor's no-op copy
            seen.append((eng.stats.captures["unified"],
                         eng.stats.replays["unified"],
                         eng.stats.replays["serve_decode"]))
        copy_page(src, dst)

    eng._copy_page = watched
    toks = _shared_prefix_run(eng)
    with eager():
        ref = _shared_prefix_run(_engine(model))
    assert toks == ref
    assert seen and eng.prefix_cache_stats()["cow"] == len(seen)
    # each copy came after the captures and between replays
    assert all(cap == 1 and rep + dec > 0 for cap, rep, dec in seen)
    assert eng.stats.replays["unified"] > seen[-1][1]


# last: a failed capture on purpose
def test_capture_failure_raises(cuda):
    """A body that reads a value back to the host cannot be captured: the
    step raises, keeps no graph, and the launch counters stay as they
    were; it does not quietly run the body eagerly instead."""
    stats = CompileStats()
    g = StepGraphs(cuda, stats)
    g.buffers("site", 0, lambda: torch.zeros(4, device=cuda))

    def body(buf):
        K3.rms_norm.launches += 1           # as a wrapper counts a launch
        buf.add_(1)
        if buf.sum().item() > 1e9:          # a host sync
            buf.zero_()

    n0 = kernels.launch_counts()
    with pytest.raises(RuntimeError):
        g.step("site", 0, body)
    torch.cuda.synchronize()
    # the warmup ran the step once, eagerly; the capture counted nothing
    assert K3.rms_norm.launches == n0[K3.rms_norm] + 1
    assert g._entries[("site", 0)].graph is None
    assert stats.captures == {}
    K3.rms_norm.launches = n0[K3.rms_norm]

"""The port's crash-consistent checkpoints (``paddle_tpu_torch.distributed.
checkpoint`` and ``ParallelEngine.save_checkpoint`` / ``restore_checkpoint``)
held against the JAX package's on the CPU.

Across packages, from the same seeds: the JAX engine trains ``gpt_tiny``
(fp32, AdamW) 3 steps and saves; the port's engine restores it, and the
reverse. Restored parameters and moments equal the other package's
arrays exactly (``nn.Linear`` weights and their moments transposed), the
recorded crc32s of equal tensors are equal, and 2 more steps on each
side stay within ``tests/test_torch_gpt.py``'s gates (losses 1e-5
relative; parameters 1e-4, or the learning rate where the step's first
gradient is under 1e-6). A bf16 model with f32 masters round-trips both
ways, and a process that cannot import ``ml_dtypes`` reads and writes
bf16 checkpoints. Within the port: the crash matrix of
``tests/test_fault_tolerance.py`` (the four ``ckpt.*`` failpoints, a
corrupted shard, a flipped bit), ``CheckpointManager`` retention and
its async writer, an async save followed at once by an in-place step,
and a resume that reproduces an uninterrupted run bit for bit with
dropout on.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.engine import ParallelEngine as JEngine
from paddle_tpu.models import gpt as jg
from paddle_tpu_torch.convert import (_linear_weights, export_jax_state_dict,
                                      load_jax_state_dict)
from paddle_tpu_torch.distributed import failpoints as fp
from paddle_tpu_torch.distributed.checkpoint import (CheckpointCorruptError,
                                                     CheckpointManager,
                                                     is_committed,
                                                     latest_committed,
                                                     load_state_dict,
                                                     resolve_committed,
                                                     save_state_dict,
                                                     wait_async_saves)
from paddle_tpu_torch.distributed.engine import ParallelEngine
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW, lr

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4
LR = 1e-3
TINY_GRAD = 1e-6
B, S = 4, 16
CKPT_FAILPOINTS = ("ckpt.write_shard", "ckpt.write_metadata",
                   "ckpt.commit", "ckpt.rename")


@pytest.fixture(autouse=True)
def _clean_failpoints():
    fp.clear()
    yield
    fp.clear()


def _ids(step, vocab):
    ids = np.random.RandomState(100 + step).randint(0, vocab, (B, S + 1))
    return ids[:, :-1], ids[:, 1:]


# ---------------------------------------------------------------------------
# the two packages' engines
# ---------------------------------------------------------------------------
def _jax_engine(seed, dtype="float32"):
    paddle.seed(seed)
    cfg = jg.gpt_tiny(dtype=dtype)
    model = jg.GPTForCausalLM(cfg)
    crit = jg.GPTPretrainingCriterion(cfg)
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=model.parameters(),
                                 multi_precision=dtype != "float32")
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1}
    hcg = jfleet.init(is_collective=True, strategy=strategy)
    eng = JEngine(model, opt, hcg.mesh)
    step = eng.train_step(lambda m, b: crit(m(b["x"]), b["y"]))

    def run(i):
        x, y = _ids(i, cfg.vocab_size)
        return float(step({"x": paddle.to_tensor(x),
                           "y": paddle.to_tensor(y)}))

    return model, opt, eng, run


def _port_engine(seed, dtype="float32"):
    cfg = tg.gpt_tiny(dtype=dtype)
    model = tg.GPTForCausalLM(cfg, device="cpu", seed=seed)
    crit = tg.GPTPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=LR, parameters=model.named_parameters(),
                multi_precision=dtype != "float32")
    eng = ParallelEngine(model, opt)
    step = eng.train_step(lambda m, b: crit(m(b["x"]), b["y"]))

    def run(i):
        x, y = _ids(i, cfg.vocab_size)
        return float(step({"x": x, "y": y}))

    return model, opt, eng, run


def _jax_params(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


def _jax_slots(model, opt):
    """{name.slot: array} of the JAX optimizer, masters included."""
    out = {}
    for n, p in model.named_parameters():
        for k, v in (opt._states.get(id(p)) or {}).items():
            out[f"{n}.{k}"] = np.asarray(v)
        if id(p) in opt._master_weights:
            out[f"{n}.master_weight"] = np.asarray(
                opt._master_weights[id(p)])
    return out


def _port_slots(model, opt):
    """The port's slots in the JAX layout, as numpy (bf16 as its bits)."""
    linear = _linear_weights(model)
    out = {}
    for n, p in model.named_parameters():
        st = dict(opt._states.get(id(p)) or {})
        if id(p) in opt._master_weights:
            st["master_weight"] = opt._master_weights[id(p)]
        for k, v in st.items():
            v = v.detach()
            out[f"{n}.{k}"] = (v.t() if n in linear else v).numpy()
    return out


def _bits(arr):
    """An array's bit image (bf16 as uint16), for exact comparisons."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        return np.ascontiguousarray(arr).view(np.uint16)
    return arr


def _port_bits(model):
    linear = _linear_weights(model)
    out = {}
    for n, p in model.named_parameters():
        t = p.detach().t() if n in linear else p.detach()
        t = t.contiguous()
        out[n] = (t.view(torch.int16).numpy().view(np.uint16)
                  if t.dtype == torch.bfloat16 else t.numpy())
    return out


def _checksums(path):
    with open(os.path.join(path, "0.metadata")) as f:
        return json.load(f)["checksums"]


def _gated(mine, ref, grad):
    """test_torch_gpt.py's parameter gate."""
    for k, r in ref.items():
        err = np.abs(mine[k] - r)
        tiny = np.abs(grad[k]) < TINY_GRAD
        assert err[~tiny].max(initial=0.0) <= PARAM_TOL, k
        assert err[tiny].max(initial=0.0) <= LR, k


def _port_grad(model, i):
    """The port model's gradient at step ``i``'s batch, in the JAX
    layout (the gate's mask); leaves no gradient behind."""
    crit = tg.GPTPretrainingCriterion(model.config)
    x, y = (torch.tensor(a) for a in _ids(i, model.config.vocab_size))
    crit(model(x), y).backward()
    linear = _linear_weights(model)
    out = {n: (p.grad.t() if n in linear else p.grad).numpy().copy()
           for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return out


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """The JAX engine: init weights, 3 steps, a checkpoint, 2 more."""
    path = str(tmp_path_factory.mktemp("jax") / "ck")
    model, opt, eng, run = _jax_engine(42)
    init = _jax_params(model)
    first = [run(i) for i in range(3)]
    eng.save_checkpoint(path)
    saved = (_jax_params(model), _jax_slots(model, opt))
    second = [run(i) for i in range(3, 5)]
    return dict(path=path, init=init, first=first, saved=saved,
                second=second, final=_jax_params(model))


def test_jax_checkpoint_restores_into_the_port_exactly(jax_saved,
                                                       tmp_path):
    model, opt, eng, run = _port_engine(seed=7)
    meta = eng.restore_checkpoint(jax_saved["path"])
    assert meta["step"] == 3 and opt._step_count == 3
    params, slots = jax_saved["saved"]
    mine = export_jax_state_dict(model)
    assert set(mine) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    got = _port_slots(model, opt)
    assert set(got) == set(slots) and slots
    for k, v in slots.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the same values give the same bytes, so the same crc32s
    eng.save_checkpoint(str(tmp_path / "again"))
    ref, again = _checksums(jax_saved["path"]), _checksums(
        str(tmp_path / "again"))
    shared = [k for k in ref if k.startswith(("model.", "optim."))]
    assert shared and set(shared) == {k for k in again
                                      if k.startswith(("model.", "optim."))}
    assert all(ref[k] == again[k] for k in shared)
    # training continues within the GPT gates
    grad = _port_grad(model, 3)
    losses = [run(i) for i in range(3, 5)]
    np.testing.assert_allclose(losses, jax_saved["second"],
                               rtol=LOSS_RTOL, atol=0)
    _gated(export_jax_state_dict(model), jax_saved["final"], grad)


def test_port_checkpoint_restores_into_jax_exactly(jax_saved, tmp_path):
    path = str(tmp_path / "ck")
    model, opt, eng, run = _port_engine(seed=7)
    load_jax_state_dict(model, jax_saved["init"])
    first = [run(i) for i in range(3)]
    np.testing.assert_allclose(first, jax_saved["first"], rtol=LOSS_RTOL,
                               atol=0)
    eng.save_checkpoint(path)
    jmodel, jopt, jeng, jrun = _jax_engine(99)
    meta = jeng.restore_checkpoint(path)
    assert meta["step"] == 3 and jopt._step_count == 3
    mine, got = export_jax_state_dict(model), _jax_params(jmodel)
    assert set(mine) == set(got)
    for k in mine:
        np.testing.assert_array_equal(got[k], mine[k], err_msg=k)
    want, jslots = _port_slots(model, opt), _jax_slots(jmodel, jopt)
    assert set(want) == set(jslots)
    for k in want:
        np.testing.assert_array_equal(jslots[k], want[k], err_msg=k)
    grad = _port_grad(model, 3)
    mine_losses = [run(i) for i in range(3, 5)]
    np.testing.assert_allclose([jrun(i) for i in range(3, 5)], mine_losses,
                               rtol=LOSS_RTOL, atol=0)
    _gated(export_jax_state_dict(model), _jax_params(jmodel), grad)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bf16_with_f32_masters_round_trips_across_packages(writer,
                                                           tmp_path):
    """bf16 parameters (their bits) and f32 masters and moments, one
    step in, carried from one package's engine to the other's."""
    path = str(tmp_path / "ck")
    pm, popt, peng, prun = _port_engine(seed=7, dtype="bfloat16")
    jm, jopt, jeng, jrun = _jax_engine(42, dtype="bfloat16")
    if writer == "port":
        prun(0)
        peng.save_checkpoint(path)
        jeng.restore_checkpoint(path)
    else:
        jrun(0)
        jeng.save_checkpoint(path)
        peng.restore_checkpoint(path)
    with open(os.path.join(path, "0.metadata")) as f:
        md = json.load(f)["state_dict_metadata"]
    assert md["model.gpt.final_ln.weight"][0]["dtype"] == "bfloat16"
    mine, ref = _port_bits(pm), _jax_params(jm)
    assert set(mine) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k], _bits(ref[k]), err_msg=k)
    ps, js = _port_slots(pm, popt), _jax_slots(jm, jopt)
    assert set(ps) == set(js) and any(k.endswith(".master_weight")
                                      for k in ps)
    for k in js:
        np.testing.assert_array_equal(ps[k], js[k], err_msg=k)


def test_bf16_without_ml_dtypes(tmp_path):
    """A process that cannot import ml_dtypes writes a bf16 checkpoint,
    reads it back bit for bit, and reads the JAX writer's ``|V2``
    members."""
    jm, _, jeng, jrun = _jax_engine(42, dtype="bfloat16")
    jeng.save_checkpoint(str(tmp_path / "jax"))
    w = np.ascontiguousarray(_bits(_jax_params(jm)[
        "gpt.embeddings.word_embeddings.weight"]))
    np.save(tmp_path / "want.npy", w)
    code = f"""
import sys
sys.modules["ml_dtypes"] = None       # any import of it now fails
import numpy as np, torch
from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                     save_state_dict)
t = (torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7).bfloat16()
save_state_dict({{"w": t}}, {str(tmp_path / "port")!r})
back = torch.zeros(3, 4, dtype=torch.bfloat16)
load_state_dict({{"w": back}}, {str(tmp_path / "port")!r})
assert torch.equal(back, t)
key = "model.gpt.embeddings.word_embeddings.weight"
raw = {{"model": {{"gpt": {{"embeddings": {{"word_embeddings": {{
    "weight": np.zeros(0)}}}}}}}}}}
load_state_dict(raw, {str(tmp_path / "jax")!r})
got = raw["model"]["gpt"]["embeddings"]["word_embeddings"]["weight"]
assert got.dtype == torch.bfloat16
want = np.load({str(tmp_path / "want.npy")!r})
assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
assert "ml_dtypes" not in [m for m in sys.modules if sys.modules[m]]
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


# ---------------------------------------------------------------------------
# resume within the port, bit for bit
# ---------------------------------------------------------------------------
def _dropout_engine(seed):
    cfg = tg.gpt_tiny(hidden_dropout=0.1, attention_dropout=0.1)
    model = tg.GPTForCausalLM(cfg, device="cpu", seed=seed)
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=8),
                            warmup_steps=2, start_lr=1e-4, end_lr=1e-3)
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    crit = tg.GPTPretrainingCriterion(cfg)
    eng = ParallelEngine(model, opt)
    step = eng.train_step(lambda m, b: crit(m(b["x"]), b["y"]))

    def run(i):
        x, y = _ids(i, cfg.vocab_size)
        return float(step({"x": x, "y": y}))

    return model, opt, eng, run


def _state(model, opt):
    out = {f"p.{n}": p.detach().clone() for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        for k, v in (opt._states.get(id(p)) or {}).items():
            out[f"s.{n}.{k}"] = v.clone()
    return out


def test_resume_reproduces_the_uninterrupted_run_with_dropout(tmp_path):
    model, opt, eng, run = _dropout_engine(0)
    gold = []
    for i in range(8):
        gold.append(run(i))
        if i == 3:
            eng.save_checkpoint(str(tmp_path / "c4"))
    model2, opt2, eng2, run2 = _dropout_engine(1)
    eng2.restore_checkpoint(str(tmp_path / "c4"))
    assert [run2(i) for i in range(4, 8)] == gold[4:]
    a, b = _state(model, opt), _state(model2, opt2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert opt._lr.state_dict() == opt2._lr.state_dict()
    assert opt2._step_count == 8
    gens = [(g1.get_state(), g2.get_state()) for g1, g2 in (
        (model.gpt.embeddings.dropout.generator,
         model2.gpt.embeddings.dropout.generator),
        (model.gpt.layers[0].attn._attn_gen,
         model2.gpt.layers[0].attn._attn_gen))]
    assert all(torch.equal(x, y) for x, y in gens)


def test_async_save_then_an_in_place_step(tmp_path):
    """The snapshot is complete when save_checkpoint returns: the step
    that follows at once updates parameters, masters and moments in
    place, and the committed checkpoint still holds the state before
    it."""
    model, opt, eng, run = _dropout_engine(0)
    run(0)
    before = _state(model, opt)
    eng.save_checkpoint(str(tmp_path / "ck"), async_save=True)
    run(1)
    wait_async_saves()
    after = _state(model, opt)
    assert not all(torch.equal(before[k], after[k]) for k in before)
    model2, opt2, eng2, _ = _dropout_engine(1)
    eng2.restore_checkpoint(str(tmp_path / "ck"))
    got = _state(model2, opt2)
    assert all(torch.equal(before[k], got[k]) for k in before)


# ---------------------------------------------------------------------------
# the crash matrix (tests/test_fault_tolerance.py's, on the port)
# ---------------------------------------------------------------------------
def _mlp(seed=0, d=8, h=16):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(d, h), torch.nn.ReLU(),
                               torch.nn.Linear(h, d))


def _params(m):
    return {n: p.detach().clone() for n, p in m.named_parameters()}


def _assert_params(m, want):
    got = _params(m)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


class TestAtomicCheckpoint:
    def test_commit_layout_npz_not_pickle(self, tmp_path):
        p = str(tmp_path / "ck")
        save_state_dict(_mlp().state_dict(), p)
        assert is_committed(p)
        with open(os.path.join(p, "0_0.distcp"), "rb") as f:
            assert f.read(2) == b"PK"
        with open(os.path.join(p, "0.metadata")) as f:
            assert json.load(f)["checksums"]
        commit = json.load(open(os.path.join(p, "COMMIT")))
        assert commit["shard_files"] == ["0_0.distcp"]

    @pytest.mark.parametrize("site", CKPT_FAILPOINTS)
    def test_crash_matrix_preserves_previous(self, tmp_path, site):
        p = str(tmp_path / "ck")
        a = _mlp(seed=1)
        save_state_dict(a.state_dict(), p)
        want = _params(a)
        with fp.scoped(f"{site}=raise"):
            with pytest.raises(fp.FailpointError):
                save_state_dict(_mlp(seed=2).state_dict(), p)
        tgt = _mlp(seed=3)
        load_state_dict(tgt.state_dict(), p)
        _assert_params(tgt, want)

    def test_uncommitted_dir_refused(self, tmp_path):
        p = str(tmp_path / "ck")
        with fp.scoped("ckpt.commit=raise"):
            with pytest.raises(fp.FailpointError):
                save_state_dict(_mlp().state_dict(), p)
        assert resolve_committed(p) is None
        with pytest.raises(Exception, match="no committed checkpoint"):
            load_state_dict(_mlp().state_dict(), p)

    def test_committed_tmp_is_recovered(self, tmp_path):
        p = str(tmp_path / "ck")
        m = _mlp(seed=4)
        with fp.scoped("ckpt.rename=raise"):
            with pytest.raises(fp.FailpointError):
                save_state_dict(m.state_dict(), p)
        assert not os.path.isdir(p)
        assert resolve_committed(p) == p + ".tmp"
        tgt = _mlp(seed=5)
        load_state_dict(tgt.state_dict(), p)
        _assert_params(tgt, _params(m))

    @pytest.mark.parametrize("how", ["write_shard_corrupt", "bit_flip"])
    def test_corrupt_shard_refused(self, tmp_path, how):
        p = str(tmp_path / "ck")
        if how == "write_shard_corrupt":
            with fp.scoped("ckpt.write_shard=corrupt"):
                save_state_dict(_mlp().state_dict(), p)
        else:
            save_state_dict(_mlp().state_dict(), p)
            shard = os.path.join(p, "0_0.distcp")
            blob = bytearray(open(shard, "rb").read())
            blob[len(blob) // 2] ^= 0x01
            open(shard, "wb").write(bytes(blob))
        assert is_committed(p)
        with pytest.raises(CheckpointCorruptError):
            load_state_dict(_mlp().state_dict(), p)

    def test_npz_reader_matches_np_load(self, tmp_path):
        """The memory-mapped reader gives np.load's arrays for the stored
        members np.savez writes, and refuses a compressed archive."""
        from paddle_tpu_torch.distributed.checkpoint.load_state_dict import \
            _npz_members

        r = np.random.RandomState(0)
        arrays = {"a@0_0": r.randn(3, 5).astype(np.float32),
                  "b@0": r.randint(0, 9, 7).astype(np.int64),
                  "c": np.zeros((0, 4), np.uint16),
                  "d": np.asfortranarray(r.randn(4, 3)),
                  "e@": np.array(2.5)}
        path = str(tmp_path / "x.npz")
        np.savez(path, **arrays)
        got = _npz_members(path)
        with np.load(path) as z:
            assert set(got) == set(z.files) == set(arrays)
            for k in arrays:
                assert got[k].dtype == z[k].dtype, k
                np.testing.assert_array_equal(got[k], z[k], err_msg=k)
        np.savez_compressed(str(tmp_path / "z.npz"), **arrays)
        with pytest.raises(ValueError, match="compressed"):
            _npz_members(str(tmp_path / "z.npz"))

    def test_bfloat16_roundtrip(self, tmp_path):
        p = str(tmp_path / "ck")
        w = torch.arange(12, dtype=torch.float32).reshape(3, 4).bfloat16()
        save_state_dict({"w": w}, p)
        tgt = torch.zeros(3, 4, dtype=torch.bfloat16)
        load_state_dict({"w": tgt}, p)
        assert torch.equal(tgt, w)

    def test_async_save_matches_sync(self, tmp_path):
        m = _mlp(seed=6)
        ps, pa = str(tmp_path / "sync"), str(tmp_path / "async")
        save_state_dict(m.state_dict(), ps)
        save_state_dict(m.state_dict(), pa, async_save=True)
        wait_async_saves()
        assert is_committed(pa)
        t1, t2 = _mlp(seed=7), _mlp(seed=8)
        load_state_dict(t1.state_dict(), ps)
        load_state_dict(t2.state_dict(), pa)
        _assert_params(t2, _params(t1))
        assert _checksums(ps) == _checksums(pa)


class TestCheckpointManager:
    def test_retention_keeps_last_k(self, tmp_path):
        m = _mlp()
        mgr = CheckpointManager(str(tmp_path), keep_last_k=2)
        for s in (1, 2, 3, 4):
            mgr.save(m.state_dict(), step=s)
        names = sorted(n for n in os.listdir(str(tmp_path))
                       if n.startswith("step_"))
        assert names == ["step_00000003", "step_00000004"]
        assert sorted(os.listdir(str(tmp_path))) == \
            ["goodput.jsonl"] + names
        assert mgr.latest_step() == 4

    def test_newest_committed_fallback_after_crash(self, tmp_path):
        a, b = _mlp(seed=1), _mlp(seed=2)
        mgr = CheckpointManager(str(tmp_path), keep_last_k=3)
        mgr.save(a.state_dict(), step=2, extra_meta={"step": 2})
        with fp.scoped("ckpt.commit=raise"):
            with pytest.raises(fp.FailpointError):
                mgr.save(b.state_dict(), step=4)
        latest = latest_committed(str(tmp_path))
        assert latest is not None and latest.endswith("step_00000002")
        tgt = _mlp(seed=3)
        load_state_dict(tgt.state_dict(), latest)
        _assert_params(tgt, _params(a))

    def test_corrupt_latest_skipped_after_delete(self, tmp_path):
        import shutil

        m = _mlp()
        mgr = CheckpointManager(str(tmp_path), keep_last_k=3)
        mgr.save(m.state_dict(), step=2)
        with fp.scoped("ckpt.write_shard=corrupt"):
            mgr.save(m.state_dict(), step=4)
        latest = latest_committed(str(tmp_path))
        assert latest.endswith("step_00000004")
        with pytest.raises(CheckpointCorruptError):
            load_state_dict(_mlp().state_dict(), latest)
        shutil.rmtree(latest)
        assert latest_committed(str(tmp_path)).endswith("step_00000002")

    def test_async_mode_and_gauges(self, tmp_path):
        from paddle_tpu_torch.observability import get_registry

        with CheckpointManager(str(tmp_path), keep_last_k=2,
                               async_save=True) as mgr:
            mgr.save(_mlp().state_dict(), step=10, extra_meta={"step": 10})
            mgr.wait()
            assert mgr.latest_step() == 10
        snap = get_registry().snapshot()["metrics"]
        for name in ("paddle_tpu_ckpt_last_save_age_seconds",
                     "paddle_tpu_ckpt_save_seconds",
                     "paddle_tpu_ckpt_save_bytes",
                     "paddle_tpu_ckpt_last_committed_step",
                     "paddle_tpu_ckpt_async_pending",
                     "paddle_tpu_ckpt_saves_total"):
            assert name in snap, name
        assert snap["paddle_tpu_ckpt_last_committed_step"][
            "series"][0]["value"] == 10.0

    def test_async_background_failure_surfaces(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        fp.configure("ckpt.write_metadata=raise")
        mgr.save(_mlp().state_dict(), step=2)
        with pytest.raises(fp.FailpointError):
            mgr.wait()
        fp.clear()
        mgr.close()

    def test_close_is_prompt_idempotent_and_save_restarts_writer(
            self, tmp_path):
        m = _mlp()
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        mgr.save(m.state_dict(), step=1)
        mgr.wait()
        writer = mgr._writer
        t0 = time.monotonic()
        mgr.close()
        assert time.monotonic() - t0 < 5.0
        writer.join(timeout=5)
        assert not writer.is_alive() and mgr._writer is None
        mgr.close()
        mgr._queue.put(None)              # a stale sentinel, stop not set
        mgr.save(m.state_dict(), step=2)
        mgr.wait(timeout=30)
        assert mgr.latest_step() == 2
        assert mgr._writer is not None and mgr._writer.is_alive()
        mgr.close()

    def test_engine_through_a_manager_falls_back_after_a_failed_commit(
            self, tmp_path):
        """An engine's async save through a manager commits; a later save
        whose commit fails leaves it the newest, and it restores."""
        base = str(tmp_path / "run")
        model, opt, eng, run = _dropout_engine(0)
        run(0)
        with CheckpointManager(base, keep_last_k=2, async_save=True) as mgr:
            eng.save_checkpoint(manager=mgr)
            want = _state(model, opt)
            run(1)
            mgr.wait()
            with fp.scoped("ckpt.commit=raise"):
                eng.save_checkpoint(manager=mgr)
                with pytest.raises(fp.FailpointError):
                    mgr.wait()
        latest = latest_committed(base)
        assert latest.endswith("step_00000001")
        model2, opt2, eng2, _ = _dropout_engine(1)
        assert eng2.restore_checkpoint(latest)["step"] == 1
        got = _state(model2, opt2)
        assert all(torch.equal(want[k], got[k]) for k in want)


def test_chip_smoke_train_ckpt_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phase 15 at gpt_tiny's size on the CPU: the same
    code path as on the card (run A with both saves, run B's resume held
    to A bit for bit, the failed commit, the telemetry checks a CPU can
    pass)."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    cfg = tg.gpt_tiny(hidden_dropout=0.1, attention_dropout=0.1)
    assert chip_smoke.phase_train_ckpt([], device="cpu", cfg=cfg, B=2,
                                       S=32) == {}

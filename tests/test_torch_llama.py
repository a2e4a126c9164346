"""The port's Llama held against the JAX package on the CPU, plus the
port's package rules.

``llama_tiny`` weights are built by the JAX package, carried across by
``paddle_tpu_torch.convert.load_jax_state_dict`` through numpy, and one
unified (mixed prefill-chunk/decode) step, one legacy prefill step and
one decode step run through both forwards with paged caches: logits
within 1e-4, updated pools within 1e-5.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.models import llama as tl

REPO = Path(__file__).resolve().parent.parent
LOGIT_TOL = 1e-4
POOL_TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = JaxLlama(jax_tiny())
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = tl.LlamaForCausalLM(tl.llama_tiny(), device="cpu")
    load_jax_state_dict(tm, state)
    return jm, tm, state


def _pools(seed, ncols, B):
    cfg = jax_tiny()
    r = np.random.RandomState(seed)
    P, page = 24, 8
    shape = (P, cfg.num_kv_heads, page, cfg.head_dim)
    kp = (0.1 * r.randn(*shape)).astype(np.float32)
    vp = (0.1 * r.randn(*shape)).astype(np.float32)
    tbl = np.full((B, ncols), P - 1, np.int32)
    perm = r.permutation(P - 1)
    for b in range(B):
        tbl[b, :4] = perm[4 * b:4 * b + 4]
    return kp, vp, tbl


def _run_both(jm, tm, ids, kp, vp, tbl, offset, valid=None):
    L = jm.config.num_layers
    jc = [(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl))
          for _ in range(L)]
    jkw = {"offset": jnp.asarray(offset) if np.ndim(offset) else offset}
    tkw = {"offset": torch.tensor(offset) if np.ndim(offset) else offset}
    if valid is not None:
        jkw["valid"] = jnp.asarray(valid)
        tkw["valid"] = torch.tensor(valid)
    with paddle.no_grad():
        jl, jcs = jm(Tensor(jnp.asarray(ids)), caches=jc, **jkw)
    tc = [(torch.tensor(kp), torch.tensor(vp), torch.tensor(tbl))
          for _ in range(L)]
    with torch.no_grad():
        tlg, tcs = tm(torch.tensor(ids, dtype=torch.int64), caches=tc, **tkw)
    return np.asarray(jl._value), jcs, tlg.numpy(), tcs


def _check_pools(jcs, tcs, trash):
    for (jk, jv, _), (tk, tv, _) in zip(jcs, tcs):
        # the trash page takes the dead slots' duplicate writes: any one
        # of them may win, so it is excluded
        for j, t in ((jk, tk), (jv, tv)):
            np.testing.assert_allclose(np.asarray(j)[:trash],
                                       t.numpy()[:trash], rtol=0,
                                       atol=POOL_TOL)


def test_weights_carry_across(models):
    jm, tm, state = models
    sd = tm.state_dict()
    assert set(sd) == set(state)
    np.testing.assert_array_equal(
        sd["llama.layers.0.self_attn.k_proj.weight"].numpy(),
        state["llama.layers.0.self_attn.k_proj.weight"].T)
    np.testing.assert_array_equal(sd["llama.embed_tokens.weight"].numpy(),
                                  state["llama.embed_tokens.weight"])


def test_unified_step_matches_jax(models):
    """Mixed batch through the `valid` contract: a chunk straddling pages,
    a decode row, a partial chunk, a dead row (table has the extra
    trailing trash column)."""
    jm, tm, _ = models
    B, S = 4, 16
    kp, vp, tbl = _pools(1, 16 + 1, B)
    ids = np.random.RandomState(2).randint(1, 256, (B, S))
    starts = np.asarray([5, 20, 9, 0], np.int32)
    valid = np.asarray([16, 1, 7, 0], np.int32)
    jl, jcs, tlg, tcs = _run_both(jm, tm, ids, kp, vp, tbl, starts, valid)
    for b in range(B):
        n = valid[b]
        np.testing.assert_allclose(tlg[b, :n], jl[b, :n], rtol=0,
                                   atol=LOGIT_TOL)
    _check_pools(jcs, tcs, trash=kp.shape[0] - 1)


def test_decode_step_matches_jax(models):
    jm, tm, _ = models
    B = 4
    kp, vp, tbl = _pools(3, 16, B)
    ids = np.random.RandomState(4).randint(1, 256, (B, 1))
    pos = np.asarray([0, 7, 8, 31], np.int32)
    jl, jcs, tlg, tcs = _run_both(jm, tm, ids, kp, vp, tbl, pos)
    np.testing.assert_allclose(tlg, jl, rtol=0, atol=LOGIT_TOL)
    _check_pools(jcs, tcs, trash=kp.shape[0] - 1)


def test_legacy_prefill_step_matches_jax(models):
    """[1, Sb] prefill at offset 0 (the engine's legacy admission path),
    right-padded past the prompt."""
    jm, tm, _ = models
    kp, vp, tbl = _pools(5, 16, 1)
    ids = np.zeros((1, 32), np.int64)
    ids[0, :27] = np.random.RandomState(6).randint(1, 256, 27)
    jl, jcs, tlg, tcs = _run_both(jm, tm, ids, kp, vp, tbl, 0)
    np.testing.assert_allclose(tlg, jl, rtol=0, atol=LOGIT_TOL)
    _check_pools(jcs, tcs, trash=kp.shape[0] - 1)


def test_rope_tables_and_rotate_half_match_jax():
    from paddle_tpu.models.llama import _rope_tables as jax_rope
    from paddle_tpu.ops.nn_ops import rotate_half as jax_rot
    from paddle_tpu_torch.ops.nn_ops import rotate_half

    cfg = tl.llama_tiny()
    cos, sin = tl._rope_tables(cfg, "cpu")
    jc, js = jax_rope(jax_tiny())
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(js))
    x = np.random.RandomState(0).randn(2, 3, 4, 16).astype(np.float32)
    np.testing.assert_array_equal(rotate_half(torch.tensor(x)).numpy(),
                                  np.asarray(jax_rot(jnp.asarray(x))))


def test_module_to_moves_and_casts_rope_tables(models):
    """A dtype cast of the model keeps serving: the rope tables follow
    the module, and state_dict holds only the JAX package's names."""
    state = models[2]
    m = tl.LlamaForCausalLM(tl.llama_tiny(), device="cpu")
    load_jax_state_dict(m, state)
    m.to(torch.bfloat16)
    attn = m.llama.layers[0].self_attn
    assert attn.rope_cos.dtype == torch.bfloat16
    assert set(m.state_dict()) == set(state)
    kp, vp, tbl = _pools(5, 16, 1)
    cache = [(torch.tensor(kp).bfloat16(), torch.tensor(vp).bfloat16(),
              torch.tensor(tbl)) for _ in range(2)]
    with torch.no_grad():
        logits, _ = m(torch.ones(1, 4, dtype=torch.int64), caches=cache)
    assert logits.dtype == torch.bfloat16 and torch.isfinite(
        logits.float()).all()


class TestConvertChecks:
    def test_missing_name_raises(self, models):
        _, tm, state = models
        bad = dict(state)
        bad.pop("lm_head.weight")
        with pytest.raises(KeyError, match="lm_head.weight"):
            load_jax_state_dict(tm, bad)

    def test_wrong_shape_raises_and_writes_nothing(self, models):
        _, tm, state = models
        bad = dict(state)
        bad["llama.norm.weight"] = np.zeros(3, np.float32)
        before = tm.llama.embed_tokens.weight.clone()
        with pytest.raises(ValueError, match="llama.norm.weight"):
            load_jax_state_dict(tm, bad)
        assert torch.equal(tm.llama.embed_tokens.weight, before)


class TestDevicePolicy:
    def test_default_device_is_cuda_and_raises_without_one(self,
                                                           monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tl.LlamaForCausalLM(tl.llama_tiny())

    def test_params_file_and_llm_int8_paths_work(self, models, tmp_path):
        """Weight loading from a params file or a model directory through
        a model factory, and ``llm_int8_linear``, which raised before
        they were ported, now serve (tests/test_torch_params_file.py and
        tests/test_torch_llm_int8.py hold them against the JAX package);
        generate runs on the loaded model."""
        from paddle_tpu_torch.convert import export_jax_state_dict
        from paddle_tpu_torch.framework.io import save
        from paddle_tpu_torch.inference import Config, create_predictor
        from paddle_tpu_torch.nn.quant import llm_int8_linear

        _, tm, _ = models
        save(export_jax_state_dict(tm, tensors=True),
             str(tmp_path / "model.pdparams"))
        ids = torch.zeros(1, 4, dtype=torch.int64)
        want = tm.generate(ids, max_new_tokens=2)
        factory = lambda: tl.LlamaForCausalLM(tl.llama_tiny(),  # noqa: E731
                                              device="cpu", seed=3)
        for conf in (Config(params_file=str(tmp_path / "model.pdparams")),
                     Config(model_dir=str(tmp_path)),
                     Config().set_params_file(
                         str(tmp_path / "model.pdparams"))):
            pred = create_predictor(conf.set_model_factory(factory))
            assert torch.equal(pred._model.generate(ids, max_new_tokens=2),
                               want)
        out = llm_int8_linear(torch.ones(1, 4),
                              torch.ones(2, 4, dtype=torch.int8),
                              weight_scale=torch.ones(2))
        assert out.tolist() == [[4.0, 4.0]]


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------
def _port_files():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    """The port and its chip script import no JAX and nothing of the JAX
    package (not even its JAX-free modules)."""
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, f"{path}: forbidden imports {bad}"

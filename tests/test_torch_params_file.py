"""Serving a saved model: the port's ``framework.io.save`` / ``load`` and
``inference.Config(params_file=...)`` / ``Config(model_dir=...)`` with
``set_model_factory``, held against the JAX package on the CPU.

- A file ``paddle_tpu.save(model.state_dict())`` writes serves through the
  port's predictor (params file and model directory): greedy tokens equal
  the JAX predictor's on the same file bit for bit in fp32, as
  ``tests/test_inference.py`` holds the JAX package to its live model.
- The port's ``save(export_jax_state_dict(model, tensors=True))`` serves
  through the JAX predictor, tokens equal the port's.
- bf16: the port writes the JAX package's bytes exactly; a bf16 file the
  JAX package writes loads in a process where ``ml_dtypes`` cannot be
  imported (every bit equal; the port's predictor serves it there with
  the tokens it gives where ``ml_dtypes`` is present), and the port's
  bf16 ``save`` works there too.
- A file of the port's own ``state_dict()`` (torch layout) raises,
  naming ``export_jax_state_dict``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_predictor
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu_torch import load, save
from paddle_tpu_torch.convert import export_jax_state_dict
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.models import llama as tl

REPO = Path(__file__).resolve().parent.parent


def _port_factory(dtype=None):
    def build():
        m = tl.LlamaForCausalLM(tl.llama_tiny(), device="cpu", seed=123)
        return m.to(dtype) if dtype else m
    return build


def _prompt():
    return np.random.RandomState(5).randint(0, jax_tiny().vocab_size, (2, 6))


def _jax_tokens(conf, n=5):
    out = jax_predictor(conf).generate(paddle.to_tensor(_prompt()),
                                       max_new_tokens=n)
    return np.asarray(out._value)


def _port_tokens(conf, n=5):
    return create_predictor(conf).generate(
        torch.tensor(_prompt()), max_new_tokens=n).numpy()


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """A JAX Llama (seed 11) and the params file its state_dict saves to,
    in a model directory."""
    d = tmp_path_factory.mktemp("jax_model")
    paddle.seed(11)
    jm = JaxLlama(jax_tiny())
    paddle.save(jm.state_dict(), str(d / "model.pdparams"))
    return jm, d


def test_jax_file_serves_in_the_port(jax_file):
    jm, d = jax_file
    path = str(d / "model.pdparams")
    want = _jax_tokens(JaxConfig(params_file=path).set_model_factory(
        lambda: JaxLlama(jax_tiny())))
    np.testing.assert_array_equal(
        want, _jax_tokens(JaxConfig().set_model(jm)))
    for conf in (Config(params_file=path), Config(model_dir=str(d)),
                 Config().set_params_file(path)):
        got = _port_tokens(conf.set_model_factory(_port_factory()))
        np.testing.assert_array_equal(got, want)


def test_load_gives_the_jax_tensors(jax_file):
    jm, d = jax_file
    path = str(d / "model.pdparams")
    want = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    got = load(path, device="cpu")
    arrays = load(path, return_numpy=True)
    assert set(got) == set(want) == set(arrays)
    for k, v in want.items():
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(got[k].detach().numpy(), v)
        np.testing.assert_array_equal(arrays[k], v)
    jax_back = paddle.load(path)
    assert set(jax_back) == set(want)


def test_port_file_serves_in_the_jax_package(tmp_path):
    model = _port_factory()()
    path = str(tmp_path / "model.pdparams")
    save(export_jax_state_dict(model, tensors=True), path)
    want = _port_tokens(Config().set_model(model))
    got = _jax_tokens(JaxConfig(params_file=path).set_model_factory(
        lambda: JaxLlama(jax_tiny())))
    np.testing.assert_array_equal(got, want)
    # the numpy form of the export is a params file too
    save(export_jax_state_dict(model), path)
    got = _jax_tokens(JaxConfig(model_dir=str(tmp_path)).set_model_factory(
        lambda: JaxLlama(jax_tiny())))
    np.testing.assert_array_equal(got, want)


def test_bf16_save_is_the_jax_packages_bytes(tmp_path):
    r = np.random.RandomState(3)
    w = torch.tensor(r.randn(5, 7).astype(np.float32)).bfloat16()
    f = r.randn(4).astype(np.float32)
    bits = w.view(torch.int16).numpy()
    import ml_dtypes
    jw = paddle.to_tensor(bits.view(ml_dtypes.bfloat16))
    paddle.save({"w": jw, "f": paddle.to_tensor(f), "n": 3},
                str(tmp_path / "jax.pdparams"))
    save({"w": w, "f": torch.tensor(f), "n": 3},
         str(tmp_path / "port.pdparams"))
    assert (tmp_path / "jax.pdparams").read_bytes() == \
        (tmp_path / "port.pdparams").read_bytes()
    back = paddle.load(str(tmp_path / "port.pdparams"))
    assert str(back["w"]._value.dtype) == "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(back["w"]._value).view(np.int16), bits)


_NO_ML_DTYPES = r"""
import json, sys
sys.modules["ml_dtypes"] = None          # import ml_dtypes now raises
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from paddle_tpu_torch import load, save
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.models import llama as tl
path, prompt = sys.argv[2], np.array(json.loads(sys.argv[3]))
state = load(path, device="cpu")
np.savez(sys.argv[4], **{k: v.detach().view(torch.int16).numpy()
                         for k, v in state.items()})
try:
    load(path, return_numpy=True)
    raise SystemExit("return_numpy=True read bf16 without ml_dtypes")
except ModuleNotFoundError as e:
    assert "ml_dtypes" in str(e)
save({k: v.detach() for k, v in state.items()}, sys.argv[5])
def build():
    return tl.LlamaForCausalLM(tl.llama_tiny(), device="cpu",
                               seed=123).to(torch.bfloat16)
out = create_predictor(Config(params_file=path).set_model_factory(build)
                       ).generate(torch.tensor(prompt), max_new_tokens=5)
print(json.dumps(out.tolist()))
"""


def test_jax_bf16_file_loads_without_ml_dtypes(tmp_path):
    paddle.seed(11)
    jm = JaxLlama(jax_tiny())
    jm.astype("bfloat16")
    path = str(tmp_path / "bf16.pdparams")
    paddle.save(jm.state_dict(), path)
    want = {k: np.asarray(v._value).view(np.int16)
            for k, v in jm.state_dict().items()}
    assert all(str(v._value.dtype) == "bfloat16"
               for v in jm.state_dict().values())
    bits, resaved = str(tmp_path / "bits.npz"), str(tmp_path / "re.pdparams")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run(
        [sys.executable, "-c", _NO_ML_DTYPES, str(REPO), path,
         json.dumps(_prompt().tolist()), bits, resaved],
        capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    got = np.load(bits)
    assert set(got.files) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the port, where ml_dtypes imports, serves the same tokens
    tokens = np.array(json.loads(run.stdout.strip().splitlines()[-1]))
    np.testing.assert_array_equal(tokens, _port_tokens(
        Config(params_file=path).set_model_factory(
            _port_factory(torch.bfloat16))))
    # what the port saved there is a bf16 file the JAX package reads
    back = paddle.load(resaved)
    for k, v in want.items():
        assert str(back[k]._value.dtype) == "bfloat16"
        np.testing.assert_array_equal(np.asarray(back[k]._value)
                                      .view(np.int16), v)


def test_torch_layout_file_is_refused(tmp_path):
    model = _port_factory()()
    path = str(tmp_path / "model.pdparams")
    save(model.state_dict(), path)
    conf = Config(params_file=path).set_model_factory(_port_factory())
    with pytest.raises(ValueError, match="export_jax_state_dict"):
        create_predictor(conf)
    # without the mark, a shape that only the transpose fits says so too
    save({k: v for k, v in model.state_dict().items()}, path)
    with pytest.raises(ValueError, match="export_jax_state_dict"):
        create_predictor(conf)
    # and a name the model lacks raises in load_jax_state_dict
    state = export_jax_state_dict(model)
    state["extra.weight"] = np.zeros(2, np.float32)
    save(state, path)
    with pytest.raises(KeyError, match="extra.weight"):
        create_predictor(conf)
    with pytest.raises(FileNotFoundError, match="model.pdparams"):
        create_predictor(Config(model_dir=str(tmp_path / "none"))
                         .set_model_factory(_port_factory()))

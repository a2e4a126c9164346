"""The port's FLAGS registry (``paddle_tpu_torch.core.flags``) held against
the JAX package's (``paddle_tpu.core.flags``) on the CPU: the same names,
defaults and types, the ``FLAGS_`` prefix, the environment override read
when a flag is defined, the bool spellings and the errors on unknown
names. The port reads ``use_autotune`` and ``check_nan_inf`` (which
installs ``amp.debugging``'s checker); every other flag raises
``NotImplementedError`` when set to anything but its default. Every test
restores the flags it sets, in both packages.
"""
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core import flags as jflags
from paddle_tpu_torch.core import flags as tflags


@pytest.fixture(autouse=True)
def restore_flags():
    saved = [(reg, {n: f.value for n, f in reg.items()})
             for reg in (jflags._REGISTRY, tflags._REGISTRY)]
    yield
    for reg, values in saved:
        for n in list(reg):
            if n not in values:
                del reg[n]       # a flag a test defined
            else:
                reg[n].value = values[n]


def test_same_names_defaults_and_types():
    assert set(tflags._REGISTRY) == set(jflags._REGISTRY)
    assert len(tflags._REGISTRY) == 9
    for name, jf in jflags._REGISTRY.items():
        tf = tflags._REGISTRY[name]
        assert (tf.default, tf.dtype) == (jf.default, jf.dtype), name
        assert tflags.get_flags(name) == jflags.get_flags(name)


def test_package_exports():
    assert paddle_tpu_torch.set_flags is tflags.set_flags
    assert paddle_tpu_torch.get_flags is tflags.get_flags
    assert paddle_tpu.set_flags is jflags.set_flags


@pytest.mark.parametrize("key", ["use_autotune", "FLAGS_use_autotune"])
def test_prefix_set_and_get(key):
    for mod in (jflags, tflags):
        mod.set_flags({key: True})
        assert mod.get_flags(key) == {key: True}
        assert mod.get_flags(["use_autotune", "FLAGS_use_autotune"]) == {
            "use_autotune": True, "FLAGS_use_autotune": True}
        assert mod._get("use_autotune") is True
        mod.set_flags({key: "off"})
        assert mod.get_flags(key) == {key: False}


COERCE = [True, False, "1", "true", "TRUE", "Yes", "on", "ON", "0", "false",
          "no", "off", "", "maybe", 1, 0, 2]


@pytest.mark.parametrize("value", COERCE, ids=repr)
def test_bool_coercion(value):
    assert tflags._coerce(value, bool) is jflags._coerce(value, bool)
    jflags.set_flags({"use_autotune": value})
    tflags.set_flags({"use_autotune": value})
    assert tflags.get_flags("use_autotune") == jflags.get_flags(
        "use_autotune")


@pytest.mark.parametrize("value,dtype", [("2.5", float), ("7", int),
                                         (3, float), ("high", str)])
def test_other_coercions(value, dtype):
    assert tflags._coerce(value, dtype) == jflags._coerce(value, dtype)
    assert type(tflags._coerce(value, dtype)) is dtype


@pytest.mark.parametrize("env,default", [("1", False), ("on", False),
                                         ("false", True), ("2.5", 1.0),
                                         ("highest", "default")])
def test_environment_override_at_definition(monkeypatch, env, default):
    monkeypatch.setenv("FLAGS_port_test_flag", env)
    jf = jflags._Flag("port_test_flag", default, "")
    tf = tflags._Flag("port_test_flag", default, "")
    assert tf.value == jf.value and type(tf.value) is type(jf.value)
    assert tf.value != default
    # read at definition only: a later change of the environment does not
    # move the value
    before = tf.value
    monkeypatch.setenv("FLAGS_port_test_flag", "0")
    assert tf.value == before == jf.value
    monkeypatch.delenv("FLAGS_port_test_flag")
    assert tflags._Flag("port_test_flag", default, "").value == default


def test_environment_override_of_use_autotune(monkeypatch):
    monkeypatch.setenv("FLAGS_use_autotune", "yes")
    for mod in (jflags, tflags):
        del mod._REGISTRY["use_autotune"]
        mod.define_flag("use_autotune", False, "")
        assert mod.get_flags("use_autotune") == {"use_autotune": True}


def test_unknown_names_raise():
    for mod in (jflags, tflags):
        with pytest.raises(ValueError, match="unknown flag 'FLAGS_nope'"):
            mod.set_flags({"FLAGS_nope": 1})
        with pytest.raises(ValueError, match="unknown flag 'nope'"):
            mod.get_flags("nope")
        assert not mod.flag_defined("nope")
        assert mod.flag_defined("use_autotune")
        with pytest.raises(ValueError, match="already defined"):
            mod.define_flag("use_autotune", False)


UNREAD = {"benchmark": True,
          "eager_op_jit_cache": False, "use_pallas_kernels": False,
          "allocator_strategy": "torch", "collective_timeout_s": 60.0,
          "enable_async_trace": True, "tpu_matmul_precision": "highest"}


@pytest.mark.parametrize("name", sorted(UNREAD))
def test_flags_the_port_does_not_read_raise(name):
    assert set(UNREAD) | {"use_autotune", "check_nan_inf"} == set(
        tflags._REGISTRY)
    default = tflags._REGISTRY[name].default
    # the default is accepted, by either spelling
    tflags.set_flags({name: default, "FLAGS_" + name: default})
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue 1"):
        tflags.set_flags({"FLAGS_" + name: UNREAD[name]})
    assert tflags.get_flags(name) == {name: default}
    # the JAX package takes the value (its own reader is its concern)
    jflags.set_flags({name: UNREAD[name]})
    assert jflags.get_flags(name) == {name: UNREAD[name]}


def test_unread_flag_from_the_environment_raises(monkeypatch):
    monkeypatch.setenv("FLAGS_port_todo_flag", "1")
    with pytest.raises(NotImplementedError, match="item 2.2"):
        tflags.define_flag("port_todo_flag", False, "", tflags._ITEM2_2)
    assert not tflags.flag_defined("port_todo_flag")
    monkeypatch.setenv("FLAGS_port_todo_flag", "0")
    tflags.define_flag("port_todo_flag", False, "", tflags._ITEM2_2)
    assert tflags.get_flags("port_todo_flag") == {"port_todo_flag": False}


def test_check_nan_inf_is_read_in_both_packages():
    """FLAGS_check_nan_inf: set, both packages raise FloatingPointError
    naming the op whose output is not finite (the port installs
    amp.debugging's hooks, the JAX package scans at its dispatch); unset,
    neither does, and the port's hooks are gone."""
    import jax.numpy as jnp
    import torch

    from paddle_tpu import ops as jops
    from paddle_tpu_torch.amp import debugging
    from paddle_tpu_torch.ops import kernels

    x = torch.tensor([1.0, 0.0])
    try:
        for spelling in ("FLAGS_check_nan_inf", "check_nan_inf"):
            tflags.set_flags({spelling: True})
            jflags.set_flags({spelling: True})
            assert kernels.after_call is not None
            with pytest.raises(FloatingPointError, match="op 'div'"):
                x / x
            with pytest.raises(FloatingPointError, match="op 'divide'"):
                jops.divide(paddle_tpu.to_tensor(jnp.ones(2)),
                            paddle_tpu.to_tensor(jnp.asarray([1.0, 0.0])))
            tflags.set_flags({spelling: False})
            jflags.set_flags({spelling: False})
            assert kernels.after_call is None and debugging._mode is None
            assert torch.isnan((x / x)[1])
    finally:
        tflags.set_flags({"check_nan_inf": False})
        jflags.set_flags({"check_nan_inf": False})

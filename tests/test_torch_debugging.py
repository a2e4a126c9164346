"""``amp.debugging``, ``FLAGS_check_nan_inf`` and ``GPTForCausalLM.aux_loss``
of the port held against the JAX package on the CPU.

``check_numerics`` must give the JAX function's counts exactly (empty
and non-floating tensors included) and raise as it does; operator stats
count the port's aten ops and kernel wrappers by name and dtype (the
names differ from the JAX package's Paddle op names: ROADMAP.md queue 3),
print the same table and return ``{op: {dtype: calls}}``; the tensor
checker raises ``FloatingPointError`` naming the op, for an aten op and
for a kernel wrapper, and leaves no hook installed once off. A dense
GPT's ``aux_loss`` is the JAX value 0, and ``loss + model.aux_loss``
trains as the JAX eager loop does (1e-5).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as K1

NUMERICS = {
    "finite": np.array([1.0, -2.0, 3.5], np.float32),
    "nan_inf": np.array([[1.0, np.nan], [np.inf, -np.inf]], np.float32),
    "scalar_nan": np.array(np.nan, np.float32),
    "empty": np.zeros((0, 3), np.float32),
    "ints": np.array([1, 2, 3], np.int32),
}


@pytest.mark.parametrize("mode", [tdbg.DebugMode.CHECK_NAN_INF,
                                  tdbg.DebugMode.CHECK_ALL])
@pytest.mark.parametrize("case", sorted(NUMERICS))
def test_check_numerics_counts_as_jax(case, mode):
    x = NUMERICS[case]
    ref = jdbg.check_numerics(jnp.asarray(x), debug_mode=mode)
    assert tdbg.check_numerics(torch.tensor(x), debug_mode=mode) == ref


def test_check_numerics_abort_raises_as_jax():
    x = NUMERICS["nan_inf"]
    for check, t in ((jdbg.check_numerics, jnp.asarray(x)),
                     (tdbg.check_numerics, torch.tensor(x))):
        with pytest.raises(FloatingPointError,
                           match="matmul_out has 1 NaN and 2 Inf"):
            check(t, "matmul", "matmul_out")
    assert tdbg.check_numerics(torch.ones(3)) == (0, 0, 3)


def test_debug_modes_and_config_as_jax():
    for name in ("CHECK_NAN_INF_AND_ABORT", "CHECK_NAN_INF", "CHECK_ALL"):
        assert getattr(tdbg.DebugMode, name) == getattr(jdbg.DebugMode, name)
    cfg, jcfg = tdbg.TensorCheckerConfig(), jdbg.TensorCheckerConfig()
    for field in ("enable", "debug_mode", "checked_op_list",
                  "skipped_op_list"):
        assert getattr(cfg, field) == getattr(jcfg, field)


def test_operator_stats_count_aten_ops_and_kernels(capsys):
    """Counts by name and the first tensor argument's dtype: aten's
    names, and the kernel wrappers' (the CPU route of K1 here). The table
    is printed as the JAX function prints it; the hooks go once it ends."""
    x = torch.randn(2, 16, 2, 16)
    with tdbg.collect_operator_stats():
        torch.randn(3, 4).bfloat16() @ torch.randn(4, 5).bfloat16()
        torch.randn(3, 4) @ torch.randn(4, 5)
        K1.flash_attention_fwd(x, x, x, True)
    table = capsys.readouterr().out.splitlines()
    assert table[0].split() == ["op", "dtype", "calls"]
    rows = {tuple(ln.split()[:2]): int(ln.split()[2]) for ln in table[1:]}
    assert rows[("mm", "bfloat16")] == 1 and rows[("mm", "float32")] >= 1
    assert rows[("flash_attention_fwd", "float32")] == 1
    assert kernels.after_call is None and tdbg._mode is None
    tdbg.enable_operator_stats_collection()
    torch.ones(2) + 1
    stats = tdbg.disable_operator_stats_collection()
    assert stats["add"]["float32"] == 1 and stats["ones"]["other"] == 1


def test_tensor_checker_raises_naming_the_op():
    """enable_tensor_checker sets FLAGS_check_nan_inf: a NaN from an aten
    op raises naming it, a NaN out of a kernel wrapper names the wrapper;
    a clean forward passes; disable removes both hooks (the JAX checker
    raises the same error at its op)."""
    from paddle_tpu import ops as jops

    x = torch.randn(1, 8, 2, 16)
    bad = x.clone()
    bad[0, 3, 0, 0] = float("nan")
    tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig())
    jdbg.enable_tensor_checker(jdbg.TensorCheckerConfig())
    try:
        K1.flash_attention_fwd(x, x, x, True)
        with pytest.raises(FloatingPointError, match="op 'log'"):
            torch.log(-torch.ones(2))
        with pytest.raises(FloatingPointError, match="output of op '"):
            K1.flash_attention_fwd(bad, x, x, True)
        with pytest.raises(FloatingPointError, match="op 'log'"):
            jops.log(paddle.to_tensor(-jnp.ones(2)))
    finally:
        tdbg.disable_tensor_checker()
        jdbg.disable_tensor_checker()
    assert kernels.after_call is None and tdbg._mode is None
    assert torch.isnan(torch.log(-torch.ones(1))).all()
    # a disabled config changes nothing
    tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig(enable=False))
    assert kernels.after_call is None


def test_kernel_hook_names_the_wrapper():
    """The counted wrapper reports its own name: a NaN made inside the
    plain version is caught at an aten op first, so here the hook alone
    is driven."""
    seen = []
    kernels.after_call = lambda name, args, out: seen.append(name)
    try:
        x = torch.randn(1, 8, 2, 16)
        K1.flash_attention_fwd(x, x, x)
    finally:
        kernels.after_call = None
    assert seen == ["flash_attention_fwd"]


def test_dense_gpt_aux_loss_is_zero_and_trains():
    """``loss + model.aux_loss`` on a dense GPT, 3 AdamW steps from the JAX
    weights: the JAX property is 0 and so is the port's (an f32 scalar on
    the model's device), and the losses equal the JAX eager loop's."""
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu_torch.convert import load_jax_state_dict
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.optimizer import AdamW

    paddle.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v._value)
                             for k, v in jm.state_dict().items()})
    aux = tm.aux_loss
    assert aux.dtype == torch.float32 and aux.shape == () and aux == 0
    assert aux.device == tm.device and float(jm.aux_loss.numpy()) == 0.0
    r = np.random.RandomState(1)
    ids = r.randint(0, 256, (2, 17))
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    topt = AdamW(learning_rate=1e-3, parameters=tm.named_parameters())
    jcrit, tcrit = jgpt.GPTPretrainingCriterion(), \
        tgpt.GPTPretrainingCriterion()
    for _ in range(3):
        jl = jcrit(jm(paddle.to_tensor(ids[:, :-1])),
                   paddle.to_tensor(ids[:, 1:])) + jm.aux_loss
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = tcrit(tm(torch.tensor(ids[:, :-1])),
                   torch.tensor(ids[:, 1:])) + tm.aux_loss
        tl.backward()
        topt.step()
        topt.clear_grad()
        np.testing.assert_allclose(float(tl.detach()), float(jl.numpy()),
                                   rtol=1e-5)

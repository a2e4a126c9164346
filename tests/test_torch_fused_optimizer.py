"""The port's multi-tensor Adam / AdamW update (K8's plain version, reached
through ``Optimizer._fused_update``) against the JAX package's
``Optimizer._fused_update`` on the CPU.

Both sides get the same numpy parameters, gradients, masters and moments.
Under a loss scaler the JAX side runs the JAX engine's own lines around
its update (``paddle_tpu/distributed/engine.py:843-865`` and ``:901-910``:
found over the raw gradients, the f32 unscale rounded to the gradient's
dtype with an inverse scale of 0 on overflow, the applied step, and the
old values kept on overflow); the port side runs ``amp.AmpStep`` inside
its update.

Tolerances: f32 outputs within 1e-6 relative to the tensor's largest
magnitude. Element by element the two differ by an ulp where terms
cancel: XLA's CPU backend contracts ``b1*m + (1-b1)*g`` into one FMA,
while the port (and K8) round each product and sum on its own, so an
element-wise relative error near a cancellation is unbounded. bf16
outputs equal JAX's or lie one bf16 ulp apart, where the two f32 paths
differ in the last bit before the rounding.
The JAX AdamW never applies ``apply_decay_param_fun``; a tensor the
port's mask exempts is held against the JAX update with weight decay 0.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.regularizer import L1Decay as JaxL1Decay
from paddle_tpu.regularizer import L2Decay as JaxL2Decay
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.ops.kernels import fused_adam as K8
from paddle_tpu_torch.regularizer import L1Decay, L2Decay

SHAPES = [(16, 24), (24,), (3, 5, 7), (1,)]
LR, STEP, SCALE = 1e-2, 3, 2.0 ** 10
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# (optimizer, decay, mask, param dtype, state dtype, clip, amp)
CASES = [
    (o, d, mask, pdt, sdt, clip, amp)
    for o in ("Adam", "AdamW")
    for pdt in ("float32", "bfloat16")
    for sdt in ("float32", "bfloat16")
    for clip in (False, True)
    for d, mask, amp in (("l2", False, None), ("l1", True, "clean"),
                         ("l2", True, "found"))
    if o == "AdamW" or not mask
]


def _data(pdt, found, seed=0):
    rng = np.random.RandomState(seed)
    p = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    g = [(0.5 * rng.randn(*s)).astype(np.float32) for s in SHAPES]
    m = [(0.1 * rng.randn(*s)).astype(np.float32) for s in SHAPES]
    v = [(0.01 * rng.rand(*s)).astype(np.float32) for s in SHAPES]
    if pdt == "bfloat16":
        # values a bf16 parameter and its gradient can hold exactly
        p = [np.asarray(torch.tensor(a).bfloat16().float()) for a in p]
        g = [np.asarray(torch.tensor(a).bfloat16().float()) for a in g]
    if found:
        g[1][3] = np.inf
    return p, g, m, v


def _jax(case, data, decays):
    """Per tensor (new p or master, new m, new v) from the JAX update."""
    o, d, mask, pdt, sdt, clip, amp = case
    p, g, m, v = data
    master = pdt == "bfloat16"
    out = []
    for wd_on in sorted(set(decays)):
        wd = (JaxL1Decay(0.1) if d == "l1" else JaxL2Decay(0.1)) \
            if wd_on else 0.0
        cls = getattr(paddle.optimizer, o)
        opt = cls(learning_rate=LR, weight_decay=wd,
                  parameters=[],
                  grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0)
                  if clip else None)
        opt._state_dtype = JDT[sdt]
        pv = tuple(jnp.asarray(a) if master else jnp.asarray(a, JDT[pdt])
                   for a in p)
        gv = [jnp.asarray(a * (SCALE if amp else 1.0), JDT[pdt]) for a in g]
        st = tuple({"moment1": jnp.asarray(a, JDT[sdt]),
                    "moment2": jnp.asarray(b, JDT[sdt])}
                   for a, b in zip(m, v))
        if amp:
            # the JAX engine's protocol around the update
            finite = jnp.float32(1.0)
            for x in gv:
                finite = finite * jnp.all(jnp.isfinite(x)).astype(
                    jnp.float32)
            found_b = (1.0 - finite) > 0
            inv = jnp.where(found_b, 0.0, 1.0 / jnp.float32(SCALE))
            gv = [(x.astype(jnp.float32) * inv).astype(x.dtype) for x in gv]
            stepc = jnp.int32(STEP - 1) + (1 - found_b.astype(jnp.int32))
        else:
            stepc = jnp.int32(STEP)
        new_p, new_s = opt._fused_update(pv, tuple(gv), st,
                                         jnp.asarray(LR, jnp.float32), stepc)
        if amp:
            new_p = tuple(jnp.where(found_b, u, n)
                          for u, n in zip(pv, new_p))
            new_s = tuple({k: jnp.where(found_b, old[k], ns[k]) for k in ns}
                          for old, ns in zip(st, new_s))
        out.append([(np.asarray(a, np.float32),
                     np.asarray(s["moment1"].astype(jnp.float32)),
                     np.asarray(s["moment2"].astype(jnp.float32)))
                    for a, s in zip(new_p, new_s)])
    if len(out) == 1:
        return out[0]
    return [out[1][i] if dk else out[0][i] for i, dk in enumerate(decays)]


def _port(case, data, decays):
    o, d, mask, pdt, sdt, clip, amp = case
    p, g, m, v = data
    names = [f"w{i}" for i in range(len(p))]
    params = [torch.tensor(a).to(TDT[pdt]) for a in p]
    kw = dict(learning_rate=LR, multi_precision=pdt == "bfloat16",
              weight_decay=L1Decay(0.1) if d == "l1" else L2Decay(0.1),
              state_dtype=sdt, parameters=list(zip(names, params)),
              grad_clip=ClipGradByGlobalNorm(1.0) if clip else None)
    if mask:
        kw["apply_decay_param_fun"] = lambda n: decays[names.index(n)]
    opt = getattr(topt, o)(**kw)
    states, masters = [], []
    for i, t in enumerate(params):
        st = opt._param_state(t)
        st["moment1"].copy_(torch.tensor(m[i]))
        st["moment2"].copy_(torch.tensor(v[i]))
        states.append(st)
        masters.append(opt._master_weights.get(id(t)))
    grads = [(torch.tensor(a) * (SCALE if amp else 1.0)).to(TDT[pdt])
             for a in g]
    amp_step = None
    if amp:
        amp_step = tamp.AmpStep(
            torch.tensor([SCALE]), torch.tensor([0, 0, STEP - 1],
                                                dtype=torch.int32),
            True, 1000, 2, 2.0, 0.5, 2.0 ** 62)
    before = launches = K8.fused_adam.launches
    norm = opt._fused_update(params, grads, states, masters, LR, STEP,
                             amp_step)
    assert K8.fused_adam.launches == before == launches  # plain on the CPU
    out = [((mw if mw is not None else t).float().numpy(),
            st["moment1"].float().numpy(), st["moment2"].float().numpy())
           for t, mw, st in zip(params, masters, states)]
    return out, params, norm, amp_step


def _close(x, ref, what):
    """Within 1e-6 of the reference's largest magnitude."""
    err = float(np.max(np.abs(x - ref)))
    assert err <= 1e-6 * float(np.max(np.abs(ref))), (what, err)


def _ulps_bf16(a, b):
    ia = torch.tensor(a).bfloat16().view(torch.int16).int()
    ib = torch.tensor(b).bfloat16().view(torch.int16).int()
    return int((ia - ib).abs().max())


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_fused_update_matches_jax(case):
    o, d, mask, pdt, sdt, clip, amp = case
    data = _data(pdt, amp == "found")
    decays = [i % 2 == 0 for i in range(len(SHAPES))] if mask \
        else [True] * len(SHAPES)
    ref = _jax(case, data, decays)
    mine, params, norm, amp_step = _port(case, data, decays)
    for i, ((rp, rm, rv), (mp, mm, mv)) in enumerate(zip(ref, mine)):
        if amp == "found":
            # a skipped step is a true no-op
            np.testing.assert_array_equal(mp, data[0][i])
            np.testing.assert_array_equal(mm, np.asarray(torch.tensor(
                data[2][i]).to(TDT[sdt]).float()))
            continue
        _close(mp, rp, f"param/master {i}")
        for name, r, x in (("moment1", rm, mm), ("moment2", rv, mv)):
            if sdt == "float32":
                _close(x, r, f"{name} {i}")
            else:
                assert _ulps_bf16(x, r) <= 1, (name, i)
        if pdt == "bfloat16":
            # the parameter is the master rounded: equal or one ulp
            assert _ulps_bf16(params[i].float().numpy(), rp) <= 1
    if amp:
        assert float(amp_step.found) == (1.0 if amp == "found" else 0.0)
        assert int(amp_step.counts[2]) == STEP - (amp == "found")
    if clip and amp != "found":
        g = np.concatenate([a.ravel() for a in data[1]])
        assert float(norm) == pytest.approx(float(np.sqrt((g * g).sum())),
                                            rel=1e-5)


def _tensors(dtype=torch.float32, sdt=torch.float32, n=3):
    p = [torch.randn(5, 4).to(dtype) for _ in range(n)]
    return (p, [torch.randn(5, 4).to(dtype) for _ in p], [None] * n,
            [torch.zeros(5, 4, dtype=sdt) for _ in p],
            [torch.zeros(5, 4, dtype=sdt) for _ in p], [True] * n)


KW = dict(lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.0)


class TestWrapperPolicy:
    def test_cpu_set_takes_the_plain_version(self):
        a = _tensors()
        b = [[t.clone() if t is not None else None for t in ts]
             for ts in a[:5]] + [a[5]]
        n0 = K8.fused_adam.launches
        K8.fused_adam(*a, **KW, step=1)
        K8.fused_adam_dense(*b, **KW, step=1)
        assert K8.fused_adam.launches == n0
        for x, y in zip(a[0] + a[3] + a[4], b[0] + b[3] + b[4]):
            assert torch.equal(x, y)

    def test_a_device_that_is_not_cpu_or_cuda_raises(self):
        a = _tensors()
        a = [[t.to("meta") for t in ts] if i != 2 and i != 5 else ts
             for i, ts in enumerate(a)]
        with pytest.raises(ValueError, match="unsupported device"):
            K8.fused_adam(*a, **KW, step=1)

    def test_cuda_model_without_a_card_raises(self, monkeypatch):
        """The optimizer never moves a CUDA request to the CPU: a model
        on the default device raises before any step."""
        from paddle_tpu_torch.models import llama as tl
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tl.LlamaForCausalLM(tl.llama_tiny())

    @pytest.mark.parametrize("bad", ["float64", "mixed_moments",
                                     "master_dtype", "grad_dtype"])
    def test_unsupported_dtypes_raise(self, bad):
        p, g, mw, m1, m2, dec = _tensors()
        if bad == "float64":
            p = [t.double() for t in p]
            g = [t.double() for t in g]
        elif bad == "mixed_moments":
            m2 = [t.bfloat16() for t in m2]
        elif bad == "master_dtype":
            mw = [t.bfloat16() for t in p]
        else:
            g = [t.bfloat16() for t in g]
        with pytest.raises(TypeError):
            K8.fused_adam(p, g, mw, m1, m2, dec, **KW, step=1)

    def test_bias_correction_is_the_f32_power(self):
        for t in (1, 2, 7, 1000):
            want = np.float32(1) - np.float32(np.float64(np.float32(0.999))
                                              ** t)
            assert K8.bias_correction(0.999, t) == float(want)
            got = K8.bias_correction(0.999, torch.tensor([t],
                                                         dtype=torch.int32))
            assert float(got) == float(want)

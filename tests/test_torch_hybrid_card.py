"""The kernel changes of the port's tensor parallelism, on the card:

    python -m pytest tests/test_torch_hybrid_card.py -m cuda -q

- K8's split reduce (``fused_adam(..., split=(GradSync, flags))``: the
  mp shards' and the replicated tensors' squared sums apart, then the
  finalize from their sum) against its plain version with the same
  split, with and without a loss scaler, and its norm against the
  degree-1 call's;
- K1 / K2 with attention dropout at a head offset: a rank's heads run
  with ``head_offset`` give the bits of the whole call's same heads, and
  match the plain version at the offset.

Without a card every test skips with a reason (decided inside the
``cuda`` fixture). Tolerances: f32 buffers 1e-6 of each tensor's largest
magnitude, bf16 one ulp of it, norms 1e-5 (K8, as chip_smoke.py's
kernels phase); attention 2e-2 of the plain version's largest magnitude
(bf16) and 1e-4 (fp32).
"""
import math

import pytest
import torch

from paddle_tpu_torch.amp import AmpStep
from paddle_tpu_torch.nn.clip import GradSync
from paddle_tpu_torch.ops.kernels import flash_attention as K1
from paddle_tpu_torch.ops.kernels import fused_adam as K8

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


SHAPES = [(257, 64), (64,), (1000, 3), (33,), (64, 128), (7,)]
FLAGS = [True, False, True, True, False, False]


def _buffers(dev, pdt, grads=None, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    params = [(0.02 * torch.randn(s, device=dev, generator=g)).to(pdt)
              for s in SHAPES]
    new = [(1e-2 * torch.randn(s, device=dev, generator=g)).to(pdt)
           for s in SHAPES]
    return dict(params=params, grads=grads or new,
                masters=[p.float() if pdt != torch.float32 else None
                         for p in params],
                moments1=[1e-4 * torch.randn(s, device=dev, generator=g)
                          for s in SHAPES],
                moments2=[1e-8 * torch.rand(s, device=dev, generator=g)
                          for s in SHAPES],
                decays=[True] * len(SHAPES))


def _amp(dev):
    return AmpStep(scale=torch.tensor([1024.0], device=dev),
                   counts=torch.tensor([0, 0, 2], dtype=torch.int32,
                                       device=dev),
                   dynamic=True, incr_every=1000, decr_every=2,
                   incr_ratio=2.0, decr_ratio=0.5, cap=2.0 ** 62)


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("scaler", [False, True])
def test_fused_adam_split_matches_plain(cuda, pdt, scaler):
    split = (GradSync(), FLAGS)
    kw = dict(lr=3e-4, beta1=0.9, beta2=0.999, epsilon=1e-8,
              weight_decay=0.01, decoupled=True, step=3, clip_norm=1.0)
    A = _buffers(cuda, pdt)
    B = _buffers(cuda, pdt, A["grads"])
    if scaler:
        A["grads"] = [(g.float() * 1024).to(pdt) for g in A["grads"]]
        B["grads"] = A["grads"]
    ampA = _amp(cuda) if scaler else None
    ampB = _amp(cuda) if scaler else None
    n0 = K8.fused_adam.launches
    norm = K8.fused_adam(**A, **kw, amp=ampA, split=split)
    assert K8.fused_adam.launches == n0 + 1
    rnorm = K8.fused_adam_dense(**B, **kw, amp=ampB, split=split)
    torch.cuda.synchronize()
    assert abs(norm.item() - rnorm.item()) <= 1e-5 * rnorm.item()
    for key in ("masters", "moments1", "moments2", "params"):
        for x, r in zip(A[key], B[key]):
            if x is None:
                continue
            d = (x.float() - r.float()).abs().max().item()
            top = max(r.float().abs().max().item(), 1e-30)
            if x.dtype == torch.float32:
                assert d <= 1e-6 * top, key
            else:
                assert d <= 2.0 ** (math.floor(math.log2(top)) - 7), key
    if scaler:
        assert torch.equal(ampA.scale, ampB.scale)
        assert torch.equal(ampA.counts, ampB.counts)
    # the degree-1 call's norm: the same sum in another order
    C = _buffers(cuda, pdt, A["grads"])
    dnorm = K8.fused_adam(**C, **kw, amp=_amp(cuda) if scaler else None)
    assert abs(norm.item() - dnorm.item()) <= 1e-5 * dnorm.item()


def test_fused_adam_split_overflow_writes_nothing(cuda):
    """Under a scaler an inf in a shard skips the step (phase 2 reads the
    flag phase 1 wrote)."""
    A = _buffers(cuda, torch.bfloat16)
    A["grads"][0][0, 0] = float("inf")
    before = {k: [t.clone() if t is not None else None for t in A[k]]
              for k in ("params", "masters", "moments1", "moments2")}
    amp = _amp(cuda)
    K8.fused_adam(**A, lr=3e-4, beta1=0.9, beta2=0.999, epsilon=1e-8,
                  weight_decay=0.01, decoupled=True, clip_norm=1.0, amp=amp,
                  split=(GradSync(), FLAGS))
    torch.cuda.synchronize()
    assert amp.found.item() == 1.0
    for k, ts in before.items():
        for x, b in zip(A[k], ts):
            if x is not None:
                assert torch.equal(x, b), k


@pytest.mark.parametrize("dt, D", [(torch.bfloat16, 128), (torch.bfloat16, 64),
                                   (torch.bfloat16, 32), (torch.float32, 64)],
                         ids=["bf16-128", "bf16-64", "bf16-32", "fp32-64"])
@pytest.mark.parametrize("h0", [2, 5])
def test_dropout_at_a_head_offset_is_the_whole_calls_slice(cuda, dt, D, h0):
    p, seed = 0.1, 0x5EED
    B, S, H = 2, 256, 8
    g = torch.Generator(device=cuda).manual_seed(D + h0)
    q, k, v, do = (torch.randn(B, S, H, D, device=cuda, generator=g).to(dt)
                   for _ in range(4))
    out, lse = K1.flash_attention_fwd_lse(q, k, v, True, dropout=p, seed=seed)
    grads = K1.flash_attention_bwd(q, k, v, out, lse, do, True, dropout=p,
                                   seed=seed)
    hq, hk, hv, hdo = (t[:, :, h0:].contiguous() for t in (q, k, v, do))
    n0 = K1.flash_attention_fwd_dropout.launches
    hout, hlse = K1.flash_attention_fwd_lse(hq, hk, hv, True, dropout=p,
                                            seed=seed, head_offset=h0)
    hgrads = K1.flash_attention_bwd(hq, hk, hv, hout, hlse, hdo, True,
                                    dropout=p, seed=seed, head_offset=h0)
    assert K1.flash_attention_fwd_dropout.launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(hout, out[:, :, h0:])
    assert torch.equal(hlse, lse[:, h0:])
    for a, b in zip(hgrads, grads):
        assert torch.equal(a, b[:, :, h0:])
    r_out, _ = K1.flash_attention_dense(hq, hk, hv, True, dropout=p,
                                        seed=seed, head_offset=h0)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    err = (hout.float() - r_out.float()).abs().max().item()
    assert err <= tol * r_out.float().abs().max().item()

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with a CUDA card (the kernels build from
paddle_tpu_torch/csrc with nvcc on first use):

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

Without a card every test here skips with a reason (decided inside the
``cuda`` fixture, never at import). Tolerances: fp32 1e-4; bf16 2e-2 on
unit-scale inputs (both sides accumulate in f32 and round once).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import decode_attention as K5
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as K4
from paddle_tpu_torch.ops.kernels import rms_norm as K3

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _err(a, b):
    torch.cuda.synchronize()
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(1, 64), (7, 4096), (3, 5, 128),
                                   (2, 8192)])
def test_rms_norm_kernel(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    w = torch.randn(shape[-1], device=cuda, generator=g).to(dtype)
    n = K3.rms_norm.launches
    out = K3.rms_norm(x, w, 1e-5)
    assert K3.rms_norm.launches == n + 1
    assert _err(out, K3.rms_norm_dense(x, w, 1e-5)) <= TOL[dtype]


def _paged(cuda, dtype, B, Sq, H, KV, D, page, npages, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    P = B * npages + 3
    q = torch.randn(B, Sq, H, D, device=cuda, generator=g).to(dtype)
    kp = torch.randn(P, KV, page, D, device=cuda, generator=g).to(dtype)
    vp = torch.randn(P, KV, page, D, device=cuda, generator=g).to(dtype)
    perm = torch.randperm(P, device=cuda, generator=g)[:B * npages]
    return q, kp, vp, perm.reshape(B, npages).to(torch.int32)


GEOMS = {  # (H, KV, D, page)
    "mha_d128_p8": (8, 8, 128, 8),
    "gqa4_d64_p64": (8, 2, 64, 64),
    "gqa2_d16_p8": (4, 2, 16, 8),
    "gqa2_d256_p16": (4, 2, 256, 16),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_ragged_kernel(cuda, geom, dtype):
    H, KV, D, page = GEOMS[geom]
    B, Sq, npages = 4, 16, 12
    q, kp, vp, tbl = _paged(cuda, dtype, B, Sq, H, KV, D, page, npages, 1)
    M = npages * page
    st = torch.tensor([5, M - 1, 0, 3], dtype=torch.int32, device=cuda)
    nv = torch.tensor([16, 1, 0, 7], dtype=torch.int32, device=cuda)
    n = K4.ragged_paged_attention.launches
    out = K4.ragged_paged_attention(q, kp, vp, tbl, st, nv)
    assert K4.ragged_paged_attention.launches == n + 1
    ref = K4.ragged_paged_attention_dense(q, kp, vp, tbl, st, nv)
    assert _err(out, ref) <= TOL[dtype]
    # dead slots are exactly zero
    assert (out[2] == 0).all() and (out[3, 7:] == 0).all() \
        and (out[1, 1:] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ragged_kernel_partial_tiles(cuda, dtype):
    """80 (slot, q-head) rows per KV head: a full 64-row tile and a
    partial one; live slots end mid-tile; chunks straddle 64-key pages."""
    B, Sq, H, KV, D, page, npages = 4, 40, 4, 2, 128, 64, 6
    q, kp, vp, tbl = _paged(cuda, dtype, B, Sq, H, KV, D, page, npages, 4)
    st = torch.tensor([30, 250, 0, 100], dtype=torch.int32, device=cuda)
    nv = torch.tensor([40, 1, 33, 0], dtype=torch.int32, device=cuda)
    out = K4.ragged_paged_attention(q, kp, vp, tbl, st, nv)
    ref = K4.ragged_paged_attention_dense(q, kp, vp, tbl, st, nv)
    assert _err(out, ref) <= TOL[dtype]
    assert (out[3] == 0).all() and (out[2, 33:] == 0).all() \
        and (out[1, 1:] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("sq", [1, 16])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_paged_decode_kernel(cuda, geom, sq, dtype):
    H, KV, D, page = GEOMS[geom]
    B, npages = 4, 12
    q, kp, vp, tbl = _paged(cuda, dtype, B, sq, H, KV, D, page, npages, 2)
    M = npages * page
    lengths = torch.tensor([0, 9, M // 2, M - sq], dtype=torch.int32,
                           device=cuda)
    out = K5.paged_decode_attention(q, kp, vp, tbl, lengths)
    ref = K5.paged_attention_dense(q, kp, vp, tbl, lengths)
    assert _err(out, ref) <= TOL[dtype]


def test_kernel_limits_raise_on_the_card(cuda):
    """No fallback: what the kernel does not take raises on CUDA."""
    q, kp, vp, tbl = _paged(cuda, torch.float32, 2, 1, 4, 2, 12, 8, 4, 3)
    lengths = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="D % 8"):
        K5.paged_decode_attention(q, kp, vp, tbl, lengths)
    x = torch.randn(2, 6, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        K3.rms_norm(x, torch.ones(6, device=cuda))


@pytest.mark.parametrize("how", ["built_on_cuda", "moved_to_cuda"])
def test_tiny_serving_cuda_equals_cpu(cuda, how):
    import copy

    from paddle_tpu_torch.inference import (Config, ServingEngine,
                                            create_predictor)
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

    cpu = LlamaForCausalLM(llama_tiny(), device="cpu", seed=3)
    if how == "moved_to_cuda":
        gpu = copy.deepcopy(cpu).to(cuda)
    else:
        gpu = LlamaForCausalLM(llama_tiny(), device=cuda)
        gpu.load_state_dict(cpu.state_dict())
    r = np.random.RandomState(0)
    prompts = [r.randint(1, 256, (L,)) for L in (7, 4, 19, 33, 5)]
    outs = []
    for m in (cpu, gpu):
        eng = ServingEngine(create_predictor(
            Config().set_model(m).enable_paged_kv(8)), max_batch=2,
            prefill_chunk=16)
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        done = eng.run()
        outs.append([list(done[i].new_tokens) for i in rids])
        assert all(k.device == m.device for k, _ in eng.pools)
    assert outs[0] == outs[1]

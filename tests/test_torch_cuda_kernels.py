"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with a CUDA card (the kernels build from
paddle_tpu_torch/csrc with nvcc on first use):

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

Without a card every test here skips with a reason (decided inside the
``cuda`` fixture, never at import). Tolerances: fp32 1e-4; bf16 2e-2 on
unit-scale inputs (both sides accumulate in f32 and round once). Flash
attention outputs and gradients, and RMSNorm gradients, are held to the
same tolerances as a relative L2 error over tiles of 16 positions of one
(batch, head), each tile against its own magnitude: in causal attention
the first rows and keys are far larger than the late ones, and an error
scaled by the largest value would let a wrong late tile pass.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import decode_attention as K5  # K5, K6
from paddle_tpu_torch.ops.kernels import flash_attention as K1
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


# -- K4 / K5 Hopper bodies: TMA page loads, split-K, wgmma --------------------
SPLIT = {  # (H, KV, D, page)
    "mha_d128_p64": (4, 4, 128, 64),
    "gqa4_d128_p16": (8, 2, 128, 16),
    "mha_d64_p8": (4, 4, 64, 8),
    "gqa2_d64_p64": (4, 2, 64, 64),
}
SPLIT_KEYS = 2048


def _split_pools(cuda, geom, B, Sq, seed):
    """bf16 pools of SPLIT_KEYS keys a row; the table handed to the kernel
    is the column slice tables[:, :-1] of a table one column wider, as the
    serving engine passes it (row stride npages + 1)."""
    H, KV, D, page = SPLIT[geom]
    npages = SPLIT_KEYS // page
    q, kp, vp, tbl = _paged(cuda, torch.bfloat16, B, Sq, H, KV, D, page,
                            npages + 1, seed)
    return q, kp, vp, tbl[:, :-1]


@pytest.mark.parametrize("geom", sorted(SPLIT))
def test_split_decode_body(cuda, geom):
    """K5 decode rows on wgmma_split: up to 2048 keys (4 splits of 512),
    a frontier on each side of a split boundary, start = M - 1, a row of
    one key (three empty splits), against the plain version."""
    q, kp, vp, tbl = _split_pools(cuda, geom, 6, 1, 5)
    r = K5.paged_route(q, kp, tbl)
    assert r.body == "wgmma_split" and r.splits == SPLIT_KEYS // r.split_len
    L = r.split_len
    lengths = torch.tensor([1600, L - 1, L, SPLIT_KEYS - 1, 0, 3 * L - 1],
                           dtype=torch.int32, device=cuda)
    n = K5.paged_decode_attention.launches
    out = K5.paged_decode_attention(q, kp, vp, tbl, lengths)
    assert K5.paged_decode_attention.launches == n + 1  # merge included
    ref = K5.paged_attention_dense(q, kp, vp, tbl, lengths)
    assert _scaled(out, ref) <= TOL[torch.bfloat16]
    assert _err(out, ref) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("geom", sorted(SPLIT))
def test_split_ragged_body(cuda, geom):
    """K4 on wgmma_split: 80-slot chunks at 0 and 1500 (a partial 128-row
    tile, or three tiles under GQA), thin decode rows whose frontier sits
    on each side of a 512-key split boundary and at M - 1, an all-dead
    row, a 37-slot chunk, and thin 3-slot tiles whose rows end before the
    last split; dead slots exactly 0."""
    q, kp, vp, tbl = _split_pools(cuda, geom, 9, 80, 6)
    r = K5.paged_route(q, kp, tbl)
    assert r.body == "wgmma_split" and r.splits == SPLIT_KEYS // r.split_len
    L = r.split_len
    starts = [0, 1500, L - 1, L, SPLIT_KEYS - 1, 0, 900, 1700, 2 * L - 2]
    lens = [80, 80, 1, 1, 1, 0, 37, 3, 3]
    st = torch.tensor(starts, dtype=torch.int32, device=cuda)
    nv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    n = K4.ragged_paged_attention.launches
    out = K4.ragged_paged_attention(q, kp, vp, tbl, st, nv)
    assert K4.ragged_paged_attention.launches == n + 1
    ref = K4.ragged_paged_attention_dense(q, kp, vp, tbl, st, nv)
    assert _scaled(out, ref) <= TOL[torch.bfloat16]
    assert _err(out, ref) <= TOL[torch.bfloat16]
    for b, n_live in enumerate(lens):
        assert (out[b, n_live:] == 0).all()


@pytest.mark.parametrize("kernel", ["ragged", "decode"])
def test_split_bodies_bit_equal_and_graph_replay(cuda, kernel):
    """Two calls give equal bits (the merge runs in split order, no
    atomics), and a call captured in a CUDA graph, workspace included,
    replays to the eager result."""
    if kernel == "ragged":
        q, kp, vp, tbl = _split_pools(cuda, "mha_d128_p64", 4, 64, 7)
        st = torch.tensor([1900, 0, 700, 1200], dtype=torch.int32,
                          device=cuda)
        nv = torch.tensor([1, 64, 1, 30], dtype=torch.int32, device=cuda)
        call = lambda: K4.ragged_paged_attention(q, kp, vp, tbl, st, nv)
    else:
        q, kp, vp, tbl = _split_pools(cuda, "gqa4_d128_p16", 4, 1, 8)
        st = torch.tensor([2047, 5, 1024, 700], dtype=torch.int32,
                          device=cuda)
        call = lambda: K5.paged_decode_attention(q, kp, vp, tbl, st)
    assert K5.paged_route(q, kp, tbl).splits > 1
    a, b = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, a)


# -- K6: attention over the contiguous head-major cache -----------------------
K6 = {  # (B, Sq, H, KV, D, M, offsets: int or per-row list)
    "sq1_rows_gqa4_m512": (4, 1, 8, 2, 128, 512, [0, 9, 256, 511]),
    "sq1_scalar_mha_m100": (3, 1, 4, 4, 64, 100, 99),
    "sq16_scalar_gqa4_m100": (2, 16, 8, 2, 128, 100, 84),
    "sq300_rows_gqa2_m1000": (2, 300, 4, 2, 128, 1000, [0, 700]),
    "sq300_scalar_mha_m300": (1, 300, 2, 2, 64, 300, 0),
    "sq40_rows_d16_m77": (2, 40, 2, 1, 16, 77, [0, 37]),
    # below one 64-key tile; rows past the end of the cache see all of it
    "sq1_rows_mha_m50": (3, 1, 4, 4, 128, 50, [0, 17, 49]),
    "sq16_rows_mha_m50_past_end": (2, 16, 4, 4, 64, 50, [40, 49]),
    # 4 splits of 512 over M = 2047, a row at M - 1
    "sq1_rows_gqa4_m2047": (4, 1, 8, 2, 128, 2047, [0, 511, 512, 2046]),
    # Sq 300 at ragged offsets, one at M - Sq; GQA
    "sq300_rows_gqa4_m2047": (2, 300, 8, 2, 128, 2047, [1747, 401]),
    "sq300_rows_gqa8_m100": (2, 300, 8, 1, 64, 100, [0, 37]),
}


def _contig(cuda, dtype, B, Sq, H, KV, D, M, off, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, device=cuda, generator=g).to(dtype)
    off = off if np.ndim(off) == 0 else torch.tensor(
        off, dtype=torch.int32, device=cuda)
    return mk(B, Sq, H, D), mk(B, KV, M, D), mk(B, KV, M, D), off


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", sorted(K6))
def test_decode_attention_kernel(cuda, case, dtype):
    """K6 against its plain version: scalar and per-row offsets, Sq 1 to
    300 (bf16 on wgmma_split, fp32 on f32_tile or the FMA body, D = 16 on
    mma), GQA, cache lengths below one tile and no multiple of the 8- or
    64-key steps, rows at and past the end of the cache."""
    q, k, v, off = _contig(cuda, dtype, *K6[case], 9)
    n = K5.decode_attention.launches
    out = K5.decode_attention(q, k, v, off)
    assert K5.decode_attention.launches == n + 1
    ref = K5.decode_attention_dense(q, k, v, off)
    assert _scaled(out, ref) <= TOL[dtype]
    assert _err(out, ref) <= 4 * TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("sq", [1, 64])
def test_contiguous_cache_as_pages_gives_k5(cuda, sq, dtype):
    """The counterpart of JAX test_paged_vs_contiguous_cache: a contiguous
    cache cut into pages, each row's pages in order, gives K6 and K5 the
    same keys in the same order. One body serves both in each dtype
    (wgmma_split in bf16; fma or f32_tile in fp32) with the same tiles and
    splits, so their outputs are identical."""
    B, H, KV, D, page, npages = 3, 8, 2, 128, 64, 5
    q, k, v, _ = _contig(cuda, dtype, B, sq, H, KV, D, page * npages, 0, 10)
    off = torch.tensor([0, 100, page * npages - sq], dtype=torch.int32,
                       device=cuda)

    def pages(c):
        return c.reshape(B, KV, npages, page, D).transpose(1, 2).reshape(
            B * npages, KV, page, D).contiguous()

    tbl = torch.arange(B * npages, dtype=torch.int32,
                       device=cuda).reshape(B, npages)
    a = K5.decode_attention(q, k, v, off)
    b = K5.paged_decode_attention(q, pages(k), pages(v), tbl, off)
    torch.cuda.synchronize()
    assert K5.decode_route(q, k).body == K5.paged_route(q, pages(k),
                                                        tbl).body
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_decode_route(cuda, dtype):
    """K6's route: wgmma_split for bf16 at D = 64 / 128 whatever M and Sq
    (ceil(M / 512) splits), f32_tile for fp32 with >= 16 rows a KV head,
    fma for fp32 decode rows, mma for bf16 at D = 16 with >= 16 rows; K4
    and K5 take f32_tile by the same rule."""
    def route(Sq, H, KV, D, M):
        q = torch.empty(2, Sq, H, D, device=cuda, dtype=dtype)
        return K5.decode_route(q, torch.empty(2, KV, M, D, device=cuda,
                                              dtype=dtype))
    for Sq, H, KV, D, M in [(1, 32, 32, 128, 2048), (1, 32, 8, 128, 2048),
                            (1024, 32, 32, 128, 2048), (16, 4, 4, 64, 50),
                            (300, 8, 2, 64, 2047), (4, 8, 2, 128, 100)]:
        r = route(Sq, H, KV, D, M)
        rows = Sq * H // KV
        if dtype == torch.bfloat16:
            assert r.body == "wgmma_split" and r.split_len == 512
            assert r.splits == -(-M // 512)
            assert r.workspace_bytes == (0 if r.splits == 1 else
                                         r.splits * 2 * KV * 16 * (D + 2) * 4)
        else:
            assert r.body == ("f32_tile" if rows >= 16 else "fma")
            assert r.splits == 1 and r.workspace_bytes == 0
    assert route(40, 2, 1, 16, 77).body == (
        "mma" if dtype == torch.bfloat16 else "f32_tile")
    q, kp, vp, tbl = _paged(cuda, dtype, 2, 16, 8, 2, 128, 16, 4, 1)
    assert K5.paged_route(q, kp, tbl).body == (
        "wgmma_split" if dtype == torch.bfloat16 else "f32_tile")


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("sq", [1, 40])
def test_decode_attention_graph_replay_new_offsets(cuda, sq, dtype):
    """A K6 call captured in a CUDA graph (the split workspace included)
    and replayed after its offsets changed in place equals an eager call
    at the new offsets, bit for bit."""
    q, k, v, off = _contig(cuda, dtype, 4, sq, 8, 2, 128, 2047,
                           [5, 600, 1500, 2047 - sq], 12)
    call = lambda: K5.decode_attention(q, k, v, off)
    if dtype == torch.bfloat16:
        assert K5.decode_route(q, k).splits == 4
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    off.copy_(torch.tensor([1999, 0, 511, 1024], dtype=torch.int32,
                           device=cuda))
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, call())
    assert _scaled(out, K5.decode_attention_dense(q, k, v, off)) \
        <= TOL[dtype]


@pytest.mark.parametrize("geom", ["mha_d128_p8", "gqa2_d256_p16",
                                  "gqa4_d64_p64", "gqa2_d16_p8"])
@pytest.mark.parametrize("kernel", ["ragged", "decode"])
def test_f32_tile_paged_bodies(cuda, kernel, geom):
    """fp32 K4 and K5 with >= 16 rows a KV head run f32_tile: partial
    64-row tiles, chunks straddling pages, dead slots exactly 0, against
    the plain versions within 1e-4."""
    H, KV, D, page = GEOMS[geom]
    B, Sq, npages = 4, 40, 192 // page
    q, kp, vp, tbl = _paged(cuda, torch.float32, B, Sq, H, KV, D, page,
                            npages, 13)
    M = npages * page
    assert K5.paged_route(q, kp, tbl).body == "f32_tile"
    st = torch.tensor([0, 70, M - Sq, 9], dtype=torch.int32, device=cuda)
    if kernel == "ragged":
        nv = torch.tensor([40, 1, 33, 0], dtype=torch.int32, device=cuda)
        out = K4.ragged_paged_attention(q, kp, vp, tbl, st, nv)
        ref = K4.ragged_paged_attention_dense(q, kp, vp, tbl, st, nv)
        assert (out[3] == 0).all() and (out[2, 33:] == 0).all() \
            and (out[1, 1:] == 0).all()
    else:
        out = K5.paged_decode_attention(q, kp, vp, tbl, st)
        ref = K5.paged_attention_dense(q, kp, vp, tbl, st)
    assert _err(out, ref) <= TOL[torch.float32]


def test_fused_ops_launch_k6_on_the_card(cuda):
    """masked_multihead_attention and FusedMultiTransformer with caches go
    through K6 on CUDA tensors and agree with the CPU."""
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.incubate.nn.functional import \
        masked_multihead_attention

    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(3, 3 * 4 * 64, device=cuda, generator=g)
    cache = torch.randn(2, 3, 4, 50, 64, device=cuda, generator=g)
    sl = torch.tensor([[0], [7], [49]], dtype=torch.int32, device=cuda)
    ccpu = cache.cpu()
    n = K5.decode_attention.launches
    out, _ = masked_multihead_attention(x, cache, sequence_lengths=sl)
    assert K5.decode_attention.launches == n + 1
    ref, _ = masked_multihead_attention(x.cpu(), ccpu,
                                        sequence_lengths=sl.cpu())
    assert _err(out, ref.to(cuda)) <= TOL[torch.float32]
    assert _err(cache, ccpu.to(cuda)) == 0.0
    cpu = FusedMultiTransformer(128, 2, 256, num_layers=2,
                                device="cpu").eval()
    gpu = FusedMultiTransformer(128, 2, 256, num_layers=2,
                                device=cuda).eval()
    gpu.load_state_dict(cpu.state_dict())
    cc, gc = cpu.empty_caches(2, 24), gpu.empty_caches(2, 24)
    n = K5.decode_attention.launches
    with torch.no_grad():
        for S, t in [(9, 0), (1, 9), (1, 10)]:
            xs = torch.randn(2, S, 128, device=cuda, generator=g)
            a, gc = gpu(xs, caches=gc, time_step=t)
            b, cc = cpu(xs.cpu(), caches=cc, time_step=t)
            assert _err(a, b.to(cuda)) <= TOL[torch.float32]
    assert K5.decode_attention.launches == n + 6


@pytest.mark.parametrize("page", [None, 8], ids=["static", "paged"])
def test_tiny_generate_cuda_equals_cpu(cuda, page):
    """Predictor.generate of llama_tiny on cuda and cpu from the same
    weights: ragged rows with an EOS, identical tokens (fp32)."""
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

    cpu = LlamaForCausalLM(llama_tiny(), device="cpu", seed=3)
    gpu = LlamaForCausalLM(llama_tiny(), device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    ids = np.random.RandomState(1).randint(1, 256, (3, 24))
    outs = []
    for m in (cpu, gpu):
        conf = Config().set_model(m)
        if page:
            conf.enable_paged_kv(page)
        pred = create_predictor(conf)
        outs.append(pred.generate(ids, max_new_tokens=8, lengths=[11, 24, 17],
                                  eos_token_id=7).cpu())
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(gpu.generate(torch.tensor(ids, device=cuda),
                                    max_new_tokens=5).cpu(),
                       cpu.generate(torch.tensor(ids), max_new_tokens=5))


def test_kernel_limits_raise_on_the_card(cuda):
    """No fallback: what the kernel does not take raises on CUDA."""
    q, kp, vp, tbl = _paged(cuda, torch.float32, 2, 1, 4, 2, 12, 8, 4, 3)
    lengths = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="D % 8"):
        K5.paged_decode_attention(q, kp, vp, tbl, lengths)
    kc = torch.zeros(2, 2, 10, 12, device=cuda)
    with pytest.raises(ValueError, match="D % 8"):
        K5.decode_attention(q, kc, kc, 3)
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


# -- K1 / K2: flash attention -------------------------------------------------
FLASH = {  # (B, Sq, Skv, H, KV, D, causal, segments)
    "mha_d128_causal": (2, 256, 256, 4, 4, 128, True, False),
    "gqa4_d64_causal": (2, 192, 192, 8, 2, 64, True, False),
    "mha_d64_full": (1, 128, 128, 4, 4, 64, False, False),
    "rect_d128": (2, 100, 300, 4, 2, 128, True, False),
    "segments_d128": (2, 256, 256, 4, 2, 128, True, True),
    "partial_tiles_d32": (3, 37, 37, 2, 1, 32, True, False),
    "partial_rect_d16": (1, 45, 77, 4, 4, 16, False, True),
    # the 128-row tiles' edges: one row past a tile; fewer keys than one
    # key tile; causal Sq > Skv, where the first rows see no key (output 0,
    # lse -1e30)
    "edge129_d128": (2, 129, 129, 4, 4, 128, True, False),
    "short_kv_d128": (2, 200, 50, 4, 2, 128, False, False),
    "causal_sq_gt_skv_d128": (2, 192, 70, 4, 4, 128, True, False),
}


def _scaled(a, b, block=16):
    """Largest ||a - b|| / ||b|| over tiles of ``block`` positions (dim 1)
    of one (batch, head) of [B, S, H, D] tensors; a tile whose reference
    is all zero must come out all zero."""
    torch.cuda.synchronize()
    a, b = a.float(), b.float()
    B, S, H, D = b.shape
    pad = -S % block
    dn, rn = (torch.cat([t, t.new_zeros(B, pad, H, D)], 1).reshape(
        B, -1, block, H, D).pow(2).sum((2, 4)).sqrt() for t in (a - b, b))
    return torch.where(rn > 0, dn / rn.clamp_min(1e-38),
                       torch.where(dn > 0, float("inf"), 0.0)).max().item()


def _flash(cuda, dtype, B, Sq, Skv, H, KV, D, segments, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, device=cuda, generator=g).to(dtype)
    q, k, v = mk(B, Sq, H, D), mk(B, Skv, KV, D), mk(B, Skv, KV, D)
    do = mk(B, Sq, H, D)
    qs = ks = None
    if segments:
        ks = (torch.arange(Skv, device=cuda) * 3 // Skv).to(
            torch.int32).expand(B, Skv).contiguous()
        qs = ks[:, Skv - Sq:].contiguous()
    return q, k, v, do, qs, ks


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_attention_kernels(cuda, case, dtype):
    B, Sq, Skv, H, KV, D, causal, segm = FLASH[case]
    q, k, v, do, qs, ks = _flash(cuda, dtype, B, Sq, Skv, H, KV, D, segm, 5)
    nf, nb = K1.flash_attention_fwd.launches, K1.flash_attention_bwd.launches
    out, lse = K1.flash_attention_fwd_lse(q, k, v, causal, None, qs, ks)
    grads = K1.flash_attention_bwd(q, k, v, out, lse, do, causal, None, qs,
                                   ks)
    assert (K1.flash_attention_fwd.launches,
            K1.flash_attention_bwd.launches) == (nf + 1, nb + 1)
    r_out, r_lse = K1.flash_attention_dense(q, k, v, causal, None, qs, ks)
    assert _scaled(out, r_out) <= TOL[dtype]
    assert _err(lse, r_lse) <= TOL[dtype]
    r_grads = K1.flash_attention_bwd_dense(q, k, v, do, causal, None, qs, ks)
    for a, b in zip(grads, r_grads):
        assert _scaled(a, b) <= TOL[dtype]


@pytest.mark.parametrize("case", ["mha_d128_causal", "gqa4_d64_causal",
                                  "segments_d128"])
def test_flash_attention_backward_is_deterministic(cuda, case):
    """No atomics: two K2 runs on the same inputs give the same bits."""
    B, Sq, Skv, H, KV, D, causal, segm = FLASH[case]
    q, k, v, do, qs, ks = _flash(cuda, torch.bfloat16, B, Sq, Skv, H, KV, D,
                                 segm, 7)
    out, lse = K1.flash_attention_fwd_lse(q, k, v, causal, None, qs, ks)
    first = K1.flash_attention_bwd(q, k, v, out, lse, do, causal, None, qs,
                                   ks)
    again = K1.flash_attention_bwd(q, k, v, out, lse, do, causal, None, qs,
                                   ks)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_flash_attention_autograd_and_launch_counts(cuda):
    q, k, v, do, _, _ = _flash(cuda, torch.bfloat16, 2, 128, 128, 4, 2, 64,
                               False, 6)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    nf, nb = K1.flash_attention_fwd.launches, K1.flash_attention_bwd.launches
    out = K1.flash_attention_fwd(q, k, v, True)
    assert out.grad_fn is not None
    out.backward(do)
    assert (K1.flash_attention_fwd.launches,
            K1.flash_attention_bwd.launches) == (nf + 1, nb + 1)
    r = K1.flash_attention_bwd_dense(q, k, v, do, True)
    for a, b in zip((q.grad, k.grad, v.grad), r):
        assert _scaled(a, b) <= TOL[torch.bfloat16]


DROP_CASES = ["mha_d128_causal", "gqa4_d64_causal", "mha_d64_full",
              "rect_d128", "segments_d128", "edge129_d128",
              "causal_sq_gt_skv_d128"]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", DROP_CASES)
def test_flash_attention_dropout_kernels(cuda, case, dtype):
    """K1 and K2 with attention dropout (p = 0.2) against the plain
    version with the same seed; GQA, segment ids and rectangular causal
    cases included. Each call counts one launch of its dropout variant."""
    B, Sq, Skv, H, KV, D, causal, segm = FLASH[case]
    q, k, v, do, qs, ks = _flash(cuda, dtype, B, Sq, Skv, H, KV, D, segm, 9)
    kw = dict(dropout=0.2, seed=0xD0_0D + Sq)
    n = (K1.flash_attention_fwd_dropout.launches,
         K1.flash_attention_bwd_dropout.launches)
    out, lse = K1.flash_attention_fwd_lse(q, k, v, causal, None, qs, ks, **kw)
    grads = K1.flash_attention_bwd(q, k, v, out, lse, do, causal, None, qs,
                                   ks, **kw)
    assert (K1.flash_attention_fwd_dropout.launches,
            K1.flash_attention_bwd_dropout.launches) == (n[0] + 1, n[1] + 1)
    r_out, r_lse = K1.flash_attention_dense(q, k, v, causal, None, qs, ks,
                                            **kw)
    assert _scaled(out, r_out) <= TOL[dtype]
    assert _err(lse, r_lse) <= TOL[dtype]
    r_grads = K1.flash_attention_bwd_dense(q, k, v, do, causal, None, qs, ks,
                                           **kw)
    for a, b in zip(grads, r_grads):
        assert _scaled(a, b) <= TOL[dtype]
    # the no-dropout call differs: the mask is applied
    assert not torch.equal(out, K1.flash_attention_fwd_lse(
        q, k, v, causal, None, qs, ks)[0])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_dropout_mask_reads_back_bit_exact(cuda, D, causal, dtype):
    """V's rows the identity: K1's output is non-zero exactly where the
    plain mask keeps a visible pair; dO's rows the identity too: K2's dV,
    computed on S^T, gives the same mask."""
    from paddle_tpu_torch.ops.kernels import dropout_mask as DM

    B, S, H, p, seed = 2, D, 4, 0.25, 0xABCDEF + D
    g = torch.Generator(device=cuda).manual_seed(D)
    eye = torch.eye(D, device=cuda, dtype=dtype)
    q = torch.randn(B, S, H, D, device=cuda, generator=g).to(dtype)
    k = torch.randn(B, S, H, D, device=cuda, generator=g).to(dtype)
    v = eye[None, :, None, :].expand(B, S, H, D).contiguous()
    keep = DM.dropout_keep(seed, p, B, H, S, S, cuda)
    vis = torch.ones(S, S, dtype=torch.bool, device=cuda)
    vis = vis.tril() if causal else vis
    out, lse = K1.flash_attention_fwd_lse(q, k, v, causal, dropout=p,
                                          seed=seed)
    got = (out != 0).permute(0, 2, 1, 3)
    assert torch.equal(got & vis, keep & vis)
    _, _, dv = K1.flash_attention_bwd(q, k, v, out, lse, v, causal,
                                      dropout=p, seed=seed)
    assert torch.equal((dv != 0).permute(0, 2, 3, 1) & vis, keep & vis)
    # the plain mask is the same bits on either device
    assert torch.equal(DM.dropout_keep(seed, p, B, H, S, S).to(cuda), keep)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("S", [13, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_dropout_mask_reads_back_ragged_keys(cuda, causal, S, D, dtype):
    """Sq = Skv not a multiple of 8 (a half-filled 8-key group ends each
    row; at 200 > D the read-back runs in windows of D keys): V's rows
    the identity on a window of keys (zero elsewhere) gives K1's output
    non-zero exactly where the plain mask keeps a visible pair of the
    window, and dO's rows the identity on a window of q rows gives K2's
    dV the same on S^T."""
    from paddle_tpu_torch.ops.kernels import dropout_mask as DM

    B, H, p, seed = 1, 2, 0.25, 0x5A6E + 7 * S + D
    g = torch.Generator(device=cuda).manual_seed(S + D)
    q = torch.randn(B, S, H, D, device=cuda, generator=g).to(dtype)
    k = torch.randn(B, S, H, D, device=cuda, generator=g).to(dtype)
    keep = DM.dropout_keep(seed, p, B, H, S, S, cuda)
    vis = torch.ones(S, S, dtype=torch.bool, device=cuda)
    vis = vis.tril() if causal else vis

    def window(w0):    # [B, S, H, D]: row j is e_(j - w0) inside the window
        eye = torch.zeros(S, D, device=cuda, dtype=dtype)
        n = min(D, S - w0)
        eye[w0:w0 + n, :n] = torch.eye(n, device=cuda, dtype=dtype)
        return eye[None, :, None, :].expand(B, S, H, D).contiguous(), n

    for w0 in range(0, S, D):
        v, n = window(w0)
        out, lse = K1.flash_attention_fwd_lse(q, k, v, causal, dropout=p,
                                              seed=seed)
        got = (out[..., :n] != 0).permute(0, 2, 1, 3)       # [B, H, S, n]
        kw, vw = keep[..., w0:w0 + n], vis[:, w0:w0 + n]
        assert torch.equal(got & vw, kw & vw)
        assert not (got & ~vw).any()
        _, _, dv = K1.flash_attention_bwd(q, k, v, out, lse, v, causal,
                                          dropout=p, seed=seed)
        gotv = (dv[..., :n] != 0).permute(0, 2, 3, 1)       # [B, H, n, S]
        kr, vr = keep[:, :, w0:w0 + n], vis[w0:w0 + n]
        assert torch.equal(gotv & vr, kr & vr)


def test_philox_matches_curand(cuda):
    from paddle_tpu_torch.ops.kernels import dropout_mask as DM

    rs = np.random.RandomState(4)
    ctr = torch.from_numpy(rs.randint(0, 2 ** 32, (4096, 4),
                                      dtype=np.uint64).astype(np.int64))
    key = torch.from_numpy(rs.randint(0, 2 ** 32, (4096, 2),
                                      dtype=np.uint64).astype(np.int64))
    ctr[0], key[0] = 0, 0
    mine, theirs = DM.philox_check(ctr, key)
    assert torch.equal(mine, theirs)
    assert tuple(mine[0].tolist()) == (0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                       0x9B00DBD8)
    for i in (1, 2, 3):
        words = DM.philox4x32_10(*(ctr[i:i + 1, j] for j in range(4)),
                                 int(key[i, 0]), int(key[i, 1]))
        assert [int(w) for w in words] == mine[i].tolist()


MMA_DROP = {  # (B, Sq, Skv, H, KV, D, causal, segments): the mma.sync bodies
    "d16_causal": (2, 130, 130, 4, 4, 16, True, False),
    "d32_gqa_rect": (2, 70, 200, 8, 2, 32, True, False),
    "d16_segments_full": (1, 96, 96, 4, 2, 16, False, True),
}


@pytest.mark.parametrize("case", sorted(MMA_DROP))
def test_dropout_on_the_mma_bodies(cuda, case):
    """bf16 D = 16 and 32 run the mma.sync bodies' dropout instances:
    forward and backward against the plain version with the same seed,
    each call one launch of the dropout variants."""
    B, Sq, Skv, H, KV, D, causal, segm = MMA_DROP[case]
    q, k, v, do, qs, ks = _flash(cuda, torch.bfloat16, B, Sq, Skv, H, KV, D,
                                 segm, 1)
    kw = dict(dropout=0.15, seed=0xBEEF + D)
    n = (K1.flash_attention_fwd_dropout.launches,
         K1.flash_attention_bwd_dropout.launches)
    out, lse = K1.flash_attention_fwd_lse(q, k, v, causal, None, qs, ks, **kw)
    grads = K1.flash_attention_bwd(q, k, v, out, lse, do, causal, None, qs,
                                   ks, **kw)
    assert (K1.flash_attention_fwd_dropout.launches,
            K1.flash_attention_bwd_dropout.launches) == (n[0] + 1, n[1] + 1)
    r_out, r_lse = K1.flash_attention_dense(q, k, v, causal, None, qs, ks,
                                            **kw)
    assert _scaled(out, r_out) <= TOL[torch.bfloat16]
    assert _err(lse, r_lse) <= TOL[torch.bfloat16]
    r_grads = K1.flash_attention_bwd_dense(q, k, v, do, causal, None, qs, ks,
                                           **kw)
    for a, b in zip(grads, r_grads):
        assert _scaled(a, b) <= TOL[torch.bfloat16]


# The mma bodies' structure (bf16, D = 16 / 32): a ring of cp.async stages
# (128 keys a forward stage), masks on cut tiles only, heaviest-first causal
# blocks, K2's roles in one launch. "laps" runs the ring over 2085 keys
# (17 forward stages, the last partial); "rect" puts the bottom-right
# frontier across the reversed block order, Sq > Skv leaving the first rows
# no key; "gqa4" sums four query heads in each dk/dv CTA.
MMA = {  # (B, Sq, Skv, H, KV, D, causal, segments)
    "laps_d32": (1, 200, 2085, 4, 2, 32, True, False),
    "laps_d16": (1, 2085, 2085, 2, 1, 16, True, False),
    "rect_causal_d32": (2, 300, 700, 4, 4, 32, True, False),
    "rect_causal_sq_gt_skv_d32": (2, 700, 300, 4, 4, 32, True, False),
    "gqa4_d32": (2, 256, 256, 8, 2, 32, True, False),
    "gqa4_full_d16": (1, 160, 190, 8, 2, 16, False, False),
    "segments_d32": (2, 256, 256, 4, 2, 32, True, True),
}


@pytest.mark.parametrize("p", [0.0, 0.2])
@pytest.mark.parametrize("case", sorted(MMA))
def test_mma_bodies(cuda, case, p):
    """K1 and K2 on the mma bodies against the plain version (2e-2 per
    tile, lse too), without and with dropout; K2's dq and dk/dv roles
    launched alone (parts DQ, DKV) give the one-launch backward's bits, and
    a second backward gives the same bytes (no atomics)."""
    B, Sq, Skv, H, KV, D, causal, segm = MMA[case]
    q, k, v, do, qs, ks = _flash(cuda, torch.bfloat16, B, Sq, Skv, H, KV, D,
                                 segm, 13)
    kw = dict(dropout=p, seed=0x3A3A + D if p else None)
    out, lse = K1.flash_attention_fwd_lse(q, k, v, causal, None, qs, ks, **kw)
    r_out, r_lse = K1.flash_attention_dense(q, k, v, causal, None, qs, ks,
                                            **kw)
    assert _scaled(out, r_out) <= TOL[torch.bfloat16]
    assert _err(lse, r_lse) <= TOL[torch.bfloat16]
    grads = K1.flash_attention_bwd(q, k, v, out, lse, do, causal, None, qs,
                                   ks, **kw)
    r_grads = K1.flash_attention_bwd_dense(q, k, v, do, causal, None, qs, ks,
                                           **kw)
    for a, b in zip(grads, r_grads):
        assert _scaled(a, b) <= TOL[torch.bfloat16]
    again = K1.flash_attention_bwd(q, k, v, out, lse, do, causal, None, qs,
                                   ks, **kw)
    args = (q, k, v, out, lse, do, causal, 1.0 / D ** 0.5, qs, ks)
    drop = K1._drop_args(p, kw["seed"], "test")
    dq = K1._k2(*args, parts=K1.DQ, drop=drop)[0]
    _, dk, dv, _ = K1._k2(*args, parts=K1.DKV, drop=drop)
    torch.cuda.synchronize()
    for a, b, c in zip(grads, again, (dq, dk, dv)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_mma_varlen_pack_through_flash_attn_unpadded(cuda):
    """A causal pack at D = 32 through nn.functional.flash_attn_unpadded:
    K1/K2 on the mma bodies with the frontier arrays (their varlen
    counters), never the plain version; the output against the plain
    version on the pack's ranges, the gradients against K2's function."""
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops import attention as tattn

    cu_q, cu_k = [0, 150, 230, 430], [0, 300, 420, 900]
    g = torch.Generator(device=cuda).manual_seed(21)
    mk = lambda *s: torch.randn(*s, device=cuda, generator=g).bfloat16()
    q, k, v, do = mk(430, 8, 32), mk(900, 2, 32), mk(900, 2, 32), \
        mk(430, 8, 32)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    n = (K1.flash_attention_fwd_varlen.launches,
         K1.flash_attention_bwd_varlen.launches)
    out, soft = PF.flash_attn_unpadded(q, k, v, cu_q, cu_k, causal=True)
    out.backward(do)
    assert soft is None
    assert (K1.flash_attention_fwd_varlen.launches,
            K1.flash_attention_bwd_varlen.launches) == (n[0] + 1, n[1] + 1)
    qr, _ = tattn.varlen_ranges(cu_q, cu_k, 430, 900, True, cuda)
    q4, k4, v4 = (t.detach()[None] for t in (q, k, v))
    r_out = K1.flash_attention_dense(q4, k4, v4, q_ranges=qr)[0]
    assert _scaled(out.detach()[None], r_out) <= TOL[torch.bfloat16]
    ref = _k2_function(q4, k4, v4, do[None], out.detach()[None],
                       K1.ranges_keep(qr, 900))
    for a, b in zip((q.grad, k.grad, v.grad), ref):
        assert _scaled(a[None], b) <= TOL[torch.bfloat16]


def _poisoned_like(shape, cuda):
    """Leave NaN in the allocator's next block of ``shape`` bf16, so an
    output a kernel does not write shows."""
    torch.full(shape, float("nan"), device=cuda, dtype=torch.bfloat16)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("empty", ["sq", "skv"])
def test_no_pair_calls_at_d64_d128(cuda, D, empty):
    """bf16 calls with no q row or no key at D = 64 / 128 (the Hopper
    bodies' tensor maps need both): K1 gives O = 0 and lse -1e30, K2 zero
    gradients, each call one launch of each."""
    Sq, Skv = (0, 50) if empty == "sq" else (40, 0)
    q, k, v, do, _, _ = _flash(cuda, torch.bfloat16, 2, Sq, Skv, 4, 2, D,
                               False, 17)
    nf, nb = K1.flash_attention_fwd.launches, K1.flash_attention_bwd.launches
    _poisoned_like(q.shape, cuda)
    out, lse = K1.flash_attention_fwd_lse(q, k, v, True)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.equal(lse, torch.full_like(lse, -1e30))
    _poisoned_like(k.shape, cuda)
    grads = K1.flash_attention_bwd(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    assert (K1.flash_attention_fwd.launches,
            K1.flash_attention_bwd.launches) == (nf + 1, nb + 1)
    for t in grads:
        assert torch.equal(t, torch.zeros_like(t))


# varlen packs: (cu_seqlens_q, cu_seqlens_k, Tq, Tk); "chunked" gives each
# q the last part of its sequence, "padded" leaves tokens past both packs,
# "short_q" has a sequence with more q than k tokens (rows that see no key)
PACKS = {
    "chunked": ([0, 64, 96, 200], [0, 150, 230, 400], 200, 400),
    "padded": ([0, 30, 100], [0, 50, 170], 110, 190),
    "short_q": ([0, 70, 90, 140], [0, 40, 170, 200], 140, 200),
    "same": ([0, 33, 128, 160], [0, 33, 128, 160], 160, 160),
}


def _k2_function(q, k, v, do, out, keep, p=0.0, seed=None):
    """(dq, dk, dv) as K2 computes them, written out in f32 for [1, S, H,
    D] inputs and a keep-mask [1, Sq, Skv]: delta = rowsum(dO o O) from
    K1's output ``out``, P and dS rounded to the inputs' dtype before
    their products (as the TPU kernel rounds them), the dropout factor Z
    on dP and, for dv, on P. Autograd through the plain version takes the
    exact delta and unrounded P and dS; where a row sees one key or two
    (a sequence with more q than k tokens), dP - delta nearly cancels and
    those roundings are most of dq, kernel or not."""
    H, KV, D = q.shape[2], k.shape[2], q.shape[3]
    rep = H // KV
    qf, dof, of = (t[0].float().transpose(0, 1) for t in (q, do, out))
    kf, vf = (t[0].float().transpose(0, 1).repeat_interleave(rep, 0)
              for t in (k, v))
    s = (qf @ kf.transpose(-1, -2) / D ** 0.5).masked_fill(~keep, -1e30)
    P = torch.softmax(s, -1) * keep
    Z = (K1._dropout_factor(seed, p, 1, H, H, q.shape[1], k.shape[1],
                            q.device)[0, :, 0] if p else 1.0)
    dP = dof @ vf.transpose(-1, -2) * Z
    dS = (P * (dP - (dof * of).sum(-1, keepdim=True))).to(q.dtype).float()
    dq = dS @ kf / D ** 0.5
    dk = (dS.transpose(-1, -2) @ qf / D ** 0.5).reshape(KV, rep, -1, D)
    dv = ((P * Z).to(q.dtype).float().transpose(-1, -2) @ dof).reshape(
        KV, rep, -1, D)
    return (dq.transpose(0, 1)[None], dk.sum(1).transpose(0, 1)[None],
            dv.sum(1).transpose(0, 1)[None])


def _pack(cuda, dtype, name, H, KV, D, seed):
    cu_q, cu_k, Tq, Tk = PACKS[name]
    g = torch.Generator(device=cuda).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, device=cuda, generator=g).to(dtype)
    return (mk(Tq, H, D), mk(Tk, KV, D), mk(Tk, KV, D), mk(Tq, H, D), cu_q,
            cu_k)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("D,KV", [(16, 2), (32, 4), (64, 2), (128, 4)])
@pytest.mark.parametrize("pack", sorted(PACKS))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("p", [0.0, 0.2])
def test_varlen_pack_runs_k1_k2_with_frontiers(cuda, pack, causal, D, KV,
                                               dtype, p, monkeypatch):
    """Every varlen pack, causal with its own q and k boundaries included,
    with or without dropout, runs K1 and K2 with the frontier arrays
    (their launch counters), never the dense plain version; K1 matches
    that plain version on the same ranges, K2 the gradients written out
    with K2's delta and roundings (``_k2_function``), and the CPU route
    gives the same output."""
    from paddle_tpu_torch.ops import attention as tattn

    calls = []
    dense = K1.flash_attention_dense
    monkeypatch.setattr(K1, "flash_attention_dense", lambda *a, **kw: (
        calls.append(1), dense(*a, **kw))[1])
    q, k, v, do, cu_q, cu_k = _pack(cuda, dtype, pack, 8, KV, D, 3)
    kw = dict(dropout=p, seed=0x5EED + D if p else None)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    n = (K1.flash_attention_fwd_varlen.launches,
         K1.flash_attention_bwd_varlen.launches)
    out = tattn.flash_attn_varlen(q, k, v, cu_q, cu_k, causal, **kw)
    out.backward(do)
    assert (K1.flash_attention_fwd_varlen.launches,
            K1.flash_attention_bwd_varlen.launches) == (n[0] + 1, n[1] + 1)
    assert not calls
    monkeypatch.setattr(K1, "flash_attention_dense", dense)
    qr, kr = tattn.varlen_ranges(cu_q, cu_k, q.shape[0], k.shape[0], causal,
                                 cuda)
    q4, k4, v4 = (t.detach()[None] for t in (q, k, v))
    r_out = dense(q4, k4, v4, dropout=p, seed=kw["seed"], q_ranges=qr)[0]
    assert _scaled(out.detach()[None], r_out) <= TOL[dtype]
    ref = _k2_function(q4, k4, v4, do[None], out.detach()[None],
                       K1.ranges_keep(qr, k.shape[0]), p, kw["seed"])
    # a row that sees one key ("short_q") has dq = 0 in exact arithmetic
    # (dS = z dP - delta cancels), so both sides give rounding noise there
    # (in fp32 it differs between f32 and f64 by a tile error of 110 at
    # D = 32, p = 0.2): those rows are held to TOL of the largest |dq|,
    # the rest per tile
    one = (qr[0, :, 0] == qr[0, :, 1])[None, :, None, None]
    dq, ref_dq = q.grad[None], ref[0]
    assert _err(dq.masked_fill(~one, 0), 0 * dq) <= TOL[dtype] * _err(
        ref_dq, 0 * ref_dq)
    grads = (dq.masked_fill(one, 0), k.grad[None], v.grad[None])
    for a, b in zip(grads, (ref_dq.masked_fill(one, 0),) + ref[1:]):
        assert _scaled(a, b) <= TOL[dtype]
    cpu = tattn.flash_attn_varlen(*(t.detach().cpu() for t in (q, k, v)),
                                  cu_q, cu_k, causal, **kw)
    assert _scaled(out.detach()[None], cpu.to(cuda)[None]) <= TOL[dtype]


# packs whose blocks differ in work in other orders than chip_smoke.py's
# descending pack: the sequences shortest first (each q the last half),
# and documents of lengths that are no multiple of 64 (q = k), so blocks
# straddle documents
ROLE_PACKS = {
    "ascending": ([32, 96, 160, 224], [64, 192, 320, 448]),
    "straddling": ([100, 333, 70, 260, 201],) * 2,
}


@pytest.mark.parametrize("p", [0.0, 0.2])
@pytest.mark.parametrize("KV", [8, 2])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("pack", sorted(ROLE_PACKS))
def test_frontier_launch_roles_are_bit_equal(cuda, pack, D, KV, p):
    """The Hopper bodies at the frontier arrays (bf16, 8 q heads, the
    1-D grids): K2's DQ and DKV parts launched alone give the bits of
    their one launch together, two runs of K1 and K2 the same bits, and
    K1's output agrees with the plain version."""
    from paddle_tpu_torch.ops import attention as tattn

    q_lens, k_lens = ROLE_PACKS[pack]
    cu_q, cu_k = np.cumsum([0] + q_lens), np.cumsum([0] + k_lens)
    Tq, Tk, H = int(cu_q[-1]), int(cu_k[-1]), 8
    g = torch.Generator(device=cuda).manual_seed(D + KV)
    mk = lambda *s: torch.randn(*s, device=cuda, generator=g).bfloat16()
    q, do = mk(1, Tq, H, D), mk(1, Tq, H, D)
    k, v = mk(1, Tk, KV, D), mk(1, Tk, KV, D)
    qr, kr = tattn.varlen_ranges(cu_q.tolist(), cu_k.tolist(), Tq, Tk, True,
                                 cuda)
    drop = K1._drop_args(p, 0xD0 + D, "test")
    scale = 1.0 / D ** 0.5
    o, lse = K1._k1(q, k, v, False, scale, None, None, None, drop, qr, kr)
    o2, lse2 = K1._k1(q, k, v, False, scale, None, None, None, drop, qr, kr)
    args = (q, k, v, o, lse, do, False, scale, None, None)
    kw = dict(drop=drop, qr=qr, kr=kr)
    dq, dk, dv, work = K1._k2(*args, **kw)
    again = K1._k2(*args, **kw)[:3]
    alone = (K1._k2(*args, parts=K1.DQ, work=work, **kw)[0],
             *K1._k2(*args, parts=K1.DKV, work=work, **kw)[1:3])
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    for a, b, c in zip((dq, dk, dv), again, alone):
        assert torch.equal(a, b) and torch.equal(a, c)
    r_out = K1.flash_attention_dense(q, k, v, q_ranges=qr, dropout=p,
                                     seed=0xD0 + D if p else None)[0]
    assert _scaled(o, r_out) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_varlen_dropout_mask_reads_back_bit_exact(cuda, D):
    """A causal pack with differing boundaries, V's rows the identity:
    K1's output is non-zero exactly where the plain mask (batch row 0,
    packed rows and keys) keeps a pair the frontiers let through, and K2's
    dV (dO's rows the identity) gives the same mask on S^T."""
    from paddle_tpu_torch.ops import attention as tattn
    from paddle_tpu_torch.ops.kernels import dropout_mask as DM

    cu_q, cu_k = [0, D // 4, D // 2], [0, D // 2, D]
    Tq, Tk, H, p, seed = D // 2, D, 2, 0.3, 0xFACE + D
    g = torch.Generator(device=cuda).manual_seed(D)
    eye = torch.eye(D, device=cuda, dtype=torch.bfloat16)
    q = torch.randn(1, Tq, H, D, device=cuda, generator=g).bfloat16()
    k = torch.randn(1, Tk, H, D, device=cuda, generator=g).bfloat16()
    v = eye[None, :Tk, None, :].expand(1, Tk, H, D).contiguous()
    qr, kr = tattn.varlen_ranges(cu_q, cu_k, Tq, Tk, True, cuda)
    vis = K1.ranges_keep(qr, Tk)[:, None]                 # [1, 1, Tq, Tk]
    keep = DM.dropout_keep(seed, p, 1, H, Tq, Tk, cuda)
    kw = dict(dropout=p, seed=seed, q_ranges=qr, kv_ranges=kr)
    out, lse = K1.flash_attention_fwd_lse(q, k, v, **kw)
    got = (out[..., :Tk] != 0).permute(0, 2, 1, 3)
    assert torch.equal(got & vis, keep & vis)
    assert not (got & ~vis).any()
    dout = eye[None, :Tq, None, :].expand(1, Tq, H, D).contiguous()
    _, _, dv = K1.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert torch.equal((dv[..., :Tq] != 0).permute(0, 2, 3, 1) & vis,
                       keep & vis)


def test_attention_dropout_entry_on_the_card(cuda):
    """ops.attention.flash_attention with a generator: the call draws one
    seed and launches the dropout kernel, never the dense path; the
    gradient flows through K2's dropout variant."""
    from paddle_tpu_torch.ops import attention as tattn
    from paddle_tpu_torch.ops.kernels import dropout_mask as DM

    q, k, v, do, _, _ = _flash(cuda, torch.bfloat16, 2, 128, 128, 4, 2, 64,
                               False, 2)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    n = (K1.flash_attention_fwd_dropout.launches,
         K1.flash_attention_bwd_dropout.launches)
    out = tattn.flash_attention(q, k, v, True, 0.1,
                                generator=torch.Generator().manual_seed(3))
    out.backward(do)
    assert (K1.flash_attention_fwd_dropout.launches,
            K1.flash_attention_bwd_dropout.launches) == (n[0] + 1, n[1] + 1)
    seed = DM.draw_seed(torch.Generator().manual_seed(3))
    ref = K1.flash_attention_bwd_dense(q, k, v, do, True, dropout=0.1,
                                       seed=seed)
    for a, b in zip((q.grad, k.grad, v.grad), ref):
        assert _scaled(a, b) <= TOL[torch.bfloat16]


def test_flash_attention_limits_raise_on_the_card(cuda):
    q = torch.randn(1, 16, 2, 96, device=cuda)
    with pytest.raises(ValueError, match="head dim 96"):
        K1.flash_attention_fwd(q, q, q)
    x = torch.randn(1, 16, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K1.flash_attention_fwd(x.transpose(1, 2), x.transpose(1, 2),
                               x.transpose(1, 2))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_rms_norm_gradient_on_the_card(cuda, dtype):
    """K3 inside its autograd.Function: a CUDA output that requires grad
    has a grad_fn, and the backward matches autograd on the plain
    version; under no_grad it is one launch as before."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(3, 5, 256, device=cuda, generator=g).to(
        dtype).requires_grad_(True)
    w = torch.randn(256, device=cuda, generator=g).to(
        dtype).requires_grad_(True)
    go = torch.randn(3, 5, 256, device=cuda, generator=g).to(dtype)
    out = K3.rms_norm(x, w, 1e-5)
    assert out.grad_fn is not None
    dx, dw = torch.autograd.grad(out, (x, w), go)
    rx, rw = torch.autograd.grad(K3.rms_norm_dense(x, w, 1e-5), (x, w), go)
    assert _scaled(dx.reshape(1, 15, 1, 256),
                   rx.reshape(1, 15, 1, 256)) <= TOL[dtype]
    assert _scaled(dw[None, None, None], rw[None, None, None]) <= TOL[dtype]
    n = K3.rms_norm.launches
    with torch.no_grad():
        assert K3.rms_norm(x, w, 1e-5).grad_fn is None
    assert K3.rms_norm.launches == n + 1


def test_tiny_training_cuda_equals_cpu(cuda):
    """Three AdamW steps of llama_tiny (fp32, TF32 off) through
    ParallelEngine on cuda and on cpu from the same weights."""
    from paddle_tpu_torch.distributed.engine import ParallelEngine
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               LlamaPretrainingCriterion,
                                               llama_tiny)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    cpu = LlamaForCausalLM(llama_tiny(), device="cpu", seed=3)
    gpu = LlamaForCausalLM(llama_tiny(), device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    ids = np.random.RandomState(0).randint(0, 256, (2, 65))
    batch = {"x": ids[:, :-1], "y": ids[:, 1:]}
    crit = LlamaPretrainingCriterion()
    losses = []
    for m in (cpu, gpu):
        opt = AdamW(learning_rate=3e-3, parameters=m.parameters(),
                    multi_precision=True,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        step = ParallelEngine(m, opt).train_step(
            lambda mm, b: crit(mm(b["x"]), b["y"]))
        losses.append([float(step(batch)) for _ in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


def test_tiny_training_bf16_attention_grads(cuda):
    """llama_tiny in bf16 on the card: every layer's attention, as the
    training forward and backward run it (K1 and K2's tensor-core
    bodies, through autograd), against the plain version on the same q,
    k, v and output gradient."""
    import paddle_tpu_torch.models.llama as llama
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               LlamaPretrainingCriterion,
                                               llama_tiny)

    m = LlamaForCausalLM(llama_tiny(dtype="bfloat16"), device=cuda, seed=4)
    ids = torch.tensor(np.random.RandomState(1).randint(0, 256, (2, 65)),
                       device=cuda)
    kernel_path, seen = llama.flash_attention, []

    def watched(q, k, v, causal=False, dropout=0.0):
        out = kernel_path(q, k, v, causal=causal, dropout=dropout)
        rec = dict(q=q.detach(), k=k.detach(), v=v.detach(),
                   out=out.detach())
        for key, t in (("do", out), ("dq", q), ("dk", k), ("dv", v)):
            t.register_hook(lambda g, key=key: rec.__setitem__(key, g))
        seen.append(rec)
        return out

    nb = K1.flash_attention_bwd.launches
    llama.flash_attention = watched
    try:
        LlamaPretrainingCriterion()(m(ids[:, :-1]), ids[:, 1:]).backward()
    finally:
        llama.flash_attention = kernel_path
    assert len(seen) == 2 and K1.flash_attention_bwd.launches == nb + 2
    for r in seen:
        assert r["q"].dtype == torch.bfloat16
        r_out = K1.flash_attention_dense(r["q"], r["k"], r["v"], True)[0]
        assert _scaled(r["out"], r_out) <= TOL[torch.bfloat16]
        ref = K1.flash_attention_bwd_dense(r["q"], r["k"], r["v"], r["do"],
                                           True)
        for n, g in zip(("dq", "dk", "dv"), ref):
            assert _scaled(r[n], g) <= TOL[torch.bfloat16], n


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_varlen_noncausal_rect_pack_launches_k1(cuda, dtype):
    """A non-causal varlen pack with Tq != Tk: K1 serves it on the card
    (with the pack's frontier arrays), and it matches the CPU route."""
    from paddle_tpu_torch.ops.attention import flash_attn_varlen

    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn(64, 4, 64, device=cuda, generator=g).to(dtype)
    k = torch.randn(80, 2, 64, device=cuda, generator=g).to(dtype)
    v = torch.randn(80, 2, 64, device=cuda, generator=g).to(dtype)
    cu_q, cu_k = [0, 20, 52, 64], [0, 30, 50, 80]
    n = K1.flash_attention_fwd.launches
    out = flash_attn_varlen(q, k, v, cu_q, cu_k)
    assert K1.flash_attention_fwd.launches == n + 1
    ref = flash_attn_varlen(q.cpu(), k.cpu(), v.cpu(), cu_q, cu_k)
    assert _scaled(out[None], ref.to(cuda)[None]) <= TOL[dtype]


# -- K1's tiles and K7, the measured tile search --------------------------------
TILE_CASES = {  # (B, Sq, Skv, H, KV, D, causal, segments), bf16
    "d128_causal": (2, 256, 256, 4, 4, 128, True, False),
    "d64_causal": (2, 256, 256, 4, 4, 64, True, False),
    "d128_full": (1, 200, 200, 4, 4, 128, False, False),
    "gqa4_d64_full": (2, 192, 192, 8, 2, 64, False, False),
    "gqa4_d128_causal": (2, 256, 256, 8, 2, 128, True, False),
    "rect_d128": (2, 100, 300, 4, 2, 128, True, False),
    "rect_long_q_d64": (1, 300, 130, 4, 4, 64, False, False),
    # a partial last q tile at every block_q (1000 = 7 * 128 + 104 =
    # 5 * 192 + 40 = 15 * 64 + 40)
    "partial_q1000_d128": (1, 1000, 1000, 4, 4, 128, True, False),
    "partial_q1000_gqa_d64": (1, 1000, 1000, 2, 1, 64, True, False),
    "segments_d128": (2, 256, 256, 4, 2, 128, True, True),
    "segments_d64_full": (1, 320, 320, 4, 4, 64, False, True),
    # causal Sq > Skv: the first rows see no key (output 0, lse -1e30)
    "zero_key_rows_d128": (2, 192, 70, 4, 4, 128, True, False),
    "zero_key_rows_d64": (1, 300, 100, 2, 2, 64, True, False),
}


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_k1_every_built_tile(cuda, case):
    """K1 at each tile the build lists (the default too) against the
    plain version. Every tile runs the softmax in the same 64-key
    sub-steps, so all tiles give the same bits, and the default tile
    (None) is the first listed."""
    B, Sq, Skv, H, KV, D, causal, segm = TILE_CASES[case]
    q, k, v, _, qs, ks = _flash(cuda, torch.bfloat16, B, Sq, Skv, H, KV, D,
                                segm, 11)
    tiles = K1.fwd_tiles(D, torch.bfloat16)
    assert len(tiles) >= 3 and tiles[0] == (128, 128)
    r_out, r_lse = K1.flash_attention_dense(q, k, v, causal, None, qs, ks)
    outs = {}
    for t in tiles:
        n = K1.flash_attention_fwd.launches
        out, lse = K1.flash_attention_fwd_lse(q, k, v, causal, None, qs, ks,
                                              blocks=t)
        assert K1.flash_attention_fwd.launches == n + 1
        assert _scaled(out, r_out) <= TOL[torch.bfloat16], t
        assert _err(lse, r_lse) <= TOL[torch.bfloat16], t
        outs[t] = (out, lse)
    default = K1.flash_attention_fwd_lse(q, k, v, causal, None, qs, ks)
    torch.cuda.synchronize()
    for out, lse in list(outs.values()) + [default]:
        assert torch.equal(out, outs[tiles[0]][0])
        assert torch.equal(lse, outs[tiles[0]][1])


def test_k1_tiles_listed_and_refused(cuda):
    import ctypes

    for D in (64, 128):
        tiles = K1.fwd_tiles(D, torch.bfloat16)
        assert len(set(tiles)) == len(tiles) >= 3
        assert all(bq in (64, 128, 192) and bkv in (64, 128)
                   for bq, bkv in tiles)
    assert K1.fwd_tiles(128, torch.float32) == ()
    assert K1.fwd_tiles(32, torch.bfloat16) == ()
    q, k, v, _, _, _ = _flash(cuda, torch.bfloat16, 1, 128, 128, 2, 2, 128,
                              False, 3)
    for bad in ((256, 128), (64, 32), (128, 256)):
        with pytest.raises(ValueError, match="not built"):
            K1.flash_attention_fwd_lse(q, k, v, True, blocks=bad)
    qf = q.float()
    with pytest.raises(ValueError, match="not built"):
        K1.flash_attention_fwd_lse(qf, qf, qf, True, blocks=(128, 128))
    # the C entry refuses an unlisted pair itself, without a launch
    out = torch.empty_like(q)
    lse = torch.empty(1, 2, 128, device=cuda)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    null = ctypes.c_void_p(0)
    rc = K1._lib().flash_attention_fwd_launch(
        p(q), p(k), p(v), null, null, null, null, p(out),
        p(lse), 1, 128, 128, 2, 2, 128, 1, 0.1, 1, 256, 128,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert rc != 0


def test_k7_search_on_the_card(cuda, tmp_path):
    """FLAGS_use_autotune on: the first call measures every built tile at
    the call's shape and caches the argmin in the file; later calls, and
    a new cache over the file, measure nothing and run that tile."""
    import json

    from paddle_tpu_torch import get_flags, set_flags
    from paddle_tpu_torch.ops.kernels import autotune as K7

    q, k, v, _, _, _ = _flash(cuda, torch.bfloat16, 2, 512, 512, 8, 2, 128,
                              False, 12)
    path = str(tmp_path / "autotune.json")
    old = K7.set_cache(K7.AlgoCache(path))
    flag = get_flags("use_autotune")["use_autotune"]
    set_flags({"FLAGS_use_autotune": True})
    try:
        tiles = K1.fwd_tiles(128, torch.bfloat16)
        n = K7.measure_flash_blocks.launches
        chosen = K1._select_blocks(q, k, True, None)
        rec = K7.search_log[-1]
        assert K7.measure_flash_blocks.launches == n + len(tiles)
        assert set(rec["times"]) == set(tiles)
        assert all(0 < t < float("inf") for t in rec["times"].values())
        assert chosen == min(rec["times"], key=rec["times"].get)
        key = K1._autotune_key(q, k, True)
        assert rec["key"] == key
        assert json.load(open(path)) == {key: list(chosen)}
        K7.set_cache(K7.AlgoCache(path))
        out = K1.flash_attention_fwd(q, k, v, True)
        assert K7.measure_flash_blocks.launches == n + len(tiles)
        ref, _ = K1.flash_attention_fwd_lse(q, k, v, True, blocks=chosen)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
    finally:
        set_flags({"FLAGS_use_autotune": flag})
        K7.set_cache(old)


# -- K8: the multi-tensor Adam / AdamW update ---------------------------------
from paddle_tpu_torch import amp as _amp  # noqa: E402
from paddle_tpu_torch.ops.kernels import fused_adam as K8  # noqa: E402

K8_KW = dict(lr=1e-2, beta1=0.9, beta2=0.999, epsilon=1e-8,
             weight_decay=0.05)


def _k8_set(dev, shapes, pdt, sdt, master, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    params = [torch.randn(s, device=dev, generator=g).to(pdt) for s in shapes]
    return dict(
        params=params,
        grads=[(0.1 * torch.randn(s, device=dev, generator=g)).to(pdt)
               for s in shapes],
        masters=[p.float().clone() if master else None for p in params],
        moments1=[(0.01 * torch.randn(s, device=dev, generator=g)).to(sdt)
                  for s in shapes],
        moments2=[(1e-4 * torch.rand(s, device=dev, generator=g)).to(sdt)
                  for s in shapes],
        decays=[i % 3 != 0 for i in range(len(shapes))])


def _k8_clone(s):
    return {k: [t.clone() if isinstance(t, torch.Tensor) else t for t in v]
            for k, v in s.items()}


def _k8_amp(dev, scale=1024.0):
    return _amp.AmpStep(torch.tensor([scale], device=dev),
                        torch.tensor([3, 0, 4], dtype=torch.int32,
                                     device=dev),
                        True, 5, 1, 2.0, 0.5, 2.0 ** 62)


def _k8_buffers(s):
    return [t for k in ("params", "masters", "moments1", "moments2")
            for t in s[k] if t is not None]


def _k8_agree(a, b):
    """f32 buffers within 1e-6 of the reference's largest magnitude; bf16
    and f16 buffers within one unit in the last place."""
    torch.cuda.synchronize()
    for x, r in zip(_k8_buffers(a), _k8_buffers(b)):
        if x.dtype == torch.float32:
            err = (x - r).abs().max().item()
            assert err <= 1e-6 * r.abs().max().item(), err
        else:
            ulps = (x.view(torch.int16).int()
                    - r.view(torch.int16).int()).abs().max().item()
            assert ulps <= 1, ulps


K8_SMALL = [(5,), (7, 3), (64, 33), (1,), (130, 257), (8,), (3, 5, 7),
            (65536 + 9,)] * 20          # 160 tensors, tails and chunk edges


@pytest.mark.parametrize("pdt,sdt,master", [
    (torch.float32, torch.float32, False),
    (torch.bfloat16, torch.float32, True),
    (torch.bfloat16, torch.bfloat16, True),
    (torch.bfloat16, torch.float32, False),
    (torch.float16, torch.float32, True),
    (torch.float32, torch.bfloat16, False)], ids=str)
@pytest.mark.parametrize("variant", ["adamw_clip", "adam_l1", "amp_clean"])
def test_fused_adam_many_small_tensors(cuda, pdt, sdt, master, variant):
    s = _k8_set(cuda, K8_SMALL, pdt, sdt, master, seed=1)
    ref = _k8_clone(s)
    kw = dict(K8_KW, decoupled=variant != "adam_l1",
              l1=variant == "adam_l1",
              clip_norm=0.5 if variant == "adamw_clip" else 0.0, step=3)
    amps = [None, None]
    if variant == "amp_clean":
        for d in (s, ref):
            d["grads"] = [(g.float() * 1024.0).to(g.dtype)
                          for g in d["grads"]]
        amps = [_k8_amp(cuda), _k8_amp(cuda)]
    n = K8.fused_adam.launches
    norm = K8.fused_adam(**s, **kw, amp=amps[0])
    assert K8.fused_adam.launches == n + 1
    rnorm = K8.fused_adam_dense(**ref, **kw, amp=amps[1])
    _k8_agree(s, ref)
    if norm is not None:
        assert abs(norm.item() - rnorm.item()) <= 1e-5 * rnorm.item()
    if variant == "amp_clean":
        assert torch.equal(amps[0].scale, amps[1].scale)
        assert torch.equal(amps[0].counts, amps[1].counts)
        assert amps[0].found.item() == 0.0


def test_fused_adam_tensor_over_2_31_bytes(cuda):
    n = (1 << 31) // 4 + 4099            # f32: over 2^31 bytes, ragged tail
    s = _k8_set(cuda, [(n,), (300,)], torch.float32, torch.float32, False,
                seed=2)
    assert s["params"][0].nbytes > 2 ** 31
    tail = s["params"][0][-5:].clone()
    kw = dict(K8_KW, decoupled=True, clip_norm=1.0, step=7)
    norm = K8.fused_adam(**s, **kw)
    # the plain version on the same inputs (the same seeded generator)
    ref = _k8_set(cuda, [(n,), (300,)], torch.float32, torch.float32, False,
                  seed=2)
    rnorm = K8.fused_adam_dense(**ref, **kw)
    assert abs(norm.item() - rnorm.item()) <= 1e-5 * rnorm.item()
    _k8_agree(s, ref)
    assert not torch.equal(s["params"][0][-5:], tail)


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16], ids=str)
def test_fused_adam_overflow_leaves_every_buffer_bit_equal(cuda, pdt):
    s = _k8_set(cuda, K8_SMALL[:16], pdt, torch.float32,
                pdt != torch.float32, seed=3)
    s["grads"][5].view(-1)[2] = float("inf")
    before = [t.clone() for t in _k8_buffers(s)]
    a, b = _k8_amp(cuda), _k8_amp(cuda)
    K8.fused_adam(**s, **K8_KW, decoupled=True, clip_norm=1.0, amp=a)
    torch.cuda.synchronize()
    for x, y in zip(_k8_buffers(s), before):
        assert torch.equal(x, y)
    assert a.found.item() == 1.0
    # the bookkeeping of the plain version: decays (decr_every 1), the
    # applied-step count does not advance, good steps reset
    K8.fused_adam_dense(**_k8_clone(s), **K8_KW, decoupled=True,
                        clip_norm=1.0, amp=b)
    assert a.scale.item() == b.scale.item() == 512.0
    assert a.counts.tolist() == b.counts.tolist() == [0, 0, 4]


def test_fused_adam_norm_is_deterministic(cuda):
    outs = []
    for _ in range(2):
        s = _k8_set(cuda, K8_SMALL, torch.bfloat16, torch.float32, True,
                    seed=4)
        norm = K8.fused_adam(**s, **K8_KW, decoupled=True, clip_norm=1.0)
        outs.append((norm.item(), [t.clone() for t in _k8_buffers(s)]))
    assert outs[0][0] == outs[1][0]
    for x, y in zip(outs[0][1], outs[1][1]):
        assert torch.equal(x, y)


def test_fused_adam_layout_and_dtype_raise(cuda):
    s = _k8_set(cuda, [(16, 8), (4,)], torch.float32, torch.float32, False,
                seed=5)
    bad = _k8_clone(s)
    bad["grads"][0] = bad["grads"][0].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        K8.fused_adam(**bad, **K8_KW, step=1)
    bad = _k8_clone(s)
    buf = torch.zeros(65, device=cuda)
    bad["params"][1] = buf[1:5]
    bad["grads"][1] = torch.zeros(65, device=cuda)[1:5]
    with pytest.raises(ValueError, match="aligned"):
        K8.fused_adam(**bad, **K8_KW, step=1)
    bad = _k8_clone(s)
    bad["moments1"][0] = bad["moments1"][0].cpu()
    with pytest.raises(ValueError, match="several devices"):
        K8.fused_adam(**bad, **K8_KW, step=1)
    bad = _k8_clone(s)
    bad["params"] = [p.double() for p in bad["params"]]
    bad["grads"] = [p.double() for p in bad["grads"]]
    with pytest.raises(TypeError):
        K8.fused_adam(**bad, **K8_KW, step=1)


def test_adamw_on_the_card_launches_k8_each_step(cuda):
    from paddle_tpu_torch.optimizer import AdamW
    w = torch.nn.Parameter(torch.randn(64, 64, device=cuda))
    opt = AdamW(learning_rate=1e-2, parameters=[w])
    n = K8.fused_adam.launches
    for _ in range(3):
        w.grad = torch.randn_like(w)
        opt.step()
        opt.clear_grad()
    assert K8.fused_adam.launches == n + 3


# ---------------------------------------------------------------------------
# K10: LLM.int8's linear
# ---------------------------------------------------------------------------
def _k10_case(cuda, M, K, N, dtype, outliers, seed):
    """x [M, K] in ``dtype``, weight_quantize(w, "llm.int8") of a [K, N]
    weight, and the threshold: 6.0 with no column above it, 6.0 with 8
    planted columns up to |20| ("planted") or with 40 more than the
    kernel's gathered capacity ("over"), 2.0 on randn (most columns), or
    -1 (every column)."""
    from paddle_tpu_torch.nn.quant import weight_quantize
    from paddle_tpu_torch.ops.kernels.llm_int8_linear import CAPACITY
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(M, K, device=cuda, generator=g).clamp(-5.5, 5.5)
    thr = {"none": 6.0, "planted": 6.0, "over": 6.0, "most": 2.0,
           "all": -1.0}[outliers]
    if outliers in ("planted", "over"):
        n = 8 if outliers == "planted" else CAPACITY + 40
        cols = torch.randperm(K, device=cuda, generator=g)[:n]
        x[:, cols] *= 20.0 / 5.5
        x[torch.arange(n, device=cuda) % M, cols] = 20.0
    elif outliers in ("most", "all"):
        x = torch.randn(M, K, device=cuda, generator=g)
    w = torch.randn(K, N, device=cuda, generator=g) * 0.02
    q, s = weight_quantize(w, "llm.int8")
    return x.to(dtype), q, s, thr


# (M, K, N) and the body each takes: gemv at M = 1, 8 and 16 (K not a
# multiple of 64 in the last); wgmma with M, N and K off its tiles, one
# x tile and three, and on whole 256 x 128 tiles only; mma where K is
# not a multiple of 16, above and below 16 rows
K10_BODIES = {(1, 64, 8): "gemv", (8, 4096, 1000): "gemv",
              (130, 200, 130): "mma", (300, 512, 264): "wgmma",
              (17, 1104, 260): "wgmma", (200, 1040, 520): "wgmma",
              (520, 2064, 392): "wgmma", (512, 1024, 256): "wgmma",
              (16, 1056, 300): "gemv", (12, 136, 40): "mma"}
K10_SHAPES = list(K10_BODIES)


def _k10_check(cuda, shape, dtype, outliers, bias):
    """One K10 call against its plain version (test_llm_int8_kernel),
    with ``parts`` and without: the wgmma body stores a whole tile's
    outputs 16 bytes at a time only when it writes no acc."""
    from paddle_tpu_torch.ops.kernels import llm_int8_linear as K10
    M, K, N = shape
    x, q, s, thr = _k10_case(cuda, M, K, N, dtype, outliers, seed=M + K + N)
    b = None
    if bias:
        b = torch.randn(N, device=cuda).to(torch.float32 if bias == "f32"
                                           else dtype)
    n = K10.llm_int8_linear.launches
    out, got = K10.llm_int8_linear(x, q, s, b, thr, parts=True)
    assert K10.llm_int8_linear.launches == n + 1
    assert got["body"] == K10_BODIES[shape]
    ref, want = K10.llm_int8_linear_dense(x, q, s, b, thr, parts=True)
    torch.cuda.synchronize()
    for key in ("col_amax", "xq", "a_scale", "acc"):
        assert torch.equal(got[key], want[key]), key
    cols = torch.nonzero(want["col_amax"] > thr).flatten().to(torch.int32)
    count = int(got["count"].item())
    assert torch.equal(got["idx"][:count], cols)
    if outliers == "none":
        assert count == 0 and torch.equal(out, ref)
    elif outliers == "planted":
        assert count == 8
    elif outliers == "over":
        assert K10.CAPACITY < count == K10.CAPACITY + 40 < K
    elif outliers == "all":
        assert count == K
    top = ref.float().abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert _err(out, ref) <= tol * top
    fast = K10.llm_int8_linear(x, q, s, b, thr)
    assert K10.llm_int8_linear.launches == n + 2
    if outliers == "none":
        assert torch.equal(fast, ref)
    assert _err(fast, ref) <= tol * top


@pytest.mark.parametrize("bias", [None, "f32", "same"])
@pytest.mark.parametrize("outliers", ["none", "planted", "most", "all"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", K10_SHAPES, ids=str)
def test_llm_int8_kernel(cuda, shape, dtype, outliers, bias):
    """K10's xq, scales, column absmax and int32 product bit-equal to the
    plain version's, its outlier list the plain version's outlier columns
    in order, its output within fp32 1e-5 / bf16 2e-2 of the output's
    largest magnitude (the outlier sum runs in another order), and equal
    bit for bit when no column is an outlier; each shape on its body."""
    _k10_check(cuda, shape, dtype, outliers, bias)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(8, 4096, 1000), (16, 1056, 300),
                                   (300, 512, 264), (520, 2064, 392),
                                   (130, 200, 130)], ids=str)
def test_llm_int8_kernel_over_capacity(cuda, shape, dtype):
    """More outlier columns than the kernel gathers once a call (and
    fewer than K): the gathered columns and the ones read at a stride of
    K add up to the plain version's term, on each body."""
    _k10_check(cuda, shape, dtype, "over", "f32")


@pytest.mark.parametrize("M, body", [(24, "wgmma"), (8, "gemv")])
def test_llm_int8_kernel_leading_dims_graph_and_empty(cuda, M, body):
    """3-D x, within bf16 2e-2 of the plain version; a call captured in a
    CUDA graph (nothing reads back to the host) replays to the eager
    output, on the wgmma body and on the gemv body (a pre-pass and a
    product behind it with programmatic dependent launch); no rows
    launches nothing."""
    from paddle_tpu_torch.ops.kernels import llm_int8_linear as K10
    x, q, s, thr = _k10_case(cuda, M, 256, 96, torch.bfloat16, "planted", 5)
    assert K10.llm_int8_route(M, 96, 256).body == body
    x3 = x.reshape(2, M // 2, 256)
    eager = K10.llm_int8_linear(x3, q, s, None, thr)
    assert eager.shape == (2, M // 2, 96)
    ref = K10.llm_int8_linear_dense(x3, q, s, None, thr)
    assert _err(eager, ref) <= 2e-2 * ref.float().abs().max().item()
    assert torch.equal(eager.reshape(M, 96),
                       K10.llm_int8_linear(x, q, s, None, thr))
    K10.llm_int8_linear(x3, q, s, None, thr)          # warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K10.llm_int8_linear(x3, q, s, None, thr)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    n = K10.llm_int8_linear.launches
    empty = K10.llm_int8_linear(x[:0], q, s, None, thr)
    assert empty.shape == (0, 96) and K10.llm_int8_linear.launches == n


def test_llm_int8_kernel_checks_raise(cuda):
    from paddle_tpu_torch.ops.kernels import llm_int8_linear as K10
    x, q, s, thr = _k10_case(cuda, 4, 64, 32, torch.bfloat16, "none", 1)
    with pytest.raises(ValueError, match="contiguous"):
        K10.llm_int8_linear(x.t().contiguous().t(), q, s)
    with pytest.raises(ValueError, match="several devices"):
        K10.llm_int8_linear(x, q, s.cpu())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K10.llm_int8_linear(x.half(), q, s)

"""K9, the weight-only linear, on the card: against its plain version,
under CUDA-graph capture and replay, its refusals, and weight-only
generation on the card against the CPU.

    python -m pytest tests/test_torch_weight_only_card.py -m cuda -q

Without a card every test here skips with a reason (decided inside the
``cuda`` fixture, never at import). Gates against the plain version, as
in chip_smoke.py's kernels phase: the largest difference over the
output's largest magnitude, bf16 2e-2 (the plain version rounds the same
f32 sum once; K9 sums in another order and, at M > 16, through bf16
tensor-core products, exact for integer weights), f32 1e-4 (FMA bodies,
no TF32).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import weight_only_linear as K9

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# chip_smoke.py's cases, plus M = 3; (4128, 200) is the TMA edge: K not
# a multiple of 64, N not of 128
ROWS = [1, 3, 8, 16, 17, 2048]
SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4128, 200),
          (200, 72)]  # (K, N)
# the gemv body (bf16, M <= 16): every M at the decode shapes, the ragged
# two and a K whose slices stage x in several windows
GEMV_SHAPES = SHAPES + [(65536, 256)]
# the wgmma body (bf16, M > 16): the main path's rows and (K, N), and the
# TMA edge at ragged M
WGMMA_ROWS = [17, 100, 2048, 8192]
WGMMA_CASES = ([(M, K, N) for M in WGMMA_ROWS for K, N in SHAPES[:3]]
               + [(300, 4128, 200), (8192, 4128, 200)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel K9 runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(dev, M, K, N, int4, dtype, bias, seed=0):
    """x, q, scale and a bias (None, in x's dtype, or ``bias`` itself
    when it is a dtype)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, K, device=dev, generator=g).to(dtype)
    w = torch.randn(N, K, device=dev, generator=g) * 0.02
    from paddle_tpu_torch.nn.quant import weight_quantize

    q, s = weight_quantize(w.T, "weight_only_int4" if int4
                           else "weight_only_int8")
    bdt = bias if isinstance(bias, torch.dtype) else dtype
    b = (torch.randn(N, device=dev, generator=g).to(bdt) if bias
         else None)
    return x, q, s, b


def _rel(a, b):
    torch.cuda.synchronize()
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("kn", SHAPES, ids=lambda s: f"k{s[0]}n{s[1]}")
@pytest.mark.parametrize("M", ROWS)
def test_k9_matches_plain(cuda, M, kn, int4, dtype, bias):
    K, N = kn
    x, q, s, b = _case(cuda, M, K, N, int4, dtype, bias)
    n = K9.weight_only_linear.launches
    out = K9.weight_only_linear(x, q, s, b, int4)
    assert K9.weight_only_linear.launches == n + 1
    assert out.dtype == dtype and tuple(out.shape) == (M, N)
    ref = K9.weight_only_linear_dense(x, q, s, b, int4)
    assert _rel(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("bias", [None, torch.bfloat16, torch.float32],
                         ids=["nobias", "bf16bias", "f32bias"])
@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("mkn", WGMMA_CASES,
                         ids=lambda c: "m{}k{}n{}".format(*c))
def test_k9_wgmma_body_matches_plain(cuda, mkn, int4, bias):
    """bf16 M > 16 at the main path's (K, N) and the TMA edge runs the
    wgmma body (its counter advances once) within bf16 2e-2 of the plain
    version, with no bias, a bf16 bias and an f32 bias."""
    M, K, N = mkn
    x, q, s, b = _case(cuda, M, K, N, int4, torch.bfloat16, bias, seed=M)
    assert K9.weight_only_route(M, N, K, int4, torch.bfloat16).body \
        == "wgmma"
    n = K9.weight_only_linear_wgmma.launches
    out = K9.weight_only_linear(x, q, s, b, int4)
    assert K9.weight_only_linear_wgmma.launches == n + 1
    ref = K9.weight_only_linear_dense(x, q, s, b, int4)
    assert _rel(out, ref) <= TOL[torch.bfloat16]


_QUANTIZED = {}


def _gemv_case(dev, M, K, N, int4, bias):
    """x [M, K] (seeded by M) and a bias over one quantized weight a
    (K, N, int4), made once."""
    if (K, N, int4) not in _QUANTIZED:
        _QUANTIZED.clear()
        _, q, s, _ = _case(dev, 1, K, N, int4, torch.bfloat16, None)
        _QUANTIZED[K, N, int4] = q, s
    q, s = _QUANTIZED[K, N, int4]
    g = torch.Generator(device=dev).manual_seed(M)
    x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
    b = (torch.randn(N, device=dev, generator=g).to(bias) if bias
         else None)
    return x, q, s, b


@pytest.mark.parametrize("bias", [None, torch.bfloat16, torch.float32],
                         ids=["nobias", "bf16bias", "f32bias"])
@pytest.mark.parametrize("M", range(1, 17))
@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("kn", GEMV_SHAPES, ids=lambda s: f"k{s[0]}n{s[1]}")
def test_k9_gemv_body_matches_plain(cuda, kn, int4, M, bias):
    """bf16 M <= 16 runs the gemv body (one cluster a column block, the
    K slices summed through distributed shared memory) within bf16 2e-2
    of the plain version: every M from 1 to 16 at the decode shapes, the
    ragged ones and a K staged in several x windows, with no bias, a bf16
    bias and an f32 bias; and a second call gives the same bits (the
    slices are summed in slice order)."""
    K, N = kn
    x, q, s, b = _gemv_case(cuda, M, K, N, int4, bias)
    plan = K9.weight_only_route(M, N, K, int4, torch.bfloat16)
    assert plan.body == "gemv" and K9.route_kernels(plan) == 1
    n = K9.weight_only_linear.launches
    out = K9.weight_only_linear(x, q, s, b, int4)
    assert K9.weight_only_linear.launches == n + 1
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (M, N)
    ref = K9.weight_only_linear_dense(x, q, s, b, int4)
    assert _rel(out, ref) <= TOL[torch.bfloat16]
    assert torch.equal(K9.weight_only_linear(x, q, s, b, int4), out)


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("kn", SHAPES[:3], ids=lambda s: f"k{s[0]}n{s[1]}")
def test_k9_gemv_one_kernel_a_call(cuda, kn, int4, M):
    """A bf16 M <= 16 call launches exactly one kernel (torch.profiler's
    count of the CUDA kernels of 4 calls): no split-sum pass. A short
    profile may hold fewer kernel records than ran, never more, so it is
    taken again (at most 3 times) until it holds one a call."""
    from torch.profiler import ProfilerActivity, profile

    K, N = kn
    x, q, s, b = _gemv_case(cuda, M, K, N, int4, torch.bfloat16)
    K9.weight_only_linear(x, q, s, b, int4)
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                K9.weight_only_linear(x, q, s, b, int4)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        assert all("gemv_cluster_kernel" in e.key for e in kern), \
            [e.key for e in kern]
        if sum(e.count for e in kern) >= 4:
            break
    assert sum(e.count for e in kern) == 4, [(e.key, e.count) for e in kern]


@pytest.mark.parametrize("M", [8, 16])
@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_k9_gemv_unaligned_input(cuda, int4, M):
    """x starting 2 bytes past a 16-byte boundary: the gemv body stages
    it element by element and still matches the plain version."""
    K, N = 4096, 4096
    x, q, s, b = _gemv_case(cuda, M, K, N, int4, torch.bfloat16)
    flat = torch.empty(M * K + 8, device=cuda, dtype=torch.bfloat16)
    xu = flat[1:1 + M * K].view(M, K)
    xu.copy_(x)
    assert xu.data_ptr() % 16 == 2
    assert K9.weight_only_route(M, N, K, int4, torch.bfloat16,
                                False).body == "gemv"
    out = K9.weight_only_linear(xu, q, s, b, int4)
    ref = K9.weight_only_linear_dense(x, q, s, b, int4)
    assert _rel(out, ref) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_k9_unaligned_input_takes_tile_body(cuda, int4):
    """x starting 2 bytes past a 16-byte boundary: TMA cannot address it,
    so the launch takes the tile body (the wgmma counter stays) and still
    matches the plain version."""
    M, K, N = 300, 4096, 200
    x, q, s, b = _case(cuda, M, K, N, int4, torch.bfloat16, True)
    flat = torch.empty(M * K + 8, device=cuda, dtype=torch.bfloat16)
    xu = flat[1:1 + M * K].view(M, K)
    xu.copy_(x)
    assert xu.data_ptr() % 16 == 2
    n, nw = K9.weight_only_linear.launches, K9.weight_only_linear_wgmma.launches
    out = K9.weight_only_linear(xu, q, s, b, int4)
    assert K9.weight_only_linear.launches == n + 1
    assert K9.weight_only_linear_wgmma.launches == nw
    ref = K9.weight_only_linear_dense(x, q, s, b, int4)
    assert _rel(out, ref) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_k9_batched_input_and_bf16_bias_on_f32(cuda, int4):
    """x [B, S, K] (the model's layout) and an f32 bias under bf16 x."""
    x, q, s, _ = _case(cuda, 24, 256, 96, int4, torch.bfloat16, False)
    b = torch.randn(96, device=cuda)
    x3 = x.reshape(2, 12, 256)
    out = K9.weight_only_linear(x3, q, s, b, int4)
    assert tuple(out.shape) == (2, 12, 96)
    ref = K9.weight_only_linear_dense(x3, q, s, b, int4)
    assert _rel(out, ref) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("M,K,N,int4", [(8, 4096, 4096, False),
                                        (8, 4096, 11008, True),
                                        (16, 11008, 4096, False),
                                        (3, 200, 72, True),
                                        (2048, 4096, 4096, False),
                                        (2048, 4096, 11008, True),
                                        (300, 4128, 200, False)],
                         ids=["gemv", "gemv_int4", "gemv_m16", "gemv_ragged",
                              "wgmma", "wgmma_int4", "wgmma_edge"])
def test_k9_graph_replay_equals_eager(cuda, M, K, N, int4):
    """A capture of K9 (the gemv body's cluster launch at M <= 16; the
    wgmma body's tensor maps at M > 16) replays to the eager call's bits;
    the launch counter advances through add_launches, once a replay."""
    x, q, s, b = _case(cuda, M, K, N, int4, torch.bfloat16, True)
    eager_out = K9.weight_only_linear(x, q, s, b, int4)
    static_x = x.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        K9.weight_only_linear(static_x, q, s, b, int4)  # warm on the side
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    n0 = K9.weight_only_linear.launches
    with kernels.recording_launches() as rec:
        with torch.cuda.graph(graph):
            out = K9.weight_only_linear(static_x, q, s, b, int4)
    want = {K9.weight_only_linear: 1}
    if M > 16:
        want[K9.weight_only_linear_wgmma] = 1
    assert rec == want
    assert K9.weight_only_linear.launches == n0
    for _ in range(3):
        graph.replay()
        kernels.add_launches(rec)
    torch.cuda.synchronize()
    assert K9.weight_only_linear.launches == n0 + 3
    assert torch.equal(out, eager_out)


def test_k9_refusals(cuda):
    x, q, s, b = _case(cuda, 8, 256, 64, False, torch.bfloat16, False)
    with pytest.raises(ValueError, match="several devices"):
        K9.weight_only_linear(x, q.cpu(), s)
    with pytest.raises(TypeError, match="scale must be float32"):
        K9.weight_only_linear(x, q, s.to(torch.bfloat16))
    x4, q4, s4, _ = _case(cuda, 8, 256, 64, True, torch.bfloat16, False)
    with pytest.raises(ValueError, match="even input dimension"):
        K9.weight_only_linear(torch.zeros(8, 255, device=cuda,
                                          dtype=torch.bfloat16), q4, s4,
                              None, True)
    with pytest.raises(ValueError, match="contiguous"):
        K9.weight_only_linear(x.t().contiguous().t(), q, s)
    n = K9.weight_only_linear.launches
    with pytest.raises(TypeError, match="bias"):
        K9.weight_only_linear(x, q, s, torch.zeros(64, device=cuda,
                                                   dtype=torch.float16))
    assert K9.weight_only_linear.launches == n


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_weight_only_generate_card_equals_cpu(cuda, algo):
    """llama_tiny fp32 (hidden 64: gemv and f32 bodies, the head kept in
    f32) through weight-only Predictor.generate, static and paged: the
    card's greedy tokens equal the CPU's, through K9."""
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

    cpu = LlamaForCausalLM(llama_tiny(), device="cpu", seed=4)
    gpu = LlamaForCausalLM(llama_tiny(), device=cuda, seed=0)
    gpu.load_state_dict(cpu.state_dict())
    ids = np.random.RandomState(1).randint(1, 256, (3, 20))
    lens = [20, 9, 14]
    outs = []
    for page in (None, 8):
        for m in (cpu, gpu):
            conf = Config().set_model(m).enable_weight_only(algo)
            if page:
                conf.enable_paged_kv(page)
            n = K9.weight_only_linear.launches
            outs.append(create_predictor(conf).generate(
                ids, max_new_tokens=8, lengths=lens).cpu().numpy())
            if m is gpu:
                assert K9.weight_only_linear.launches > n
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])

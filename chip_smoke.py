#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) through its main path
on one CUDA card and check it.

    python3 chip_smoke.py              # from the root of a checkout

Phases, each of which fails the run (non-zero exit, no result line):

1. build   every kernel from paddle_tpu_torch/csrc/*.cu with nvcc, all
           sources in parallel; print the build seconds
2. kernels K3 (RMSNorm), K4 (ragged paged attention) and K5 (paged decode
           attention) against their plain PyTorch versions at the main
           path's shapes, bf16 and fp32, GQA included; kernel, plain and
           library times from CUDA events, and each kernel's bound
3. parity  a reduced Llama (fp32, TF32 off) served on cuda and on cpu
           with the same weights and arrival schedule: the committed
           token streams must be equal
4. serve   Llama-7B widths (32 layers, bf16, random weights from a seed)
           through ServingEngine: 16 greedy requests, 8 of them arriving
           mid-run; every kernel must have launched on this path

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.

Developer options (the plain run uses none of them): ``--phases`` runs a
subset, ``--layers`` cuts the serving run's depth, and ``--profile``
serves the schedule once more under torch.profiler and prints the
device's busy share of that profiled run and its time by kernel.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
              torch.float32: 67e12}    # fp32 outside the tensor cores
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warm=3):
    """Device milliseconds of one fn() call: ``iters`` calls captured in
    a CUDA graph and replayed between two CUDA events, so the host's
    launch rate (the ctypes wrappers) does not enter the time."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    t1.synchronize()
    del graph
    return t0.elapsed_time(t1) / iters


def bound(nbytes, flops, dtype):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# -- phase 2: kernels against their plain versions ---------------------------
def check_rms(dev, results):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import rms_norm as K3

    g = torch.Generator(device=dev).manual_seed(1)
    for T in (2048, 8):
        for dt in (torch.bfloat16, torch.float32):
            H = 4096
            x = torch.randn(T, H, device=dev, generator=g).to(dt)
            w = (1 + 0.1 * torch.randn(H, device=dev, generator=g)).to(dt)
            eps = 1e-5
            out = K3.rms_norm(x, w, eps)
            ref = K3.rms_norm_dense(x, w, eps)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            isz = x.element_size()
            b_ms, b_by = bound(2 * T * H * isz + H * isz, 4 * T * H, dt)
            # timed on rotating copies of x, together larger than the
            # 50 MB L2, so each launch reads x from device memory
            xs = itertools.cycle([x.clone() for _ in range(
                min(16, 1 + int(100e6 // x.nbytes)))])
            rec = dict(
                name="rms_norm", shape=[T, H], dtype=str(dt)[6:],
                max_abs_err=err, tol=TOL[dt],
                ms=cuda_ms(lambda: K3.rms_norm(next(xs), w, eps)),
                plain_ms=cuda_ms(lambda: K3.rms_norm_dense(next(xs), w,
                                                           eps)),
                library_ms=cuda_ms(lambda: F.rms_norm(next(xs), (H,), w,
                                                      eps)),
                library="torch.nn.functional.rms_norm",
                bound_ms=b_ms, bound_by=b_by)
            results.append(rec)


def _attn_case(dev, dt, B, Sq, H, KV, starts, seq_lens, g, P=512, page=64,
               npages=32, D=128):
    q = torch.randn(B, Sq, H, D, device=dev, generator=g).to(dt)
    kp = torch.randn(P, KV, page, D, device=dev, generator=g).to(dt)
    vp = torch.randn(P, KV, page, D, device=dev, generator=g).to(dt)
    perm = torch.randperm(P - 1, device=dev, generator=g)[:B * npages]
    tbl = perm.reshape(B, npages).to(torch.int32).contiguous()
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    nv = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    return q, kp, vp, tbl, st, nv


def _attn_cost(q, kp, starts, seq_lens):
    """Bytes and flops this call's data needs: q of the live slots once,
    every slot of out once, and for every live row the K and V rows up
    to its frontier once per KV head; 4*D flops per (q head, visible
    key)."""
    B, Sq, H, D = q.shape
    KV = kp.shape[1]
    isz = q.element_size()
    nbytes = (sum(seq_lens) * H * D + q.numel()) * isz
    flops = 0
    for s, n in zip(starts, seq_lens):
        if n <= 0:
            continue
        nbytes += 2 * KV * (s + n) * D * isz
        flops += 4 * D * H * sum(s + i + 1 for i in range(n))
    return nbytes, flops


def _sdpa_yardstick(q, kp, vp, tbl, starts, seq_lens):
    """One torch call computing the same function (scaled_dot_product_
    attention) on K/V already gathered into contiguous form, with the
    same mask. Timed as a yardstick; the port never calls it."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels.decode_attention import _gather_pages

    B, Sq, H, D = q.shape
    k = _gather_pages(kp, tbl)
    v = _gather_pages(vp, tbl)
    rep = H // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    M = k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    st = starts.long()[:, None, None]
    i = torch.arange(Sq, device=q.device)[None, :, None]
    m = torch.arange(M, device=q.device)[None, None, :]
    mask = ((m <= st + i) & (i < seq_lens.long()[:, None, None]))[:, None]
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask))


def check_attention(dev, results):
    from paddle_tpu_torch.ops.kernels import decode_attention as K5
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as K4

    g = torch.Generator(device=dev).manual_seed(2)
    # mixed unified round: prefill chunks (one straddling pages from 300),
    # decode rows with 1..1500 tokens of history, a dead row, a partial
    # chunk
    starts = [0, 300, 1024, 0, 700, 1500, 0, 37]
    lens = [256, 200, 256, 1, 1, 1, 0, 19]
    dec = [int(v) for v in np.random.RandomState(3).randint(1, 1501, 8)]
    for KV in (32, 8):
        for dt in (torch.bfloat16, torch.float32):
            q, kp, vp, tbl, st, nv = _attn_case(dev, dt, 8, 256, 32, KV,
                                                starts, lens, g)
            out = K4.ragged_paged_attention(q, kp, vp, tbl, st, nv)
            ref = K4.ragged_paged_attention_dense(q, kp, vp, tbl, st, nv)
            torch.cuda.synchronize()
            dead = out[6].abs().max().item() + out[7, 19:].abs().max().item()
            nb, fl = _attn_cost(q, kp, starts, lens)
            b_ms, b_by = bound(nb, fl, dt)
            results.append(dict(
                name="ragged_paged_attention", shape=list(q.shape),
                kv_heads=KV, dtype=str(dt)[6:],
                max_abs_err=(out.float() - ref.float()).abs().max().item(),
                dead_slot_abs_max=dead, tol=TOL[dt],
                ms=cuda_ms(lambda: K4.ragged_paged_attention(
                    q, kp, vp, tbl, st, nv)),
                plain_ms=cuda_ms(lambda: K4.ragged_paged_attention_dense(
                    q, kp, vp, tbl, st, nv), iters=3, warm=1),
                library_ms=_sdpa_yardstick(q, kp, vp, tbl, st, nv),
                library="sdpa on K/V gathered to contiguous, same mask",
                bound_ms=b_ms, bound_by=b_by))
            if dead != 0.0:
                raise AssertionError("dead slots of K4 are not exactly 0")

            q, kp, vp, tbl, st, nv = _attn_case(dev, dt, 8, 1, 32, KV, dec,
                                                [1] * 8, g)
            out = K5.paged_decode_attention(q, kp, vp, tbl, st)
            ref = K5.paged_attention_dense(q, kp, vp, tbl, st)
            torch.cuda.synchronize()
            nb, fl = _attn_cost(q, kp, dec, [1] * 8)
            b_ms, b_by = bound(nb, fl, dt)
            results.append(dict(
                name="paged_decode_attention", shape=list(q.shape),
                kv_heads=KV, dtype=str(dt)[6:],
                max_abs_err=(out.float() - ref.float()).abs().max().item(),
                tol=TOL[dt],
                ms=cuda_ms(lambda: K5.paged_decode_attention(
                    q, kp, vp, tbl, st)),
                plain_ms=cuda_ms(lambda: K5.paged_attention_dense(
                    q, kp, vp, tbl, st), iters=5, warm=1),
                library_ms=_sdpa_yardstick(q, kp, vp, tbl, st, nv),
                library="sdpa on K/V gathered to contiguous, same mask",
                bound_ms=b_ms, bound_by=b_by))


# -- phases 3 and 4: serving ---------------------------------------------------
def serve(model, schedule, page, max_length, **engine_kw):
    """Run ``schedule`` = (first prompts, later prompts, steps before the
    later ones arrive, max_new_tokens) through a fresh engine."""
    from paddle_tpu_torch.inference import (Config, ServingEngine,
                                            create_predictor)

    first, later, after, n_new = schedule
    conf = Config().set_model(model).enable_paged_kv(page)
    conf.max_length = max_length
    eng = ServingEngine(create_predictor(conf), **engine_kw)
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=n_new) for p in first]
    for _ in range(after):
        eng.step()
    rids += [eng.submit(p, max_new_tokens=n_new) for p in later]
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, [done[r] for r in rids], wall


def prompts(seed, lens, vocab):
    r = np.random.RandomState(seed)
    return [r.randint(1, vocab, (int(L),)) for L in lens]


def phase_parity():
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=4096, hidden_size=1024, num_layers=2,
                      num_heads=8, num_kv_heads=2, intermediate_size=2816,
                      max_position_embeddings=1024, dtype="float32")
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=5)
    gpu = LlamaForCausalLM(cfg, device="cuda", seed=0)
    gpu.load_state_dict(cpu.state_dict())
    sched = (prompts(7, [40, 200, 130], 4096), prompts(8, [7, 300, 64], 4096),
             3, 10)
    kw = dict(page=64, max_length=1024, max_batch=4, prefill_chunk=128)
    e_cpu, r_cpu, _ = serve(cpu, sched, **kw)
    e_gpu, r_gpu, _ = serve(gpu, sched, **kw)
    a = [list(r.new_tokens) for r in r_cpu]
    b = [list(r.new_tokens) for r in r_gpu]
    log(f"[parity] tf32 off; rounds cpu {dict(e_cpu.rounds)} "
        f"cuda {dict(e_gpu.rounds)}")
    log(f"[parity] cuda streams {b}")
    if a != b:
        raise AssertionError(f"cuda and cpu token streams differ:\ncpu  {a}"
                             f"\ncuda {b}")
    log("[parity] cuda == cpu token streams: OK")


def phase_serve(layers, counters, profile=False):
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    cfg = llama_7b(dtype="bfloat16", num_layers=layers)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[serve] llama_7b widths, {layers} layers, bf16, random weights "
        f"(seed 0, std {cfg.initializer_range}); built in "
        f"{time.perf_counter() - t0:.1f}s, {cfg.num_params() / 1e9:.2f}B "
        "params")
    kw = dict(page=64, max_length=2048, max_batch=8, prefill_chunk=256,
              prefill_token_budget=256)
    # warmup (not measured): first cuBLAS handles, allocator growth
    serve(model, (prompts(0, [64], cfg.vocab_size), [], 0, 4), **kw)
    lens = np.random.RandomState(11).randint(64, 1537, 16)
    sched = (prompts(12, lens[:8], cfg.vocab_size),
             prompts(13, lens[8:], cfg.vocab_size), 4, 32)
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    eng, reqs, wall = serve(model, sched, **kw)
    launches = {c.__name__: c.launches for c in counters}
    n_tok = sum(len(r.new_tokens) for r in reqs)
    ttft = [1e3 * (r.t_first_token - r.t_submit) for r in reqs]
    tpot = [1e3 * (r.t_finish - r.t_first_token) / (len(r.new_tokens) - 1)
            for r in reqs]
    for r in reqs:
        if len(r.new_tokens) != 32 or not all(
                0 <= t < cfg.vocab_size for t in r.new_tokens):
            raise AssertionError(f"request {r.rid}: bad output "
                                 f"{r.new_tokens}")
    summary = dict(
        layers=layers, requests=len(reqs), prompt_lens=[int(x) for x in lens],
        new_tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
        ttft_ms_p50=float(np.percentile(ttft, 50)),
        ttft_ms_p99=float(np.percentile(ttft, 99)),
        tpot_ms_p50=float(np.percentile(tpot, 50)),
        rounds=dict(eng.rounds), pool_pages=eng.P,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches)
    log("[serve] " + json.dumps(summary))
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    if profile:
        profile_serve(model, sched, kw)
    return launches


def profile_serve(model, sched, kw):
    """The same schedule again under torch.profiler: device time by
    kernel name and the device's busy share of the wall (one stream, so
    kernel times add up without overlap)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = serve(model, sched, **kw)
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    log(f"[profile] wall {wall * 1e3:.1f} ms (profiled), device busy "
        f"{busy_ms:.1f} ms = {100 * busy_ms / (wall * 1e3):.1f}%")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.1f} ms "
            f"{e.count:7d} calls  {e.key[:90]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="depth of the 7B-width serving run")
    ap.add_argument("--phases", default="build,kernels,parity,serve")
    ap.add_argument("--profile", action="store_true",
                    help="serve the schedule once more under torch.profiler "
                    "and print device time by kernel")
    args = ap.parse_args()
    phases = args.phases.split(",")

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; it runs the port on one card")
    repo = Path(__file__).resolve().parent
    if not (repo / "paddle_tpu_torch").is_dir():
        sys.exit("chip_smoke.py: run it from the root of a checkout "
                 "(paddle_tpu_torch/ not found beside it)")
    sys.path.insert(0, str(repo))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels.decode_attention import \
        paged_decode_attention
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        ragged_paged_attention
    from paddle_tpu_torch.ops.kernels.rms_norm import rms_norm

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f}s")

    dev = torch.device("cuda", 0)
    results = []
    if "kernels" in phases:
        check_rms(dev, results)
        check_attention(dev, results)
        bad = []
        for r in results:
            log("[kernels] " + json.dumps(r))
            if not r["max_abs_err"] <= r["tol"]:
                bad.append(f"{r['name']} {r['shape']} {r['dtype']}: "
                           f"{r['max_abs_err']} > {r['tol']}")
        if bad:
            raise AssertionError("kernels disagree with their plain "
                                 "versions: " + "; ".join(bad))
        log("[kernels] every case within tolerance: OK")
    if "parity" in phases:
        phase_parity()
    counters = [rms_norm, ragged_paged_attention, paged_decode_attention]
    launches = {c.__name__: None for c in counters}
    if "serve" in phases:
        launches = phase_serve(args.layers, counters, args.profile)

    # one entry per kernel: the main path's dtype (bf16) at its main shape
    main_shape = {"rms_norm": [2048, 4096],
                  "ragged_paged_attention": [8, 256, 32, 128],
                  "paged_decode_attention": [8, 1, 32, 128]}
    meta = {
        "rms_norm": ("paddle_tpu_torch/csrc/rms_norm.cu",
                     "paddle_tpu/ops/pallas/rms_norm.py:75"),
        "ragged_paged_attention": (
            "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/ops/pallas/ragged_paged_attention.py:122"),
        "paged_decode_attention": (
            "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/ops/pallas/decode_attention.py:220")}
    kernels = []
    for name, (src, repl) in meta.items():
        mine = [r for r in results if r["name"] == name]
        main = [r for r in mine if r["shape"] == main_shape[name]
                and r["dtype"] == "bfloat16"
                and r.get("kv_heads", 32) == 32]
        row = main[0] if main else {}
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=launches[name],
            max_abs_err=max((r["max_abs_err"] for r in mine), default=None),
            ms=row.get("ms"), plain_ms=row.get("plain_ms"),
            bound_ms=row.get("bound_ms"), bound_by=row.get("bound_by"),
            library_ms=row.get("library_ms"), shape=main_shape[name],
            dtype="bfloat16"))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

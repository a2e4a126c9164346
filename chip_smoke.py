#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) through its main path
on one CUDA card and check it.

    python3 chip_smoke.py              # from the root of a checkout

Phases, each of which fails the run (non-zero exit, no result line):

1. build        every kernel from paddle_tpu_torch/csrc/*.cu with nvcc,
                all sources in parallel; print the build seconds and the
                flash and paged attention kernels' registers and spills
                (ptxas -v); every K1 tile the build lists
                (flash_attention_fwd_tiles) must be built with 0 spill
                bytes
2. kernels      K3 (RMSNorm, and its gradient), K4 (ragged paged
                attention), K5 (paged decode attention), K6 (decode
                attention over the contiguous cache), K1 and K2 (flash
                attention forward and backward) against their plain
                PyTorch versions at the main paths' shapes, bf16 and
                fp32, GQA, rectangular, segment-id and odd-cache-length
                cases included; kernel, plain and library times, and each
                kernel's bound; K2 also timed part by part (pre-pass,
                dq, dk/dv). K1/K2/K6 outputs, K2 gradients and the K3
                gradient are held to the tolerance as a relative L2 error
                over tiles of 64 positions of one (batch, head), each tile
                against its own magnitude. K4 and K5 rows name the body
                each call ran (wgmma_split, mma, fma), its split count and
                workspace bytes; the bf16 cases must run the Hopper body.
                K8 (the multi-tensor AdamW + clip update) at the train
                phase's 1.881 B-parameter set (bf16 parameters, f32
                masters and moments) against its plain version: f32
                buffers within 1e-6 of each tensor's largest magnitude,
                bf16 parameters within one ulp; K8, plain and
                torch._fused_adamw_ timed with CUDA events. K1 at every
                built tile (block_q, block_kv) at the train shape [4,
                2048, 32, 128] and at GQA [4, 2048, 32 / 8, 128], causal
                bf16, against the plain version and timed; K7's search
                over the plain version timed as its plain time
3. parity       a reduced Llama (fp32, TF32 off) served on cuda, graphed
                and eager, and on cpu with the same weights and arrival
                schedule, and run through Predictor.generate with static
                and paged caches (ragged rows, an EOS), graphed and eager:
                every token stream must be equal, across devices, between
                the two caches and between graphed and eager (with equal
                launch counts); top-k/top-p sampling from one seed,
                graphed against eager, equal; a FusedMultiTransformer
                prefill and 3 decode steps, cuda against cpu, within 1e-4
4. serve        Llama-7B widths (32 layers, bf16, random weights from a
                seed) through one ServingEngine: a warmup that captures
                the unified and decode rounds' CUDA graphs, then 16
                greedy requests, 8 of them arriving mid-run, four times:
                eager, graphed, graphed, eager. Equal tokens in all four,
                launches of K3, K4 and K5 exactly as the rounds imply,
                every graphed round a replay, one graph per shape key.
                Then one unified round holding both prefill chunks and
                decode rows, and one decode round, of a second short
                eager serve with every layer's K4 and K5 call watched:
                each output against the plain version on the engine's
                own q, pools, tables, starts and lengths, per tile, 2e-2
5. generate     the same model through Predictor.generate: 8 ragged
                prompts of 128..1024 tokens, 128 greedy new tokens with
                the static cache (K6), then with enable_paged_kv(64) (K5);
                an untimed graphed call captures the decode graph, then
                four measured calls, eager, graphed, graphed, eager:
                prefill and per-token decode ms, tokens/s, peak memory,
                exact launch counts of K6, K5 and K3, every graphed
                decode step a replay, graphed-eager token agreement; then
                an eager paged generation of 2 tokens with every layer's
                K5 call (the prefill and a decode step) held against the
                plain version per tile, 2e-2
6. train-parity the reduced Llama trains 3 steps on cuda and on cpu from
                the same weights and batch: losses and global grad norms
                within 1e-4 relative; then 5 steps from fresh weights
                under a GradScaler (2^10) and a warmup + cosine schedule,
                the third an overflow: clean steps within 1e-4 across
                devices, the overflow step a bit-exact no-op on both
7. train        Llama-7B widths cut to 8 layers (bf16 weights, f32 AdamW
                masters and moments) through ParallelEngine.train_step:
                12 steps on one fixed 4 x 2048 batch, 2 untimed; finite,
                falling losses, step time, tokens/s, MFU, peak memory; K3,
                K1, K2 and K8 must launch in the timed steps. Then one more
                forward and backward with each layer's attention watched:
                K1's output and K2's gradients on the model's own bf16
                activations against the plain version, per tile, 2e-2
8. train-autotune
                the same trainer, seed and batch with FLAGS_use_autotune
                on and a fresh cache file ($PADDLE_TPU_TORCH_AUTOTUNE_CACHE
                in a temporary directory): 7 steps, 2 untimed, after 7
                flag-off steps from the same seed. The first step's
                forward runs K7: every built K1 tile measured at the train
                shape (each time finite), the argmin chosen and written to
                the file; the search's seconds, every candidate's ms, the
                choice and the step p50 are logged. Losses must equal the
                flag-off run's as closely as two flag-off runs agree when
                the default tile wins (bit-equal expected), and lie within
                1e-2 relative when another wins. One forward and backward
                from the trained state at each tile: loss and gradient
                norm within 2e-2 of the default tile's. A second process
                over the same file makes one K1 call at the train shape
                with the flag on: 0 measurements, the same tile

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.

Developer options (the plain run uses none of them; ``--k1-probe`` is
the second process of train-autotune): ``--phases`` runs a
subset, ``--layers`` cuts the 7B-width serving and generate runs' depth,
and ``--profile`` serves the schedule once more (graphed), runs 16 more
graphed decode steps of each generate run and two more train steps under
torch.profiler, and prints the device's busy share of those profiled runs
and their time by kernel.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import subprocess
import sys
import time
from collections import Counter
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
    # the gradient: K3's forward inside its autograd.Function, the backward
    # rms_norm_grad, against autograd through rms_norm_dense
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(2048, 4096, device=dev, generator=g).to(
            dt).requires_grad_(True)
        w = (1 + 0.1 * torch.randn(4096, device=dev, generator=g)).to(
            dt).requires_grad_(True)
        go = torch.randn(2048, 4096, device=dev, generator=g).to(dt)
        out = K3.rms_norm(x, w, 1e-5)
        if out.grad_fn is None:
            raise AssertionError("K3 on a CUDA tensor that requires grad "
                                 "returned no grad_fn")
        dx, dw = torch.autograd.grad(out, (x, w), go)
        rx, rw = torch.autograd.grad(K3.rms_norm_dense(x, w, 1e-5), (x, w),
                                     go)
        # dx in tiles of 64 rows, dw whole
        ex = _errs(dx[None, :, None], rx[None, :, None])
        ew = _errs(dw[None, None, None], rw[None, None, None])
        results.append(dict(
            name="rms_norm_grad", shape=[2048, 4096], dtype=str(dt)[6:],
            max_abs_err=max(ex[0], ew[0]), rel_err=max(ex[3], ew[3]),
            tol=TOL[dt]))


def _errs(a, b, block=64):
    """(max |a - b|, max |b|, RMS of b, the gate's error) for [B, S, H, D]
    tensors. The gate's error is the largest relative L2 error
    ||a - b|| / ||b|| over tiles of ``block`` consecutive positions of one
    (batch, head): each tile is held to its own magnitude. In causal
    attention the first rows' outputs and the first keys' gradients are
    tens of times larger than the late ones', so an error scaled by the
    largest value would let a wrong tile of late rows or keys pass. A tile
    whose reference is all zero must come out all zero."""
    torch.cuda.synchronize()
    a, b = a.float(), b.float()
    B, S, H, D = b.shape
    pad = -S % block
    tiles = []
    for t in (a - b, b):
        t = torch.cat([t, t.new_zeros(B, pad, H, D)], 1)
        tiles.append(t.reshape(B, -1, block, H, D).pow(2).sum((2, 4)).sqrt())
    dn, rn = tiles
    rel = torch.where(rn > 0, dn / rn.clamp_min(1e-38),
                      torch.where(dn > 0, float("inf"), 0.0))
    return ((a - b).abs().max().item(), b.abs().max().item(),
            b.pow(2).mean().sqrt().item(), rel.max().item())


def events_ms(fn, iters=10, warm=2):
    """Device milliseconds of one fn() call from CUDA events around
    ``iters`` back-to-back calls; for calls that run autograd, which a
    CUDA graph capture does not take. Right for calls of a millisecond
    or more, where the host's launch time hides behind the device."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


# K1/K2 cases: (label, B, Sq, Skv, H, KV, D, causal, segments); the first
# is the training shape of the 7B-width train phase. "edge129" puts one row
# and one key past the 128-row tiles. It is not causal: causally, key 128
# is seen by row 128 alone, so its dk is one bf16 product whose error is
# that of dP - delta, delta being summed from the bf16 output as the TPU
# kernel does; a near-cancellation there fails a one-key tile's relative
# gate whatever the kernel (the card tests hold the causal 129 case)
FLASH_CASES = [
    ("train", 4, 2048, 2048, 32, 32, 128, True, False),
    ("gqa", 2, 1024, 1024, 32, 8, 128, True, False),
    ("rect", 2, 300, 1000, 16, 16, 128, True, False),
    ("segments", 2, 1024, 1024, 16, 4, 64, True, True),
    ("d64", 2, 1024, 1024, 16, 16, 64, False, False),
    ("edge129", 2, 129, 129, 8, 8, 128, False, False),
]


def _flash_inputs(dev, dt, B, Sq, Skv, H, KV, D, segments, g):
    q = torch.randn(B, Sq, H, D, device=dev, generator=g).to(dt)
    k = torch.randn(B, Skv, KV, D, device=dev, generator=g).to(dt)
    v = torch.randn(B, Skv, KV, D, device=dev, generator=g).to(dt)
    do = torch.randn(B, Sq, H, D, device=dev, generator=g).to(dt)
    qs = ks = None
    if segments:
        # packed rows of 3 sequences each, boundaries differing per row
        ks = torch.zeros(B, Skv, dtype=torch.int32, device=dev)
        for b in range(B):
            cut = sorted(torch.randint(1, Skv, (2,), device=dev,
                                       generator=g).tolist())
            ks[b, cut[0]:] = 1
            ks[b, cut[1]:] = 2
        qs = ks[:, Skv - Sq:].contiguous()
    return q, k, v, do, qs, ks


def _flash_cost(q, k, causal, qs, ks):
    """Bytes and flops this call's data needs. Visible (row, key) pairs
    are counted from the mask: 2 matmuls of 2*D flops per pair and q
    head forward, 5 backward. Forward bytes: q, k, v read, out written
    once, lse written; backward: q, k, v, out, dout, lse read, dq, dk,
    dv written."""
    from paddle_tpu_torch.ops.kernels.flash_attention import _keep_mask

    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    keep = _keep_mask(Sq, Skv, causal, qs, ks, q.device)
    pairs = B * Sq * Skv if keep is None else int(
        keep.expand(B, 1, 1, Sq, Skv).sum().item())
    isz = q.element_size()
    qb, kb = B * Sq * H * D * isz, B * Skv * KV * D * isz
    lse = B * H * Sq * 4
    return ((2 * qb + 2 * kb + lse, 4 * D * H * pairs),
            (4 * qb + 4 * kb + lse, 10 * D * H * pairs))


def _sdpa_args(q, k, v, causal, qs, ks):
    """F.scaled_dot_product_attention's layout and mask for the case:
    its is_causal aligns top-left, so rectangular and segment cases take
    the same keep-mask the plain version builds."""
    from paddle_tpu_torch.ops.kernels.flash_attention import _keep_mask

    Sq, Skv = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kw = dict(enable_gqa=q.shape[2] != k.shape[2])
    if causal and Sq == Skv and qs is None:
        kw["is_causal"] = True
    elif causal or qs is not None:
        kw["attn_mask"] = _keep_mask(Sq, Skv, causal, qs, ks,
                                     q.device)[:, 0]
    return qt, kt, vt, kw


def check_flash(dev, results):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    g = torch.Generator(device=dev).manual_seed(4)
    for label, B, Sq, Skv, H, KV, D, causal, segm in FLASH_CASES:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, do, qs, ks = _flash_inputs(dev, dt, B, Sq, Skv, H, KV,
                                                D, segm, g)
            out, lse = K1.flash_attention_fwd_lse(q, k, v, causal, None, qs,
                                                  ks)
            r_out, r_lse = K1.flash_attention_dense(q, k, v, causal, None,
                                                    qs, ks)
            grads = K1.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                           None, qs, ks)
            r_grads = K1.flash_attention_bwd_dense(q, k, v, do, causal, None,
                                                   qs, ks)
            (fb, ff), (bb, bf) = _flash_cost(q, k, causal, qs, ks)
            base = dict(case=label, shape=[B, Sq, H, D], skv=Skv,
                        kv_heads=KV, causal=causal, segments=segm,
                        dtype=str(dt)[6:], tol=TOL[dt])
            qt, kt, vt, kw = _sdpa_args(q, k, v, causal, qs, ks)
            b_ms, b_by = bound(fb, ff, dt)
            eo = _errs(out, r_out)
            results.append(dict(
                base, name="flash_attention_fwd", bytes=fb, flops=ff,
                max_abs_err=eo[0], ref_max_abs=eo[1], ref_rms=eo[2],
                rel_err=eo[3],
                lse_abs_err=(lse - r_lse).abs().max().item(),
                ms=cuda_ms(lambda: K1.flash_attention_fwd_lse(
                    q, k, v, causal, None, qs, ks)),
                plain_ms=cuda_ms(lambda: K1.flash_attention_dense(
                    q, k, v, causal, None, qs, ks), iters=3, warm=1),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, **kw)),
                library="F.scaled_dot_product_attention forward",
                bound_ms=b_ms, bound_by=b_by))
            if not results[-1]["lse_abs_err"] <= TOL[dt]:
                raise AssertionError(f"K1 lse off by "
                                     f"{results[-1]['lse_abs_err']} ({label} "
                                     f"{dt})")
            qg, kg, vg = (t.detach().requires_grad_(True)
                          for t in (qt, kt, vt))
            lib_out = F.scaled_dot_product_attention(qg, kg, vg, **kw)
            dot = do.transpose(1, 2).contiguous()
            b_ms, b_by = bound(bb, bf, dt)
            eg = [_errs(a, b) for a, b in zip(grads, r_grads)]
            results.append(dict(
                base, name="flash_attention_bwd", bytes=bb, flops=bf,
                max_abs_err=max(e[0] for e in eg),
                ref_max_abs=[e[1] for e in eg], ref_rms=[e[2] for e in eg],
                rel_err=max(e[3] for e in eg),
                ms=cuda_ms(lambda: K1.flash_attention_bwd(
                    q, k, v, out, lse, do, causal, None, qs, ks)),
                plain_ms=events_ms(lambda: K1.flash_attention_bwd_dense(
                    q, k, v, do, causal, None, qs, ks), iters=3, warm=1),
                library_ms=events_ms(lambda: torch.autograd.grad(
                    lib_out, (qg, kg, vg), dot, retain_graph=True)),
                library="backward of F.scaled_dot_product_attention "
                        "(autograd.grad on a kept graph)",
                library_fwd_bwd_ms=events_ms(lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(qg, kg, vg, **kw),
                    (qg, kg, vg), dot)),
                bound_ms=b_ms, bound_by=b_by, **_k2_split(
                    K1, q, k, v, out, lse, do, causal, qs, ks)))
            del lib_out, qg, kg, vg


# K1's tile cases: (label, B, S, H, KV, D), causal bf16; "train" is the
# 7B-width train phase's shape, the one K7 searches there
TILE_CASES = [("train", 4, 2048, 32, 32, 128), ("gqa", 4, 2048, 32, 8, 128)]
K7_REPS = 5   # measure_flash_blocks' default: 1 + reps K1 launches a tile


def check_flash_tiles(dev, results, k7):
    """K1 at every tile the build lists, against the plain version on the
    same inputs, each timed from a CUDA graph; and K7's plain time: the
    search with each candidate's (1 + reps) launches made by the plain
    version."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import autotune as K7
    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    dt = torch.bfloat16
    tiles = K1.fwd_tiles(128, dt)
    g = torch.Generator(device=dev).manual_seed(8)
    for label, B, S, H, KV, D in TILE_CASES:
        q, k, v, _, _, _ = _flash_inputs(dev, dt, B, S, S, H, KV, D, False,
                                         g)
        r_out, r_lse = K1.flash_attention_dense(q, k, v, True)
        plain_ms = cuda_ms(lambda: K1.flash_attention_dense(q, k, v, True),
                           iters=3, warm=1)
        qt, kt, vt, kw = _sdpa_args(q, k, v, True, None, None)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **kw))
        (fb, ff), _ = _flash_cost(q, k, True, None, None)
        b_ms, b_by = bound(fb, ff, dt)
        for t in tiles:
            out, lse = K1.flash_attention_fwd_lse(q, k, v, True, blocks=t)
            eo = _errs(out, r_out)
            rec = dict(
                name="flash_attention_fwd", case=f"tile_{label}",
                blocks=list(t), shape=[B, S, H, D], skv=S, kv_heads=KV,
                causal=True, dtype="bfloat16", tol=TOL[dt],
                max_abs_err=eo[0], rel_err=eo[3],
                lse_abs_err=(lse - r_lse).abs().max().item(),
                ms=cuda_ms(lambda: K1.flash_attention_fwd_lse(
                    q, k, v, True, blocks=t)),
                plain_ms=plain_ms, library_ms=library_ms,
                library="F.scaled_dot_product_attention forward",
                bound_ms=b_ms, bound_by=b_by)
            results.append(rec)
            if not rec["lse_abs_err"] <= TOL[dt]:
                raise AssertionError(f"K1 tile {t} lse off by "
                                     f"{rec['lse_abs_err']} ({label})")
            if label == "train":
                k7.setdefault("k1_ms", {})[t] = rec["ms"]
                k7["k1_bound_ms"] = b_ms
            del out, lse
        if label == "train":
            def plain_measure(cand):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                K1.flash_attention_dense(q, k, v, True)
                t0.record()
                for _ in range(K7_REPS):
                    K1.flash_attention_dense(q, k, v, True)
                t1.record()
                t1.synchronize()
                return t0.elapsed_time(t1) / 1e3 / K7_REPS

            t0 = time.perf_counter()
            with torch.no_grad():
                K7.autotune("plain", tiles, plain_measure, K7.AlgoCache(None))
            k7["plain_ms"] = (time.perf_counter() - t0) * 1e3
        del q, k, v, r_out, r_lse, qt, kt, vt


def _train_shapes(cfg):
    """The parameter shapes of LlamaForCausalLM(cfg), in its order."""
    h, m, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_kv_heads * cfg.head_dim
    layer = [(h,), (h, h), (kv, h), (kv, h), (h, h), (h,), (m, h), (m, h),
             (h, m)]
    shapes = [(V, h)] + layer * cfg.num_layers + [(h,)]
    if not cfg.tie_word_embeddings:
        shapes.append((V, h))
    assert sum(int(np.prod(s)) for s in shapes) == cfg.num_params()
    return shapes


# the train phase's parameter count: Llama-7B widths x 8 layers
_FUSED_ADAM_N = 1_881_214_976


def check_fused_adam(dev, results):
    """K8 at the train phase's parameter set: Llama-7B widths x 8 layers,
    1.881 B bf16 parameters and gradients, f32 masters and moments, the
    train step's AdamW (decoupled decay 0.01 on every tensor). One call
    of the kernel against one call of the plain version on two copies of
    the same seeded buffers (the gradients, read-only, shared), without
    a clip and with the train step's clip (1.0): the f32 masters and
    moments within 1e-6 of each tensor's largest magnitude, and the two
    norms, summed in different orders, within 1e-5. Without the clip
    both compute the same IEEE operations, and every bf16 parameter must
    lie within one ulp of the plain one. With it, a last-bit difference
    of the clip coefficient (from the norm's summation order) would
    change an update in its last bit, which is many ulps of a parameter
    the update cancels to near zero; there the bf16 parameters are held
    within one ulp of each tensor's largest magnitude. Element-wise ulps
    and whether the buffers are bit-equal are reported. Then
    K8, the plain version and the library's fused AdamW
    (torch._fused_adamw_ on f32 gradients, with a foreach global-norm
    clip) are timed with CUDA events."""
    from paddle_tpu_torch.models.llama import llama_7b
    from paddle_tpu_torch.ops.kernels import fused_adam as K8

    cfg = llama_7b(num_layers=8)
    shapes = _train_shapes(cfg)
    N = cfg.num_params()

    def buffers(grads=None):
        g = torch.Generator(device=dev).manual_seed(8)
        params = [(0.02 * torch.randn(s, device=dev, generator=g)
                   ).bfloat16() for s in shapes]
        new = [(1e-3 * torch.randn(s, device=dev, generator=g)).bfloat16()
               for s in shapes]
        return dict(
            params=params, grads=grads or new,
            masters=[p.float() for p in params],
            moments1=[1e-4 * torch.randn(s, device=dev, generator=g)
                      for s in shapes],
            moments2=[1e-8 * torch.rand(s, device=dev, generator=g)
                      for s in shapes],
            decays=[True] * len(shapes))

    kw = dict(lr=3e-4, beta1=0.9, beta2=0.999, epsilon=1e-8,
              weight_decay=0.01, decoupled=True, step=3)
    stats = {}
    for clip in (0.0, 1.0):
        A = buffers()
        B = buffers(A["grads"])
        norm = K8.fused_adam(**A, **kw, clip_norm=clip)
        rnorm = K8.fused_adam_dense(**B, **kw, clip_norm=clip)
        torch.cuda.synchronize()
        rel, ulps, scaled, abs_err = 0.0, 0, 0.0, 0.0
        for key in ("masters", "moments1", "moments2", "params"):
            for x, r in zip(A[key], B[key]):
                d = (x.float() - r.float()).abs().max().item()
                top = max(r.float().abs().max().item(), 1e-30)
                abs_err = max(abs_err, d)
                if x.dtype == torch.float32:
                    rel = max(rel, d / top)
                else:
                    ulps = max(ulps, (x.view(torch.int16).int()
                                      - r.view(torch.int16).int()
                                      ).abs().max().item())
                    # one bf16 ulp at the tensor's largest magnitude
                    scaled = max(scaled, d / (2.0 ** (math.floor(
                        math.log2(top)) - 7)))
        equal = all(torch.equal(x, r) for key in ("masters", "moments1",
                                                  "moments2", "params")
                    for x, r in zip(A[key], B[key]))
        stats[clip] = dict(rel=rel, ulps=ulps, ulps_at_max=scaled,
                           bit_equal=equal,
                           abs_err=abs_err, norm_err=(
                               abs(norm.item() - rnorm.item()) / rnorm.item()
                               if clip else 0.0))
        del B
        if clip == 0.0:
            del A
        torch.cuda.empty_cache()
    log(f"[kernels] fused_adam against its plain version, without and "
        f"with the clip: {json.dumps(stats)}")
    s0, s1 = stats[0.0], stats[1.0]
    if not (s0["ulps"] <= 1 and s1["ulps_at_max"] <= 1
            and s1["norm_err"] <= 1e-5):
        raise AssertionError(f"K8 disagrees with its plain version: {stats}")
    rel = max(s0["rel"], s1["rel"])
    abs_err = max(s0["abs_err"], s1["abs_err"])
    norm_err = s1["norm_err"]
    nbytes = 28 * N
    b_ms, b_by = bound(nbytes, 30 * N, torch.float32)
    kw["clip_norm"] = 1.0         # timed as the train step calls it
    ms = events_ms(lambda: K8.fused_adam(**A, **kw), iters=10, warm=2)
    plain_ms = events_ms(lambda: K8.fused_adam_dense(**A, **kw), iters=3,
                         warm=1)
    g32 = [t.float() for t in A["grads"]]
    steps = [torch.tensor(3.0, device=dev) for _ in shapes]

    def library():
        norms = torch._foreach_norm(g32)
        total = torch.linalg.vector_norm(torch.stack(norms))
        torch._foreach_mul_(g32, torch.clamp(1.0 / torch.clamp(
            total, min=1e-6), max=1.0))
        torch._fused_adamw_(A["masters"], g32, A["moments1"], A["moments2"],
                            [], steps, lr=3e-4, beta1=0.9, beta2=0.999,
                            weight_decay=0.01, eps=1e-8, amsgrad=False,
                            maximize=False)

    library_ms = events_ms(library, iters=5, warm=1)
    del g32
    log(f"[kernels] fused_adam: {N / 1e9:.3f}B parameters in "
        f"{len(shapes)} tensors; bound {nbytes / 1e9:.2f} GB each input "
        f"and output once = {b_ms:.2f} ms, the two-pass design's "
        f"{30 * N / 1e9:.2f} GB = {30 * N / HBM_BYTES_PER_S * 1e3:.2f} ms "
        f"at 3.35 TB/s")
    results.append(dict(
        name="fused_adam", shape=[N], tensors=len(shapes), dtype="bfloat16",
        max_abs_err=abs_err, rel_err=rel, tol=1e-6,
        bf16_ulps_at_tensor_max=max(s0["ulps_at_max"], s1["ulps_at_max"]),
        bf16_max_elementwise_ulps=[s0["ulps"], s1["ulps"]],
        bit_equal=[s0["bit_equal"], s1["bit_equal"]],
        norm_rel_err=norm_err, ms=ms, plain_ms=plain_ms,
        library_ms=library_ms,
        library="torch._fused_adamw_ on f32 grads + foreach global-norm clip",
        bytes=nbytes, design_bytes=30 * N, bound_ms=b_ms, bound_by=b_by))
    del A
    torch.cuda.empty_cache()


def _k2_split(K1, q, k, v, out, lse, do, causal, qs, ks):
    """K2's three launches timed one by one (CUDA graphs, as ``ms``): the
    pre-pass, the dq kernel and the dk/dv kernel, the last two on the
    workspace of one pre-pass run. Not counted as launches."""
    scale = 1.0 / q.shape[-1] ** 0.5
    args = (q, k, v, out, lse, do, causal, scale, qs, ks)
    work = K1._k2(*args, parts=K1.PREPASS)[3]
    return {f"{name}_ms": cuda_ms(lambda part=part: K1._k2(
        *args, parts=part, work=work))
        for name, part in (("prepass", K1.PREPASS), ("dq", K1.DQ),
                           ("dkv", K1.DKV))}


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
    first = len(results)
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
                **K5.paged_route(q, kp, tbl)._asdict(),
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
                **K5.paged_route(q, kp, tbl)._asdict(),
                max_abs_err=(out.float() - ref.float()).abs().max().item(),
                tol=TOL[dt],
                ms=cuda_ms(lambda: K5.paged_decode_attention(
                    q, kp, vp, tbl, st)),
                plain_ms=cuda_ms(lambda: K5.paged_attention_dense(
                    q, kp, vp, tbl, st), iters=5, warm=1),
                library_ms=_sdpa_yardstick(q, kp, vp, tbl, st, nv),
                library="sdpa on K/V gathered to contiguous, same mask",
                bound_ms=b_ms, bound_by=b_by))
    # diagnostic: the chunk at 1024 alone (two 128-row tiles of 18 and 20
    # 64-key steps a head): the serial key range that bounds the K4 case
    q, kp, vp, tbl, st, nv = _attn_case(dev, torch.bfloat16, 8, 256, 32, 32,
                                        starts, [0, 0, 256, 0, 0, 0, 0, 0], g)
    out = K4.ragged_paged_attention(q, kp, vp, tbl, st, nv)
    ref = K4.ragged_paged_attention_dense(q, kp, vp, tbl, st, nv)
    nb, fl = _attn_cost(q, kp, starts, [0, 0, 256, 0, 0, 0, 0, 0])
    b_ms, b_by = bound(nb, fl, torch.bfloat16)
    results.append(dict(
        name="ragged_paged_attention", case="chunk_alone", diagnostic=True,
        shape=list(q.shape), kv_heads=32, dtype="bfloat16",
        **K5.paged_route(q, kp, tbl)._asdict(),
        max_abs_err=(out.float() - ref.float()).abs().max().item(),
        tol=TOL[torch.bfloat16],
        ms=cuda_ms(lambda: K4.ragged_paged_attention(q, kp, vp, tbl, st, nv)),
        bound_ms=b_ms, bound_by=b_by))
    # the bf16 cases (the serving path's type) must run the Hopper body
    for r in results[first:]:
        if r["dtype"] == "bfloat16" and r["body"] != "wgmma_split":
            raise AssertionError(f"{r['name']} {r['shape']} KV {r['kv_heads']}"
                                 f" ran the {r['body']} body, not wgmma_split")


# K6 cases: (label, B, Sq, H, KV, M, offsets); "decode" is the shape of the
# generate phase's decode steps, "prefill" that of its prefill
def _k6_cases():
    r = np.random.RandomState(3)
    dec = [int(x) for x in r.randint(1, 1501, 8)]
    return [("decode", 8, 1, 32, 32, 2048, dec),
            ("prefill", 8, 1024, 32, 32, 2048, 0),
            ("gqa", 8, 1, 32, 8, 2048, dec),
            ("m100", 8, 16, 32, 32, 100, 84),
            ("sq300", 8, 300, 32, 32, 2048,
             [int(x) for x in r.randint(0, 1749, 8)])]


def _k6_cost(B, Sq, H, KV, M, offs, D, isz):
    """Bytes and flops this call's data needs: each row's K and V rows up
    to its frontier min(off + Sq, M) once per KV head, q and out once;
    4*D flops per (q head, visible key), row s of batch b seeing
    min(off_b + s + 1, M) keys."""
    nbytes = 2 * B * Sq * H * D * isz
    pairs = 0
    for o in offs:
        nbytes += 2 * KV * min(o + Sq, M) * D * isz
        pairs += sum(min(o + s + 1, M) for s in range(Sq))
    return nbytes, 4 * D * H * pairs


def check_decode(dev, results):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import decode_attention as K6

    g = torch.Generator(device=dev).manual_seed(6)
    D = 128
    for label, B, Sq, H, KV, M, off in _k6_cases():
        offs = off if isinstance(off, list) else [off] * B
        for dt in (torch.bfloat16, torch.float32):
            q = torch.randn(B, Sq, H, D, device=dev, generator=g).to(dt)
            k = torch.randn(B, KV, M, D, device=dev, generator=g).to(dt)
            v = torch.randn(B, KV, M, D, device=dev, generator=g).to(dt)
            o = torch.tensor(off, dtype=torch.int32, device=dev) \
                if isinstance(off, list) else off
            out = K6.decode_attention(q, k, v, o)
            ref = K6.decode_attention_dense(q, k, v, o)
            e = _errs(out, ref)
            b_ms, b_by = bound(*_k6_cost(B, Sq, H, KV, M, offs, D,
                                         q.element_size()), dt)
            # the yardstick: SDPA over the same cache and boolean mask
            qt = q.transpose(1, 2).contiguous()
            pos = torch.tensor(offs, device=dev)[:, None, None] \
                + torch.arange(Sq, device=dev)[None, :, None]
            mask = (torch.arange(M, device=dev)[None, None] <= pos)[:, None]
            results.append(dict(
                name="decode_attention", case=label, shape=[B, Sq, H, D],
                cache_len=M, kv_heads=KV, dtype=str(dt)[6:],
                offsets=off, max_abs_err=e[0], ref_max_abs=e[1],
                rel_err=e[3], tol=TOL[dt],
                ms=cuda_ms(lambda: K6.decode_attention(q, k, v, o)),
                plain_ms=cuda_ms(lambda: K6.decode_attention_dense(
                    q, k, v, o), iters=3, warm=1),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, k, v, attn_mask=mask, enable_gqa=KV != H)),
                library="F.scaled_dot_product_attention on the cache, same "
                        "boolean mask, enable_gqa",
                bound_ms=b_ms, bound_by=b_by))
            del q, k, v, out, ref, qt, mask


# -- phases 3 and 4: serving ---------------------------------------------------
def make_engine(model, page, max_length, **engine_kw):
    from paddle_tpu_torch.inference import (Config, ServingEngine,
                                            create_predictor)

    conf = Config().set_model(model).enable_paged_kv(page)
    conf.max_length = max_length
    return ServingEngine(create_predictor(conf), **engine_kw)


def serve(eng, schedule):
    """Run ``schedule`` = (first prompts, later prompts, steps before the
    later ones arrive, max_new_tokens) through the engine ``eng`` (which
    may have served before). Returns the requests, the wall seconds, and
    the rounds, graph replays and kernel launches of this run."""
    from paddle_tpu_torch.ops import kernels

    first, later, after, n_new = schedule
    rounds0, replays0 = Counter(eng.rounds), Counter(eng.stats.replays)
    launches0 = kernels.launch_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=n_new) for p in first]
    for _ in range(after):
        eng.step()
    rids += [eng.submit(p, max_new_tokens=n_new) for p in later]
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {f.__name__: n - launches0[f]
                for f, n in kernels.launch_counts().items()
                if n != launches0[f]}
    return ([done[r] for r in rids], wall, eng.rounds - rounds0,
            eng.stats.replays - replays0, launches)


def mode_ctx(mode):
    """The context a measured run's mode asks for: eager() runs every
    step body without its graph; "graphed" is the default."""
    from paddle_tpu_torch.core.cuda_graphs import eager

    return eager() if mode == "eager" else contextlib.nullcontext()


def graphs_summary(stats):
    """Graphs captured, capture seconds, the memory their captures
    reserved and replays by site, and the check that each graphed site
    holds one graph per shape key it saw."""
    sites = sorted(stats.captures)
    for site in sites:
        if stats.captures[site] != stats.keys(site):
            raise AssertionError(f"{site}: {stats.captures[site]} graphs "
                                 f"for {stats.keys(site)} shape keys")
    return {site: dict(graphs=stats.captures[site],
                       capture_s=stats.capture_s[site],
                       pool_mib=stats.capture_bytes[site] / 2**20,
                       replays=stats.replays[site]) for site in sites}


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
    runs, counts = {}, {}
    for dev, model, mode in (("cpu", cpu, "eager"), ("cuda", gpu, "graphed"),
                             ("cuda", gpu, "eager")):
        eng = make_engine(model, **kw)
        with mode_ctx(mode):
            reqs, _, rounds, replays, launches = serve(eng, sched)
        runs[dev, mode] = [list(r.new_tokens) for r in reqs]
        counts[dev, mode] = launches
        log(f"[parity] serve {dev} {mode}: rounds {dict(rounds)}, graph "
            f"replays {dict(replays)}, graphs "
            f"{json.dumps(graphs_summary(eng.stats))}, launches {launches}")
        if mode == "graphed" and not (replays["unified"] > 0
                                      and replays["serve_decode"] > 0):
            raise AssertionError("the graphed serve replayed no graph")
    a, b, c = runs["cpu", "eager"], runs["cuda", "graphed"], \
        runs["cuda", "eager"]
    log(f"[parity] tf32 off; cuda graphed streams {b}")
    if not a == b == c:
        raise AssertionError(f"token streams differ:\ncpu  {a}\ncuda "
                             f"graphed {b}\ncuda eager {c}")
    if counts["cuda", "graphed"] != counts["cuda", "eager"]:
        raise AssertionError(f"graphed and eager serve launch counts "
                             f"differ: {counts}")
    log("[parity] serve: cuda graphed == cuda eager == cpu token streams, "
        "equal launch counts: OK")
    generate_parity(cpu, gpu)
    fused_transformer_parity()


def generate_parity(cpu, gpu):
    """Predictor.generate with static (K6) and paged (K5) caches on cuda
    and cpu: ragged rows and an EOS that stops one of them; all four
    token streams must be equal."""
    from paddle_tpu_torch.inference import Config, create_predictor

    lens = [40, 200, 130]
    ids = np.zeros((3, max(lens)), np.int64)
    for b, p in enumerate(prompts(9, lens, 4096)):
        ids[b, :len(p)] = p

    from paddle_tpu_torch.ops import kernels

    def run(model, page, mode="graphed", **kw):
        conf = Config().set_model(model)
        if page:
            conf.enable_paged_kv(page)
        pred = create_predictor(conf)
        n0 = kernels.launch_counts()
        with mode_ctx(mode):
            out = pred.generate(ids, max_new_tokens=12, lengths=lens,
                                **kw).cpu().numpy()
        n = {f.__name__: c - n0[f] for f, c in kernels.launch_counts().items()
             if c != n0[f]}
        if model is gpu and mode == "graphed" and \
                pred.stats.replays["decode"] != 10:
            raise AssertionError(f"graphed generate replayed "
                                 f"{pred.stats.replays['decode']} of 10 "
                                 "decode steps")
        return out, n

    eos = int(run(cpu, None)[0][1, -9])   # row 1 stops at its 4th new token
    outs, counts = {}, {}
    for dev, m in (("cpu", cpu), ("cuda", gpu)):
        for page in (None, 64):
            for mode in (("graphed", "eager") if dev == "cuda"
                         else ("eager",)):
                outs[dev, page, mode], counts[dev, page, mode] = run(
                    m, page, mode, eos_token_id=eos)
    log(f"[parity] generate (eos {eos}) cuda static graphed new tokens "
        f"{outs['cuda', None, 'graphed'][:, -12:].tolist()}")
    first = outs["cpu", None, "eager"]
    if not all(np.array_equal(first, o) for o in outs.values()):
        raise AssertionError(f"generate streams differ: {outs}")
    if list(first[1, -9:]) != [eos] * 9:
        raise AssertionError("the EOS row did not freeze")
    for page in (None, 64):
        if counts["cuda", page, "graphed"] != counts["cuda", page, "eager"]:
            raise AssertionError(f"generate launches differ: {counts}")
    log("[parity] Predictor.generate static == paged, cuda graphed == cuda "
        f"eager == cpu, equal launch counts {counts['cuda', None, 'eager']}"
        f" / {counts['cuda', 64, 'eager']}: OK")
    # top-k / top-p sampling from one seed: graphed and eager draw the
    # same numbers (the graphs advance the generator as the eager steps)
    for page in (None, 64):
        kw = dict(temperature=0.8, top_k=50, top_p=0.9, seed=3)
        g, _ = run(gpu, page, "graphed", **kw)
        e, _ = run(gpu, page, "eager", **kw)
        if not np.array_equal(g, e):
            raise AssertionError(f"sampled generate (page {page}): graphed "
                                 f"{g[:, -12:].tolist()} != eager "
                                 f"{e[:, -12:].tolist()}")
    log("[parity] sampled generate (temperature 0.8, top-k 50, top-p 0.9, "
        "seed 3), static and paged: cuda graphed == cuda eager: OK")


def fused_transformer_parity():
    """FusedMultiTransformer prefill + 3 decode steps through its caches
    (K6 on cuda), cuda against cpu within 1e-4."""
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.ops.kernels import decode_attention as K6

    cpu = FusedMultiTransformer(1024, 8, 2816, num_layers=2,
                                device="cpu").eval()
    gpu = FusedMultiTransformer(1024, 8, 2816, num_layers=2,
                                device="cuda").eval()
    gpu.load_state_dict(cpu.state_dict())
    cc, gc = cpu.empty_caches(2, 128), gpu.empty_caches(2, 128)
    r = np.random.RandomState(10)
    worst, n0 = 0.0, K6.decode_attention.launches
    with torch.no_grad():
        for S, t in [(64, 0), (1, 64), (1, 65), (1, 66)]:
            x = torch.tensor(r.randn(2, S, 1024).astype(np.float32))
            a, gc = gpu(x.cuda(), caches=gc, time_step=t)
            b, cc = cpu(x, caches=cc, time_step=t)
            worst = max(worst, (a.cpu() - b).abs().max().item())
    n = K6.decode_attention.launches - n0
    log(f"[parity] FusedMultiTransformer cuda vs cpu: max |diff| {worst}, "
        f"K6 launches {n}")
    if not (worst <= 1e-4 and n == 8):
        raise AssertionError("FusedMultiTransformer cuda and cpu differ")


def build_7b(layers):
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    cfg = llama_7b(dtype="bfloat16", num_layers=layers)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[7b] llama_7b widths, {layers} layers, bf16, random weights "
        f"(seed 0, std {cfg.initializer_range}); built in "
        f"{time.perf_counter() - t0:.1f}s, {cfg.num_params() / 1e9:.2f}B "
        "params")
    return model


def phase_serve(model, counters, profile=False):
    """The 7B-width serve: one engine, warmed up (its unified and decode
    graphs are captured there), then the measured schedule four times,
    eager, graphed, graphed, eager. Every run must commit the same tokens
    and launch exactly the kernels its rounds imply; graphed runs replay
    every round. Returns the launches of a graphed run."""
    cfg = model.config
    L = cfg.num_layers
    kw = dict(page=64, max_length=2048, max_batch=8, prefill_chunk=256,
              prefill_token_budget=256)
    eng = make_engine(model, **kw)
    # warmup (not measured): first cuBLAS handles, allocator growth, the
    # unified and decode rounds' graph captures
    serve(eng, (prompts(0, [64], cfg.vocab_size), [], 0, 4))
    lens = np.random.RandomState(11).randint(64, 1537, 16)
    sched = (prompts(12, lens[:8], cfg.vocab_size),
             prompts(13, lens[8:], cfg.vocab_size), 4, 32)
    runs = []
    for mode in ("eager", "graphed", "graphed", "eager"):
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        with mode_ctx(mode):
            reqs, wall, rounds, replays, _ = serve(eng, sched)
        launches = {c.__name__: c.launches for c in counters}
        n_tok = sum(len(r.new_tokens) for r in reqs)
        ttft = [1e3 * (r.t_first_token - r.t_submit) for r in reqs]
        tpot = [1e3 * (r.t_finish - r.t_first_token)
                / (len(r.new_tokens) - 1) for r in reqs]
        for r in reqs:
            if len(r.new_tokens) != 32 or not all(
                    0 <= t < cfg.vocab_size for t in r.new_tokens):
                raise AssertionError(f"request {r.rid}: bad output "
                                     f"{r.new_tokens}")
        summary = dict(
            mode=mode, layers=L, requests=len(reqs),
            prompt_lens=[int(x) for x in lens], new_tokens=n_tok,
            wall_s=wall, tokens_per_s=n_tok / wall,
            ttft_ms_p50=float(np.percentile(ttft, 50)),
            ttft_ms_p99=float(np.percentile(ttft, 99)),
            tpot_ms_p50=float(np.percentile(tpot, 50)),
            rounds=dict(rounds), graph_replays=dict(replays),
            pool_pages=eng.P,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            launches=launches)
        log("[serve] " + json.dumps(summary))
        # what the rounds imply: K4 once a layer a unified round, K5 once
        # a layer a decode step, K3 twice a layer and once at the end
        steps = rounds["unified"] + eng.chunk * rounds["decode"]
        want = {"rms_norm": (2 * L + 1) * steps,
                "ragged_paged_attention": L * rounds["unified"],
                "paged_decode_attention": L * eng.chunk * rounds["decode"]}
        if launches != want:
            raise AssertionError(f"{mode} serve launched {launches}, its "
                                 f"rounds {dict(rounds)} imply {want}")
        want_replays = ({"unified": rounds["unified"],
                         "serve_decode": rounds["decode"]}
                        if mode == "graphed" else {})
        if dict(replays) != want_replays:
            raise AssertionError(f"{mode} serve replayed {dict(replays)}, "
                                 f"expected {want_replays}")
        runs.append((mode, [list(r.new_tokens) for r in reqs], launches))
    log("[serve] graphs: " + json.dumps(graphs_summary(eng.stats)))
    if any(toks != runs[0][1] or n != runs[0][2] for _, toks, n in runs):
        raise AssertionError("serve runs differ in tokens or launches: "
                             + "; ".join(f"{m}: {n}" for m, _, n in runs))
    log("[serve] eager, graphed, graphed, eager: equal token streams and "
        f"launches {runs[0][2]}: OK")
    check_serve_attention(model, kw)
    if profile:
        profile_serve(eng, sched)
    return runs[1][2]


def check_serve_attention(model, kw):
    """A short serve of the same model and engine settings with every
    layer's K4 and K5 call watched: in the first unified round that holds
    both a prefill chunk and a decode row long enough to split its key
    range, and in the first decode round,
    each kernel output is held against the plain version on the same q,
    pools, tables, starts and lengths (the engine's own, read before the
    next layer writes its pool), per tile of 64 slots of one (batch row,
    head) as in the kernels phase, 2e-2; dead slots must be exactly 0.
    Runs eagerly (every call seen), after the serve path's launches were
    read, so its launches are not counted."""
    import paddle_tpu_torch.models.llama as llama
    from paddle_tpu_torch.core.cuda_graphs import eager
    from paddle_tpu_torch.ops.kernels import decode_attention as K5
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as K4

    L = model.config.num_layers
    calls = {"unified": 0, "decode": 0}
    watch = {"unified": None, "decode": None}   # round index watched
    worst = {"unified": [], "decode": []}
    k4, k5 = llama.ragged_paged_attention, llama.paged_decode_attention

    def check(kind, out, ref, info):
        e = _errs(out, ref)
        worst[kind].append(e[3])
        log(f"[serve] {kind} round, layer {len(worst[kind]) - 1}, "
            f"{info}: " + json.dumps(dict(max_abs_err=e[0], ref_max_abs=e[1],
                                          ref_rms=e[2], rel_err=e[3])))

    def watched_k4(q, kp, vp, tbl, st, nv):
        out = k4(q, kp, vp, tbl, st, nv)
        rnd, layer = divmod(calls["unified"], L)
        calls["unified"] += 1
        if layer == 0 and watch["unified"] is None:
            # a chunk, and a decode row long enough to split its keys
            n, at = nv.tolist(), st.tolist()
            split = K5.paged_route(q, kp, tbl).split_len
            if any(x > 1 for x in n) and any(
                    x == 1 and s0 >= split for x, s0 in zip(n, at)):
                watch["unified"] = rnd
        if watch["unified"] == rnd:
            with torch.no_grad():
                ref = K4.ragged_paged_attention_dense(q, kp, vp, tbl, st, nv)
            check("unified", out, ref, f"starts {st.tolist()} seq_lens "
                  f"{nv.tolist()} {K5.paged_route(q, kp, tbl).body}")
        return out

    def watched_k5(q, kp, vp, tbl, lengths):
        out = k5(q, kp, vp, tbl, lengths)
        if q.shape[1] == 1:
            rnd, layer = divmod(calls["decode"], L)
            calls["decode"] += 1
            if rnd == 0:
                with torch.no_grad():
                    ref = K5.paged_attention_dense(q, kp, vp, tbl, lengths)
                check("decode", out, ref, f"lengths {lengths.tolist()} "
                      f"{K5.paged_route(q, kp, tbl).body}")
        return out

    vocab = model.config.vocab_size
    # prompt 0 finishes its prefill in the first round and decodes beside
    # the longer prompts' chunks in the next ones
    sched = (prompts(14, [90, 700, 1500, 300], vocab), [], 0, 6)
    llama.ragged_paged_attention = watched_k4
    llama.paged_decode_attention = watched_k5
    try:
        with eager():
            serve(make_engine(model, **kw), sched)
    finally:
        llama.ragged_paged_attention = k4
        llama.paged_decode_attention = k5
    tol = TOL[torch.bfloat16]
    for kind, errs in worst.items():
        if len(errs) != L or not max(errs) <= tol:
            raise AssertionError(f"serve {kind} round: {len(errs)} of {L} "
                                 f"layers checked, worst tile error "
                                 f"{max(errs, default=None)}")
    log(f"[serve] every layer's K4 (a mixed unified round) and K5 (a decode "
        f"round) within {tol} of the plain version (worst tile "
        f"{max(worst['unified'])}, {max(worst['decode'])}): OK")


# -- phase 5: generation --------------------------------------------------------
def _ragged_prompts(vocab):
    """8 prompts of RandomState(21).randint(128, 1025, 8) tokens, right-
    padded into one [8, max] array."""
    lens = np.random.RandomState(21).randint(128, 1025, 8)
    ids = np.zeros((8, int(lens.max())), np.int64)
    for b, p in enumerate(prompts(22, lens, vocab)):
        ids[b, :len(p)] = p
    return ids, lens


def phase_generate(model, paths, profile=False, n_new=128):
    """Predictor.generate over the 7B-width model: the same ragged prompts
    with the static cache (K6), then with enable_paged_kv(64) (K5). For
    each, one untimed graphed call (its decode graph is captured there),
    then four measured calls, eager, graphed, graphed, eager."""
    from paddle_tpu_torch.inference import Config, create_predictor

    cfg = model.config
    ids, lens = _ragged_prompts(cfg.vocab_size)
    launches, outs, first_logits = {}, {}, {}
    want = {"rms_norm": (2 * cfg.num_layers + 1) * n_new,
            "decode_attention": cfg.num_layers * n_new,
            "paged_decode_attention": cfg.num_layers * n_new}
    for label, page in (("static", None), ("paged", 64)):
        conf = Config().set_model(model)
        conf.max_length = 2048
        if page:
            conf.enable_paged_kv(page)
        pred = create_predictor(conf)
        pred.generate(ids, max_new_tokens=n_new, lengths=lens).cpu()
        counters = paths[f"generate_{label}"]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        prefill = pred._prefill_step

        def timed_prefill(*a):
            ev[0].record()
            out = prefill(*a)
            ev[1].record()
            first_logits.setdefault(label, out[0])
            return out

        pred._prefill_step = timed_prefill
        runs = {}
        for mode in ("eager", "graphed", "graphed", "eager"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in counters:
                c.launches = 0
            replays0 = pred.stats.replays["decode"]
            t0 = time.perf_counter()
            with mode_ctx(mode):
                out = pred.generate(ids, max_new_tokens=n_new, lengths=lens)
            ev[2].record()
            toks = out.cpu().numpy()            # the readback ends the wall
            wall = time.perf_counter() - t0
            n = {c.__name__: c.launches for c in counters}
            replays = pred.stats.replays["decode"] - replays0
            new = toks[:, ids.shape[1]:]
            summary = dict(
                cache=label, mode=mode, layers=cfg.num_layers,
                prompt_lens=lens.tolist(), new_tokens=int(new.size),
                wall_s=wall, tokens_per_s=new.size / wall,
                prefill_ms=ev[0].elapsed_time(ev[1]),
                decode_ms_per_token=ev[1].elapsed_time(ev[2]) / (n_new - 1),
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                decode_replays=replays, launches=n)
            log("[generate] " + json.dumps(summary))
            if new.shape != (8, n_new) or not ((new >= 0)
                                               & (new < cfg.vocab_size)).all():
                raise AssertionError(f"bad generate output {new.shape}")
            for name, k in n.items():
                if k != want[name]:
                    raise AssertionError(f"{label} {mode}: {name} launched "
                                         f"{k} times, expected {want[name]}")
            if replays != (n_new - 1 if mode == "graphed" else 0):
                raise AssertionError(f"{label} {mode}: {replays} decode "
                                     f"replays of {n_new - 1} steps")
            if mode in runs and not np.array_equal(runs[mode], new):
                raise AssertionError(f"{label}: two {mode} runs differ")
            runs[mode] = new
            launches[label] = n
        del pred._prefill_step
        log(f"[generate] {label}: {pred.stats!r}, graphs "
            + json.dumps(graphs_summary(pred.stats)))
        same = runs["graphed"] == runs["eager"]
        log(f"[generate] {label}: graphed and eager agree on "
            f"{int(same.sum())} of {same.size} new tokens (bf16)")
        outs[label] = runs["graphed"]
        if profile:
            profile_decode(pred, ids, lens, label)
        del pred, out
    agree = int((outs["static"] == outs["paged"]).sum())
    same = outs["static"] == outs["paged"]
    first = [int(np.argmin(r)) if not r.all() else n_new for r in same]
    log(f"[generate] static and paged agree on {agree} of "
        f"{outs['static'].size} new tokens, each row up to new token "
        f"{first} (bf16, K6 and K5 run different bodies: informational)")
    # the first new token's logits from the two caches' prefills: their
    # difference against each row's gap between its two best tokens
    a, b = (first_logits[k].float() for k in ("static", "paged"))
    top2 = a.topk(2, dim=-1).values
    log("[generate] prefill logits, static vs paged: max |diff| per row "
        f"{(a - b).abs().amax(-1).tolist()}, static top-2 gap per row "
        f"{(top2[:, 0] - top2[:, 1]).tolist()}, logit RMS "
        f"{a.pow(2).mean().sqrt().item()}")
    check_generate_attention(model, ids, lens)
    return launches


def check_generate_attention(model, ids, lens):
    """Paged generation of 2 new tokens on the same prompts with every
    layer's K5 call watched: the 1024-slot prefill and the first decode
    step, each output held against the plain version on the same q, pool,
    tables and lengths, per tile of 64 slots of one (row, head), 2e-2.
    Runs eagerly (every call seen), after the generate path's launches
    were read."""
    import paddle_tpu_torch.models.llama as llama
    from paddle_tpu_torch.core.cuda_graphs import eager
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.ops.kernels import decode_attention as K5

    k5 = llama.paged_decode_attention
    worst = {"prefill": [], "decode": []}

    def watched(q, kp, vp, tbl, lengths):
        out = k5(q, kp, vp, tbl, lengths)
        with torch.no_grad():
            ref = K5.paged_attention_dense(q, kp, vp, tbl, lengths)
        worst["prefill" if q.shape[1] > 1 else "decode"].append(
            _errs(out, ref)[3])
        return out

    conf = Config().set_model(model)
    conf.max_length = 2048
    conf.enable_paged_kv(64)
    llama.paged_decode_attention = watched
    try:
        with eager():
            create_predictor(conf).generate(ids, max_new_tokens=2,
                                            lengths=lens)
    finally:
        llama.paged_decode_attention = k5
    L, tol = model.config.num_layers, TOL[torch.bfloat16]
    log(f"[generate] paged K5 per layer vs plain, worst tile: "
        + json.dumps({k: max(v, default=None) for k, v in worst.items()}))
    if not all(len(v) == L and max(v) <= tol for v in worst.values()):
        raise AssertionError(f"paged generate attention: {worst}")
    log(f"[generate] every layer's K5 (the 1024-slot prefill and a decode "
        f"step) within {tol} of the plain version: OK")


def profile_decode(pred, ids, lens, label, steps=16):
    """``steps`` graphed decode steps under torch.profiler: one generate
    call of steps + 1 tokens captures its key's graph, a second runs its
    decode loop (replays only) under the profiler. Prints the device's
    busy share of the profiled wall and the device time of one decode
    step by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    decode_loop = pred._decode_loop
    seen = {}

    def profiled(*a, **kw):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = decode_loop(*a, **kw)
            torch.cuda.synchronize()
            seen["wall"] = time.perf_counter() - t0
        seen["prof"] = prof
        return out

    pred.generate(ids, max_new_tokens=steps + 1, lengths=lens)
    replays0 = pred.stats.replays["decode"]
    pred._decode_loop = profiled
    try:
        pred.generate(ids, max_new_tokens=steps + 1, lengths=lens)
    finally:
        del pred._decode_loop
    if pred.stats.replays["decode"] - replays0 != steps:
        raise AssertionError("the profiled decode steps were not replays")
    wall = seen["wall"]
    log(f"[profile:generate_{label}] {steps} graphed decode steps, "
        f"{wall * 1e3 / steps:.2f} ms a step on the host clock")
    _log_profile(seen["prof"], wall, f"generate_{label}", per=steps)


# -- phases 6 and 7: training ---------------------------------------------
def _trainer(model, scaler=None):
    """The train step a user builds: AdamW with f32 masters and moments,
    global-norm clipping, through ParallelEngine.train_step. With a
    ``scaler`` (amp.GradScaler) the learning rate follows a warmup and
    cosine schedule, and the loss is multiplied by the batch's ``k`` (1,
    or inf to force an overflow)."""
    from paddle_tpu_torch.distributed.engine import ParallelEngine
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr

    rate = 3e-4 if scaler is None else lr.LinearWarmup(
        lr.CosineAnnealingDecay(3e-4, T_max=8), warmup_steps=2,
        start_lr=3e-5, end_lr=3e-4)
    opt = AdamW(learning_rate=rate, weight_decay=0.01, multi_precision=True,
                grad_clip=ClipGradByGlobalNorm(1.0),
                parameters=model.parameters())
    crit = LlamaPretrainingCriterion(model.config)
    eng = ParallelEngine(model, opt)
    if scaler is None:
        return opt, eng.train_step(lambda m, b: crit(m(b["x"]), b["y"]))
    return opt, eng.train_step(lambda m, b: crit(m(b["x"]), b["y"]) * b["k"],
                               scaler=scaler)


def _lm_batch(seed, B, S, vocab, device):
    """B x S token ids from ``seed`` and their next-token labels."""
    ids = np.random.RandomState(seed).randint(0, vocab, (B, S + 1))
    return {"x": torch.tensor(ids[:, :-1], device=device),
            "y": torch.tensor(ids[:, 1:], device=device)}


def phase_train_parity():
    """The reduced Llama of the serving parity phase trains 3 steps on
    cuda (kernels K1, K2, K3) and on cpu (their plain versions) from the
    same weights and batch; losses and global grad norms must agree
    within 1e-4 relative."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=4096, hidden_size=1024, num_layers=2,
                      num_heads=8, num_kv_heads=2, intermediate_size=2816,
                      max_position_embeddings=1024, dtype="float32")
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=5)
    gpu = LlamaForCausalLM(cfg, device="cuda", seed=0)
    gpu.load_state_dict(cpu.state_dict())
    runs = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        opt, step = _trainer(model)
        batch = _lm_batch(14, 2, 256, cfg.vocab_size, model.device)
        runs[name] = []
        for _ in range(3):
            loss = float(step(batch))
            runs[name].append((loss, float(opt.grad_norm)))
    log(f"[train-parity] (loss, grad norm) per step: {json.dumps(runs)}")
    for (lc, nc), (lg, ng) in zip(runs["cpu"], runs["cuda"]):
        if not (abs(lg - lc) <= 1e-4 * abs(lc)
                and abs(ng - nc) <= 1e-4 * abs(nc)):
            raise AssertionError(f"cuda and cpu training differ: {runs}")
    log("[train-parity] cuda == cpu losses and grad norms within 1e-4: OK")
    train_parity_amp(cfg)


def train_parity_amp(cfg):
    """The same model from fresh weights under a GradScaler (2^10) and a
    LinearWarmup(CosineAnnealingDecay) schedule, on cuda (K8 runs the
    loss-scale protocol) and on cpu (its plain version): 5 steps, the
    third an overflow (the loss times inf). Clean steps' losses and grad
    norms within 1e-4 across devices; the overflow step must leave every
    parameter, master and moment bit-equal on both devices, and both
    scalers must end in the same state."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cpu = LlamaForCausalLM(cfg, device="cpu", seed=6)
    gpu = LlamaForCausalLM(cfg, device="cuda", seed=0)
    gpu.load_state_dict(cpu.state_dict())
    ks = [1.0, 1.0, float("inf"), 1.0, 1.0]
    runs, scalers = {}, {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        scaler = GradScaler(init_loss_scaling=2.0 ** 10)
        opt, step = _trainer(model, scaler)
        batch = _lm_batch(16, 2, 256, cfg.vocab_size, model.device)
        runs[name] = []
        for i, k in enumerate(ks):
            batch["k"] = torch.tensor(k)
            if k != 1.0:
                snap = [t.clone() for t in _train_state(model, opt)]
            loss = float(step(batch))
            found = scaler.last_found_inf
            if found != (k != 1.0):
                raise AssertionError(f"{name} step {i}: found_inf {found}")
            if k != 1.0:
                after = _train_state(model, opt)
                if not all(torch.equal(a, b) for a, b in zip(after, snap)):
                    raise AssertionError(f"{name}: the overflow step changed "
                                         "a parameter, master or moment")
                del snap
            else:
                runs[name].append((loss, float(opt.grad_norm)))
        scalers[name] = scaler.state_dict()
    log(f"[train-parity] AMP (scaler 2^10, warmup+cosine, step 3 "
        f"overflows): clean (loss, grad norm) {json.dumps(runs)}, scaler "
        f"{json.dumps(scalers)}")
    for (lc, nc), (lg, ng) in zip(runs["cpu"], runs["cuda"]):
        if not (abs(lg - lc) <= 1e-4 * abs(lc)
                and abs(ng - nc) <= 1e-4 * abs(nc)):
            raise AssertionError(f"cuda and cpu AMP training differ: {runs}")
    if scalers["cpu"] != scalers["cuda"]:
        raise AssertionError(f"scaler states differ: {scalers}")
    log("[train-parity] AMP: cuda == cpu within 1e-4, the overflow step a "
        "bit-exact no-op on both devices: OK")


def _train_state(model, opt):
    """Every parameter, master and moment of a model and its optimizer."""
    out = [p.detach() for p in model.parameters()]
    out += list(opt._master_weights.values())
    out += [t for st in opt._states.values() for t in st.values()]
    return out


def phase_train(counters, profile=False, steps=12, warm=2):
    """Llama at 7B widths, 8 layers, bf16, through ParallelEngine:
    `steps` steps on one fixed batch, the first `warm` untimed."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    cfg = llama_7b(dtype="bfloat16", num_layers=8)
    B, S = 4, 2048
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    opt, step = _trainer(model)
    batch = _lm_batch(13, B, S, cfg.vocab_size, model.device)
    torch.cuda.synchronize()
    log(f"[train] llama_7b widths, {cfg.num_layers} layers, bf16, random "
        f"weights (seed 0), {cfg.num_params() / 1e9:.3f}B params; built in "
        f"{time.perf_counter() - t0:.1f}s; batch {B} x {S} from seed 13")
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for i in range(steps):
        if i == warm:
            for c in counters:
                c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(batch)))   # the readback ends the step
        secs.append(time.perf_counter() - t0)
    launches = {c.__name__: c.launches for c in counters}
    timed = secs[warm:]
    step_ms = float(np.percentile(timed, 50)) * 1e3
    # every timed token over the timed wall, so one slow step counts
    tok_s = B * S * len(timed) / sum(timed)
    # MFU as observability/flops.py:78 counts it, with S the real
    # sequence length (2048), not max_position_embeddings
    L, h = cfg.num_layers, cfg.hidden_size
    flops_per_token = 6 * cfg.num_params() + 12 * L * h * S
    summary = dict(
        layers=L, batch=[B, S], steps=steps, untimed=warm, losses=losses,
        step_ms=[s * 1e3 for s in secs], step_ms_p50=step_ms,
        tokens_per_s=tok_s, mfu=flops_per_token * tok_s / 989e12,
        mfu_seq_len=S, grad_norm_last=float(opt.grad_norm),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches)
    log("[train] " + json.dumps(summary))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a fixed batch: {losses}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the train path")
    check_train_attention(model, opt, _lm_batch(15, B, S, cfg.vocab_size,
                                                model.device))
    if profile:
        profile_train(model, opt, batch)
    return launches, losses


def _train_run(cfg, steps, counters=()):
    """The train phase's trainer from seed 0 on its batch (seed 13):
    (model, opt, losses, step seconds); ``counters`` are set to 0 just
    before the first step."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    opt, step = _trainer(model)
    batch = _lm_batch(13, 4, 2048, cfg.vocab_size, model.device)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    losses, secs = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(batch)))
        secs.append(time.perf_counter() - t0)
    return model, opt, losses, secs


def phase_train_autotune(counters, k7, ref_losses=None, steps=7, warm=2):
    """The train phase's trainer with FLAGS_use_autotune on, over a fresh
    cache file: K7 searches K1's tile on the first step's forward, later
    steps and a second process reuse the choice. Returns the path's
    launch counts; fills ``k7`` with the search's numbers."""
    import os
    import shutil
    import tempfile

    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.models.llama import (LlamaPretrainingCriterion,
                                               llama_7b)
    from paddle_tpu_torch.ops.kernels import autotune as K7
    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    cfg = llama_7b(dtype="bfloat16", num_layers=8)
    B, S = 4, 2048
    tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_k7_")
    path = os.path.join(tmp, "autotune.json")
    os.environ["PADDLE_TPU_TORCH_AUTOTUNE_CACHE"] = path
    K7.set_cache(None)   # the process cache now reads the fresh file
    try:
        _, _, off, _ = _train_run(cfg, steps)
        torch.cuda.empty_cache()
        if ref_losses is not None:
            spread = max(abs(a - b) for a, b in zip(off, ref_losses))
            log(f"[train-autotune] two flag-off runs (the train phase's "
                f"first {steps} steps, this one): max loss difference "
                f"{spread}" + (" (bit-equal)" if spread == 0 else ""))
        else:
            spread = 0.0
        set_flags({"FLAGS_use_autotune": True})
        n_search, hits = len(K7.search_log), K7.autotune.hits
        torch.cuda.reset_peak_memory_stats()
        model, opt, on, secs = _train_run(cfg, steps, counters)
        launches = {c.__name__: c.launches for c in counters}
        searches = K7.search_log[n_search:]
        if len(searches) != 1:
            raise AssertionError(f"{len(searches)} searches in the flag-on "
                                 "run, expected one (the first forward)")
        rec = searches[0]
        times = rec["times"]
        chosen = tuple(rec["choice"])
        cands = K1.fwd_tiles(128, torch.bfloat16)
        if set(times) != set(cands) or not all(
                t is not None and math.isfinite(t) and t > 0
                for t in times.values()):
            raise AssertionError(f"the search did not time every built "
                                 f"tile {cands}: {times}")
        if chosen != min(times, key=times.get):
            raise AssertionError(f"chose {chosen}, not the argmin: {times}")
        with open(path) as f:
            on_disk = json.load(f)
        if on_disk != {rec["key"]: list(chosen)}:
            raise AssertionError(f"cache file holds {on_disk}")
        timed = secs[warm:]
        L, h = cfg.num_layers, cfg.hidden_size
        tok_s = B * S * len(timed) / sum(timed)
        summary = dict(
            key=rec["key"], search_s=rec["seconds"],
            candidates_ms={f"{bq}x{bkv}": t * 1e3
                           for (bq, bkv), t in times.items()},
            chosen=list(chosen), default=list(cands[0]),
            first_step_ms=secs[0] * 1e3, step_ms=[t * 1e3 for t in secs],
            step_ms_p50=float(np.percentile(timed, 50)) * 1e3,
            tokens_per_s=tok_s,
            mfu=(6 * cfg.num_params() + 12 * L * h * S) * tok_s / 989e12,
            losses_on=on, losses_off=off,
            cache_hits=K7.autotune.hits - hits,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            launches=launches)
        log("[train-autotune] " + json.dumps(summary))
        diff = max(abs(a - b) for a, b in zip(on, off))
        if chosen == cands[0]:
            if not diff <= spread:
                raise AssertionError(
                    f"the default tile won, yet flag-on losses differ from "
                    f"flag-off by {diff} (two flag-off runs: {spread})")
            log(f"[train-autotune] default tile chosen: flag-on losses == "
                f"flag-off within the flag-off spread {spread} (max "
                f"difference {diff}" + (", bit-equal)" if diff == 0 else ")"))
        else:
            rel = max(abs(a - b) / abs(b) for a, b in zip(on, off))
            if not rel <= 1e-2:
                raise AssertionError(f"tile {chosen}: flag-on losses differ "
                                     f"from flag-off by {rel} relative")
            log(f"[train-autotune] tile {chosen} chosen: flag-on losses "
                f"within {rel} relative of flag-off (gate 1e-2"
                + (", bit-equal)" if rel == 0 else ")"))
        if not all(np.isfinite(on)) or not on[-1] < on[0]:
            raise AssertionError(f"flag-on losses: {on}")
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{name} never launched on the "
                                     "train-autotune path")
        # a second process over the same file: no measurement, same tile
        probe = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--k1-probe"],
            env=dict(os.environ), capture_output=True, text=True,
            timeout=600)
        if probe.returncode != 0:
            raise AssertionError(f"the second process failed "
                                 f"({probe.returncode}): {probe.stderr[-2000:]}")
        second = json.loads(probe.stdout.strip().splitlines()[-1])
        log(f"[train-autotune] second process over the same file: "
            f"{json.dumps(second)}")
        if second["measurements"] != 0 or tuple(second["blocks"]) != chosen \
                or second["key"] != rec["key"]:
            raise AssertionError(f"the second process measured or chose "
                                 f"otherwise: {second}")
        # every tile through the model's path: one forward and backward
        # from the trained state at each, the tile forced by an in-memory
        # cache entry
        crit = LlamaPretrainingCriterion(cfg)
        batch = _lm_batch(13, B, S, cfg.vocab_size, model.device)
        per_tile = {}
        for t in cands:
            forced = K7.AlgoCache(None)
            forced.put(rec["key"], t)
            K7.set_cache(forced)
            n1 = K1.flash_attention_fwd.launches
            loss = crit(model(batch["x"]), batch["y"])
            loss.backward()
            norm = math.sqrt(sum(float(p.grad.float().pow(2).sum())
                                 for p in model.parameters()
                                 if p.grad is not None))
            opt.clear_grad()
            if K1.flash_attention_fwd.launches - n1 != cfg.num_layers:
                raise AssertionError(f"tile {t}: K1 launched "
                                     f"{K1.flash_attention_fwd.launches - n1}"
                                     " times in one forward")
            per_tile[t] = (float(loss), norm)
        base = per_tile[cands[0]]
        log("[train-autotune] one forward + backward at each tile (loss, "
            "grad norm): " + json.dumps({f"{a}x{b}": v for (a, b), v in
                                         per_tile.items()}))
        for t, (l, n) in per_tile.items():
            if not (abs(l - base[0]) <= TOL[torch.bfloat16] * abs(base[0])
                    and abs(n - base[1]) <= TOL[torch.bfloat16] * base[1]):
                raise AssertionError(f"tile {t}: (loss, grad norm) {(l, n)} "
                                     f"against the default's {base}")
        log(f"[train-autotune] every tile's loss and grad norm within "
            f"{TOL[torch.bfloat16]} of the default tile's: OK")
        qe = torch.empty(B, S, cfg.num_heads, cfg.head_dim,
                         dtype=torch.bfloat16, device=model.device)
        ke = torch.empty(B, S, cfg.num_kv_heads, cfg.head_dim,
                         dtype=torch.bfloat16, device=model.device)
        (fb, ff), _ = _flash_cost(qe, ke, True, None, None)
        k7.update(search=rec, summary=summary, second=second,
                  k1_bound_ms=bound(fb, ff, torch.bfloat16)[0])
        return launches
    finally:
        set_flags({"FLAGS_use_autotune": False})
        K7.set_cache(None)
        os.environ.pop("PADDLE_TPU_TORCH_AUTOTUNE_CACHE", None)
        shutil.rmtree(tmp, ignore_errors=True)


def k1_probe():
    """The second process of train-autotune: one K1 call at the train
    shape with FLAGS_use_autotune on, over the cache file the environment
    names. Prints the tile it ran and how many measurements it made."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.ops.kernels import autotune as K7
    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    set_flags({"FLAGS_use_autotune": True})
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(4, 2048, 32, 128, generator=g, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    blocks = K1._select_blocks(q, k, True, None)
    out = K1.flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    print(json.dumps(dict(
        key=K1._autotune_key(q, k, True), blocks=list(blocks),
        measurements=K7.measure_flash_blocks.launches,
        k1_launches=K1.flash_attention_fwd.launches,
        finite=bool(torch.isfinite(out).all()))))


def check_train_attention(model, opt, batch):
    """One more forward and backward of the trained model, on a batch it
    has not seen, with every layer's attention call watched: K1's output
    and K2's dq, dk, dv, as the train step runs them (autograd, bf16,
    tensor-core bodies, the model's own activations), against the plain
    version on the same q, k, v and output gradient, by the per-tile
    relative error of the kernels phase. Runs after the train path's
    launches were read, so its launches are not counted."""
    import paddle_tpu_torch.models.llama as llama
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    kernel_path = llama.flash_attention
    seen = []

    def watched(q, k, v, causal=False, dropout=0.0):
        out = kernel_path(q, k, v, causal=causal, dropout=dropout)
        rec = dict(q=q.detach(), k=k.detach(), v=v.detach(),
                   out=out.detach(), causal=causal)
        for key, t in (("do", out), ("dq", q), ("dk", k), ("dv", v)):
            t.register_hook(lambda g, key=key: rec.__setitem__(key, g))
        seen.append(rec)
        return out

    crit = LlamaPretrainingCriterion(model.config)
    llama.flash_attention = watched
    try:
        crit(model(batch["x"]), batch["y"]).backward()
    finally:
        llama.flash_attention = kernel_path
    opt.clear_grad()
    worst = 0.0
    for i, r in enumerate(seen):
        with torch.no_grad():
            r_out = K1.flash_attention_dense(r["q"], r["k"], r["v"],
                                             r["causal"])[0]
        ref = K1.flash_attention_bwd_dense(r["q"], r["k"], r["v"], r["do"],
                                           r["causal"])
        errs = {"out": _errs(r["out"], r_out)}
        errs.update((n, _errs(r[n], g)) for n, g in zip(("dq", "dk", "dv"),
                                                        ref))
        log(f"[train] layer {i} attention, kernel path vs plain: "
            + json.dumps({n: dict(max_abs_err=e[0], ref_max_abs=e[1],
                                  ref_rms=e[2], rel_err=e[3])
                          for n, e in errs.items()}))
        worst = max([worst] + [e[3] for e in errs.values()])
        del r_out, ref
        seen[i] = None
    if not (len(seen) == model.config.num_layers
            and worst <= TOL[torch.bfloat16]):
        raise AssertionError(f"train-path attention: {len(seen)} layers "
                             f"watched, worst tile error {worst}")
    log(f"[train] every layer's K1 output and K2 gradients within "
        f"{TOL[torch.bfloat16]} of the plain version (worst tile {worst}): OK")


def profile_train(model, opt, batch):
    """The step split by hand into forward, backward and optimizer step
    (clipping included), timed with CUDA events, then two steps under
    torch.profiler: device time by kernel group and by kernel, and the
    device's busy share of the profiled wall."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion

    crit = LlamaPretrainingCriterion(model.config)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss = crit(model(batch["x"]), batch["y"])
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step()
    opt.clear_grad()
    ev[3].record()
    ev[3].synchronize()
    log("[profile:train] one step by hand, CUDA events: forward "
        f"{ev[0].elapsed_time(ev[1]):.1f} ms, backward "
        f"{ev[1].elapsed_time(ev[2]):.1f} ms, optimizer step "
        f"{ev[2].elapsed_time(ev[3]):.1f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            loss = crit(model(batch["x"]), batch["y"])
            loss.backward()
            opt.step()
            opt.clear_grad()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _log_profile(prof, wall, "train")


KERNEL_GROUPS = (("gemm (cuBLAS)", ("nvjet", "gemm", "cutlass")),
                 ("K1/K2 flash attention", ("fwd_wgmma", "dq_wgmma",
                                            "dkv_wgmma", "bwd_prepass",
                                            "fwd_mma", "dq_mma", "dkv_mma",
                                            "fwd_fma", "dq_fma", "dkv_fma")),
                 ("K3 rms_norm", ("rms_norm_kernel",)),
                 # torch's own reductions are also "reduce_kernel<...>"
                 ("K8 fused_adam", ("reduce_kernel((anonymous",
                                    "finalize_kernel(", "update_kernel<")),
                 ("K4/K5/K6 paged or contiguous-cache attention",
                  ("paged_attention", "tile_wgmma_kernel", "merge_splits")))


def _log_profile(prof, wall, tag, per=1):
    """Busy share of the profiled wall and device ms by kernel group
    (divided by ``per``: ms per step where ``per`` steps ran)."""
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    log(f"[profile:{tag}] wall {wall * 1e3:.1f} ms (profiled), device busy "
        f"{busy_ms:.1f} ms = {100 * busy_ms / (wall * 1e3):.1f}%")
    groups = {}
    for e in kern:
        g = next((name for name, keys in KERNEL_GROUPS
                  if any(k in e.key for k in keys)), "other (elementwise, "
                 "copies, reductions)")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3 / per
    log(f"[profile:{tag}] device ms by group"
        + (f", per step of {per}" if per > 1 else "") + ": "
        + json.dumps({k: round(v, 3) for k, v in sorted(
            groups.items(), key=lambda kv: -kv[1])}))
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[profile:{tag}] {e.self_device_time_total / 1e3:9.1f} ms "
            f"{e.count:7d} calls  {e.key[:90]}")


def profile_serve(eng, sched):
    """The same schedule again on the warmed engine, graphed, under
    torch.profiler: device time by kernel name and the device's busy
    share of the wall (one stream, so kernel times add up without
    overlap)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = serve(eng, sched)[1]
    _log_profile(prof, wall, "serve")


def k7_entry(k7, results, launches):
    """The kernels line's K7 entry. ms: the train-autotune search's wall;
    plain_ms: the same search with the plain version's launches; bound:
    (1 + reps) launches of every candidate at K1's bound;
    candidates_k1_sum_ms: the same launches at each tile's own K1 time
    from the kernels phase."""
    search, summary = k7.get("search"), k7.get("summary", {})
    k1_ms = k7.get("k1_ms", {})
    tiles = sorted(search["times"]) if search else sorted(k1_ms)
    errs = [r["max_abs_err"] for r in results
            if r.get("case") == "tile_train"]
    b_ms = k7.get("k1_bound_ms")
    return dict(
        name="flash_autotune", route="cuda",
        source="paddle_tpu_torch/ops/kernels/autotune.py",
        replaces="paddle_tpu/ops/pallas/autotune.py:79",
        launches=launches, max_abs_err=max(errs, default=None),
        ms=search["seconds"] * 1e3 if search else None,
        plain_ms=k7.get("plain_ms"),
        bound_ms=(len(tiles) * (1 + K7_REPS) * b_ms
                  if b_ms is not None and tiles else None),
        bound_by="operations", library_ms=None,
        library="none: no single PyTorch call searches K1's tiles",
        candidates=[dict(
            blocks=list(t),
            search_ms=(search["times"][t] * 1e3 if search else None),
            k1_ms=k1_ms.get(t)) for t in tiles],
        candidates_k1_sum_ms=(sum((1 + K7_REPS) * m for m in k1_ms.values())
                              if k1_ms else None),
        choice=summary.get("chosen"), search_s=summary.get("search_s"),
        cache_hits=summary.get("cache_hits"),
        second_process=k7.get("second"), reps=K7_REPS,
        shape=[4, 2048, 32, 128], dtype="bfloat16")


def check_tile_spills(_build):
    """Every K1 tile the library lists is a fwd_wgmma<D, W, BN> instance
    that ptxas built with 0 spill bytes."""
    import re

    from paddle_tpu_torch.ops.kernels.flash_attention import fwd_tiles

    built = {}
    for fn, rep in _build.ptxas_report("flash_attention").items():
        m = re.search(r"fwd_wgmmaILi(\d+)ELi(\d+)ELi(\d+)E", fn)
        if m:
            D, W, BN = map(int, m.groups())
            built[(D, 64 * W, BN)] = rep
    bad = []
    for D in (64, 128):
        tiles = fwd_tiles(D, torch.bfloat16)
        log(f"[build] K1 tiles at D={D} bf16 (block_q, block_kv): "
            + json.dumps({f"{bq}x{bkv}": built.get((D, bq, bkv))
                          for bq, bkv in tiles}))
        for bq, bkv in tiles:
            rep = built.get((D, bq, bkv))
            if not rep or rep.get("spill_stores", 1) or \
                    rep.get("spill_loads", 1):
                bad.append(f"D={D} {bq}x{bkv}: {rep}")
    if bad:
        raise AssertionError("K1 tiles built with spills (or not found in "
                             "the ptxas log): " + "; ".join(bad))
    log("[build] every listed K1 tile built with 0 spill bytes: OK")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="depth of the 7B-width serving and generate runs")
    ap.add_argument("--phases",
                    default="build,kernels,parity,serve,generate,"
                            "train-parity,train,train-autotune")
    ap.add_argument("--profile", action="store_true",
                    help="serve the schedule once more, run 16 more decode "
                    "steps of each generate run and two more train steps "
                    "under torch.profiler, and print device time by kernel")
    ap.add_argument("--k1-probe", action="store_true",
                    help="the train-autotune phase's second process: one K1 "
                    "call with FLAGS_use_autotune on, over the cache file "
                    "$PADDLE_TPU_TORCH_AUTOTUNE_CACHE names")
    args = ap.parse_args()
    phases = args.phases.split(",")

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; it runs the port on one card")
    repo = Path(__file__).resolve().parent
    if not (repo / "paddle_tpu_torch").is_dir():
        sys.exit("chip_smoke.py: run it from the root of a checkout "
                 "(paddle_tpu_torch/ not found beside it)")
    sys.path.insert(0, str(repo))
    if args.k1_probe:
        k1_probe()
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels.autotune import measure_flash_blocks
    from paddle_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    from paddle_tpu_torch.ops.kernels.fused_adam import fused_adam
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        ragged_paged_attention
    from paddle_tpu_torch.ops.kernels.rms_norm import rms_norm

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f}s")
    # registers and spills of the attention kernels (nvcc -Xptxas -v)
    for src in ("flash_attention", "paged_attention"):
        for fn, rep in _build.ptxas_report(src).items():
            log(f"[build] ptxas {fn}: {json.dumps(rep)}")
    check_tile_spills(_build)

    dev = torch.device("cuda", 0)
    results = []
    k7 = {}   # K7's numbers: the kernels phase's, then train-autotune's
    if "kernels" in phases:
        check_rms(dev, results)
        check_attention(dev, results)
        check_decode(dev, results)
        check_flash(dev, results)
        check_flash_tiles(dev, results, k7)
        check_fused_adam(dev, results)
        bad = []
        for r in results:
            log("[kernels] " + json.dumps(r))
            err = r.get("rel_err", r["max_abs_err"])
            if not err <= r["tol"]:
                bad.append(f"{r['name']} {r['shape']} {r['dtype']}: "
                           f"{err} > {r['tol']}")
        if bad:
            raise AssertionError("kernels disagree with their plain "
                                 "versions: " + "; ".join(bad))
        log("[kernels] every case within tolerance: OK")
    if "parity" in phases:
        phase_parity()
    # each path is driven with its kernels' counts set to 0 just before
    # it and read just after: serving runs K3, K4, K5; static-cache
    # generation K3, K6; paged generation K3, K5; training K3, K1, K2, K8
    paths = {"serve": [rms_norm, ragged_paged_attention,
                       paged_decode_attention],
             "generate_static": [rms_norm, decode_attention],
             "generate_paged": [rms_norm, paged_decode_attention],
             "train": [rms_norm, flash_attention_fwd, flash_attention_bwd,
                       fused_adam],
             "train_autotune": [rms_norm, flash_attention_fwd,
                                flash_attention_bwd, fused_adam,
                                measure_flash_blocks]}
    by_path = {p: {c.__name__: None for c in cs} for p, cs in paths.items()}
    if "serve" in phases or "generate" in phases:
        model = build_7b(args.layers)
        if "serve" in phases:
            by_path["serve"] = phase_serve(model, paths["serve"],
                                           args.profile)
        if "generate" in phases:
            by_path.update(("generate_" + k, v) for k, v in phase_generate(
                model, paths, args.profile).items())
        del model
        torch.cuda.empty_cache()
    if "train-parity" in phases:
        phase_train_parity()
    train_losses = None
    if "train" in phases:
        by_path["train"], train_losses = phase_train(paths["train"],
                                                     args.profile)
        torch.cuda.empty_cache()
    if "train-autotune" in phases:
        by_path["train_autotune"] = phase_train_autotune(
            paths["train_autotune"], k7, train_losses)

    # one entry per kernel: the main path's dtype (bf16) at its main shape
    main_shape = {"rms_norm": [2048, 4096],
                  "ragged_paged_attention": [8, 256, 32, 128],
                  "paged_decode_attention": [8, 1, 32, 128],
                  "decode_attention": [8, 1, 32, 128],
                  "flash_attention_fwd": [4, 2048, 32, 128],
                  "flash_attention_bwd": [4, 2048, 32, 128],
                  "fused_adam": [_FUSED_ADAM_N]}
    flash = "paddle_tpu/ops/pallas/flash_attention.py"
    meta = {
        "rms_norm": ("paddle_tpu_torch/csrc/rms_norm.cu",
                     "paddle_tpu/ops/pallas/rms_norm.py:75", "serve"),
        "ragged_paged_attention": (
            "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/ops/pallas/ragged_paged_attention.py:122", "serve"),
        "paged_decode_attention": (
            "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/ops/pallas/decode_attention.py:220", "serve"),
        "decode_attention": (
            "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/ops/pallas/decode_attention.py:113",
            "generate_static"),
        "flash_attention_fwd": ("paddle_tpu_torch/csrc/flash_attention.cu",
                                f"{flash}:432", "train"),
        "flash_attention_bwd": ("paddle_tpu_torch/csrc/flash_attention.cu",
                                f"{flash}:307", "train"),
        "fused_adam": ("paddle_tpu_torch/csrc/fused_adam.cu",
                       "paddle_tpu/optimizer/__init__.py:211", "train")}
    kernels = []
    for name, (src, repl, path) in meta.items():
        mine = [r for r in results if r["name"] == name]
        main = [r for r in mine if r["shape"] == main_shape[name]
                and r["dtype"] == "bfloat16" and "blocks" not in r
                and r.get("kv_heads", 32) == 32 and not r.get("diagnostic")]
        row = main[0] if main else {}
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=by_path[path][name],
            launches_by_path={p: n[name] for p, n in by_path.items()
                              if name in n},
            max_abs_err=max((r["max_abs_err"] for r in mine), default=None),
            ms=row.get("ms"), plain_ms=row.get("plain_ms"),
            bound_ms=row.get("bound_ms"), bound_by=row.get("bound_by"),
            library_ms=row.get("library_ms"), shape=main_shape[name],
            dtype="bfloat16",
            **{k: row[k] for k in ("body", "splits", "workspace_bytes")
               if k in row}))
    kernels.append(k7_entry(k7, results,
                            by_path["train_autotune"]["measure_flash_blocks"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

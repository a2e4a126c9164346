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
                bytes (the mma bodies' instances, with and without
                dropout, are printed), and so must every K9 kernel
                (weight_only_linear),
                the gemv body's gemv_cluster_kernel (8 / 16 rows, int8 /
                int4, and its read-only form) included, with no wgmma
                serialised by ptxas; K9's routes, their dynamic shared
                memory (the wrapper's count must equal the C library's)
                and the wgmma and gemv bodies' registers; K10's three
                bodies and their pre-pass kernels built (no wgmma
                serialised), and the registers and spills of each (the
                pre-pass kernels' bf16 and fp32 instances)
2. kernels      K10 (LLM.int8's linear) against its plain version at
                Llama-7B's widths, x [8, 4096] and [2048, 4096] times q
                [11008, 4096], x [2048, 11008] times q [4096, 11008],
                threshold 6.0, bf16 with 8 planted outlier columns (up to
                |20|) and with none, one fp32 and one biased case: xq, the
                row scales, the column absmax and the int32 product equal
                the plain version's bit for bit, the outlier list its
                outlier columns, the output within bf16 2e-2 / fp32 1e-5
                of its largest magnitude (equal where nothing is an
                outlier), and so the output of the same call without
                ``parts`` (the wgmma body's 16-byte stores); K10, plain,
                torch._int_mm (M > 16) and F.linear (a bf16 copy of the
                dequantized weight) timed with the bound, K10's pre-pass
                apart (torch.profiler's device time of its kernels), and
                at M = 8 the gemv body at every K split it can take;
                each row names the body it took (the prefill shapes must
                take wgmma, M = 8 gemv), its CTAs and its kernels' ptxas
                registers and spills; then nn.quant.llm_int8_linear once
                at each shape, the path whose launches the kernels line
                reads, its outputs held to the plain version's.
                K9 (the int8 / int4 weight-only linear) against its plain
                version: int8 and int4, bf16 and fp32 x, M = 1, 8, 16,
                17, 2048, 8192 at (K, N) = (4096, 4096), (4096, 11008),
                (11008, 4096), (4128, 200) (the TMA edge: K not a
                multiple of 64, N not of 128) and (200, 72), with and
                without a bias (gate: the largest difference over the
                output's largest magnitude, bf16 2e-2, fp32 1e-4); the
                cases without a bias timed with their bound, plain and
                F.linear times (the weights rotated through copies larger
                than the L2). bf16 M > 16 must run the wgmma body at
                every (K, N) but (200, 72), which TMA cannot address; the
                wgmma body has its own entry in the kernels line
                (weight_only_linear_wgmma, at [2048, 4096] x [11008,
                4096], its launches counted on its own). bf16 M <= 16
                must run the gemv body in one kernel launch a call
                (torch.profiler's count); each K9 row names its splits,
                cluster size and kernels a call. The read ceiling of the
                gemv body at the decode shapes, int8 and int4: its own
                grid and loads reading the weight bytes and nothing else,
                and a coalesced stream of the same bytes, timed as K9.
                K3 (RMSNorm, and its gradient), K4 (ragged paged
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
                each call ran (wgmma_split, f32_tile, mma, fma), its split
                count and workspace bytes; the bf16 cases must run the
                Hopper body. K6 rows name their route too (bf16 at D = 128
                must run wgmma_split), and K5 over the same keys (the
                cache cut into 64-key pages) must give K6's bits, bf16
                and fp32.
                K8 (the multi-tensor AdamW + clip update) at the train
                phase's 1.881 B-parameter set (bf16 parameters, f32
                masters and moments) against its plain version: f32
                buffers within 1e-6 of each tensor's largest magnitude,
                bf16 parameters within one ulp; K8, plain and
                torch._fused_adamw_ timed with CUDA events. K8's split
                reduce (an mp 2 rank of gpt_1p3b, 0.66 B parameters: the
                shards' and the replicated tensors' squared sums apart)
                against its plain version and the degree-1 call's norm
                (1e-5), timed beside the degree-1 call. K1/K2 with
                dropout at a head offset (heads 8..15 of gpt_1p3b's
                attention with head_offset 8) bit-equal to the whole
                call's same heads, and within 2e-2 of the plain version
                at the offset. K1 at every
                built tile (block_q, block_kv) at the train shape [4,
                2048, 32, 128] and at GQA [4, 2048, 32 / 8, 128], causal
                bf16, against the plain version and timed; K7's search
                over the plain version timed as its plain time. K4 and K5
                also at the llama-68m draft's widths (q [8, 256, 12, 64]
                and [8, 1, 12, 64], bf16), with bound and SDPA time.
                K1 and K2 with attention dropout (p = 0.1, one seed)
                against the plain version with the same seed, causal: at
                gpt_1p3b's shape [4, 2048, 16, 128] and GQA D = 64 in bf16
                (2e-2 per tile), fp32 D = 64 (1e-4); in bf16 both timed
                with and without dropout (CUDA graphs of 20 calls)
                beside the plain version and SDPA with and without
                dropout_p (the bound: the same operations as without
                dropout); each dropout row carries its instances' ptxas
                registers and spills. The mask (csrc/philox.cuh: one
                Philox4x32-10 hash decides 8 keys of a row, a 16-bit
                half each, against round(p 2^16)) read back bit for bit:
                with V's rows the identity, K1's output is non-zero
                exactly where the mask keeps, and with dO's rows the
                identity K2's dV is too (D = 64, 128 bf16, fp32, causal
                and not). The repo's Philox4x32-10 against curand's
                curand_Philox4x32_10 on 65536 counter/key pairs
2b. masked-attention
                scaled_dot_product_attention with an attn_mask and
                dropout_p = 0.1 (torch ops on the kernels' Philox mask) at
                gpt_1p3b's attention [4, 2048, 16, 128], bf16: an all-True
                mask with is_causal against K1 / K2 with dropout at the
                same seed (output and gradients, 2e-2 per 64-position
                tile); a key-padding mask [4, 1, 1, 2048] of ragged
                lengths: finite output and gradients; at [2, 128, 4, 64]
                fp32, bool and additive masks, card against cpu within
                1e-5 and the keep masks equal. The masked path's forward
                and forward + backward ms and peak memory beside the
                unmasked path's
3. parity       a reduced Llama (fp32, TF32 off) served on cuda, graphed
                and eager, and on cpu with the same weights and arrival
                schedule, and run through Predictor.generate with static
                and paged caches (ragged rows, an EOS), graphed and eager:
                every token stream must be equal, across devices, between
                the two caches and between graphed and eager (with equal
                launch counts); top-k/top-p sampling from one seed,
                graphed against eager, equal; the prefix cache,
                speculative decoding (a 1-layer fp32 draft) and the host
                tier together on a 15-page pool, so that pages are shared,
                copied on write, reclaimed, spilled and faulted back: cuda
                graphed, cuda eager and cpu token streams equal, and equal
                to the plain engine's, with equal counters; a
                FusedMultiTransformer prefill and 3 decode steps, cuda
                against cpu, within 1e-4; weight-only generation (int8
                and int4, static and paged) cuda graphed against cpu:
                equal quantized weights, equal token streams, K9 launched
4. serve        Llama-7B widths (32 layers, bf16, random weights from a
                seed) through one ServingEngine: a warmup that captures
                the unified and decode rounds' CUDA graphs, then 16
                greedy requests, 8 of them arriving mid-run, four times:
                eager, graphed, graphed, eager. Equal tokens in all four,
                launches of K3, K4 and K5 exactly as the rounds imply,
                every graphed round a replay, one graph per shape key.
                The telemetry (the engine runs with mem_ledger=True):
                each run moves the TTFT, TPOT and e2e stage histograms'
                counts by its 16 requests and leaves each request's whole
                trace (queued, prefill, chunks, decode rounds, decode,
                e2e); a /metrics scrape and /healthz over loopback; one
                memory ledger a graphed site (unified, decode), the pool
                exactly page_bytes x pool_pages.
                Then one unified round holding both prefill chunks and
                decode rows, and one decode round, of a second short
                eager serve with every layer's K4 and K5 call watched:
                each output against the plain version on the engine's
                own q, pools, tables, starts and lengths, per tile, 2e-2
4b. serve-disagg
                the serve phase's model, settings and schedule through a
                Router: first two unified replicas, then one
                phase="prefill" and one phase="decode" replica
                (pool_pages="auto": the second engine sees the first's
                pool) with KVMigrator moving each request's committed
                pages (device to host, crc32, host to device). Each fleet
                warmed a request a replica, then served graphed: every
                round a replay, no capture after the warmup, each
                replica's K3 / K4 / K5 launches exactly as its rounds
                imply, migrated bytes equal to sum(ceil(L / 64) x
                page_bytes + 128) on the counter and the comm ledger,
                the migrated requests' traces complete. Prints tokens/s,
                TTFT / TPOT p50 / p99, the migration seconds in its three
                parts, the fleets' token agreement and both fleets' worst
                teacher-forced logit gap (< 0.5). Then the same fleets at
                2 layers in fp32 (TF32 off), the split one with a second
                prefill replica and its first migration corrupted: equal
                streams, one crc error retried on the other replica
5. serve-prefix-spec
                the same model and engine settings with prefix_cache=True:
                alone, with the llama-68m draft (its published widths,
                bf16, seed 1) at spec_tokens=4, and with the target as its
                own draft, beside the plain engine. 16 prompts share a
                1024-token system prompt (each its own 64..512-token
                suffix), 32 new tokens each; 8 arrive first, 8 once those
                all decode, one of them the system prompt alone (a full
                hit). Per configuration: a warmup capturing every graph,
                then eager, graphed, graphed from an empty cache. Equal
                tokens, launches of K3, K4 and K5 exactly as the target's
                and the draft's rounds imply, every graphed round a
                replay, the pool invariant, >= 16 hit pages per second-
                wave request, a copy-on-write; self-speculation's tokens
                against a teacher-forced forward (a token that is not the
                argmax within 0.5 of its logit). tokens/s, TTFT, TPOT,
                prefix and spec counters, agreement with the plain serve
6. generate     the same model through Predictor.generate: 8 ragged
                prompts of 128..1024 tokens, 128 greedy new tokens with
                the static cache (K6), then with enable_paged_kv(64) (K5);
                an untimed graphed call captures the decode graph, then
                four measured calls, eager, graphed, graphed, eager:
                prefill and per-token decode ms, tokens/s, peak memory,
                exact launch counts of K6, K5 and K3, every graphed
                decode step a replay, graphed-eager token agreement; the
                static and paged runs must give equal tokens and equal
                prefill logits (K6 and K5 run one body); then
                an eager paged generation of 2 tokens with every layer's
                K5 call (the prefill and a decode step) held against the
                plain version per tile, 2e-2
7. weight-only  the same model quantized in place to int8 (every
                projection; the LM head stays bf16): Predictor.generate
                static and paged as in phase 6 (eager, graphed, graphed,
                eager; equal tokens, static == paged), then phase 4's
                serve schedule graphed twice; K9 launches exactly 7 a
                layer a step beside the other kernels' counts, its wgmma
                body (bf16, M > 16) exactly 7 a layer a prefill and a
                unified round; decode ms
                a token, prefill ms, tokens/s, TTFT, TPOT and peak memory
                printed beside the bf16 runs of the same call; a
                teacher-forced forward with every K9 call (all on the
                wgmma body) held against its plain version on the same
                activations and int8 weights (2e-2), and its logits
                against an all-plain
                forward (printed); the share of tokens equal to bf16's
                (not gated). Then the model rebuilt from its seed and
                quantized to int4: static generation, graphed
7b. load-serve  Llama-7B widths cut to 8 layers (bf16, seed 0) saved with
                save(export_jax_state_dict(model, tensors=True)) (the JAX
                package's format and layout, 3.76 GB) under build/, then
                served by Predictor.generate through
                Config(params_file=...) and Config(model_dir=...) with a
                model factory (another seed): 32 greedy tokens for the
                generate phase's ragged prompts equal to the live
                model's; K3 / K6 launches as the steps imply; the save and
                load seconds and GB/s; the files removed
8. train-parity the reduced Llama trains 3 steps on cuda and on cpu from
                the same weights and batch: losses and global grad norms
                within 1e-4 relative; then 5 steps from fresh weights
                under a GradScaler (2^10) and a warmup + cosine schedule,
                the third an overflow: clean steps within 1e-4 across
                devices, the overflow step a bit-exact no-op on both
9. train        Llama-7B widths cut to 8 layers (bf16 weights, f32 AdamW
                masters and moments) through ParallelEngine.train_step:
                12 steps on one fixed 4 x 2048 batch, 2 untimed; finite,
                falling losses, step time, tokens/s, MFU, peak memory; K3,
                K1, K2 and K8 must launch in the timed steps. Then one more
                forward and backward with each layer's attention watched:
                K1's output and K2's gradients on the model's own bf16
                activations against the plain version, per tile, 2e-2
10. train-autotune
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
11. gpt-parity  a reduced GPT (2 layers, hidden 512, 8 heads: D = 64,
                vocab 4096, fp32) with attention dropout 0.1 trains 3
                AdamW steps on cuda (K1/K2's dropout kernels) and on cpu
                from the same weights and seed: equal masks by
                construction, losses and global grad norms within 1e-4
                relative; with dropout 0 its cached forward (prefill 64,
                8 single-token steps) cuda against cpu within 1e-4
12. train-gpt   gpt_1p3b at full width and depth (24 layers, hidden
                2048, 16 heads, vocab 50304, 1.316 B parameters; bf16
                weights, f32 AdamW masters and moments, clip 1.0): 12
                steps on one fixed 4 x 2048 batch, 2 untimed, with dropout
                0 and then with hidden and attention dropout 0.1; finite,
                falling losses, step ms p50, tokens/s, MFU, peak memory;
                K1 and K2 exactly 24 launches a timed step, K8 one, the
                dropout variants 24 a step in the second run only; then
                each layer's attention watched (K1's output and K2's
                gradients against the plain version, 2e-2)
13. varlen      three causal packs at gpt_1p3b's attention widths (16
                heads, D = 128, bf16; VARLEN_PACKS): "varlen", 8
                sequences of 2048, 1792, ..., 256 keys (Tk 9216), each q
                the last half of its sequence (Tq 4608), so q and k
                boundaries differ; "varlen_asc", the same shortest first;
                "varlen_train", 8 documents of 700, 2100, 260, 1300, 500,
                1800, 1012 and 520 tokens with q = k (T 8192: packed
                pretraining; blocks straddle documents). Each through
                flash_attn_unpadded forward and backward, without and
                with dropout 0.1: K1/K2 with the frontier arrays launched
                once each (their varlen counters), flash_attention_dense
                called 0 times on CUDA; output and gradients against the
                plain version on the same ranges, per 64-position tile,
                2e-2; K1/K2 timed at the pack with their bound (visible
                pairs x 4 D flops a head forward, 10 D backward), K2's
                parts (pre-pass, dq and dk/dv alone) and the library's
                varlen flash forward and backward
                (aten._flash_attention_forward / _backward on the
                cu_seqlens, varlen_attn's op; first held to the plain
                version at p = 0, 2e-2); K2's dq and dk/dv roles launched
                alone bit-equal to its one launch. The same checks in
                fp32 at a small pack (1e-4). The pack's dropout mask read
                back bit for bit (Tk <= D: identity V and dO rows), bf16
                and fp32. The bf16 mma.sync bodies (D = 16, 32), causal,
                without and with dropout 0.1: gpt_tiny's [8, 128, 4, 16],
                [4, 512, 8, 32], and Pythia-31m's attention at its full
                context [8, 2048, 8, 32] with its D = 16 twin, against
                the plain version (2e-2, lse too), timed beside the plain
                version and SDPA with and without dropout_p (CUDA graphs)
                with their bound, K2's dq and dk/dv roles apart and their
                ptxas registers and spills; their masks read back at D =
                16 and 32
14. train-surface
                gpt_1p3b trained 4 untimed + 4 timed steps on a 4 x 2048
                batch by cross_entropy(label_smoothing=0.1), every 97th
                label ignored: finite, falling losses, K1/K2 24 launches
                a step and K8 one, the loss within 1e-5 of torch's f32
                evaluation of the same formula; one step under
                collect_operator_stats (bf16 matmuls and 24 K1 / K2
                calls counted), one clean step under the tensor checker
                (its ms beside the plain step's), and one with a NaN in a
                weight, which must raise FloatingPointError naming an op.
                Embedding(50304, 2048, sparse=True) f32 on the batch's
                ids: SGD and lazy Adam 5 steps, card against cpu (1e-5,
                lazy Adam's moments at the looked-up rows too); Adam
                densified against dense-gradient Adam (1e-6, weights and
                moments); SGD with a global-norm clip over sparse and
                dense gradients against the all-dense model (1e-6).
                gpt_tiny in bf16 (D = 16: the mma bodies) without dropout
                and with hidden and attention dropout 0.1: 3 AdamW steps
                each, finite losses, K1/K2 once a layer a step, the
                dropout variants iff dropout. The host cost of the kernels'
                counted wrapper with amp.debugging off (ns a call)
15. train-ckpt  gpt_1p3b at full width, 4 layers (0.31 B parameters),
                bf16, AdamW with f32 masters, clip 1.0, LinearWarmup into
                CosineAnnealingDecay, hidden and attention dropout 0.1, a
                4 x 2048 batch a step from a seed, through ParallelEngine
                with its telemetry: run A takes 8 steps, a synchronous
                save_checkpoint after step 4 and an async one through a
                CheckpointManager (keep 2) after step 6; run B, a fresh
                model from another seed, restores step 4 and takes steps
                5-8: its losses, parameters, masters, moments, step
                count, LR schedule and both dropout generators must equal
                A's bit for bit (torch.equal). A save whose commit fails
                (the ckpt.commit failpoint) must raise and leave step 6
                the newest committed checkpoint, which restores A's step-6
                parameters. Run A's telemetry: steps / tokens counters 8 /
                8 x 8192, the loss gauge the last loss, MFU within 2% of
                (6 N + 12 L h S) tokens/s / 989e12 on the last step's
                interval, device-memory gauges, no health event (and one
                loss_spike from health.loss_spike=corrupt@3 on a monitor
                with warmup 2 fed the first three steps), restore and
                ckpt_stall in the goodput journal, every train metric of
                schema.json in one /metrics scrape over loopback. K1/K2
                (their dropout instances) 4 a step and K8 one. Prints the
                checkpoint's bytes, the save, stall and restore seconds
                and GB/s, and the telemetry's host microseconds a step
16. train-hybrid
                tensor- and data-parallel GPT through the port's launcher
                (python -m paddle_tpu_torch.distributed.launch
                --nproc_per_node N chip_smoke.py --hybrid-rank MODE: fresh
                processes, each rank on cuda:0, its output in
                build/hybrid/logs/MODE/workerlog.RANK; a rank that fails
                or hangs fails the launch): NCCL at world 1 (every
                collective of the API on a CUDA tensor is the identity,
                through NCCL; one gpt_1p3b-width 2-layer bf16 step under
                a degree-1 HCG bit-equal to the step without fleet); two
                ranks on the card refused (init_parallel_env() raises;
                NCCL itself, asked anyway, reports the duplicate GPU);
                then, each held to a degree-1 run of the same model, seed
                and 4 x 2048 batch in this process (AdamW, f32 masters for
                bf16, clip 1.0): mp 2 fp32 at gpt_1p3b's widths and 2
                layers, 3 steps (losses 1e-4 relative, the gathered
                parameters 1e-4 relative L2 over all); mp 2 bf16 at 8 of
                its 24 layers (cut from full depth to keep the run inside
                half its time limit beside phase 17), 5 steps with
                dropout 0, then 5 with 0.1 (losses
                2e-2, finite and falling); dp 2 x mp 2 bf16 at 4 layers,
                3 steps (2e-2). Every run: replicated parameters
                bit-equal across the mp ranks (and every parameter across
                all ranks at dp 2), K1/K2 layers x steps launches a rank
                and K8 one a step, layer 0's attention on the rank's
                heads (dropout at its head offset) within 2e-2 of the
                plain version, the last step's booked bytes equal to the
                closed form (mp: 4 L b S H e + 2 b S H e + 2 b S 4 + 4
                all-reduced, b S 4 maxed). Prints per rank step ms p50,
                the card's tokens/s, peak memory, the bytes and the host
                staging's seconds a step, beside the card's name and
                power limit: times of ranks sharing one card over gloo,
                not of NCCL
17. train-llama-hybrid
                Llama at Llama-7B's published widths (h 4096, 32 heads, FFN
                11008, vocab 32000) under tensor parallelism, sequence
                parallelism and recompute, ranks sharing the card over gloo
                through the port's launcher as in phase 16
                (build/llama_hybrid), AdamW at lr 1e-5 (LLAMA_LR: early
                warmup's) with f32 masters for bf16, clip 1.0, one 4 x 2048
                batch from a seed, every run mp 2 and held to a degree-1 run
                of the same weights and batch made in this process first and
                freed before the ranks start. First K8's split reduce at one
                Llama mp 2 rank's parameters (8 layers, 0.94 B) against its
                plain version. (a) fp32, 2 layers, 3 steps: the gathered
                seeded initialisation bit-equal to degree 1's (sha256 of
                every tensor), losses within 1e-6 (|a - b| / max(|b|, 1):
                the batch is learnt in a few steps, so a loss near 0 is held
                absolutely) and the gathered parameters within 1e-6 relative
                L2 over all, 1e-5 for the worst tensor (LLAMA_PARAMS_GATE).
                (b) bf16, 8 layers (1.881 B), 5 steps: losses within 1e-3.
                (e) first, on (b)'s fresh model: ParallelEngine.eval_step
                with batch_specs, the vocab's shards gathered by out_spec on
                a 4 x 256 batch: bit-equal to the rank's own forward
                gathered, within 2e-2 of the degree-1 forward with its
                o_proj / down_proj products split in two halves rounded to
                bf16 before their sum, as mp 2's are (relative L2 over tiles
                of 64 positions; the reading against the plain degree-1
                forward and the split forward's own printed beside,
                LLAMA_EVAL_GATES), and in (a)'s fp32 model within 1e-4 of
                the plain forward. (c) (b) with every decoder
                layer under fleet.recompute: the same gate, and its losses
                and parameters against (b)'s (bit-equal expected; the
                largest difference and its first tensor printed). (d) the
                JAX test's SPBlock (sequence scattered, LlamaRMSNorm, column
                / row sequence-parallel linears 4096 -> 11008 -> 4096, ReLU,
                sequence gathered) stacked 8 deep over [4, 2048, 4096] bf16,
                an MSE loss, 3 steps, then again under recompute: losses
                within 1e-3 of the dense stack at degree 1. Every run:
                replicated (and sequence-parallel-marked) parameters
                bit-equal across the ranks; K1 layers x steps launches a
                rank (twice that under recompute), K2 layers x steps, K3 (2
                L + 1) x steps (4 L + 1 under recompute; the SP stack L, 2
                L), K8 one a step; the last step's booked bytes equal to the
                closed form (mp: (7 L + 2) b S H e all-reduced, 2 L b S H e
                more under recompute, + 2 b S 4 + 4, b S 4 maxed; SP:
                all-gathers of the sequence shard, reduce-scatters of the
                whole, the marked gradients' sums); K1/K2 on layer 0's
                attention on the rank's 16 heads [4, 2048, 16, 128] and K3
                (forward and gradient) on layer 0's input, the SP stack's on
                the rank's sequence shard [4096, 4096], each within 2e-2 of
                its plain version. Prints per rank step ms p50, the card's
                tokens/s, peak memory and the bytes and host staging seconds
                a step, beside the card's name and power limit
18. train-pipe  pipeline parallelism and ZeRO at gpt_1p3b's widths (h 2048,
                16 heads of 128, vocab 50304, tied embeddings):
                GPTForCausalLMPipe at mp 2 x pp 2 x sharding 2 with two
                virtual stages, 8 ranks sharing the card over gloo through
                the port's launcher as in phase 16 (build/pipe),
                micro-batch 1 x 2048, accumulate_steps 2, AdamW (lr 1e-5,
                f32 masters for bf16), clip 1.0, comm_overlap with 25 MB
                buckets, each run held to a degree-1 GPTForCausalLM of the
                same seed and batch made in this process first: (a) fp32,
                4 layers, ZeRO stage 2, 3 steps (losses 1e-5 relative, the
                parameters 1e-5 relative L2 over every element counted
                once); (b) bf16, 8 layers (2 a chunk), stage 2 then stage
                3, 5 steps each (losses 2e-2; stage 3's losses and each
                rank's parameter digest bit-equal to stage 2's). Every run:
                K1/K2 blocks on the rank x microbatches launches a step and
                K8 one, K1 and K2 (dq, dk, dv; a seeded dO) on the rank's
                first block and its heads within 2e-2 (bf16) / 1e-4 (fp32)
                per tile of the plain version, K8's call of the last step
                (the rank's ZeRO shards, bucket views and whole parameters
                as the step passes them) against the plain version on
                copies of its inputs (f32 masters, moments and parameters
                within 1e-6 of each tensor's largest magnitude, bf16
                parameters within one ulp of it, the split norm within
                1e-5), the tied embedding's copies bit-equal, the
                last step's booked bytes by group and op and the
                model-state bytes at their closed forms. Prints per rank
                step ms p50, the card's tokens/s, peak memory, model-state
                bytes, staged bytes and seconds by part (device-to-host,
                gloo, host-to-device) and the bubble gauge, beside the
                card's name and power limit

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.

Developer options (the plain run uses none of them; ``--k1-probe`` is
the second process of train-autotune): ``--phases`` runs a
subset, ``--layers`` cuts the 7B-width serving, generate and weight-only
runs' depth, and ``--profile`` serves the schedule once more (graphed),
runs 16 more graphed decode steps of each generate run (the weight-only
ones too) and two more train steps under torch.profiler, and prints the
device's busy share of those profiled runs and their time by kernel.
``python3 -c "import chip_smoke; chip_smoke.drop_sass(so)"`` prints
the SASS counts of K1/K2's dropout instances in a built flash library
``so`` (for a comparison of two builds; no phase runs it).
``--compare ROOT,ROOT,...`` times K1/K2 of each checkout root in turn
(each in its own process, with its own package and build: a ``git
archive`` of the parent under ``build/`` against ``.``, in the order
parent, change, change, parent) at the mma shapes, the Hopper dropout
cases and the three varlen packs with and without dropout (K2's parts,
its dq and dk/dv launched apart, the library), and K10 at
LLM_INT8_SHAPES with and without outlier columns (``--k10-times``: the
call, its pre-pass apart by torch.profiler, torch._int_mm and
F.linear), and prints them side by side; it runs no phase. The first
shape a process times is timed twice and its first reading dropped.
``--compare-train ROOT,ROOT,...`` runs each root's own ``chip_smoke.py
--phases build,train-gpt`` in turn and prints the step ms p50 of each
run side by side (the cost of a change to every training step; it runs
no phase of its own). ``--compare-serve
ROOT,ROOT,...`` does the same with each root's ``--phases build,serve``
and prints the graphed runs' tokens/s and TPOT p50 (the cost of a change
to every serving round).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
              torch.int8: 1979e12,     # dense tensor-core int8 (TOP/s)
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


# attention dropout (K1/K2's dropout variant): (label, B, S, H, KV, D,
# dtype); "gpt" is gpt_1p3b's training shape, the train-gpt phase's
DROPOUT_P = 0.1
DROPOUT_SEED = 0x5EED_0123_4567_89AB
DROPOUT_CASES = [("gpt", 4, 2048, 16, 16, 128, torch.bfloat16),
                 ("gqa_d64", 2, 1024, 16, 4, 64, torch.bfloat16),
                 ("f32_d64", 2, 512, 8, 8, 64, torch.float32)]


def check_flash_dropout(dev, results):
    """K1 and K2 with attention dropout (p = 0.1, one seed) against the
    plain version with the same seed, per 64-position tile (bf16 2e-2,
    fp32 1e-4), causal; in bf16 (the GPT shape and D = 64, the head dim
    of gpt_125m and gpt_350m) K1 and K2 are timed with and without
    dropout (CUDA graphs of 20 calls), beside the plain version and
    F.scaled_dot_product_attention with and without dropout_p (timed
    with events: the yardstick only, the port never calls it). The bound
    is the same operations as without dropout. Then the mask read back
    from the kernels (``check_dropout_mask``) and the hash against curand
    (``check_philox``)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    p, seed = DROPOUT_P, DROPOUT_SEED
    g = torch.Generator(device=dev).manual_seed(11)
    for label, B, S, H, KV, D, dt in DROPOUT_CASES:
        q, k, v, do, _, _ = _flash_inputs(dev, dt, B, S, S, H, KV, D, False,
                                          g)
        n0 = (K1.flash_attention_fwd_dropout.launches,
              K1.flash_attention_bwd_dropout.launches)
        out, lse = K1.flash_attention_fwd_lse(q, k, v, True, dropout=p,
                                              seed=seed)
        grads = K1.flash_attention_bwd(q, k, v, out, lse, do, True,
                                       dropout=p, seed=seed)
        if (K1.flash_attention_fwd_dropout.launches,
                K1.flash_attention_bwd_dropout.launches) != (n0[0] + 1,
                                                             n0[1] + 1):
            raise AssertionError("the dropout calls did not count one "
                                 "launch of each dropout variant")
        r_out, r_lse = K1.flash_attention_dense(q, k, v, True, dropout=p,
                                                seed=seed)
        r_grads = K1.flash_attention_bwd_dense(q, k, v, do, True,
                                               dropout=p, seed=seed)
        eo = _errs(out, r_out)
        eg = [_errs(a, b) for a, b in zip(grads, r_grads)]
        (fb, ff), (bb, bf) = _flash_cost(q, k, True, None, None)
        base = dict(case=label, shape=[B, S, H, D], skv=S, kv_heads=KV,
                    causal=True, dropout=p, dtype=str(dt)[6:], tol=TOL[dt])
        fwd = dict(base, name="flash_attention_fwd_dropout", bytes=fb,
                   flops=ff, max_abs_err=eo[0], ref_max_abs=eo[1],
                   rel_err=eo[3],
                   lse_abs_err=(lse - r_lse).abs().max().item(),
                   ptxas=drop_ptxas("fwd", D, dt))
        bwd = dict(base, name="flash_attention_bwd_dropout", bytes=bb,
                   flops=bf, max_abs_err=max(e[0] for e in eg),
                   rel_err=max(e[3] for e in eg),
                   ptxas=drop_ptxas("bwd", D, dt))
        if dt == torch.bfloat16:
            qt, kt, vt, kw = _sdpa_args(q, k, v, True, None, None)
            qg, kg, vg = (t.detach().requires_grad_(True)
                          for t in (qt, kt, vt))
            dot = do.transpose(1, 2).contiguous()
            lib = {}
            for name, dp in (("", 0.0), ("_dropout", p)):
                o = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=dp,
                                                   **kw)
                lib["fwd" + name] = events_ms(
                    lambda dp=dp: F.scaled_dot_product_attention(
                        qt, kt, vt, dropout_p=dp, **kw))
                lib["bwd" + name] = events_ms(lambda o=o: torch.autograd.grad(
                    o, (qg, kg, vg), dot, retain_graph=True))
                del o
            for rec, which in ((fwd, "fwd"), (bwd, "bwd")):
                rec["bound_ms"], rec["bound_by"] = bound(
                    *((fb, ff) if which == "fwd" else (bb, bf)), dt)
                rec["library_ms"] = lib[which + "_dropout"]
                rec["library_no_dropout_ms"] = lib[which]
                rec["library"] = "F.scaled_dot_product_attention " + (
                    "forward" if which == "fwd" else
                    "backward (autograd.grad on a kept graph)") + \
                    f", dropout_p={p}"
            fwd["ms"] = cuda_ms(lambda: K1.flash_attention_fwd_lse(
                q, k, v, True, dropout=p, seed=seed))
            fwd["no_dropout_ms"] = cuda_ms(lambda: K1.flash_attention_fwd_lse(
                q, k, v, True))
            fwd["plain_ms"] = cuda_ms(lambda: K1.flash_attention_dense(
                q, k, v, True, dropout=p, seed=seed), iters=3, warm=1)
            bwd["ms"] = cuda_ms(lambda: K1.flash_attention_bwd(
                q, k, v, out, lse, do, True, dropout=p, seed=seed))
            out0, lse0 = K1.flash_attention_fwd_lse(q, k, v, True)
            bwd["no_dropout_ms"] = cuda_ms(lambda: K1.flash_attention_bwd(
                q, k, v, out0, lse0, do, True))
            bwd["plain_ms"] = events_ms(lambda: K1.flash_attention_bwd_dense(
                q, k, v, do, True, dropout=p, seed=seed), iters=3, warm=1)
            fwd["plain_no_dropout_ms"] = cuda_ms(
                lambda: K1.flash_attention_dense(q, k, v, True), iters=3,
                warm=1)
            bwd["plain_no_dropout_ms"] = events_ms(
                lambda: K1.flash_attention_bwd_dense(q, k, v, do, True),
                iters=3, warm=1)
            del qg, kg, vg, out0, lse0
        results += [fwd, bwd]
        if not fwd["lse_abs_err"] <= TOL[dt]:
            raise AssertionError(f"K1 dropout lse off by "
                                 f"{fwd['lse_abs_err']} ({label})")
        del q, k, v, do, out, lse, grads, r_out, r_lse, r_grads
        torch.cuda.empty_cache()
    check_dropout_mask(dev)
    check_philox(dev)


def flash_instances(report):
    """The flash library's body instances in ``report`` (mangled kernel
    name -> counts: ptxas's registers and spills, or ``drop_sass``'s
    instruction counts), a record each: ``body`` (fwd, dq, dkv; bwd for
    K2's one-launch mma body), ``kind`` (wgmma, mma, fma), ``n`` (the
    head dim; for the fp32 bodies the head-dim elements a lane), ``tile``
    (K1's Hopper (block_q, block_kv), else None), ``drop`` and ``ranges``
    (kDrop, kRange), ``rep`` and ``label``: "fwd_wgmma D=128 dropout",
    "dkv_wgmma D=64 ranges", "bwd_mma D=16 dropout", "dkv_fma NI=2
    dropout"; a Hopper K1
    instance with neither flag (a tile of the rule) adds its tile, as in
    "fwd_wgmma D=64 64x128" (the flagged ones exist at the default tile
    only)."""
    import re

    out = []
    for fn, rep in report.items():
        m = re.search(r"(fwd|dq|dkv|bwd)_(wgmma|mma|fma)I((?:Li\d+E)+)"
                      r"Lb([01])E"
                      r"(?:Lb([01])E)?", fn)
        if not m:
            continue
        n = [int(a) for a in re.findall(r"Li(\d+)E", m.group(3))]
        # bwd_wgmma (K2's dq and dk/dv in one launch) exists only for the
        # frontier arrays
        r = dict(body=m.group(1), kind=m.group(2), n=n[0],
                 tile=(64 * n[1], n[2]) if len(n) == 3 else None,
                 drop=m.group(4) == "1",
                 ranges=m.group(5) == "1" or m.group(1, 2) == ("bwd",
                                                               "wgmma"),
                 rep=rep)
        r["label"] = (f"{r['body']}_{r['kind']} "
                      + ("NI" if r["kind"] == "fma" else "D") + f"={n[0]}"
                      + " dropout" * r["drop"] + " ranges" * r["ranges"])
        if r["tile"] and not (r["drop"] or r["ranges"]):
            r["label"] += " %dx%d" % r["tile"]
        out.append(r)
    return out


def drop_ptxas(which, D, dt, ranges=False, drop=True):
    """ptxas registers and spill bytes (``_build.ptxas_report``) of the
    dropout instances (``drop`` False: the mma bodies' no-dropout ones)
    one K1 (``which`` "fwd") or K2 ("bwd") call at head dim D and dtype dt
    runs, by ``flash_instances`` label: the Hopper bodies in bf16 at D =
    64 and 128 (``ranges``: the frontier-array ones), the mma.sync ones in
    bf16 at D = 16 and 32 (K2's in one launch), the fp32 FMA ones."""
    from paddle_tpu_torch.ops.kernels import _build

    kind = ("fma" if dt == torch.float32 else
            "wgmma" if D in (64, 128) else "mma")
    n = max(1, D // 32) if kind == "fma" else D
    bodies = ("fwd",) if which == "fwd" else ("dq", "dkv", "bwd")
    return {r["label"]: r["rep"] for r in flash_instances(
        _build.ptxas_report("flash_attention"))
        if r["drop"] == drop and r["body"] in bodies and r["kind"] == kind
        and r["n"] == n and r["ranges"] == ranges}


# integer ALU opcodes of sm_90 SASS (the part before the first '.'), and
# Philox4x32-10's first round multiplier 0xD2511F53 as SASS writes the
# immediate (signed or not)
_INT_OPS = frozenset(("IMAD", "IADD3", "IADD", "IMUL", "LOP3", "LOP", "SHF",
                      "SHL", "SHR", "ISETP", "SEL", "PRMT", "LEA", "IABS",
                      "IMNMX", "VIADD", "VIMNMX", "POPC", "FLO", "BMSK",
                      "SGXT", "BREV", "P2R", "R2P"))
_PHILOX_M0 = ("0xd2511f53", "-0x2daee0ad")


def drop_sass(so):
    """Instruction counts of K1/K2's dropout instances in the built flash
    library ``so`` (``cuobjdump -sass``), beside their no-dropout twins:
    all and integer ALU instructions, the Philox4x32-10 hashes in the
    code (the high products by the first round's multiplier, ten a hash)
    and the integer instructions the dropout instance adds a hash. For a
    comparison of two builds; no phase runs it."""
    import os
    import re

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    report, counts = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            counts = report.setdefault(m.group(1), dict(
                instructions=0, integer=0, philox_rounds=0))
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if counts is None or not m:
            continue
        op = m.group(1)
        counts["instructions"] += 1
        counts["integer"] += op.split(".")[0] in _INT_OPS
        counts["philox_rounds"] += (op.startswith(("IMAD.WIDE", "IMAD.HI"))
                                    and any(c in line.lower()
                                            for c in _PHILOX_M0))
    insts = flash_instances(report)
    key = ("body", "kind", "n", "tile", "ranges")
    twins = {tuple(r[k] for k in key): r["rep"] for r in insts
             if not r["drop"]}
    rows = {}
    for r in insts:
        if not r["drop"]:
            continue
        c, twin = r["rep"], twins.get(tuple(r[k] for k in key))
        hashes = c["philox_rounds"] / 10
        rows[r["label"]] = dict(
            c, hashes=hashes, twin_integer=twin and twin["integer"],
            integer_a_hash=(c["integer"] - twin["integer"]) / hashes
            if twin and hashes else None)
    log("[sass] K1/K2's dropout instances (hashes = Philox rounds / 10, "
        "integer_a_hash = integer instructions over the no-dropout twin's, "
        "a hash): " + json.dumps(rows))
    return rows


def check_dropout_mask(dev, cases=((128, torch.bfloat16, 2),
                                   (64, torch.bfloat16, 4),
                                   (64, torch.float32, 4)), tag="kernels"):
    """The mask read back from the kernels, bit for bit. With Skv <= D
    and V's rows the identity (v[j] = e_j), K1 gives out[i, j] = P_ij
    M_ij / (1 - p) / l: non-zero exactly where the mask keeps a visible
    pair. With dO's rows the identity too (Sq <= D) and one query head a
    KV head, K2's dV[j, i] = P_ij M_ij / (1 - p): the same read through
    the dk/dv body, on S^T. Both must equal the plain version's mask
    (``dropout_mask.dropout_keep``) over the visible pairs, causal and
    not, at ``cases`` (D, dtype, KV heads): bf16 at D = 64 and 128 (GQA in
    the forward) and fp32 by default."""
    from paddle_tpu_torch.ops.kernels import dropout_mask as DM
    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    g = torch.Generator(device=dev).manual_seed(12)
    summary = []
    for D, dt, KV in cases:
        for causal in (True, False):
            B, S, H = 2, D, 4
            seed = DROPOUT_SEED + D + int(causal)
            eye = torch.eye(D, device=dev, dtype=dt)
            q = torch.randn(B, S, H, D, device=dev, generator=g).to(dt)
            k = torch.randn(B, S, KV, D, device=dev, generator=g).to(dt)
            v = eye[:S, None, :].expand(S, KV, D)[None].expand(
                B, S, KV, D).contiguous()
            keep = DM.dropout_keep(seed, DROPOUT_P, B, H, S, S, dev)
            vis = torch.ones(S, S, dtype=torch.bool, device=dev)
            if causal:
                vis = vis.tril()
            out, lse = K1.flash_attention_fwd_lse(q, k, v, causal,
                                                  dropout=DROPOUT_P,
                                                  seed=seed)
            got = (out[..., :S] != 0).permute(0, 2, 1, 3)   # [B, H, S, S]
            fwd_bad = int(((got != keep) & vis).sum().item())
            fwd_vis_zero = int((got & ~vis).sum().item())
            # dV, one query head a KV head
            km, vm = k[:, :, :1].expand(B, S, H, D).contiguous(), \
                v[:, :, :1].expand(B, S, H, D).contiguous()
            outm, lsem = K1.flash_attention_fwd_lse(q, km, vm, causal,
                                                    dropout=DROPOUT_P,
                                                    seed=seed)
            dout = eye[:S, None, :].expand(S, H, D)[None].expand(
                B, S, H, D).contiguous()
            _, _, dv = K1.flash_attention_bwd(q, km, vm, outm, lsem, dout,
                                              causal, dropout=DROPOUT_P,
                                              seed=seed)
            gotv = (dv[..., :S] != 0).permute(0, 2, 3, 1)   # [B, H, i, j]
            bwd_bad = int(((gotv != keep) & vis).sum().item())
            summary.append(dict(D=D, dtype=str(dt)[6:], kv_heads=KV,
                                causal=causal, visible=int(vis.sum()) * B * H,
                                kept=int((keep & vis).sum().item()),
                                fwd_mismatch=fwd_bad,
                                fwd_masked_nonzero=fwd_vis_zero,
                                dv_mismatch=bwd_bad))
    log(f"[{tag}] dropout mask read back from K1's output and K2's dV "
        "against the plain mask: " + json.dumps(summary))
    if any(r["fwd_mismatch"] or r["fwd_masked_nonzero"] or r["dv_mismatch"]
           for r in summary):
        raise AssertionError(f"the kernels' dropout mask differs from the "
                             f"plain mask: {summary}")
    log(f"[{tag}] the recovered masks equal the plain mask bit for bit: OK")


def check_philox(dev):
    """csrc/philox.cuh against curand's curand_Philox4x32_10 on a grid of
    counters and keys (random ones and the all-zero / all-one corners),
    and the plain int64 Philox on the CPU and on the card against both."""
    from paddle_tpu_torch.ops.kernels import dropout_mask as DM

    rs = np.random.RandomState(3)
    n = 1 << 16
    ctr = rs.randint(0, 2 ** 32, size=(n, 4), dtype=np.uint64).astype(
        np.int64)
    key = rs.randint(0, 2 ** 32, size=(n, 2), dtype=np.uint64).astype(
        np.int64)
    ctr[:4], key[:4] = 0, 0
    ctr[4:8], key[4:8] = 2 ** 32 - 1, 2 ** 32 - 1
    ctr[8:64, 0] = np.arange(56)            # the layout's small counters
    ctr, key = torch.from_numpy(ctr), torch.from_numpy(key)
    mine, theirs = DM.philox_check(ctr, key)
    plain = {}
    for where in ("cpu", dev):
        c = ctr.to(where)
        words = [torch.stack(DM.philox4x32_10(
            c[i:i + 1, 0], c[i:i + 1, 1], c[i:i + 1, 2], c[i:i + 1, 3],
            int(key[i, 0]), int(key[i, 1]))) for i in range(64)]
        plain[str(where)] = torch.cat(words, 1).T.cpu()
    diff = int((mine != theirs).any(1).sum().item())
    pdiff = sum(int((w != theirs[:64].cpu()).any(1).sum().item())
                for w in plain.values())
    log(f"[kernels] philox.cuh vs curand_Philox4x32_10 on {n} counter/key "
        f"pairs: {diff} differ; the plain int64 Philox (cpu and cuda) on "
        f"64 of them: {pdiff} differ")
    if diff or pdiff:
        raise AssertionError("the repo's Philox4x32-10 differs from curand's")
    log("[kernels] Philox4x32-10 equal to curand's: OK")


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


def _mp2_shapes():
    """gpt_1p3b's parameters on one rank of mp 2 (the port's layout, in
    model order) and which are mp shards."""
    from paddle_tpu_torch.models.gpt import gpt_1p3b

    cfg = gpt_1p3b()
    h, m, V, P = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.max_position_embeddings)
    layer = [((h,), False), ((h,), False), ((3 * h // 2, h), True),
             ((3 * h // 2,), True), ((h, h // 2), True), ((h,), False),
             ((h,), False), ((h,), False), ((m // 2, h), True),
             ((m // 2,), True), ((h, m // 2), True), ((h,), False)]
    rows = [((V // 2, h), True), ((P, h), False)] + \
        layer * cfg.num_layers + [((h,), False), ((h,), False)]
    return [s for s, _ in rows], [f for _, f in rows]


def check_fused_adam_split(dev, results, shapes=None,
                           what="one mp 2 rank of gpt_1p3b"):
    """K8's split reduce (phases 1 and 2: the mp shards' and the
    replicated tensors' squared sums apart, then the finalize from their
    sum), as one rank of mp 2 on gpt_1p3b calls it (0.66 B bf16
    parameters, f32 masters and moments, clip 1.0; or ``shapes``, the
    (shapes, shard flags) of another model's rank), with no group to sum
    over: against the plain version with the same split (f32 buffers
    within 1e-6 of each tensor's largest magnitude, bf16 within one ulp
    of it, norms within 1e-5) and against the degree-1 call (the norm
    within 1e-5: the same sum in another order); one launch counted a
    call; timed beside the degree-1 call and the plain version."""
    from paddle_tpu_torch.nn.clip import GradSync
    from paddle_tpu_torch.ops.kernels import fused_adam as K8

    shapes, flags = shapes or _mp2_shapes()
    N = sum(int(np.prod(s)) for s in shapes)
    split = (GradSync(), flags)

    def buffers(grads=None):
        g = torch.Generator(device=dev).manual_seed(24)
        params = [(0.02 * torch.randn(s, device=dev, generator=g)
                   ).bfloat16() for s in shapes]
        new = [(1e-3 * torch.randn(s, device=dev, generator=g)).bfloat16()
               for s in shapes]
        return dict(params=params, grads=grads or new,
                    masters=[p.float() for p in params],
                    moments1=[1e-4 * torch.randn(s, device=dev, generator=g)
                              for s in shapes],
                    moments2=[1e-8 * torch.rand(s, device=dev, generator=g)
                              for s in shapes],
                    decays=[True] * len(shapes))

    kw = dict(lr=3e-4, beta1=0.9, beta2=0.999, epsilon=1e-8,
              weight_decay=0.01, decoupled=True, step=3, clip_norm=1.0)
    A = buffers()
    B = buffers(A["grads"])
    n0 = K8.fused_adam.launches
    norm = K8.fused_adam(**A, **kw, split=split)
    if K8.fused_adam.launches != n0 + 1:
        raise AssertionError("K8's split call did not count one launch")
    rnorm = K8.fused_adam_dense(**B, **kw, split=split)
    torch.cuda.synchronize()
    rel, scaled, abs_err = 0.0, 0.0, 0.0
    for key in ("masters", "moments1", "moments2", "params"):
        for x, r in zip(A[key], B[key]):
            d = (x.float() - r.float()).abs().max().item()
            top = max(r.float().abs().max().item(), 1e-30)
            abs_err = max(abs_err, d)
            if x.dtype == torch.float32:
                rel = max(rel, d / top)
            else:
                scaled = max(scaled, d / (2.0 ** (math.floor(
                    math.log2(top)) - 7)))
    del B
    torch.cuda.empty_cache()
    C = buffers(A["grads"])
    dnorm = K8.fused_adam(**C, **kw)
    del C
    torch.cuda.empty_cache()
    stats = dict(rel=rel, ulps_at_max=scaled, abs_err=abs_err,
                 norm_err=abs(norm.item() - rnorm.item()) / rnorm.item(),
                 norm_vs_degree1=abs(norm.item() - dnorm.item())
                 / dnorm.item(), norm=norm.item())
    log(f"[kernels] fused_adam split ({what}, "
        f"{N / 1e9:.3f}B) against its plain version and the degree-1 "
        f"call: {json.dumps(stats)}")
    if not (rel <= 1e-6 and scaled <= 1 and stats["norm_err"] <= 1e-5
            and stats["norm_vs_degree1"] <= 1e-5):
        raise AssertionError(f"K8's split reduce disagrees: {stats}")
    ms = events_ms(lambda: K8.fused_adam(**A, **kw, split=split), iters=10,
                   warm=2)
    unsplit_ms = events_ms(lambda: K8.fused_adam(**A, **kw), iters=10,
                           warm=2)
    plain_ms = events_ms(lambda: K8.fused_adam_dense(**A, **kw, split=split),
                         iters=3, warm=1)
    b_ms, b_by = bound(28 * N, 30 * N, torch.float32)
    results.append(dict(
        name="fused_adam_split", case=what, shape=[N], tensors=len(shapes),
        dtype="bfloat16", max_abs_err=abs_err, rel_err=rel, tol=1e-6,
        bf16_ulps_at_tensor_max=scaled, norm_rel_err=stats["norm_err"],
        norm_vs_degree1=stats["norm_vs_degree1"], ms=ms,
        degree1_ms=unsplit_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by))
    del A
    torch.cuda.empty_cache()


def check_head_offset(dev, results):
    """K1/K2 with dropout at a head offset: one mp 2 rank's half of
    gpt_1p3b's attention (heads 8..15 of [4, 2048, 16, 128], bf16,
    p = 0.1) run with head_offset 8 gives the bits of the whole call's
    heads 8..15 (output, lse, dq, dk, dv), and is held to the plain
    version at the same offset per tile (2e-2)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    p, seed, h0 = DROPOUT_P, DROPOUT_SEED, 8
    g = torch.Generator(device=dev).manual_seed(16)
    q, k, v, do, _, _ = _flash_inputs(dev, torch.bfloat16, 4, 2048, 2048,
                                      16, 16, 128, False, g)
    out, lse = K1.flash_attention_fwd_lse(q, k, v, True, dropout=p,
                                          seed=seed)
    grads = K1.flash_attention_bwd(q, k, v, out, lse, do, True, dropout=p,
                                   seed=seed)
    half = [t[:, :, h0:].contiguous() for t in (q, k, v, do)]
    hq, hk, hv, hdo = half
    hout, hlse = K1.flash_attention_fwd_lse(hq, hk, hv, True, dropout=p,
                                            seed=seed, head_offset=h0)
    hgrads = K1.flash_attention_bwd(hq, hk, hv, hout, hlse, hdo, True,
                                    dropout=p, seed=seed, head_offset=h0)
    bits = dict(out=torch.equal(hout, out[:, :, h0:]),
                lse=torch.equal(hlse, lse[:, h0:]),
                **{n: torch.equal(a, b[:, :, h0:]) for n, a, b in
                   zip(("dq", "dk", "dv"), hgrads, grads)})
    r_out, _ = K1.flash_attention_dense(hq, hk, hv, True, dropout=p,
                                        seed=seed, head_offset=h0)
    r_grads = K1.flash_attention_bwd_dense(hq, hk, hv, hdo, True, dropout=p,
                                           seed=seed, head_offset=h0)
    eo = _errs(hout, r_out)
    eg = [_errs(a, b) for a, b in zip(hgrads, r_grads)]
    log(f"[kernels] K1/K2 with dropout at head offset {h0} (heads 8..15 of "
        f"gpt_1p3b's attention): bit-equal to the whole call's heads "
        f"{json.dumps(bits)}; against the plain version per tile: output "
        f"{eo[3]}, gradients {max(e[3] for e in eg)}")
    if not all(bits.values()):
        raise AssertionError(f"K1/K2 at a head offset are not the whole "
                             f"call's heads: {bits}")
    base = dict(case="mp2_rank1_head_offset", shape=[4, 2048, 8, 128],
                kv_heads=8, causal=True, dropout=p, dtype="bfloat16",
                tol=TOL[torch.bfloat16], head_offset=h0,
                bit_equal_to_whole_call=bits, diagnostic=True)
    results += [dict(base, name="flash_attention_fwd_dropout",
                     max_abs_err=eo[0], rel_err=eo[3]),
                dict(base, name="flash_attention_bwd_dropout",
                     max_abs_err=max(e[0] for e in eg),
                     rel_err=max(e[3] for e in eg))]
    del q, k, v, do, out, lse, grads, half, hout, hlse, hgrads, r_out, \
        r_grads
    torch.cuda.empty_cache()


def _k2_split(K1, q, k, v, out, lse, do, causal, qs, ks, drop=None,
              mma=False, qr=None, kr=None):
    """K2's parts timed one by one (CUDA graphs, as ``ms``): the pre-pass,
    the dq kernel and the dk/dv kernel, the last two on the workspace of
    one pre-pass run; on the mma bodies (``mma``: bf16 at D = 16, 32) the
    dq and the dk/dv CTAs of their one launch, each role launched alone
    (they have no pre-pass). ``drop``: ``_drop_args``' tuple; ``qr``,
    ``kr``: the frontier arrays. Not counted as launches."""
    scale = 1.0 / q.shape[-1] ** 0.5
    args = (q, k, v, out, lse, do, causal, scale, qs, ks)
    kw = dict(drop=drop, qr=qr, kr=kr)
    work = K1._k2(*args, parts=K1.PREPASS, **kw)[3]
    parts = (() if mma else (("prepass", K1.PREPASS),)) + (
        ("dq", K1.DQ), ("dkv", K1.DKV))
    return {f"{name}_ms": cuda_ms(lambda part=part: K1._k2(
        *args, parts=part, work=work, **kw)) for name, part in parts}


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
    # the 68m draft's widths (12 heads of 64, no GQA; serve-prefix-spec):
    # its prompt-chunk feed runs K4 on the mixed round above, its
    # proposal steps K5 on the decode rows, both at D = 64
    for name, Sq, at, n in (("ragged_paged_attention", 256, starts, lens),
                            ("paged_decode_attention", 1, dec, [1] * 8)):
        dt = torch.bfloat16
        q, kp, vp, tbl, st, nv = _attn_case(dev, dt, 8, Sq, 12, 12, at, n,
                                            g, D=64)
        if Sq == 1:
            run = lambda: K5.paged_decode_attention(q, kp, vp, tbl, st)
            plain = lambda: K5.paged_attention_dense(q, kp, vp, tbl, st)
        else:
            run = lambda: K4.ragged_paged_attention(q, kp, vp, tbl, st, nv)
            plain = lambda: K4.ragged_paged_attention_dense(q, kp, vp, tbl,
                                                            st, nv)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        nb, fl = _attn_cost(q, kp, at, n)
        b_ms, b_by = bound(nb, fl, dt)
        results.append(dict(
            name=name, case="draft_68m", shape=list(q.shape), kv_heads=12,
            dtype="bfloat16", **K5.paged_route(q, kp, tbl)._asdict(),
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            tol=TOL[dt], ms=cuda_ms(run), plain_ms=cuda_ms(plain, iters=3,
                                                           warm=1),
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


def _as_pages(c, page=64):
    """A contiguous cache [B, KV, M, D] cut into pages [B * n, KV, page, D]
    (each row's pages in order, the last padded with zeros) and its
    tables [B, n]: K5 then reads the same keys as K6."""
    B, KV, M, D = c.shape
    n = -(-M // page)
    c = torch.nn.functional.pad(c, (0, 0, 0, n * page - M))
    pages = c.reshape(B, KV, n, page, D).transpose(1, 2).reshape(
        B * n, KV, page, D).contiguous()
    tbl = torch.arange(B * n, dtype=torch.int32, device=c.device)
    return pages, tbl.reshape(B, n)


def check_decode(dev, results):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import decode_attention as K6

    g = torch.Generator(device=dev).manual_seed(6)
    D = 128
    first = len(results)
    for label, B, Sq, H, KV, M, off in _k6_cases():
        offs = off if isinstance(off, list) else [off] * B
        for dt in (torch.bfloat16, torch.float32):
            q = torch.randn(B, Sq, H, D, device=dev, generator=g).to(dt)
            k = torch.randn(B, KV, M, D, device=dev, generator=g).to(dt)
            v = torch.randn(B, KV, M, D, device=dev, generator=g).to(dt)
            o = torch.tensor(offs, dtype=torch.int32, device=dev)
            out = K6.decode_attention(q, k, v, o)
            ref = K6.decode_attention_dense(q, k, v, o)
            # K5 over the same keys runs the same body, tiles and splits
            kp, tbl = _as_pages(k)
            vp, _ = _as_pages(v)
            k5 = K6.paged_decode_attention(q, kp, vp, tbl, o)
            k5_body = K6.paged_route(q, kp, tbl).body
            k5_ms = cuda_ms(lambda: K6.paged_decode_attention(q, kp, vp, tbl,
                                                              o))
            del kp, vp
            torch.cuda.synchronize()
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
                offsets=off, **K6.decode_route(q, k)._asdict(),
                k5_same_keys_equal=bool(torch.equal(out, k5)),
                k5_body=k5_body, k5_ms=k5_ms,
                max_abs_err=e[0], ref_max_abs=e[1],
                rel_err=e[3], tol=TOL[dt],
                ms=cuda_ms(lambda: K6.decode_attention(q, k, v, o)),
                plain_ms=cuda_ms(lambda: K6.decode_attention_dense(
                    q, k, v, o), iters=3, warm=1),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, k, v, attn_mask=mask, enable_gqa=KV != H)),
                library="F.scaled_dot_product_attention on the cache, same "
                        "boolean mask, enable_gqa",
                bound_ms=b_ms, bound_by=b_by))
            del q, k, v, out, ref, qt, mask, k5
    # K6 on the Hopper body in bf16 at D = 128, and K5's bits on its keys
    for r in results[first:]:
        if r["dtype"] == "bfloat16" and r["body"] != "wgmma_split":
            raise AssertionError(f"decode_attention {r['case']} ran the "
                                 f"{r['body']} body, not wgmma_split")
        if not r["k5_same_keys_equal"] or r["k5_body"] != r["body"]:
            raise AssertionError(
                f"decode_attention {r['case']} {r['dtype']}: K5 over the "
                f"same keys ({r['k5_body']}) does not give K6's "
                f"({r['body']}) bits")


# K9 cases: M rows against (K, N); the first three are the main path's
# (q/k/v/o, gate/up, down at llama_7b widths; M = 8 decode, 2048 unified
# rounds, 8192 prefill), (4128, 200) the wgmma body's TMA edge, (200, 72)
# ragged (rows of 200 bytes: the tile body)
WO_ROWS = (1, 8, 16, 17, 2048, 8192)
WO_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4128, 200),
             (200, 72))


def check_weight_only(dev, results):
    """K9 against its plain version: int8 and int4, bf16 and fp32 x, M
    in WO_ROWS at every (K, N) of WO_SHAPES, with and without a bias;
    the error gate is the largest difference over the output's largest
    magnitude. Cases without a bias are timed (a CUDA graph of 20 calls,
    the weights rotated through copies that together exceed the 50 MB
    L2, as 224 different projections a decode step do): K9, the plain
    version, and F.linear on a bf16 (or fp32) weight holding the same
    values, the projection K9 replaces, which the port never calls."""
    import torch.nn.functional as F

    from paddle_tpu_torch.nn.quant import weight_quantize
    from paddle_tpu_torch.ops.kernels import weight_only_linear as K9

    one_launch = gemv_launches(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    for K, N in WO_SHAPES:
        w = torch.randn(N, K, device=dev, generator=g) * 0.02
        for bits in (8, 4):
            int4 = bits == 4
            q, s = weight_quantize(w.T, f"weight_only_int{bits}")
            wq = (K9.unpack_int4(q) if int4 else q).float() * s[:, None]
            qs = [q] + [q.clone() for _ in range(
                min(15, int(120e6 // q.nbytes)))]
            for dt in (torch.bfloat16, torch.float32):
                wl = wq.to(dt)
                ls = [wl] + [wl.clone() for _ in range(
                    min(15, int(120e6 // wl.nbytes)))]
                for M in WO_ROWS:
                    x = torch.randn(M, K, device=dev, generator=g).to(dt)
                    plan = K9.weight_only_route(M, N, K, int4, dt)
                    for bias in (False, True):
                        b = (torch.randn(N, device=dev, generator=g).to(dt)
                             if bias else None)
                        nw = K9.weight_only_linear_wgmma.launches
                        out = K9.weight_only_linear(x, q, s, b, int4)
                        ran = ("wgmma" if K9.weight_only_linear_wgmma.launches
                               > nw else plan.body)
                        ref = K9.weight_only_linear_dense(x, q, s, b, int4)
                        torch.cuda.synchronize()
                        err = (out.float() - ref.float()).abs().max().item()
                        top = ref.float().abs().max().item()
                        rec = dict(
                            name="weight_only_linear", shape=[M, K, N],
                            dtype=str(dt)[6:], bits=bits, bias=bias,
                            body=ran, splits=plan.splits,
                            cluster=K9.route_cluster(plan)[1],
                            kernels=K9.route_kernels(plan),
                            max_abs_err=err, ref_max_abs=top,
                            rel_err=err / top if top else err, tol=TOL[dt])
                        if dt == torch.bfloat16 and (M, K, N, bits) in \
                                one_launch:
                            rec["kernels_profiled"] = one_launch[
                                M, K, N, bits]
                        if not bias:
                            nbytes = (q.nbytes + x.nbytes + s.nbytes
                                      + M * N * x.element_size())
                            b_ms, b_by = bound(nbytes, 2 * M * N * K, dt)
                            qi, li = itertools.cycle(qs), itertools.cycle(ls)
                            rec.update(
                                ms=cuda_ms(lambda: K9.weight_only_linear(
                                    x, next(qi), s, None, int4)),
                                plain_ms=cuda_ms(
                                    lambda: K9.weight_only_linear_dense(
                                        x, next(qi), s, None, int4)),
                                library_ms=cuda_ms(
                                    lambda: F.linear(x, next(li))),
                                library=f"torch.nn.functional.linear, "
                                f"{str(dt)[6:]} weight of the same values",
                                bound_ms=b_ms, bound_by=b_by)
                        results.append(rec)
            del qs, ls
    torch.cuda.empty_cache()
    # bf16 M > 16 must run the wgmma body wherever TMA can address the
    # operands: every (K, N) here but the ragged (200, 72); bf16 M <= 16
    # the gemv body in one kernel launch (torch.profiler's count)
    for r in results:
        if r["name"] != "weight_only_linear" or r["dtype"] != "bfloat16":
            continue
        M, K, N = r["shape"]
        want = ("gemv" if M <= 16 else "tile" if (K, N) == (200, 72)
                else "wgmma")
        if r["body"] != want:
            raise AssertionError(f"weight_only_linear {r['shape']} int"
                                 f"{r['bits']} ran the {r['body']} body, "
                                 f"not {want}")


LLM_INT8_SHAPES = ((8, 4096, 11008), (2048, 4096, 11008),
                   (2048, 11008, 4096))   # (M, K, N): Llama-7B's widths


def _llm_int8_inputs(dev, M, K, N, dt, planted, g):
    """x [M, K] (randn clipped to |5.5|: no column above the threshold
    6.0) with, if ``planted``, 8 columns scaled to reach |20|, as LLM.int8
    finds its outliers concentrated in a few feature dimensions; q, scale
    from weight_quantize(w, "llm.int8") of w [K, N] * 0.02."""
    from paddle_tpu_torch.nn.quant import weight_quantize

    x = torch.randn(M, K, device=dev, generator=g).clamp_(-5.5, 5.5)
    if planted:
        cols = torch.randperm(K, device=dev, generator=g)[:8]
        x[:, cols] *= 20.0 / 5.5
        x[torch.arange(8, device=dev) % M, cols] = 20.0
    w = torch.randn(K, N, device=dev, generator=g) * 0.02
    q, s = weight_quantize(w, "llm.int8")
    return x.to(dt), q, s


def check_llm_int8(dev, results, counters):
    """K10 (LLM.int8's linear) against its plain version at Llama-7B's
    widths (LLM_INT8_SHAPES), threshold 6.0: bf16 with no outlier column
    and with 8 planted ones, one fp32 case and one with a bias. xq, the
    per-row scales, the column absmax and the int32 product must equal the
    plain version's bit for bit, the outlier list its outlier columns in
    order, the output be within bf16 2e-2 / fp32 1e-5 of the output's
    largest magnitude (and equal to it where no column is an outlier). The
    bf16 cases without a bias are timed (CUDA graphs of 20 calls, the
    weights rotated through 3 copies, 135 MB, past the L2): K10, the plain
    version, torch._int_mm on the same xq and q (M > 16 only) and F.linear
    on a bf16 copy of the dequantized weight. Then the main path: one call
    at each shape through nn.quant.llm_int8_linear, the user's entry
    point, with the counters set to 0 before and read after. Returns its
    launches."""
    import torch.nn.functional as F

    from paddle_tpu_torch.nn.quant import llm_int8_linear as entry
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import llm_int8_linear as K10

    ptxas = k10_ptxas(_build)
    g = torch.Generator(device=dev).manual_seed(17)
    thr = 6.0
    cases = [(shape, torch.bfloat16, planted, False)
             for shape in LLM_INT8_SHAPES for planted in (True, False)]
    cases += [(LLM_INT8_SHAPES[1], torch.float32, True, False),
              (LLM_INT8_SHAPES[1], torch.bfloat16, True, True)]
    for (M, K, N), dt, planted, with_bias in cases:
        x, q, s = _llm_int8_inputs(dev, M, K, N, dt, planted, g)
        b = torch.randn(N, device=dev, generator=g) if with_bias else None
        n0 = K10.llm_int8_linear.launches
        out, got = K10.llm_int8_linear(x, q, s, b, thr, parts=True)
        if K10.llm_int8_linear.launches != n0 + 1:
            raise AssertionError("K10 did not count its launch")
        ref, want = K10.llm_int8_linear_dense(x, q, s, b, thr, parts=True)
        torch.cuda.synchronize()
        same = {key: bool(torch.equal(got[key], want[key]))
                for key in ("col_amax", "xq", "a_scale", "acc")}
        cols = torch.nonzero(want["col_amax"] > thr).flatten()
        count = int(got["count"].item())
        same["outliers"] = bool(torch.equal(got["idx"][:count].long(), cols))
        err = (out.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        tol = {torch.bfloat16: 2e-2, torch.float32: 1e-5}[dt]
        # the same call without parts: the wgmma body's full tiles leave
        # through 16-byte stores only then (parts' acc takes the element
        # stores)
        fast = K10.llm_int8_linear(x, q, s, b, thr)
        fast_err = (fast.float() - ref.float()).abs().max().item()
        plan = K10.llm_int8_route(M, N, K)
        rec = dict(name="llm_int8_linear", shape=[M, K, N],
                   dtype=str(dt)[6:], planted=planted, bias=with_bias,
                   body=got["body"], tiles=K10.route_tiles(plan, M, N),
                   splits=plan.splits, ptxas=ptxas[got["body"]],
                   outliers=count, bit_equal=same,
                   exact=bool(torch.equal(out, ref)), max_abs_err=err,
                   ref_max_abs=top, rel_err=err / top, tol=tol,
                   no_parts=dict(exact=bool(torch.equal(fast, ref)),
                                 max_abs_err=fast_err))
        if not all(same.values()) or count != (8 if planted else 0) or \
                (not planted and not rec["exact"]) or \
                (not planted and not rec["no_parts"]["exact"]) or \
                not err <= tol * top or not fast_err <= tol * top or \
                rec["body"] != ("gemv" if M <= 16 else "wgmma"):
            raise AssertionError(f"K10 {rec}")
        if dt == torch.bfloat16 and not with_bias:
            qs = [q] + [q.clone() for _ in range(2)]
            nbytes = (x.nbytes + q.nbytes + s.nbytes
                      + M * N * x.element_size())
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2 * M * N * K,
                                                     torch.int8)
            qi = itertools.cycle(qs)
            rec["ms"] = cuda_ms(lambda: K10.llm_int8_linear(
                x, next(qi), s, None, thr))
            rec["prepass_ms"], rec["prepass_kernels"] = k10_prepass_ms(
                lambda: K10.llm_int8_linear(x, next(qi), s, None, thr))
            if plan.body == "gemv":
                rec["split_ms"] = k10_split_ms(K10, x, qi, s, thr, ref,
                                               tol * top, planted)
            rec["plain_ms"] = cuda_ms(lambda: K10.llm_int8_linear_dense(
                x, next(qi), s, None, thr), iters=3, warm=1)
            xq = got["xq"].contiguous()
            rec["library_ms"] = None
            if M > 16:
                rec["library_ms"] = cuda_ms(lambda: torch._int_mm(
                    xq, next(qi).t()))
                rec["library"] = ("torch._int_mm on the same xq and q "
                                  "(the int8 product alone)")
            wl = (q.float() * s[:, None]).to(dt)
            ls = [wl] + [wl.clone() for _ in range(2)]
            li = itertools.cycle(ls)
            rec["flinear_ms"] = cuda_ms(lambda: F.linear(x, next(li)))
            del qs, ls, wl, xq
        results.append(rec)
        del x, q, s, out, got, ref, want, fast
    torch.cuda.empty_cache()
    # the main path: the user's entry point, one call at each shape
    calls = [_llm_int8_inputs(dev, M, K, N, torch.bfloat16, True, g)
             for M, K, N in LLM_INT8_SHAPES]
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    outs = [entry(x, q, None, s, thr) for x, q, s in calls]
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    _expect_launches(launches, {"llm_int8_linear": len(calls)},
                     "llm_int8 path")
    errs = []
    for (x, q, s), o in zip(calls, outs):
        ref = K10.llm_int8_linear_dense(x, q, s, None, thr)
        err = (o.float() - ref.float()).abs().max().item()
        errs.append(err / ref.float().abs().max().item())
        if not (torch.isfinite(o).all() and errs[-1] <= 2e-2):
            raise AssertionError(f"llm_int8 path {list(x.shape)}: off the "
                                 f"plain version by {err}")
    log(f"[kernels] llm_int8 path (nn.quant.llm_int8_linear at "
        f"{[list(sh) for sh in LLM_INT8_SHAPES]}, bf16, 8 outlier columns): "
        f"launches {launches}, error over the plain output's largest "
        f"magnitude {errs} (bf16 limit 2e-2)")
    del calls, outs
    torch.cuda.empty_cache()
    return launches


K10_PRODUCTS = ("wgmma_kernel", "gemv_kernel", "gemm_kernel")


def k10_prepass_ms(call, calls=20):
    """Device ms of a K10 call's pre-pass: ``calls`` eager calls under
    torch.profiler, each kernel (and memset) of the call but the product
    (K10_PRODUCTS) at its mean device time a launch, summed (each runs
    once a call). Returns the ms and each part's us. A profile with no
    device record is taken again, once (gemv_launches)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if kern:
            break
    pre = {e.key: e.self_device_time_total / e.count for e in kern
           if e.count and not any(k in e.key for k in K10_PRODUCTS)}
    if not pre or len(pre) == len(kern):
        raise AssertionError(f"K10 pre-pass: the profile holds "
                             f"{[(e.key, e.count) for e in kern]}")
    name = lambda k: re.search(r"\w+_kernel|Memset", k)  # noqa: E731
    return sum(pre.values()) / 1e3, {
        (name(k).group() if name(k) else k[:40]): round(v, 3)
        for k, v in pre.items()}


def k10_split_ms(K10, x, qi, s, thr, ref, limit, planted):
    """The gemv body at every K split its K allows (whole 64-byte k
    blocks, at most 8 slices), the route's own choice among them: ms
    by split count, each split's output held to the plain version's
    (equal where nothing is an outlier, within ``limit`` otherwise)."""
    M, K = x.shape
    steps = -(-K // 64)
    route = K10.llm_int8_route
    out = {}
    try:
        for want in range(1, min(8, steps) + 1):
            per = -(-steps // want)
            plan = K10.LlmInt8Route("gemv", -(-steps // per), per * 64)
            if plan.splits in out:
                continue
            K10.llm_int8_route = lambda *a, plan=plan, **k: plan
            y = K10.llm_int8_linear(x, next(qi), s, None, thr)
            err = (y.float() - ref.float()).abs().max().item()
            if not (err <= limit and (planted or torch.equal(y, ref))):
                raise AssertionError(f"K10 gemv split {plan}: off the "
                                     f"plain version by {err}")
            out[plan.splits] = cuda_ms(lambda: K10.llm_int8_linear(
                x, next(qi), s, None, thr))
    finally:
        K10.llm_int8_route = route
    return out


def gemv_launches(dev, calls=4):
    """bf16 M <= 16 runs K9's gemv body in one kernel launch a call: at
    the decode shapes (WO_SHAPES[:3]), int8 and int4, M = 1, 8 and 16,
    ``calls`` calls on distinct x each match the plain version, and
    torch.profiler holds ``calls`` CUDA kernel records, every one the
    gemv body's (no split-sum pass). Taken before any timing: a profile
    taken after the CUDA-graph timings here has come back one kernel
    record short of the calls that ran; one with no device record at all
    is taken again, once. Returns the kernels a call by (M, K, N, bits)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.nn.quant import weight_quantize
    from paddle_tpu_torch.ops.kernels import weight_only_linear as K9

    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for K, N in WO_SHAPES[:3]:
        w = torch.randn(N, K, device=dev, generator=g) * 0.02
        for bits in (8, 4):
            int4 = bits == 4
            q, s = weight_quantize(w.T, f"weight_only_int{bits}")
            for M in (1, 8, 16):
                xs = [torch.randn(M, K, device=dev, generator=g).to(
                    torch.bfloat16) for _ in range(calls)]
                K9.weight_only_linear(xs[0], q, s, None, int4)
                torch.cuda.synchronize()
                for _ in range(2):
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        ys = [K9.weight_only_linear(x, q, s, None, int4)
                              for x in xs]
                        torch.cuda.synchronize()
                    kern = [e for e in prof.key_averages() if e.device_type
                            == torch.autograd.DeviceType.CUDA]
                    if kern:
                        break
                    # a profile with no device record at all is the
                    # profiler's (an H100 run had one, its outputs right):
                    # the same calls are profiled again, once
                    log(f"[kernels] K9 gemv [{M}, {K}, {N}] int{bits}: the "
                        "profiler recorded no CUDA kernel; profiling again")
                n = sum(e.count for e in kern)
                for x, y in zip(xs, ys):
                    ref = K9.weight_only_linear_dense(x, q, s, None, int4)
                    err = (y.float() - ref.float()).abs().max().item()
                    if not err <= TOL[torch.bfloat16] * ref.float().abs() \
                            .max().item():
                        raise AssertionError(f"K9 gemv [{M}, {K}, {N}] int"
                                             f"{bits}: a call is off by {err}")
                if n != calls or not all("gemv_cluster_kernel" in e.key
                                         for e in kern):
                    raise AssertionError(
                        f"K9 gemv [{M}, {K}, {N}] int{bits}: {calls} calls "
                        f"launched {[(e.key, e.count) for e in kern]}")
                out[M, K, N, bits] = n / calls
    log(f"[kernels] K9 gemv: one kernel a call at the decode shapes, int8 "
        f"and int4, M = 1, 8, 16 ({len(out)} cases, torch.profiler): OK")
    return out


def read_ceiling(dev):
    """K9's GEMV against a pure read of its weight bytes at the decode
    shapes (WO_SHAPES[:3], int8 and int4): (a) form "gemv": the gemv
    body's grid, cluster, cp.async ring and loads at the route M = 8
    takes, and nothing else; (b) form "stream": a coalesced stream of the
    same bytes, one block a 32 KB piece. Timed as the K9 rows are
    (cuda_ms, the bytes rotated through copies that together exceed the
    L2); the bound is the bytes over 3.35 TB/s."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import weight_only_linear as K9

    fn = _build.library("weight_only_linear").weight_only_read_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sink = torch.zeros(256, dtype=torch.int32, device=dev)
    out = []
    for K, N in WO_SHAPES[:3]:
        for bits in (8, 4):
            int4 = bits == 4
            q = torch.randint(-128, 128, (N, K // 2 if int4 else K),
                              dtype=torch.int8, device=dev)
            qs = [q] + [q.clone() for _ in range(
                min(15, int(120e6 // q.nbytes)))]
            plan = K9.weight_only_route(8, N, K, int4, torch.bfloat16)
            for form in ("gemv", "stream"):
                qi = itertools.cycle(qs)

                def call():
                    rc = fn(next(qi).data_ptr(), sink.data_ptr(), N, K,
                            int(int4), plan.rows, plan.splits, plan.ks,
                            0 if form == "gemv" else 1,
                            torch.cuda.current_stream().cuda_stream)
                    _build.check(rc, "weight_only_read")
                ms = cuda_ms(call)
                b_ms = q.nbytes / HBM_BYTES_PER_S * 1e3
                out.append(dict(name="weight_only_read", form=form,
                                shape=[K, N], bits=bits, bytes=q.nbytes,
                                splits=plan.splits, ms=ms, bound_ms=b_ms,
                                tb_per_s=q.nbytes / ms / 1e9))
            del qs
    torch.cuda.empty_cache()
    return out


# -- phases 3 and 4: serving ---------------------------------------------------
def make_engine(model, page, max_length, draft=None, **engine_kw):
    """A ServingEngine over ``model``; with ``draft`` (a model, or
    ``model`` itself for self-speculation) its predictor is the engine's
    draft_predictor."""
    from paddle_tpu_torch.inference import (Config, ServingEngine,
                                            create_predictor)

    def predictor(m):
        conf = Config().set_model(m).enable_paged_kv(page)
        conf.max_length = max_length
        return create_predictor(conf)

    pred = predictor(model)
    if draft is not None:
        engine_kw["draft_predictor"] = pred if draft is model \
            else predictor(draft)
    return ServingEngine(pred, **engine_kw)


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


@contextlib.contextmanager
def gc_pauses():
    """Python's garbage-collector pauses inside the block, by generation:
    {"collections": [n0, n1, n2], "ms": [t0, t1, t2]} (the serving loop
    waits on them between two rounds)."""
    out = {"collections": [0, 0, 0], "ms": [0.0, 0.0, 0.0]}
    starts = []

    def cb(phase, info):
        if phase == "start":
            starts.append(time.perf_counter())
        elif starts:
            g = info["generation"]
            out["collections"][g] += 1
            out["ms"][g] += 1e3 * (time.perf_counter() - starts.pop())

    gc.callbacks.append(cb)
    try:
        yield out
    finally:
        gc.callbacks.remove(cb)


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
    prefix_spec_parity(cpu, gpu)
    fused_transformer_parity()


def prefix_spec_parity(cpu, gpu):
    """The prefix cache, speculative decoding (a 1-layer fp32 draft,
    hidden 256, 4 heads, 2 KV heads, k = 3) and the host tier
    (host_spill_pages=4) together on the reduced model, with a 15-page
    pool: three system prompts of 3-4 pages shared by a stream of two-slot
    requests, so pages are shared, copied on write (a full-prompt hit),
    reclaimed (LRU), spilled to the host and faulted back. cuda graphed,
    cuda eager and cpu must commit equal token streams, equal to the plain
    cpu engine's, and keep equal prefix, spec and spill counters."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    dcfg = LlamaConfig(vocab_size=4096, hidden_size=256, num_layers=1,
                       num_heads=4, num_kv_heads=2, intermediate_size=704,
                       max_position_embeddings=1024, dtype="float32")
    dcpu = LlamaForCausalLM(dcfg, device="cpu", seed=6)
    dgpu = LlamaForCausalLM(dcfg, device="cuda", seed=0)
    dgpu.load_state_dict(dcpu.state_dict())
    sched = prefix_parity_schedule(4096)
    base = dict(page=64, max_length=1024, max_batch=2, prefill_chunk=128,
                pool_pages=16)
    feats = dict(prefix_cache=True, host_spill_pages=4, spec_tokens=3,
                 debug_invariants=True)
    plain = [list(r.new_tokens)
             for r in serve(make_engine(cpu, **base), sched)[0]]
    runs, stats, counts = {}, {}, {}
    for dev, model, draft, mode in (("cpu", cpu, dcpu, "eager"),
                                    ("cuda", gpu, dgpu, "graphed"),
                                    ("cuda", gpu, dgpu, "eager")):
        eng = make_engine(model, draft=draft, **base, **feats)
        with mode_ctx(mode):
            reqs, _, rounds, replays, launches = serve(eng, sched)
        eng.check_invariants()
        runs[dev, mode] = [list(r.new_tokens) for r in reqs]
        counts[dev, mode] = launches
        pfx, spec = eng.prefix_cache_stats(), eng.spec_stats()
        stats[dev, mode] = (pfx, spec, eng.spill_stats())
        log(f"[parity] prefix+spec+spill {dev} {mode}: rounds "
            f"{dict(rounds)}, replays {dict(replays)}, prefix {pfx}, spec "
            f"{spec}, spill {eng.spill_stats()}, launches {launches}")
        if not (pfx["hits"] and pfx["cow"] and pfx["reclaimed"]
                and stats[dev, mode][2]["spilled"]
                and stats[dev, mode][2]["faulted"]):
            raise AssertionError("the parity schedule must hit, copy on "
                                 "write, reclaim, spill and fault back")
        if mode == "graphed" and not all(
                replays[s] > 0 for s in ("unified_spec", "draft_propose",
                                         "draft_chunk")):
            raise AssertionError("the graphed run replayed no spec graph")
    a, b, c = runs["cpu", "eager"], runs["cuda", "graphed"], \
        runs["cuda", "eager"]
    if not a == b == c == plain:
        raise AssertionError(f"prefix+spec+spill streams differ:\nplain "
                             f"{plain}\ncpu {a}\ncuda graphed {b}\ncuda "
                             f"eager {c}")
    if not stats["cpu", "eager"] == stats["cuda", "graphed"] \
            == stats["cuda", "eager"]:
        raise AssertionError(f"prefix, spec or spill counters differ: "
                             f"{stats}")
    if counts["cuda", "graphed"] != counts["cuda", "eager"]:
        raise AssertionError(f"graphed and eager launches differ: {counts}")
    log("[parity] prefix cache + spec (k 3) + host spill: cuda graphed == "
        "cuda eager == cpu == plain cpu token streams, equal counters and "
        "launch counts: OK")


def prefix_parity_schedule(vocab):
    """Two-slot arrivals over four system prompts (4, 3, 4 and 4 pages of
    64; more than the 15-page pool holds): two first, the rest after 4
    steps, the last of them the first system prompt alone (a full hit:
    its refeed copies a page)."""
    sa, sb, sc, sd = prompts(40, [256, 192, 256, 256], vocab)
    tail = prompts(41, [40, 30, 100, 20, 60, 10, 10], vocab)
    cat = np.concatenate
    first = [cat([sa, tail[0]]), cat([sb, tail[1]])]
    later = [cat([sc, tail[2]]), cat([sd, tail[3]]), cat([sb, tail[4]]),
             cat([sa, tail[5]]), cat([sc, tail[6]]), sa.copy()]
    return first, later, 4, 10


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


def weight_only_parity():
    """Weight-only Predictor.generate on the reduced fp32 Llama (TF32
    off), int8 and int4, static and paged caches, on cuda (graphed) and
    on cpu from the same weights: the quantized weights and scales must
    be equal bit for bit across the devices, every token stream equal,
    and the cuda runs must launch K9."""
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import weight_only_linear as K9

    cfg = LlamaConfig(vocab_size=4096, hidden_size=1024, num_layers=2,
                      num_heads=8, num_kv_heads=2, intermediate_size=2816,
                      max_position_embeddings=1024, dtype="float32")
    lens = [40, 200, 130]
    ids = np.zeros((3, max(lens)), np.int64)
    for b, p in enumerate(prompts(9, lens, 4096)):
        ids[b, :len(p)] = p
    for algo in ("weight_only_int8", "weight_only_int4"):
        cpu = LlamaForCausalLM(cfg, device="cpu", seed=5)
        gpu = LlamaForCausalLM(cfg, device="cuda", seed=0)
        gpu.load_state_dict(cpu.state_dict())
        outs, n = {}, {}
        for page in (None, 64):
            for dev, m in (("cpu", cpu), ("cuda", gpu)):
                conf = Config().set_model(m).enable_weight_only(algo)
                if page:
                    conf.enable_paged_kv(page)
                n0 = K9.weight_only_linear.launches
                outs[dev, page] = create_predictor(conf).generate(
                    ids, max_new_tokens=12, lengths=lens).cpu().numpy()
                n[dev, page] = K9.weight_only_linear.launches - n0
        sc, sg = cpu.state_dict(), gpu.state_dict()
        differ = [k for k in sc if not torch.equal(sc[k], sg[k].cpu())]
        if differ:
            raise AssertionError(f"{algo}: cpu and cuda quantized "
                                 f"differently: {differ[:4]}")
        first = outs["cpu", None]
        if not all(np.array_equal(first, o) for o in outs.values()):
            raise AssertionError(f"{algo} generate streams differ: {outs}")
        if not (n["cuda", None] > 0 and n["cuda", 64] > 0):
            raise AssertionError(f"{algo}: cuda generation launched K9 "
                                 f"{n} times")
        log(f"[parity] weight-only {algo[12:]} generate (fp32, graphed): "
            f"quantized state equal on both devices, static == paged, "
            f"cuda == cpu token streams, K9 launches {n['cuda', None]} / "
            f"{n['cuda', 64]}: OK")


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


def phase_serve(model, counters, profile=False,
                modes=("eager", "graphed", "graphed", "eager"), tag="serve"):
    """The 7B-width serve: one engine, warmed up (its unified and decode
    graphs are captured there), then the measured schedule in ``modes``
    (eager, graphed, graphed, eager). Every run must commit the same
    tokens and launch exactly the kernels its rounds imply (K9 seven
    times a layer a step when it is among ``counters``); graphed runs
    replay every round. Returns the launches of a graphed run and the
    runs' summaries."""
    cfg = model.config
    L = cfg.num_layers
    kw = dict(page=64, max_length=2048, max_batch=8, prefill_chunk=256,
              prefill_token_budget=256)
    # the serve phase runs with the memory ledger on (a ledger a launch
    # site at its first execution)
    eng = make_engine(model, mem_ledger=tag == "serve", **kw)
    # warmup (not measured): first cuBLAS handles, allocator growth, the
    # unified and decode rounds' graph captures
    serve(eng, (prompts(0, [64], cfg.vocab_size), [], 0, 4))
    sched = serve_schedule(cfg.vocab_size)
    lens = [len(p) for p in sched[0] + sched[1]]
    runs, summaries = [], []
    for mode in modes:
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        m = eng._metrics
        hist0 = (m["ttft"].count(), m["tpot"].count(),
                 m["stage_seconds"].count(stage="e2e"))
        with gc_pauses() as gcp, mode_ctx(mode):
            reqs, wall, rounds, replays, _ = serve(eng, sched)
        launches = {c.__name__: c.launches for c in counters}
        hist = (m["ttft"].count(), m["tpot"].count(),
                m["stage_seconds"].count(stage="e2e"))
        if any(b - a != len(reqs) for a, b in zip(hist0, hist)):
            raise AssertionError(f"{mode} serve: TTFT / TPOT / e2e counts "
                                 f"moved {hist0} -> {hist}, not by "
                                 f"{len(reqs)} requests")
        check_spans(eng, reqs)
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
            launches=launches, gc=gcp)
        log(f"[{tag}] " + json.dumps(summary))
        summaries.append(summary)
        # what the rounds imply: K4 once a layer a unified round, K5 once
        # a layer a decode step, K3 twice a layer and once at the end, K9
        # once a projection a step
        steps = rounds["unified"] + eng.chunk * rounds["decode"]
        want = {"rms_norm": (2 * L + 1) * steps,
                "ragged_paged_attention": L * rounds["unified"],
                "paged_decode_attention": L * eng.chunk * rounds["decode"]}
        if "weight_only_linear" in launches:
            want["weight_only_linear"] = 7 * L * steps
            # the unified rounds' [8, 256] rows run the wgmma body
            want["weight_only_linear_wgmma"] = 7 * L * rounds["unified"]
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
    log(f"[{tag}] graphs: " + json.dumps(graphs_summary(eng.stats)))
    if any(toks != runs[0][1] or n != runs[0][2] for _, toks, n in runs):
        raise AssertionError(f"{tag} runs differ in tokens or launches: "
                             + "; ".join(f"{m}: {n}" for m, _, n in runs))
    log(f"[{tag}] {', '.join(modes)}: equal token streams and "
        f"launches {runs[0][2]}: OK")
    if tag == "serve":
        check_serve_telemetry(eng)
        check_serve_attention(model, kw)
    if profile:
        profile_serve(eng, sched, tag)
    graphed = next(n for m, _, n in runs if m == "graphed")
    return graphed, summaries


def serve_schedule(vocab):
    """The serve phase's schedule: 16 greedy requests of 64..1536 prompt
    tokens, 32 new tokens each, 8 arriving after 4 steps."""
    lens = np.random.RandomState(11).randint(64, 1537, 16)
    return (prompts(12, lens[:8], vocab), prompts(13, lens[8:], vocab), 4,
            32)


def check_spans(eng, reqs, migrated=False):
    """Every request of a run has its whole trace in the engine's ring:
    queued, prefill (with its chunks), decode rounds, decode and e2e, all
    closed (a migrated request: migrate_in, decode rounds, decode, e2e)."""
    want = ({"migrate_in", "decode_round", "decode", "e2e"} if migrated
            else {"queued", "prefill", "prefill_chunk", "decode_round",
                  "decode", "e2e"})
    traces = {t["rid"]: t for t in eng.request_traces()}
    for r in reqs:
        t = traces.get(r.rid)
        if t is None or not want <= {s["name"] for s in t["spans"]} or \
                any(s["t1"] is None for s in t["spans"]) or \
                t["trace_id"] != r.trace_id:
            raise AssertionError(f"request {r.rid}: incomplete trace "
                                 f"{t and [s['name'] for s in t['spans']]}")


def check_serve_telemetry(eng):
    """The serve phase's telemetry on the card: /metrics and /healthz
    answer over loopback with the engine's series; the memory ledger has
    one ledger a graphed launch site, and the pool's bytes are exactly
    page_bytes x pool_pages."""
    import urllib.request

    from paddle_tpu_torch import observability as obs

    with obs.serve_metrics(0) as srv:
        url = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            text = obs.parse_prometheus_text(r.read().decode())
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
    n = text["paddle_tpu_serving_ttft_seconds_count"][()]
    if n != eng._metrics["ttft"].count() or health["status"] != "ok" or \
            {"component": "serving", "status": "ok"} not in \
            health.get("components", []):
        raise AssertionError(f"scrape: ttft count {n}, healthz {health}")
    summary = eng.memory_summary()
    st = summary["state"]
    pools = sum(t.numel() * t.element_size() for kv in eng.pools
                for t in kv)
    sites = set(eng._mem_ledgers)
    want = {("unified", eng.Sc), ("decode",)}
    if st["kv_pool_bytes"] != st["page_bytes"] * st["pool_pages"] or \
            st["kv_pool_bytes"] != pools or sites != want:
        raise AssertionError(f"memory ledger: {st}, sites {sites}")
    for site in sorted(want):
        led = eng.memory_ledger(site)
        if led.alias_bytes != pools or led.temp_bytes <= 0:
            raise AssertionError(f"{site} ledger: {led}")
    # a forced tick (gauges, allocator read, registry snapshot): the host
    # work the loop waits on at most every SNAPSHOT_EVERY_S
    t0 = time.perf_counter()
    for _ in range(100):
        eng.metrics_snapshot()
    tick_us = (time.perf_counter() - t0) / 100 * 1e6
    log("[serve] telemetry: /metrics ttft count "
        f"{int(n)}, /healthz {health['status']}; a snapshot tick "
        f"{tick_us:.1f} us of host; memory "
        + json.dumps(summary) + "; roofline "
        + json.dumps(eng.roofline_report().to_dict()))


def corrupt_once(migrator):
    """Make the next migration's wire flip one byte of its first page
    (the crc32 must catch it); the frame's bytes are kept in
    ``migrator.tampered_bytes`` (the migration counter books them)."""
    def transmit(wire):
        if not hasattr(migrator, "tampered_bytes"):
            migrator.tampered_bytes = int(wire["wire_bytes"])
            pages = [a.copy() for a in wire["pages"]]
            pages[0].view(np.uint8).reshape(-1)[3] ^= 0xFF
            wire = dict(wire, pages=pages)
        return wire

    migrator._transmit = transmit


def fleet(model, names, page=64, max_length=2048, **kw):
    """A Router over one engine a (name, phase) pair, each with the serve
    phase's settings and its own predictor of ``model``."""
    from paddle_tpu_torch.inference import Router

    kw = dict(dict(max_batch=8, prefill_chunk=256,
                   prefill_token_budget=256), **kw)
    return Router([(n, make_engine(model, page, max_length, phase=ph, **kw))
                   for n, ph in names])


def book_launches(rt, counters):
    """Book the kernels' launches of each replica's steps to its name."""
    per = {r.name: Counter() for r in rt.replicas}
    for r in rt.replicas:
        def step(orig=r.engine.step, name=r.name):
            before = [c.launches for c in counters]
            orig()
            for c, b in zip(counters, before):
                if c.launches != b:
                    per[name][c.__name__] += c.launches - b
        r.engine.step = step
    return per


def serve_fleet(rt, schedule):
    """``serve`` for a Router: the requests (in submission order) and the
    wall seconds."""
    first, later, after, n_new = schedule
    t0 = time.perf_counter()
    gids = [rt.submit(p, max_new_tokens=n_new) for p in first]
    for _ in range(after):
        rt.step()
    gids += [rt.submit(p, max_new_tokens=n_new) for p in later]
    res = rt.run(max_steps=100000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rt.pending:
        raise AssertionError(f"fleet left {rt.pending} requests unserved")
    return [res[g] for g in gids], wall


def run_fleet(rt, schedule, counters, L, tag, after_warmup=None):
    """Warm every replica (one request each: the graphs they need are
    captured), call ``after_warmup(rt)``, then serve ``schedule`` graphed
    with the kernels' counts set to 0 just before it. Checks: every
    round a replay, no capture after the warmup, each replica's K3 / K4 /
    K5 launches exactly as its rounds imply, migrated bytes at the closed
    form on the counter and the comm ledger, a migrated request's trace
    complete. Returns the requests, the summary, and the launches."""
    engines = {r.name: r.engine for r in rt.replicas}
    vocab = next(iter(engines.values())).pred._model.config.vocab_size
    warm = prompts(1, [64] * len(rt.frontdoor), vocab)
    serve_fleet(rt, (warm, [], 0, 4))
    if after_warmup is not None:
        after_warmup(rt)
    mig = rt.migrator
    n_mig0 = mig.migrated if mig else 0
    caps0 = {n: dict(e.stats.captures) for n, e in engines.items()}
    rounds0 = {n: Counter(e.rounds) for n, e in engines.items()}
    replays0 = {n: Counter(e.stats.replays) for n, e in engines.items()}
    per = book_launches(rt, counters)
    for c in counters:
        c.launches = 0
    m = next(iter(engines.values()))._metrics
    bytes0 = (m["migration_bytes"].value(),
              m["comm_bytes"].value(axis="migrate", op="ppermute"))
    torch.cuda.reset_peak_memory_stats()
    reqs, wall = serve_fleet(rt, schedule)
    launches = {c.__name__: c.launches for c in counters}
    for n, e in engines.items():
        rounds = e.rounds - rounds0[n]
        want = {k: v for k, v in implied_launches(e, rounds, L, 0).items()
                if v}
        if dict(per[n]) != want:
            raise AssertionError(f"{tag} {n}: launched {dict(per[n])}, its "
                                 f"rounds {dict(rounds)} imply {want}")
        reps = e.stats.replays - replays0[n]
        want_reps = {k: v for k, v in (("unified", rounds["unified"]),
                                       ("serve_decode", rounds["decode"]))
                     if v}
        if dict(reps) != want_reps or dict(e.stats.captures) != caps0[n]:
            raise AssertionError(f"{tag} {n}: replays {dict(reps)} for "
                                 f"rounds {dict(rounds)}, captures "
                                 f"{dict(e.stats.captures)} after warmup "
                                 f"{caps0[n]}")
        per[n] = dict(per[n], rounds=dict(rounds), pool_pages=e.P)
    n_tok = sum(len(r.new_tokens) for r in reqs)
    ttft = [1e3 * (r.t_first_token - r.t_submit) for r in reqs]
    tpot = [1e3 * (r.t_finish - r.t_first_token) / (len(r.new_tokens) - 1)
            for r in reqs]
    summary = dict(
        fleet=tag, replicas={n: e.phase or "unified"
                             for n, e in engines.items()},
        requests=len(reqs), new_tokens=n_tok, wall_s=wall,
        tokens_per_s=n_tok / wall,
        ttft_ms_p50=float(np.percentile(ttft, 50)),
        ttft_ms_p99=float(np.percentile(ttft, 99)),
        tpot_ms_p50=float(np.percentile(tpot, 50)),
        tpot_ms_p99=float(np.percentile(tpot, 99)),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        by_replica=per)
    if mig is not None:
        e0 = next(e for e in engines.values() if e.phase == "decode")
        page_bytes = e0._page_bytes()
        want = sum(-(-len(r.prompt) // e0.page) * page_bytes + e0.npages * 4
                   for r in reqs)
        # a frame that failed its crc32 was booked on the wire too
        booked = want + getattr(mig, "tampered_bytes", 0)
        got = (m["migration_bytes"].value() - bytes0[0],
               m["comm_bytes"].value(axis="migrate", op="ppermute")
               - bytes0[1])
        t = list(mig.timings)[-(mig.migrated - n_mig0):]
        if got != (booked, booked) or \
                sum(x["wire_bytes"] for x in t) != want:
            raise AssertionError(f"{tag}: migrated bytes {got}, timings "
                                 f"{sum(x['wire_bytes'] for x in t)}, "
                                 f"closed form {want}")
        check_spans(e0, reqs, migrated=True)
        parts = {k: [x[k] for x in t] for k in ("d2h_s", "crc_s", "h2d_s")}
        summary.update(
            migrated_bytes=want, migrated_bytes_closed_form=want,
            migrations=len(t),
            migration_s={k: dict(p50=float(np.percentile(v, 50)),
                                 mean=float(np.mean(v)),
                                 max=float(np.max(v)))
                         for k, v in parts.items()},
            migration_gb_s=want / 1e9 / sum(
                x["d2h_s"] + x["crc_s"] + x["h2d_s"] for x in t),
            migration_per_request=[
                {"pages": x["pages"], **{k: round(x[k], 6) for k in parts}}
                for x in t])
    log(f"[serve-disagg] {tag}: " + json.dumps(summary))
    return reqs, summary, launches


def free_fleet(rt):
    """Drop the fleet's engines (pools, graphs and their memory pool)."""
    for r in rt.replicas:
        r.engine.pools = r.engine._graphs = None
    for held in (rt.replicas, rt.frontdoor, rt._prefill_engines,
                 rt._by_name, rt._name_of):
        held.clear()
    if rt.migrator is not None:
        rt.migrator.decode.clear()
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_disagg(model, counters, fp32_layers=2):
    """Disaggregated serving at the serve phase's widths and schedule:
    a unified 2-replica Router, then 1 prefill + 1 decode replica
    (pool_pages="auto", which sees the pool already on the card), each
    replica with its own predictor of the shared bf16 model. Reports
    migration seconds (device to host, crc32, host to device), TTFT /
    TPOT, tokens/s, migrated bytes against the closed form, the fleets'
    agreement and the worst teacher-forced logit gap (< 0.5). Then the
    same fleets at ``fp32_layers`` layers in fp32 (TF32 off) must commit
    equal streams, with a second prefill replica and one corrupted
    migration retried there. Returns the split fleet's launches."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.observability import memledger as ml

    cfg = model.config
    L = cfg.num_layers
    sched = serve_schedule(cfg.vocab_size)
    rt = fleet(model, [("u0", None), ("u1", None)])
    ureqs, usum, _ = run_fleet(rt, sched, counters, L, "unified")
    free_fleet(rt)
    page_bytes = 2 * L * cfg.num_kv_heads * 64 * cfg.head_dim * 2
    fits = [ml.suggest_pool_pages(torch.device("cuda"), page_bytes, 0)]
    from paddle_tpu_torch.inference import Router

    p0 = make_engine(model, 64, 2048, phase="prefill", max_batch=8,
                     prefill_chunk=256, prefill_token_budget=256,
                     pool_pages="auto")
    fits.append(ml.suggest_pool_pages(torch.device("cuda"), page_bytes, 0))
    d0 = make_engine(model, 64, 2048, phase="decode", max_batch=8,
                     pool_pages="auto")
    rt = Router([("p0", p0), ("d0", d0)])
    log(f"[serve-disagg] pool_pages='auto': the card fits {fits[0]} then "
        f"{fits[1]} pages of {page_bytes} B (the prefill replica's pool "
        f"taken off); pools {p0.P} / {d0.P} (the geometric cap "
        f"{p0.B * p0.npages + 1}, bucketed)")
    if not fits[1] < fits[0]:
        raise AssertionError(f"auto sizing did not see the first pool: "
                             f"{fits}")
    sreqs, ssum, launches = run_fleet(rt, sched, counters, L, "split")
    free_fleet(rt)
    same = [list(a.new_tokens) == list(b.new_tokens)
            for a, b in zip(ureqs, sreqs)]
    pos = sum(x == y for a, b in zip(ureqs, sreqs)
              for x, y in zip(a.new_tokens, b.new_tokens))
    total = sum(len(a.new_tokens) for a in ureqs)
    bad, worst, n = teacher_forced(model, sreqs)
    ubad, uworst, _ = teacher_forced(model, ureqs)
    log("[serve-disagg] bf16 " + json.dumps(dict(
        identical_requests=sum(same), requests=len(same),
        agreeing_tokens=pos, tokens=total,
        split_teacher_forced=dict(mismatches=bad, worst_gap=worst,
                                  tokens=n),
        unified_teacher_forced=dict(mismatches=ubad, worst_gap=uworst),
        tokens_per_s=[usum["tokens_per_s"], ssum["tokens_per_s"]],
        tpot_ms_p50=[usum["tpot_ms_p50"], ssum["tpot_ms_p50"]]))
        + " (unified, split)")

    # fp32 at a reduced depth: the streams must be equal
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        m32 = LlamaForCausalLM(llama_7b(dtype="float32",
                                        num_layers=fp32_layers),
                               device="cuda", seed=0)
        rt = fleet(m32, [("u0", None), ("u1", None)])
        u32, _, _ = run_fleet(rt, sched, counters, fp32_layers, "unified_fp32")
        free_fleet(rt)
        rt = fleet(m32, [("p0", "prefill"), ("p1", "prefill"),
                         ("d0", "decode")])
        m = rt.replicas[0].engine._metrics

        def retries():
            return sum(m["router_requests"].value(replica=n, decision="retry")
                       for n in ("p0", "p1"))

        crc0, retry0 = m["migrations"].value(result="crc_error"), retries()
        s32, _, _ = run_fleet(rt, sched, counters, fp32_layers, "split_fp32",
                              after_warmup=lambda r: corrupt_once(r.migrator))
        free_fleet(rt)
        crc = m["migrations"].value(result="crc_error") - crc0
        retry = retries() - retry0
        del m32
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
        gc.collect()
        torch.cuda.empty_cache()
    diff = [i for i, (a, b) in enumerate(zip(u32, s32))
            if list(a.new_tokens) != list(b.new_tokens)]
    if diff or crc != 1 or retry != 1:
        raise AssertionError(f"fp32 fleets: requests {diff} differ; "
                             f"crc errors {crc}, retries {retry}")
    log(f"[serve-disagg] fp32 at {fp32_layers} layers: the split fleet's "
        f"{len(s32)} streams equal the unified fleet's, one corrupted "
        f"migration retried on the other prefill replica to the same "
        f"tokens: OK")
    return launches


def compare_serve(roots):
    """``--compare-serve``: the serve phase of each checkout root in
    turn, each root's own ``chip_smoke.py --phases build,serve`` in a
    process of its own (its package, its build), then the graphed runs'
    tokens/s and TPOT p50 side by side: the cost of what one root adds
    to every round (its telemetry, say)."""
    runs = []
    for root in roots:
        res = subprocess.run([sys.executable, "chip_smoke.py", "--phases",
                              "build,serve"], cwd=root,
                             capture_output=True, text=True)
        if res.returncode:
            raise AssertionError(f"serve in {root} failed: "
                                 f"{res.stderr[-4000:]}")
        rows = [json.loads(ln.split("[serve] ", 1)[1])
                for ln in res.stdout.splitlines()
                if ln.startswith("[serve] {")]
        graphed = [r for r in rows if r["mode"] == "graphed"]
        runs.append(graphed)
        log(f"[compare-serve] {root}: " + json.dumps(
            [{k: r[k] for k in ("mode", "tokens_per_s", "tpot_ms_p50",
                                "ttft_ms_p50", "wall_s", "gc") if k in r}
             for r in rows]))
        for ln in res.stdout.splitlines():
            if ln.startswith("[serve] telemetry"):
                log(f"[compare-serve] {root}: {ln}")
    log(f"[compare-serve] graphed tokens/s (roots {', '.join(roots)}): "
        + json.dumps([[r["tokens_per_s"] for r in run] for run in runs]))
    log(f"[compare-serve] graphed TPOT ms p50 (roots {', '.join(roots)}): "
        + json.dumps([[r["tpot_ms_p50"] for r in run] for run in runs]))


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


# -- phase 5: serving with the prefix cache and speculative decoding -----------
def build_draft_68m():
    """The draft model at the published widths of JackFram/llama-68m, the
    usual draft of Llama-7B (its config.json: hidden 768, 2 layers, 12
    heads of 64, intermediate 3072, vocab 32000, 2048 positions, RMSNorm
    eps 1e-6), bf16, random weights from seed 1."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=32000, hidden_size=768, num_layers=2,
                      num_heads=12, intermediate_size=3072,
                      max_position_embeddings=2048, rms_norm_eps=1e-6,
                      dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device="cuda", seed=1)
    log(f"[serve-prefix-spec] draft: llama-68m widths, "
        f"{cfg.num_params() / 1e6:.1f}M params, bf16, seed 1")
    return model


def prefix_waves(vocab):
    """Every prompt is one shared 1024-token system prompt (seed 14) and
    its own suffix of 64..512 tokens (seed 15); 8 prompts a wave, the
    second wave's first prompt the system prompt alone (a full hit)."""
    system = prompts(14, [1024], vocab)[0]
    r = np.random.RandomState(15)
    ps = [np.concatenate([system, r.randint(1, vocab, (int(n),))])
          for n in r.randint(64, 513, 16)]
    ps[8] = system.copy()
    return ps[:8], ps[8:]


def serve_waves(eng, waves, n_new):
    """Submit the first wave, step until every one of its rows decodes,
    submit the second and drain. Returns the requests in submission
    order, the wall seconds, the rounds and graph replays of this run, and
    the cache-hit pages each second-wave request was admitted with."""
    first, second = waves
    rounds0, replays0 = Counter(eng.rounds), Counter(eng.stats.replays)
    hits = {}

    def step():
        eng.step()
        for s in eng.slots:
            if s is not None:
                hits.setdefault(s.req.rid, s.hit_pages)

    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=n_new) for p in first]
    while eng.queue or any(s is not None and s.state != "decode"
                           for s in eng.slots):
        step()
    later = [eng.submit(p, max_new_tokens=n_new) for p in second]
    while eng.queue or eng.num_active:
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([eng.finished[r] for r in rids + later], wall,
            eng.rounds - rounds0, eng.stats.replays - replays0,
            [hits[r] for r in later])


def drop_cache(eng):
    """Reclaim every idle cached page, so that each run of a schedule
    starts from an empty prefix cache and the runs' tokens compare."""
    while eng._lru:
        eng._cache_reclaim()
    eng.check_invariants()


def implied_launches(eng, rounds, L, dL):
    """K3, K4 and K5 launches the rounds imply: per target step K3 twice
    a layer and once at the end; K4 once a layer a unified or verify
    round (target) and a chunk feed (draft); K5 once a layer a decode
    step (target) and each of the k+1 proposal steps (draft)."""
    target = rounds["unified"] + rounds["unified_spec"]
    steps = target + eng.chunk * rounds["decode"]
    proposals = (eng.spec + 1) * rounds["draft_propose"]
    return {"rms_norm": (2 * L + 1) * steps
            + (2 * dL + 1) * (proposals + rounds["draft_chunk"]),
            "ragged_paged_attention": L * target
            + dL * rounds["draft_chunk"],
            "paged_decode_attention": L * eng.chunk * rounds["decode"]
            + dL * proposals}


def teacher_forced(model, reqs, tol=0.5):
    """Every committed token against the target's argmax in one forward
    of prompt + committed tokens (the training forward, K1): where the
    two differ, the logits of the two tokens must be within ``tol`` (the
    bf16 gap between two attention bodies). Returns (mismatches, worst
    gap, tokens)."""
    bad, worst, n = 0, 0.0, 0
    with torch.no_grad():
        for r in reqs:
            L = len(r.prompt)
            ids = torch.tensor(np.concatenate([r.prompt, r.new_tokens[:-1]]),
                               device=model.device)[None]
            lg = model(ids)[0, L - 1:].float()
            got = torch.tensor(r.new_tokens, device=model.device)[:, None]
            gap = (lg.max(-1).values - lg.gather(1, got)[:, 0]).tolist()
            bad += sum(g > 0 for g in gap)
            worst = max(worst, max(gap))
            n += len(gap)
    if worst >= tol:
        raise AssertionError(f"a committed token is {worst} logits below "
                             f"the teacher-forced argmax (tolerance {tol})")
    return bad, worst, n


def phase_serve_prefix_spec(model, counters, profile=False):
    """The serve phase's model and engine settings with the prefix cache,
    and with speculative decoding from the llama-68m draft or from the
    target itself (k = 4), beside the plain engine, on a schedule of two
    waves sharing a 1024-token system prompt. Per configuration one
    engine, warmed up (every graph captured), then eager, graphed,
    graphed (plain: graphed twice), each run from an empty cache. Fails
    unless each run launches exactly the K3/K4/K5 its rounds imply and
    graphed runs replay every round; a configuration's runs commit equal
    tokens; the invariant holds; every second-wave request hits >= 16
    pages; a copy-on-write runs; and self-speculation commits the
    teacher-forced argmax. Returns the launches of the first graphed run
    with the draft."""
    cfg = model.config
    L = cfg.num_layers
    kw = dict(page=64, max_length=2048, max_batch=8, prefill_chunk=256,
              prefill_token_budget=256)
    waves = prefix_waves(cfg.vocab_size)
    # a full hit of 4 pages (copy-on-write) after its donor: every site
    warm = ([prompts(16, [256], cfg.vocab_size)[0]],
            [prompts(16, [256], cfg.vocab_size)[0]])
    draft = build_draft_68m()
    pfx = dict(prefix_cache=True, debug_invariants=True)
    configs = [("plain", None, {}, ("graphed", "graphed")),
               ("prefix", None, pfx, ("eager", "graphed", "graphed")),
               ("prefix+draft", draft, dict(spec_tokens=4, **pfx),
                ("eager", "graphed", "graphed")),
               ("prefix+self", model, dict(spec_tokens=4, **pfx),
                ("eager", "graphed", "graphed"))]
    tokens, result = {}, None
    for name, dmodel, extra, modes in configs:
        eng = make_engine(model, draft=dmodel, **kw, **extra)
        dL = 0 if dmodel is None else dmodel.config.num_layers
        serve_waves(eng, warm, 6)
        runs = []
        for mode in modes:
            drop_cache(eng)
            p0, s0 = eng.prefix_cache_stats(), eng.spec_stats()
            torch.cuda.reset_peak_memory_stats()
            for c in counters:
                c.launches = 0
            with mode_ctx(mode):
                reqs, wall, rounds, replays, hits = serve_waves(eng, waves,
                                                                32)
            launches = {c.__name__: c.launches for c in counters}
            eng.check_invariants()
            p1, s1 = eng.prefix_cache_stats(), eng.spec_stats()
            dp = {k: p1[k] - p0[k] for k in ("lookups", "hits", "cow",
                                             "reclaimed", "registered",
                                             "skipped_tokens",
                                             "fed_tokens")}
            ds = {k: s1[k] - s0[k] for k in ("proposed", "accepted",
                                             "rounds", "committed")}
            n_tok = sum(len(r.new_tokens) for r in reqs)
            ttft = [1e3 * (r.t_first_token - r.t_submit) for r in reqs]
            tpot = [1e3 * (r.t_finish - r.t_first_token)
                    / (len(r.new_tokens) - 1) for r in reqs]
            for r in reqs:
                if len(r.new_tokens) != 32 or not all(
                        0 <= t < cfg.vocab_size for t in r.new_tokens):
                    raise AssertionError(f"{name} request {r.rid}: bad "
                                         f"output {r.new_tokens}")
            summary = dict(
                config=name, mode=mode, layers=L, draft_layers=dL,
                spec_tokens=eng.spec, requests=len(reqs), new_tokens=n_tok,
                prompt_tokens=sum(len(r.prompt) for r in reqs),
                wall_s=wall, tokens_per_s=n_tok / wall,
                ttft_ms_p50=float(np.percentile(ttft, 50)),
                ttft_ms_p99=float(np.percentile(ttft, 99)),
                tpot_ms_p50=float(np.percentile(tpot, 50)),
                rounds=dict(rounds), graph_replays=dict(replays),
                second_wave_hit_pages=hits, prefix=dp, spec=ds,
                accept_rate=(ds["accepted"] / ds["proposed"]
                             if ds["proposed"] else None),
                tokens_per_step=(ds["committed"] / ds["rounds"]
                                 if ds["rounds"] else None),
                pool_pages=eng.P,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches=launches)
            log("[serve-prefix-spec] " + json.dumps(summary))
            want = implied_launches(eng, rounds, L, dL)
            if launches != want:
                raise AssertionError(f"{name} {mode} launched {launches}, "
                                     f"its rounds {dict(rounds)} imply "
                                     f"{want}")
            # each graph site and the rounds it runs
            site_rounds = {"unified": "unified", "unified_spec":
                           "unified_spec", "serve_decode": "decode",
                           "draft_propose": "draft_propose",
                           "draft_chunk": "draft_chunk"}
            want_replays = ({s: rounds[r] for s, r in site_rounds.items()
                             if rounds[r]} if mode == "graphed" else {})
            if dict(replays) != want_replays:
                raise AssertionError(f"{name} {mode} replayed "
                                     f"{dict(replays)}, expected "
                                     f"{want_replays}")
            if extra.get("prefix_cache"):
                if min(hits) < 16 or dp["cow"] < 1:
                    raise AssertionError(f"{name} {mode}: second-wave hit "
                                         f"pages {hits}, copy-on-writes "
                                         f"{dp['cow']}")
            runs.append((mode, reqs, launches))
        log(f"[serve-prefix-spec] {name} graphs: "
            + json.dumps(graphs_summary(eng.stats)))
        first = [list(r.new_tokens) for r in runs[0][1]]
        if any([list(r.new_tokens) for r in rq] != first or n != runs[0][2]
               for _, rq, n in runs):
            raise AssertionError(f"{name}: runs differ in tokens or "
                                 "launches: " + "; ".join(
                                     f"{m}: {n}" for m, _, n in runs))
        graphed = next(rq for m, rq, _ in runs if m == "graphed")
        tokens[name] = [list(r.new_tokens) for r in graphed]
        if name == "prefix+self":
            bad, worst, n = teacher_forced(model, graphed)
            log(f"[serve-prefix-spec] prefix+self: {bad} of {n} committed "
                f"tokens are not the teacher-forced argmax, worst logit "
                f"gap {worst} (< 0.5): OK")
        if name == "prefix+draft":
            result = next(n for m, _, n in runs if m == "graphed")
        if profile and name == "prefix+draft":
            drop_cache(eng)
            _profiled(lambda: serve_waves(eng, waves, 32)[1],
                      "serve-prefix-spec")
        log(f"[serve-prefix-spec] {name}: {', '.join(modes)} runs commit "
            f"equal tokens and launches {runs[0][2]}: OK")
        del eng, runs
        gc.collect()
        torch.cuda.empty_cache()
    plain = tokens["plain"]
    agree = {name: sum(a == b for x, y in zip(toks, plain)
                       for a, b in zip(x, y))
             for name, toks in tokens.items() if name != "plain"}
    log(f"[serve-prefix-spec] tokens equal to the plain bf16 serve's, of "
        f"{sum(map(len, plain))}: {json.dumps(agree)}")
    del draft
    return result


# -- phase 6: generation --------------------------------------------------------
MASKED_SHAPE = (4, 2048, 16, 128)   # gpt_1p3b's attention
MASKED_LENS = (2048, 1536, 1000, 517)


def _masked_grads(q, k, v, do, **kw):
    """(out, dq, dk, dv) of scaled_dot_product_attention (the user's entry
    point) by autograd."""
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention

    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = scaled_dot_product_attention(qq, kk, vv, **kw)
    return (out.detach(),) + torch.autograd.grad(out, (qq, kk, vv), do)


def phase_masked_attention(dev):
    """Masked attention with dropout (scaled_dot_product_attention with an
    attn_mask and dropout_p, item 2.13: torch ops on the kernels' Philox
    mask) at gpt_1p3b's attention shape [4, 2048, 16, 128], bf16, p = 0.1,
    one seed. An all-True bool mask with is_causal gives K1's kDrop output
    for the seed, and its backward K2's gradients (2e-2 per 64-position
    tile); a key-padding mask [4, 1, 1, 2048] of ragged lengths gives
    finite outputs and gradients; at [2, 128, 4, 64] fp32 (a bool mask and
    an additive one) the card's output and gradients equal the CPU's
    within 1e-5 (TF32 off) and the keep masks are torch.equal. Prints the
    masked path's forward and forward + backward ms (CUDA events) and its
    peak memory beside the unmasked path's (K1/K2 with dropout)."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops.kernels import dropout_mask as DM

    p, seed = DROPOUT_P, DROPOUT_SEED
    B, S, H, D = MASKED_SHAPE
    g = torch.Generator(device=dev).manual_seed(23)
    q, k, v, do = (torch.randn(B, S, H, D, device=dev, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    ones = torch.ones(1, 1, S, S, dtype=torch.bool, device=dev)
    masked = dict(attn_mask=ones, dropout_p=p, is_causal=True, seed=seed)
    got = _masked_grads(q, k, v, do, **masked)

    def unmasked(qq, kk, vv):
        return A.flash_attention(qq, kk, vv, causal=True, dropout=p,
                                 seed=seed)

    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = unmasked(qq, kk, vv)
    want = (o.detach(),) + torch.autograd.grad(o, (qq, kk, vv), do)
    errs = [_errs(a, b) for a, b in zip(got, want)]
    rec = dict(shape=list(MASKED_SHAPE), dtype="bfloat16", dropout=p,
               fwd_rel_err=errs[0][3],
               bwd_rel_err=max(e[3] for e in errs[1:]), tol=2e-2)
    if not max(rec["fwd_rel_err"], rec["bwd_rel_err"]) <= 2e-2:
        raise AssertionError(f"masked attention (all-True mask) against "
                             f"K1/K2 with dropout: {rec}")
    del got, want, o, qq, kk, vv

    pad = (torch.arange(S, device=dev)[None, None, None, :]
           < torch.tensor(MASKED_LENS, device=dev)[:, None, None, None])
    got = _masked_grads(q, k, v, do, attn_mask=pad, dropout_p=p, seed=seed)
    rec["padding_finite"] = all(bool(torch.isfinite(t).all()) for t in got)
    if not rec["padding_finite"]:
        raise AssertionError("masked attention (key padding): non-finite "
                             "output or gradient")
    del got

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        return events_ms(fn, iters=5, warm=1), peak / 2 ** 30

    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
    rec["masked_fwd_ms"], rec["masked_fwd_peak_gib"] = timed(
        lambda: scaled_dot_product_attention(q, k, v, **masked))
    rec["masked_fwd_bwd_ms"], rec["masked_fwd_bwd_peak_gib"] = timed(
        lambda: _masked_grads(q, k, v, do, **masked))
    rec["masked_padding_fwd_bwd_ms"], rec["masked_padding_peak_gib"] = \
        timed(lambda: _masked_grads(q, k, v, do, attn_mask=pad, dropout_p=p,
                                    seed=seed))
    rec["unmasked_fwd_ms"], rec["unmasked_fwd_peak_gib"] = timed(
        lambda: scaled_dot_product_attention(q, k, v, dropout_p=p,
                                             is_causal=True, seed=seed))
    rec["unmasked_fwd_bwd_ms"], rec["unmasked_fwd_bwd_peak_gib"] = timed(
        lambda: _masked_grads(q, k, v, do, dropout_p=p, is_causal=True,
                              seed=seed))
    rec["keep_mask_ms"], rec["keep_mask_peak_gib"] = timed(
        lambda: DM.dropout_keep(seed, p, B, H, S, S, dev))
    del q, k, v, do, pad, ones

    # fp32: the card against the CPU on the same inputs, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    r = np.random.RandomState(29)
    small = [r.randn(2, 128, 4, 64).astype(np.float32) for _ in range(4)]
    bmask = r.rand(2, 1, 128, 128) > 0.3
    bmask[..., 0] = True
    amask = (r.randn(1, 4, 128, 128) * 2).astype(np.float32)
    worst = 0.0
    for am, causal in ((bmask, False), (bmask, True), (amask, False)):
        outs = {}
        for d in ("cuda", "cpu"):
            t = [torch.tensor(a, device=d) for a in small]
            outs[d] = _masked_grads(*t[:3], t[3],
                                    attn_mask=torch.tensor(am, device=d),
                                    dropout_p=p, is_causal=causal,
                                    seed=seed)
        for a, b in zip(outs["cuda"], outs["cpu"]):
            worst = max(worst, (a.cpu() - b).abs().max().item())
    rec["fp32_cuda_vs_cpu"] = worst
    rec["fp32_keep_equal"] = bool(torch.equal(
        DM.dropout_keep(seed, p, 2, 4, 128, 128, dev).cpu(),
        DM.dropout_keep(seed, p, 2, 4, 128, 128, "cpu")))
    log("[masked-attention] " + json.dumps(rec))
    if not (worst <= 1e-5 and rec["fp32_keep_equal"]):
        raise AssertionError(f"masked attention fp32: card against cpu "
                             f"{worst} (> 1e-5) or keep masks differ")
    torch.cuda.empty_cache()
    return rec

def phase_load_serve(counters, layers=8, n_new=32):
    """Serving a saved model (item 1.4) at Llama-7B widths cut to
    ``layers`` layers, bf16, random weights from seed 0: the live model's
    predictor generates ``n_new`` greedy tokens for the generate phase's
    ragged prompts (static cache, graphed decode); the model is saved with
    ``save(export_jax_state_dict(model, tensors=True), path)`` (the JAX
    package's format and layout) under build/, then
    ``create_predictor(Config(params_file=path).set_model_factory(...))``,
    the factory building the model from another seed, and the
    ``Config(model_dir=...)`` route each generate the same prompts: their
    tokens must equal the live predictor's. The first file route is the
    path whose K3 / K6 launches the kernels line reads (counts set to 0
    before its generate, read after). Prints the file's bytes, the save
    and load seconds and GB/s (the load: create_predictor less the
    factory's build), and removes the files."""
    import shutil

    from paddle_tpu_torch import save
    from paddle_tpu_torch.convert import export_jax_state_dict
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    cfg = llama_7b(dtype="bfloat16", num_layers=layers)
    model = build_7b(layers)
    ids, lens = _ragged_prompts(cfg.vocab_size)

    def generate(conf):
        conf.max_length = 2048
        pred = create_predictor(conf)
        return pred, pred.generate(ids, max_new_tokens=n_new,
                                   lengths=lens).cpu().numpy()

    _, live = generate(Config().set_model(model))
    root = Path(__file__).resolve().parent / "build" / "load_serve"
    shutil.rmtree(root, ignore_errors=True)
    path = root / "model.pdparams"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(export_jax_state_dict(model, tensors=True), str(path))
        save_s = time.perf_counter() - t0
        nbytes = path.stat().st_size
        del model
        gc.collect()
        torch.cuda.empty_cache()
        built = []

        def factory():
            t = time.perf_counter()
            m = LlamaForCausalLM(cfg, device="cuda", seed=1)
            torch.cuda.synchronize()
            built.append(time.perf_counter() - t)
            return m

        conf = Config(params_file=str(path)).set_model_factory(factory)
        conf.max_length = 2048
        t0 = time.perf_counter()
        pred = create_predictor(conf)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0 - built[-1]
        pred.generate(ids, max_new_tokens=n_new, lengths=lens).cpu()  # warm
        for c in counters:
            c.launches = 0
        from_file = pred.generate(ids, max_new_tokens=n_new,
                                  lengths=lens).cpu().numpy()
        launches = {c.__name__: c.launches for c in counters}
        del pred
        gc.collect()
        torch.cuda.empty_cache()
        _, from_dir = generate(Config(model_dir=str(root))
                               .set_model_factory(factory))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _expect_launches(launches, {
        "rms_norm": (2 * layers + 1) * n_new,
        "decode_attention": layers * n_new}, "load-serve path")
    rec = dict(layers=layers, dtype="bfloat16", prompt_lens=lens.tolist(),
               new_tokens=n_new, file_bytes=nbytes, save_s=save_s,
               save_gb_s=nbytes / save_s / 1e9, load_s=load_s,
               load_gb_s=nbytes / load_s / 1e9,
               factory_s=built[0], params_file_equal=bool(
                   (from_file == live).all()),
               model_dir_equal=bool((from_dir == live).all()),
               launches=launches)
    log("[load-serve] " + json.dumps(rec))
    if not (rec["params_file_equal"] and rec["model_dir_equal"]):
        raise AssertionError("load-serve: a predictor built from the saved "
                             "file generated other tokens than the live "
                             "model's")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _ragged_prompts(vocab):
    """8 prompts of RandomState(21).randint(128, 1025, 8) tokens, right-
    padded into one [8, max] array."""
    lens = np.random.RandomState(21).randint(128, 1025, 8)
    ids = np.zeros((8, int(lens.max())), np.int64)
    for b, p in enumerate(prompts(22, lens, vocab)):
        ids[b, :len(p)] = p
    return ids, lens


def phase_generate(model, paths, profile=False, n_new=128,
                   caches=(("static", None), ("paged", 64)),
                   modes=("eager", "graphed", "graphed", "eager"),
                   tag="generate"):
    """Predictor.generate over the 7B-width model: the same ragged prompts
    with the static cache (K6), then with enable_paged_kv(64) (K5). For
    each, one untimed graphed call (its decode graph is captured there),
    then the measured calls in ``modes`` (eager, graphed, graphed,
    eager). Returns the launches by cache and the runs' summaries."""
    from paddle_tpu_torch.inference import Config, create_predictor

    cfg = model.config
    ids, lens = _ragged_prompts(cfg.vocab_size)
    launches, outs, first_logits, summaries = {}, {}, {}, []
    want = {"rms_norm": (2 * cfg.num_layers + 1) * n_new,
            "decode_attention": cfg.num_layers * n_new,
            "paged_decode_attention": cfg.num_layers * n_new,
            "weight_only_linear": 7 * cfg.num_layers * n_new,
            # the prefill's 8 x Sb rows: the wgmma body, once a projection
            "weight_only_linear_wgmma": 7 * cfg.num_layers}
    for label, page in caches:
        conf = Config().set_model(model)
        conf.max_length = 2048
        if page:
            conf.enable_paged_kv(page)
        pred = create_predictor(conf)
        pred.generate(ids, max_new_tokens=n_new, lengths=lens).cpu()
        counters = paths[f"{tag}_{label}"]
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
        for mode in modes:
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
            log(f"[{tag}] " + json.dumps(summary))
            summaries.append(summary)
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
        log(f"[{tag}] {label}: {pred.stats!r}, graphs "
            + json.dumps(graphs_summary(pred.stats)))
        if "eager" in runs:
            same = runs["graphed"] == runs["eager"]
            log(f"[{tag}] {label}: graphed and eager agree on "
                f"{int(same.sum())} of {same.size} new tokens (bf16)")
        outs[label] = runs["graphed"]
        if profile:
            profile_decode(pred, ids, lens, f"{tag}_{label}")
        del pred, out
    if len(outs) < 2:
        return launches, summaries, outs
    same = outs["static"] == outs["paged"]
    first = [int(np.argmin(r)) if not r.all() else n_new for r in same]
    log(f"[{tag}] static and paged agree on {int(same.sum())} of "
        f"{same.size} new tokens, each row up to new token {first} (bf16; "
        f"K6 and K5 run one body over the same keys)")
    # the first new token's logits from the two caches' prefills
    a, b = (first_logits[k].float() for k in ("static", "paged"))
    top2 = a.topk(2, dim=-1).values
    log(f"[{tag}] prefill logits, static vs paged: max |diff| per row "
        f"{(a - b).abs().amax(-1).tolist()}, static top-2 gap per row "
        f"{(top2[:, 0] - top2[:, 1]).tolist()}, logit RMS "
        f"{a.pow(2).mean().sqrt().item()}")
    if not same.all() or not torch.equal(first_logits["static"],
                                         first_logits["paged"]):
        raise AssertionError("bf16 static and paged generation differ: K6 "
                             "and K5 over the same keys must give the same "
                             "bits")
    if tag == "generate":
        check_generate_attention(model, ids, lens)
    return launches, summaries, outs


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
    log(f"[profile:{label}] {steps} graphed decode steps, "
        f"{wall * 1e3 / steps:.2f} ms a step on the host clock")
    _log_profile(seen["prof"], wall, label, per=steps)


# -- phase 7: weight-only serving ------------------------------------------------
def _graphed(summaries, **match):
    """The graphed summaries that match ``match``."""
    return [s for s in summaries if s["mode"] == "graphed"
            and all(s.get(k) == v for k, v in match.items())]


def _beside(tag, ours, bf16, keys):
    """One line: each metric of the quantized runs beside bf16's (the
    graphed runs of the same call; 'not run' when bf16's phase did not
    run)."""
    line = {}
    for k in keys:
        line[k] = dict(weight_only=[s[k] for s in ours],
                       bf16=[s[k] for s in bf16] or "not run")
    log(f"[{tag}] beside bf16 (graphed runs): " + json.dumps(line))


def wo_teacher_forced(model, ids, lens, new, rows=(0, 1)):
    """One forward of the quantized model over prompt + generated tokens
    (the training forward) per row, with every K9 call watched: its
    output against the plain version on the same activations and int8
    weights, per call, the largest difference over the output's largest
    magnitude, bf16 gate 2e-2. The same forward with K9's plain version
    throughout gives the end-to-end logit difference and the argmax
    agreement, printed and not gated: one rounding of a bf16 projection
    output that falls the other way grows through 32 layers of random
    weights. Also where the committed token is not the argmax of K9's
    teacher-forced logits, its logit gap."""
    from paddle_tpu_torch.nn import quant
    from paddle_tpu_torch.ops.kernels import weight_only_linear as K9

    kernel = quant.k9_linear
    per_call = []

    def plain(x, q, s, b=None, int4=False):
        return K9.weight_only_linear_dense(x, q, s, b, int4)

    def watched(x, q, s, b=None, int4=False):
        out = kernel(x, q, s, b, int4)
        ref = plain(x, q, s, b, int4).float()
        per_call.append(((out.float() - ref).abs().max()
                         / ref.abs().max().clamp_min(1e-30)).item())
        return out

    e2e, agree, bad, gap, n = 0.0, [], 0, 0.0, 0
    nw = K9.weight_only_linear_wgmma.launches
    with torch.no_grad():
        for b in rows:
            seq = np.concatenate([ids[b, :lens[b]], new[b, :-1]])
            t = torch.tensor(seq, device=model.device)[None]
            calls = len(per_call)
            quant.k9_linear = watched
            try:
                a = model(t)[0].float()
                quant.k9_linear = plain
                r = model(t)[0].float()
            finally:
                quant.k9_linear = kernel
            if len(per_call) - calls != 7 * model.config.num_layers:
                raise AssertionError("the teacher-forced forward did not go "
                                     "through K9 once a projection")
            e2e = max(e2e, ((a - r).norm(dim=-1) / r.norm(dim=-1)).max()
                      .item())
            agree.append((a.argmax(-1) == r.argmax(-1)).float().mean()
                         .item())
            lg = a[lens[b] - 1:]
            got = torch.tensor(new[b], device=model.device)[:, None]
            g = lg.max(-1).values - lg.gather(1, got)[:, 0]
            bad += int((g > 0).sum())
            gap = max(gap, g.max().item())
            n += len(new[b])
    worst = max(per_call)
    if K9.weight_only_linear_wgmma.launches - nw != len(per_call):
        raise AssertionError("the teacher-forced forward's K9 calls did not "
                             "all run the wgmma body")
    log(f"[weight-only] teacher-forced forward of rows {list(rows)}: "
        f"{len(per_call)} K9 calls (the wgmma body) against the plain "
        f"version on the same "
        f"activations and int8 weights, worst {worst} (gate "
        f"{TOL[torch.bfloat16]}); logits against an all-plain forward: "
        f"worst per-position relative L2 {e2e}, argmax agreement "
        f"{agree} (not gated); committed tokens not the K9 argmax: {bad} "
        f"of {n}, largest logit gap {gap}")
    if not worst <= TOL[torch.bfloat16]:
        raise AssertionError(f"weight-only forward: a K9 call differs from "
                             f"its plain version by {worst}")


def phase_weight_only(model, paths, bf16, profile=False):
    """Weight-only int8 serving on the 7B-width model: quantized in place
    (every projection; the LM head kept bf16), then Predictor.generate
    static and paged (eager, graphed, graphed, eager), a teacher-forced
    logit check and the token agreement with bf16's, then the serve
    schedule graphed twice. K9 must launch 7 times a layer a step, with
    the other kernels as before. Returns the launches by path."""
    from paddle_tpu_torch.nn.quant import quantize_for_serving

    cfg = model.config
    t0 = time.perf_counter()
    quantize_for_serving(model, "weight_only_int8", ("lm_head",))
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    qbytes = sum(p.nbytes for n, p in model.named_parameters()
                 if n.endswith("weight_quant"))
    log(f"[weight-only] int8: {7 * cfg.num_layers} projections quantized "
        f"in place in {time.perf_counter() - t0:.1f}s ({qbytes / 1e9:.3f} "
        f"GB of int8 weights; the LM head stays bf16)")
    launches, summaries, outs = phase_generate(
        model, paths, profile, tag="weight_only_generate")
    for label in ("static", "paged"):
        _beside(f"weight-only generate {label}",
                _graphed(summaries, cache=label),
                _graphed(bf16["generate"], cache=label),
                ("decode_ms_per_token", "prefill_ms", "tokens_per_s",
                 "peak_mem_gib"))
    ids, lens = _ragged_prompts(cfg.vocab_size)
    wo_teacher_forced(model, ids, lens, outs["static"])
    ref = bf16["generate_outs"].get("static")
    if ref is not None:
        same = outs["static"] == ref
        log(f"[weight-only] int8 static generation equals bf16's on "
            f"{int(same.sum())} of {same.size} new tokens (not gated)")
    by_path = {f"weight_only_generate_{k}": v for k, v in launches.items()}
    by_path["weight_only_serve"], served = phase_serve(
        model, paths["weight_only_serve"], profile,
        modes=("graphed", "graphed"), tag="weight-only serve")
    _beside("weight-only serve", served, _graphed(bf16["serve"]),
            ("tokens_per_s", "ttft_ms_p50", "ttft_ms_p99", "tpot_ms_p50",
             "peak_mem_gib"))
    return by_path


def phase_weight_only_int4(model, paths, bf16, profile=False):
    """int4 on the same weights (the model rebuilt from its seed):
    static-cache Predictor.generate, graphed."""
    from paddle_tpu_torch.nn.quant import quantize_for_serving

    quantize_for_serving(model, "weight_only_int4", ("lm_head",))
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    launches, summaries, _ = phase_generate(
        model, paths, profile, caches=(("static", None),),
        modes=("graphed",), tag="weight_only_int4_generate")
    _beside("weight-only int4 generate static", summaries,
            _graphed(bf16["generate"], cache="static"),
            ("decode_ms_per_token", "prefill_ms", "tokens_per_s",
             "peak_mem_gib"))
    return {"weight_only_int4_generate_static": launches["static"]}


# -- phases 8 to 10: training ---------------------------------------------
def _trainer(model, scaler=None, crit=None):
    """The train step a user builds: AdamW with f32 masters and moments,
    global-norm clipping, through ParallelEngine.train_step. With a
    ``scaler`` (amp.GradScaler) the learning rate follows a warmup and
    cosine schedule, and the loss is multiplied by the batch's ``k`` (1,
    or inf to force an overflow). ``crit``: the model's criterion
    (default: Llama's)."""
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
    crit = crit or LlamaPretrainingCriterion(model.config)
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


# -- phases 11 and 12: GPT at degree 1 ---------------------------------------
def phase_gpt_parity():
    """A reduced GPT (2 layers, hidden 512, 8 heads: head dim 64, vocab
    4096, fp32, TF32 off) with attention dropout 0.1 and hidden dropout 0
    trains 3 AdamW steps on cuda (K1/K2's dropout kernels, fp32 bodies)
    and on cpu (their plain version) from the same weights and seed: the
    attention masks are equal by construction (one Philox seed a call from
    the model's CPU generator), so losses and global grad norms must agree
    within 1e-4 relative. Then, with dropout 0, the cached forward (a
    prefill of 64 tokens, then 8 single-token steps) on cuda against cpu
    within 1e-4 of the logits' largest magnitude."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                             GPTPretrainingCriterion)
    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shape = dict(vocab_size=4096, hidden_size=512, num_layers=2,
                 num_heads=8, max_position_embeddings=512)
    cfg = GPTConfig(**shape, attention_dropout=0.1, hidden_dropout=0.0)
    runs = {}
    nd = K1.flash_attention_fwd_dropout.launches
    for dev in ("cpu", "cuda"):
        model = GPTForCausalLM(cfg, device=dev, seed=5)
        if dev == "cuda":
            model.load_state_dict(cpu_state)
        else:
            cpu_state = {k: v.clone() for k, v in model.state_dict().items()}
        opt, step = _trainer(model, crit=GPTPretrainingCriterion(cfg))
        batch = _lm_batch(17, 2, 256, cfg.vocab_size, model.device)
        runs[dev] = [(float(step(batch)), float(opt.grad_norm))
                     for _ in range(3)]
        del model, opt, step
    drops = K1.flash_attention_fwd_dropout.launches - nd
    log(f"[gpt-parity] attention dropout 0.1, (loss, grad norm) per step: "
        f"{json.dumps(runs)}; K1 dropout launches on cuda {drops}")
    if drops != 3 * cfg.num_layers:
        raise AssertionError(f"cuda training ran {drops} K1 dropout "
                             f"launches, not {3 * cfg.num_layers}")
    for (lc, nc), (lg, ng) in zip(runs["cpu"], runs["cuda"]):
        if not (abs(lg - lc) <= 1e-4 * abs(lc)
                and abs(ng - nc) <= 1e-4 * abs(nc)):
            raise AssertionError(f"cuda and cpu GPT training differ: {runs}")
    log("[gpt-parity] cuda == cpu losses and grad norms within 1e-4 with "
        "attention dropout on: OK")
    plain = GPTConfig(**shape)
    ids = np.random.RandomState(18).randint(0, plain.vocab_size, (2, 72))
    logits = {}
    for dev in ("cpu", "cuda"):
        model = GPTForCausalLM(plain, device=dev, seed=6).eval()
        model.load_state_dict(cpu_state)
        caches = [(torch.zeros(2, 0, 8, 64, device=dev),) * 2
                  for _ in range(plain.num_layers)]
        out, pos = [], 0
        with torch.no_grad():
            for chunk in [ids[:, :64]] + [ids[:, i:i + 1]
                                          for i in range(64, 72)]:
                lg, caches = model(torch.tensor(chunk, device=dev), caches,
                                   position_offset=pos)
                out.append(lg.cpu())
                pos += chunk.shape[1]
        logits[dev] = torch.cat(out, 1)
    err = ((logits["cuda"] - logits["cpu"]).abs().max()
           / logits["cpu"].abs().max()).item()
    log(f"[gpt-parity] cached forward (prefill 64, 8 single-token steps), "
        f"cuda vs cpu logits: {err:.3e} of the largest")
    if not err <= 1e-4:
        raise AssertionError(f"cached GPT forward differs: {err}")
    log("[gpt-parity] cached forward cuda == cpu within 1e-4: OK")


def _gpt_run(dropout, counters, steps, warm):
    """gpt_1p3b at full width and depth, bf16, through the trainer: one
    fixed 4 x 2048 batch, ``steps`` steps, ``counters`` set to 0 before
    step ``warm``. Returns (model, opt, summary)."""
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             GPTPretrainingCriterion,
                                             gpt_1p3b)

    cfg = gpt_1p3b(dtype="bfloat16", hidden_dropout=dropout,
                   attention_dropout=dropout)
    B, S = 4, 2048
    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    opt, step = _trainer(model, crit=GPTPretrainingCriterion(cfg))
    batch = _lm_batch(19, B, S, cfg.vocab_size, model.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for i in range(steps):
        if i == warm:
            for c in counters:
                c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(batch)))
        secs.append(time.perf_counter() - t0)
    timed = secs[warm:]
    tok_s = B * S * len(timed) / sum(timed)
    L, h = cfg.num_layers, cfg.hidden_size
    flops_per_token = 6 * cfg.num_params() + 12 * L * h * S
    summary = dict(
        config="gpt_1p3b", dropout=dropout, params=cfg.num_params(),
        layers=L, hidden=h, heads=cfg.num_heads, vocab=cfg.vocab_size,
        batch=[B, S], steps=steps, untimed=warm, losses=losses,
        step_ms=[t * 1e3 for t in secs],
        step_ms_p50=float(np.percentile(timed, 50)) * 1e3,
        tokens_per_s=tok_s, mfu=flops_per_token * tok_s / 989e12,
        grad_norm_last=float(opt.grad_norm),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches={c.__name__: c.launches for c in counters})
    return model, opt, summary


def phase_train_gpt(counters, steps=12, warm=2):
    """gpt_1p3b (24 layers, hidden 2048, 16 heads, vocab 50304, 1.316 B
    parameters; bf16 weights, AdamW with f32 masters and moments, clip
    1.0): 12 steps on one fixed 4 x 2048 batch, 2 untimed, first with the
    config's defaults (dropout 0), then with hidden and attention dropout
    0.1. Each run: finite, falling losses; step ms p50, tokens/s, MFU
    ((6 N + 12 L h S) tokens/s / 989e12) and peak memory; in the timed
    steps K1 and K2 exactly 24 launches a step, K8 one, and the dropout
    variants 24 a step in the second run and none in the first; then one
    forward and backward with each layer's attention watched (K1's output
    and K2's gradients against the plain version, 2e-2). Returns the
    launches of each run by path name."""
    from paddle_tpu_torch.ops.kernels import flash_attention as K1
    from paddle_tpu_torch.ops.kernels.fused_adam import fused_adam

    out = {}
    for dropout, path in ((0.0, "train_gpt"), (0.1, "train_gpt_dropout")):
        model, opt, summary = _gpt_run(dropout, counters, steps, warm)
        log(f"[train-gpt] " + json.dumps(summary))
        losses, launches = summary["losses"], summary["launches"]
        n, L = steps - warm, model.config.num_layers
        want = {K1.flash_attention_fwd.__name__: L * n,
                K1.flash_attention_bwd.__name__: L * n,
                fused_adam.__name__: n,
                K1.flash_attention_fwd_dropout.__name__:
                    L * n if dropout else 0,
                K1.flash_attention_bwd_dropout.__name__:
                    L * n if dropout else 0}
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite GPT training loss: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"GPT loss did not fall: {losses}")
        if launches != want:
            raise AssertionError(f"train-gpt launches {launches}, expected "
                                 f"{want}")
        check_gpt_attention(model, opt, _lm_batch(20, 4, 2048,
                                                  model.config.vocab_size,
                                                  model.device))
        out[path] = launches
        del model, opt
        gc.collect()
        torch.cuda.empty_cache()
    log("[train-gpt] both runs: finite, falling losses and the expected "
        "launches: OK")
    return out


def _grads_with_delta(q, k, v, do, delta, lse, causal, p, seed):
    """The attention gradients (dq, dk, dv) written out for a given delta
    [B, H, Sq] (MHA), as K2 computes them: dS = P o (dP o Z - delta) with
    dP = dO V^T, Z the dropout factor (1 without dropout), dq = scale
    r(dS) K, dk = scale r(dS)^T Q, dv = r(P o Z)^T dO, where r rounds to
    the inputs' dtype (bf16 P and dS before their products, as the TPU
    kernel rounds them: flash_attention.py:249, :291, :297) and the
    products accumulate in f32. P is K2's, exp2(S scale log2(e) - lse
    log2(e)) from K1's f32 ``lse`` [B, H, Sq] (both products rounded to
    f32 as K2 rounds them). With delta = rowsum(dO o O) from K1's bf16
    output and K1's lse it is K2's function; autograd through the plain
    version takes the exact f32 delta, the softmax's P and unrounded P and
    dS."""
    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    sl2 = (torch.tensor(scale, dtype=torch.float32) * log2e).double()
    lse2 = (lse.float() * log2e.to(lse.device)).double()
    s = (qf @ kf.transpose(-1, -2)).double() * sl2 - lse2[..., None]
    P = torch.exp2(s).float()
    del s
    if causal:
        P = P.masked_fill(~torch.ones(S, S, dtype=torch.bool,
                                      device=q.device).tril(), 0.0)
    Z = (K1._dropout_factor(seed, p, B, H, H, S, S, q.device).reshape(
        B, H, S, S) if p else None)
    dP = dof @ vf.transpose(-1, -2)
    if Z is not None:
        dP.mul_(Z)
    dS = (P * (dP - delta[..., None])).to(q.dtype).float()
    del dP
    dq = (dS @ kf * scale).transpose(1, 2)
    dk = (dS.transpose(-1, -2) @ qf * scale).transpose(1, 2)
    del dS
    if Z is not None:
        P.mul_(Z)
    P = P.to(q.dtype).float()
    dv = (P.transpose(-1, -2) @ dof).transpose(1, 2)
    return dq, dk, dv


def check_gpt_attention(model, opt, batch):
    """One more forward and backward of the trained GPT in train mode with
    every layer's attention call watched: each call's seed is drawn from
    the model's generator as the layer would draw it, then K1's output
    against the plain version with the same seed, and K2's dq, dk, dv
    against the gradients written out with the delta and lse K2 takes
    (rowsum of dO times K1's bf16 output; K1's lse: ``_grads_with_delta``),
    per tile, 2e-2; K1's lse is held to the plain version's first (2e-2
    absolute), since that reference takes it. The trained model's attention runs over keys and
    values nearly equal across positions (GPT's k and v carry biases),
    so dP - delta and the sums over keys nearly cancel: there the
    roundings K2 makes as the TPU kernel does (delta from the bf16
    output, bf16 P and dS) are most of dq and dk, and autograd's exact
    gradients are not the function the kernels compute (on an H100: tile
    errors of 580 for dq at the last layer against autograd, at absolute
    differences of 1.3e-10, and 0.042 with the bf16 delta alone under
    dropout). P itself is such a rounding: normalized by the softmax
    instead of K1's lse, a dq tile of a middle layer under dropout moved
    by 0.033 against K2's function (on an H100, with the 16-bit keep
    test's masks). The autograd gradients' errors are printed beside for
    the first and last layer."""
    import paddle_tpu_torch.models.gpt as gpt
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.ops.kernels import dropout_mask as DM
    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    kernel_path = gpt.flash_attention
    seen = []

    def watched(q, k, v, causal=False, dropout=0.0, generator=None,
                head_offset=0):
        seed = DM.draw_seed(generator) if dropout else None
        out = kernel_path(q, k, v, causal=causal, dropout=dropout, seed=seed,
                          head_offset=head_offset)
        rec = dict(q=q.detach(), k=k.detach(), v=v.detach(),
                   out=out.detach(), causal=causal, p=dropout, seed=seed,
                   h0=head_offset)
        for key, t in (("do", out), ("dq", q), ("dk", k), ("dv", v)):
            t.register_hook(lambda g, key=key: rec.__setitem__(key, g))
        seen.append(rec)
        return out

    crit = GPTPretrainingCriterion(model.config)
    gpt.flash_attention = watched
    try:
        crit(model(batch["x"]), batch["y"]).backward()
    finally:
        gpt.flash_attention = kernel_path
    opt.clear_grad()
    worst, worst_lse, by_layer = 0.0, 0.0, []
    drop_p = seen[0]["p"] if seen else None
    for i, r in enumerate(seen):
        kw = dict(dropout=r["p"], seed=r["seed"])
        with torch.no_grad():
            r_out, r_lse = K1.flash_attention_dense(r["q"], r["k"], r["v"],
                                                    r["causal"], **kw)
            # K2's lse is K1's: the call's forward again, the same bits
            lse = K1.flash_attention_fwd_lse(r["q"], r["k"], r["v"],
                                             r["causal"], **kw)[1]
            delta = (r["do"].float() * r["out"].float()).sum(-1).transpose(
                1, 2)
            ref = _grads_with_delta(r["q"], r["k"], r["v"], r["do"], delta,
                                    lse, r["causal"], r["p"], r["seed"])
        errs = {"out": _errs(r["out"], r_out)}
        errs.update((n, _errs(r[n], g)) for n, g in zip(("dq", "dk", "dv"),
                                                        ref))
        lse_err = (lse - r_lse).abs().max().item()
        worst = max([worst] + [e[3] for e in errs.values()])
        worst_lse = max(worst_lse, lse_err)
        name, e = max(errs.items(), key=lambda kv: kv[1][3])
        by_layer.append(dict(
            layer=i, worst=name, rel_err=e[3], max_abs_err=e[0],
            ref_max_abs=e[1], lse_abs_err=lse_err))
        del lse, r_lse
        if i in (0, len(seen) - 1):
            auto = K1.flash_attention_bwd_dense(r["q"], r["k"], r["v"],
                                                r["do"], r["causal"], **kw)
            log(f"[train-gpt] layer {i} attention (dropout {r['p']}), "
                "kernel path vs plain (K2's delta; autograd's exact delta "
                "beside): " + json.dumps(
                    {n: dict(max_abs_err=e[0], ref_max_abs=e[1],
                             rel_err=e[3]) for n, e in errs.items()} | {
                        "autograd_" + n: dict(rel_err=_errs(r[n], g)[3])
                        for n, g in zip(("dq", "dk", "dv"), auto)}))
            del auto
        del r_out, ref
        seen[i] = None
    log(f"[train-gpt] each layer's worst tensor (dropout {drop_p}): "
        + json.dumps(by_layer))
    if not (len(seen) == model.config.num_layers
            and worst <= TOL[torch.bfloat16]
            and worst_lse <= TOL[torch.bfloat16]):
        raise AssertionError(f"train-gpt attention: {len(seen)} layers "
                             f"watched, worst tile error {worst}, worst "
                             f"lse error {worst_lse}")
    log(f"[train-gpt] every layer's K1 output and lse and K2 gradients "
        f"within {TOL[torch.bfloat16]} of the plain version (worst tile "
        f"{worst}, worst lse {worst_lse}): OK")


# -- phase 13: varlen packs on K1/K2 with per-sequence frontiers -----------
# gpt_1p3b's attention widths; k lengths 2048, 1792, ..., 256, each q the
# last half of its sequence (chunked prefill, a packed continuation)
VARLEN_K = [2048 - 256 * i for i in range(8)]
VARLEN_SEED = 0x5EED_7AC5_0F0F_1234
TINY_SHAPE = [8, 128, 4, 16]    # gpt_tiny's attention in train-surface
# the timed packs (16 heads of 128, bf16, causal): name -> (q lengths, k
# lengths). Their lengths are illustrative, not drawn from a corpus.
# "varlen": the sequences longest first, each q the last half (chunked
# prefill, a packed continuation); "varlen_asc": the same shortest first,
# so index order starts the heaviest blocks last; "varlen_train": a
# packed pretraining batch (q = k, as PaddleNLP's intokens GPT
# pretraining feeds flash_attn_unpadded) of 8 documents whose lengths are
# no multiple of 64, so blocks straddle documents
TRAIN_DOCS = [700, 2100, 260, 1300, 500, 1800, 1012, 520]
VARLEN_PACKS = {
    "varlen": ([n // 2 for n in VARLEN_K], VARLEN_K),
    "varlen_asc": ([n // 2 for n in VARLEN_K[::-1]], VARLEN_K[::-1]),
    "varlen_train": (TRAIN_DOCS, TRAIN_DOCS),
}


def _varlen_pack(dev, dt, k_lens, H, D, seed, q_lens=None):
    """q, k, v, dO [T, H, D] of a pack of sequences of ``k_lens`` keys and
    ``q_lens`` q rows (None: the last half of each), and its cu_seqlens."""
    if q_lens is None:
        q_lens = [n // 2 for n in k_lens]
    cu_q = [0] + list(itertools.accumulate(q_lens))
    cu_k = [0] + list(itertools.accumulate(k_lens))
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda n: torch.randn(n, H, D, device=dev, generator=g).to(dt)  # noqa: E731
    return mk(cu_q[-1]), mk(cu_k[-1]), mk(cu_k[-1]), mk(cu_q[-1]), cu_q, cu_k


def _varlen_cost(qr, H, D, isz, Tq, Tk):
    """Bytes and flops the pack's data needs: its visible (row, key) pairs
    (from the frontier arrays) times 4 D flops a head forward and 10 D
    backward; q, k, v, out (and dO, dq, dk, dv) once each, lse and the
    two frontier arrays."""
    pairs = int((qr[..., 1] - qr[..., 0] + 1).clamp_min(0).sum().item())
    qb, kb, side = Tq * H * D * isz, Tk * H * D * isz, H * Tq * 4
    side += 8 * (Tq + Tk)
    return ((2 * qb + 2 * kb + side, 4 * D * H * pairs),
            (4 * qb + 4 * kb + side, 10 * D * H * pairs), pairs)


def _varlen_library(q, k, v, do, cu_q, cu_k, p, r_out=None, r_grads=None):
    """The library's yardstick for a causal pack: PyTorch's varlen flash
    forward and backward (``torch.ops.aten._flash_attention_forward`` /
    ``_backward``, the op ``torch.nn.attention.varlen.varlen_attn`` runs,
    which fixes dropout at 0) on the pack's cu_seqlens, causal by
    FlashAttention's bottom-right rule per sequence. Given the plain
    version's output and gradients (p = 0), its own are first held to
    them (2e-2 per tile), so the yardstick provably computes the same
    mask. Returns the forward and backward calls, each one PyTorch call
    (the backward on one forward's residuals)."""
    dev = q.device
    cq, ck = (torch.tensor(c, dtype=torch.int32, device=dev)
              for c in (cu_q, cu_k))
    mq, mk = (max(b - a for a, b in zip(c, c[1:])) for c in (cu_q, cu_k))
    aten = torch.ops.aten

    def fwd():
        return aten._flash_attention_forward(q, k, v, cq, ck, mq, mk, p,
                                             True, False)

    f = fwd()

    def bwd():
        return aten._flash_attention_backward(do, q, k, v, f[0], f[1], cq, ck,
                                              mq, mk, p, True, f[2], f[3])

    if r_out is not None:
        errs = [_errs(f[0][None], r_out)[3]] + [
            _errs(a[None], b)[3] for a, b in zip(bwd()[:3], r_grads)]
        log(f"[varlen] the library's varlen flash against the plain version "
            f"(out, dq, dk, dv; per-tile relative): {errs}")
        if not max(errs) <= TOL[torch.bfloat16]:
            raise AssertionError(f"the library's varlen flash computes "
                                 f"another mask: {errs}")
    return fwd, bwd


def _expect_launches(launches, want, what):
    """Fail unless each counter of ``want`` read ``launches`` its count."""
    got = {k: launches.get(k) for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def varlen_main_path(q, k, v, do, cu_q, cu_k, p, counters):
    """The user's entry point, flash_attn_unpadded, forward and backward,
    with ``counters`` set to 0 just before and read just after, and the
    plain version watched: its CUDA calls are counted (there must be
    none). Returns (out, (dq, dk, dv), launches, dense CUDA calls)."""
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    dense, cuda_calls = K1.flash_attention_dense, []

    def watched(q, *a, **kw):
        if q.is_cuda:
            cuda_calls.append(1)
        return dense(q, *a, **kw)

    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    for c in counters:
        c.launches = 0
    K1.flash_attention_dense = watched
    try:
        out, soft = PF.flash_attn_unpadded(
            qg, kg, vg, cu_q, cu_k, causal=True, dropout=p,
            seed=VARLEN_SEED if p else None)
        out.backward(do)
        torch.cuda.synchronize()
    finally:
        K1.flash_attention_dense = dense
    if soft is not None:
        raise AssertionError("flash_attn_unpadded returned a softmax")
    return (out.detach(), (qg.grad, kg.grad, vg.grad),
            {c.__name__: c.launches for c in counters}, len(cuda_calls))


def check_roles_bits(K1, args, drop, qr, kr):
    """K2 at a pack (``args``: ``_k2``'s first ten) with its dq and dk/dv
    roles launched alone, each after its own pre-pass run: the
    gradients bit-equal to the one launch's. Returns the verdict."""
    kw = dict(drop=drop, qr=qr, kr=kr)
    whole = K1._k2(*args, **kw)
    work = K1._k2(*args, parts=K1.PREPASS, **kw)[3]
    alone = (K1._k2(*args, parts=K1.DQ, work=work, **kw)[0],
             *K1._k2(*args, parts=K1.DKV, work=work, **kw)[1:3])
    return dict(roles_alone_bits_equal=all(
        torch.equal(a, b) for a, b in zip(whole[:3], alone)))


def check_varlen_pack(dev, results, dt, pack, q_lens, k_lens, H, D, p,
                      counters, timed=False):
    """The pack ``pack`` (sequences of ``q_lens`` q rows and ``k_lens``
    keys) through ``varlen_main_path``, then K1's output and K2's
    gradients against the plain version on the same frontier arrays, per
    64-position tile (bf16 2e-2, fp32 1e-4). Appends the forward and
    backward rows (timed at the pack: CUDA graphs of the K1 and K2
    calls and of K2's parts, the plain version by events, the library's
    varlen flash forward and backward by CUDA graphs,
    ``_varlen_library``; and ``check_roles_bits``'s verdict). Returns the
    main path's launches."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    q, k, v, do, cu_q, cu_k = _varlen_pack(dev, dt, k_lens, H, D,
                                           13 + len(k_lens), q_lens)
    Tq, Tk = q.shape[0], k.shape[0]
    out, grads, launches, dense_calls = varlen_main_path(
        q, k, v, do, cu_q, cu_k, p, counters)
    _expect_launches(launches, {
        "flash_attention_fwd": 1, "flash_attention_bwd": 1,
        "flash_attention_fwd_varlen": 1, "flash_attention_bwd_varlen": 1,
        "flash_attention_fwd_dropout": int(bool(p)),
        "flash_attention_bwd_dropout": int(bool(p))}, "varlen main path")
    if dense_calls:
        raise AssertionError(f"varlen main path: flash_attention_dense ran "
                             f"{dense_calls} times on CUDA")
    seed = VARLEN_SEED if p else None
    qr, kr = A.varlen_ranges(cu_q, cu_k, Tq, Tk, True, dev)
    q4, k4, v4, do4 = (t[None] for t in (q, k, v, do))
    kw = dict(dropout=p, seed=seed, q_ranges=qr)
    r_out = K1.flash_attention_dense(q4, k4, v4, **kw)[0]
    eo = _errs(out[None], r_out)
    r_grads = K1.flash_attention_bwd_dense(q4, k4, v4, do4, **kw)
    eg = [_errs(a[None], b) for a, b in zip(grads, r_grads)]
    if timed:   # the yardstick held to the plain version on the pack at
        # p = 0 (the same op and pack carry the dropout pack's time)
        lib_fwd, lib_bwd = _varlen_library(
            q, k, v, do, cu_q, cu_k, p, *(() if p else (r_out, r_grads)))
    del r_out, r_grads
    (fb, ff), (bb, bf), pairs = _varlen_cost(qr, H, D, q.element_size(), Tq,
                                             Tk)
    base = dict(case=pack, shape=[1, Tq, H, D], skv=Tk, kv_heads=H,
                causal=True, dropout=p, dtype=str(dt)[6:], tol=TOL[dt],
                q_lens=q_lens, k_lens=k_lens, visible_pairs=pairs,
                launches_main_path=launches)
    fwd = dict(base, name="flash_attention_fwd_varlen", bytes=fb, flops=ff,
               max_abs_err=eo[0], ref_max_abs=eo[1], rel_err=eo[3])
    bwd = dict(base, name="flash_attention_bwd_varlen", bytes=bb, flops=bf,
               max_abs_err=max(e[0] for e in eg),
               ref_max_abs=[e[1] for e in eg], rel_err=max(e[3] for e in eg))
    if p:
        fwd["ptxas"] = drop_ptxas("fwd", D, dt, ranges=True)
        bwd["ptxas"] = drop_ptxas("bwd", D, dt, ranges=True)
    if timed:
        kk = dict(dropout=p, seed=seed, q_ranges=qr, kv_ranges=kr)
        o4, lse = K1.flash_attention_fwd_lse(q4, k4, v4, **kk)
        lib = (f"torch.ops.aten._flash_attention_{{}} on cu_seqlens, causal "
               f"(FlashAttention's bottom-right rule per sequence), "
               f"dropout_p={p}: the op torch.nn.attention.varlen.varlen_attn "
               f"runs (at dropout 0)")
        for rec, (nb, nf), name, f in ((fwd, (fb, ff), "forward", lib_fwd),
                                       (bwd, (bb, bf), "backward", lib_bwd)):
            rec["bound_ms"], rec["bound_by"] = bound(nb, nf, dt)
            rec["library_ms"] = cuda_ms(f)
            rec["library"] = lib.format(name)
        fwd["ms"] = cuda_ms(lambda: K1.flash_attention_fwd_lse(q4, k4, v4,
                                                               **kk))
        fwd["plain_ms"] = events_ms(lambda: K1.flash_attention_dense(
            q4, k4, v4, **kw), iters=3, warm=1)
        bwd["ms"] = cuda_ms(lambda: K1.flash_attention_bwd(
            q4, k4, v4, o4, lse, do4, **kk))
        bwd["plain_ms"] = events_ms(lambda: K1.flash_attention_bwd_dense(
            q4, k4, v4, do4, **kw), iters=3, warm=1)
        drop = K1._drop_args(p, seed, "K2")
        bwd.update(_k2_split(K1, q4, k4, v4, o4, lse, do4, False, None, None,
                             drop, qr=qr, kr=kr))
        bwd.update(check_roles_bits(
            K1, (q4, k4, v4, o4, lse, do4, False, 1.0 / D ** 0.5, None,
                 None), drop, qr, kr))
        del o4, lse
    for rec in (fwd, bwd):
        log("[varlen] " + json.dumps(rec))
        if not rec["rel_err"] <= rec["tol"]:
            raise AssertionError(f"{rec['name']} {rec['case']} p={p} "
                                 f"{rec['dtype']}: {rec['rel_err']} > "
                                 f"{rec['tol']}")
        if not rec.get("roles_alone_bits_equal", True):
            raise AssertionError(f"{rec['name']} {rec['case']} p={p}: K2's "
                                 f"roles alone differ from its one launch")
    results += [fwd, bwd]
    torch.cuda.empty_cache()
    return launches


def check_varlen_mask(dev):
    """The dropout mask read back bit for bit through the frontier arrays:
    a causal pack of 8 sequences whose q and k boundaries differ (k 28,
    24, ..., 6 keys, each q the last half: Tk = 124 <= D), V's rows the
    identity, so K1's output is non-zero exactly where the plain mask
    (batch row 0, packed rows and keys) keeps a pair the frontiers let
    through; dO's rows the identity too, K2's dV gives it on S^T. bf16 at
    D = 128 and fp32 at D = 128."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops.kernels import dropout_mask as DM
    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    k_lens = [28, 24, 20, 16, 12, 10, 8, 6]
    summary = []
    for dt in (torch.bfloat16, torch.float32):
        D, H, P = 128, 4, DROPOUT_P
        q, k, _, _, cu_q, cu_k = _varlen_pack(dev, dt, k_lens, H, D, 31)
        Tq, Tk = q.shape[0], k.shape[0]
        eye = torch.eye(D, device=dev, dtype=dt)
        v = eye[:Tk, None, :].expand(Tk, H, D).contiguous()
        qr, kr = A.varlen_ranges(cu_q, cu_k, Tq, Tk, True, dev)
        vis = K1.ranges_keep(qr, Tk)[:, None]               # [1, 1, Tq, Tk]
        keep = DM.dropout_keep(VARLEN_SEED, P, 1, H, Tq, Tk, dev)
        kw = dict(dropout=P, seed=VARLEN_SEED, q_ranges=qr, kv_ranges=kr)
        out, lse = K1.flash_attention_fwd_lse(q[None], k[None], v[None],
                                              **kw)
        got = (out[..., :Tk] != 0).permute(0, 2, 1, 3)
        dout = eye[:Tq, None, :].expand(Tq, H, D)[None].contiguous()
        _, _, dv = K1.flash_attention_bwd(q[None], k[None], v[None], out, lse,
                                          dout, **kw)
        gotv = (dv[..., :Tq] != 0).permute(0, 2, 3, 1)
        summary.append(dict(
            dtype=str(dt)[6:], visible=int(vis.sum()) * H,
            kept=int((keep & vis).sum().item()),
            fwd_mismatch=int(((got != keep) & vis).sum().item()),
            fwd_masked_nonzero=int((got & ~vis).sum().item()),
            dv_mismatch=int(((gotv != keep) & vis).sum().item())))
    log("[varlen] dropout mask of a causal pack (k lengths "
        f"{k_lens}, q the last halves) read back from K1's output and K2's "
        "dV: " + json.dumps(summary))
    if any(r["fwd_mismatch"] or r["fwd_masked_nonzero"] or r["dv_mismatch"]
           for r in summary):
        raise AssertionError(f"the pack's dropout mask differs: {summary}")


# the mma bodies' timed shapes (bf16, causal; [B, S, H, D]): gpt_tiny's
# attention, a D = 32 head, and Pythia-31m's attention at its full context
# (EleutherAI's config: hidden 256 in 8 heads of 32, 2048 positions) with
# its D = 16 twin, where the work, not the launch, sets the time
MMA_SHAPES = (TINY_SHAPE, [4, 512, 8, 32], [8, 2048, 8, 32],
              [8, 2048, 8, 16])


def check_mma_dropout(dev, results):
    """bf16 attention on the mma.sync bodies (D = 16, 32) at MMA_SHAPES,
    causal, without and with dropout (p = 0.1): K1 and K2 against the
    plain version with the same seed (2e-2 per tile, K1's lse too), timed
    beside the plain version and SDPA with and without dropout_p (CUDA
    graphs, as the kernels: at the small shapes a call is tens of
    microseconds, below what events around eager launches can time; the
    yardstick only), with the bound (``_flash_cost``), K2's dq and dk/dv
    roles timed apart (``_k2_split``) and each row's instances' ptxas
    registers and spills; then the mask read back at D = 16 and 32
    (``check_dropout_mask``)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    g = torch.Generator(device=dev).manual_seed(16)
    dt = torch.bfloat16
    for B, S, H, D in MMA_SHAPES:
        q, k, v, do, _, _ = _flash_inputs(dev, dt, B, S, S, H, H, D, False, g)
        (fb, ff), (bb, bf) = _flash_cost(q, k, True, None, None)
        qt, kt, vt, skw = _sdpa_args(q, k, v, True, None, None)
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        dot = do.transpose(1, 2).contiguous()
        for p in (0.0, DROPOUT_P):
            kw = dict(dropout=p, seed=DROPOUT_SEED + 16 if p else None)
            out, lse = K1.flash_attention_fwd_lse(q, k, v, True, **kw)
            grads = K1.flash_attention_bwd(q, k, v, out, lse, do, True, **kw)
            r_out, r_lse = K1.flash_attention_dense(q, k, v, True, **kw)
            eo = _errs(out, r_out)
            eg = [_errs(a, b) for a, b in zip(
                grads, K1.flash_attention_bwd_dense(q, k, v, do, True, **kw))]
            lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, dropout_p=p, **skw))
            lib_fwd_bwd = cuda_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(qg, kg, vg, dropout_p=p,
                                               **skw), (qg, kg, vg), dot))
            name = "_dropout_mma" if p else "_mma"
            base = dict(case=f"mma_d{D}", shape=[B, S, H, D], skv=S,
                        kv_heads=H, causal=True, dropout=p, dtype="bfloat16",
                        tol=TOL[dt], body="mma")
            fwd = dict(base, name="flash_attention_fwd" + name, bytes=fb,
                       flops=ff, max_abs_err=eo[0], rel_err=eo[3],
                       ptxas=drop_ptxas("fwd", D, dt, drop=bool(p)),
                       lse_abs_err=(lse - r_lse).abs().max().item(),
                       ms=cuda_ms(lambda: K1.flash_attention_fwd_lse(
                           q, k, v, True, **kw)),
                       plain_ms=cuda_ms(lambda: K1.flash_attention_dense(
                           q, k, v, True, **kw), iters=3, warm=1),
                       library_ms=lib_fwd,
                       library=f"F.scaled_dot_product_attention forward, "
                               f"dropout_p={p} (CUDA graph)")
            bwd = dict(base, name="flash_attention_bwd" + name, bytes=bb,
                       flops=bf, max_abs_err=max(e[0] for e in eg),
                       rel_err=max(e[3] for e in eg),
                       ptxas=drop_ptxas("bwd", D, dt, drop=bool(p)),
                       ms=cuda_ms(lambda: K1.flash_attention_bwd(
                           q, k, v, out, lse, do, True, **kw)),
                       plain_ms=events_ms(
                           lambda: K1.flash_attention_bwd_dense(
                               q, k, v, do, True, **kw), iters=3, warm=1),
                       library_ms=lib_fwd_bwd - lib_fwd,
                       library_fwd_bwd_ms=lib_fwd_bwd,
                       library=f"backward of F.scaled_dot_product_attention, "
                               f"dropout_p={p}: a CUDA graph of the forward "
                               f"and autograd.grad less one of the forward",
                       **_k2_split(K1, q, k, v, out, lse, do, True, None,
                                   None, K1._drop_args(p, kw["seed"], "K2"),
                                   mma=True))
            for rec, (nb, nf) in ((fwd, (fb, ff)), (bwd, (bb, bf))):
                rec["bound_ms"], rec["bound_by"] = bound(nb, nf, dt)
                log("[varlen] " + json.dumps(rec))
                if not (rec["rel_err"] <= rec["tol"]
                        and rec.get("lse_abs_err", 0.0) <= rec["tol"]):
                    raise AssertionError(f"{rec['name']} {rec['shape']}: "
                                         f"{rec['rel_err']} > {rec['tol']}")
            results += [fwd, bwd]
            del out, lse, grads, r_out, r_lse
        del qg, kg, vg, q, k, v, do, qt, kt, vt, dot
        torch.cuda.empty_cache()
    check_dropout_mask(dev, ((16, torch.bfloat16, 2),
                             (32, torch.bfloat16, 4)), tag="varlen")


def phase_varlen(dev, results, counters):
    """Phase 13: the VARLEN_PACKS packs at gpt_1p3b's attention widths (H
    16, D 128, bf16) through flash_attn_unpadded without and with
    dropout 0.1, checked and timed; the same checks in fp32 at a small
    pack (k 160, 96, 64, 32; H 4, D 64, 1e-4); a pack's mask read back;
    the mma bodies' dropout instances. Returns the launches by path (a
    pack's name, "_dropout" added with dropout)."""
    out = {}
    for p in (0.0, DROPOUT_P):
        for name, (q_lens, k_lens) in VARLEN_PACKS.items():
            out[name + "_dropout" * bool(p)] = check_varlen_pack(
                dev, results, torch.bfloat16, name, q_lens, k_lens, 16, 128,
                p, counters, timed=True)
        check_varlen_pack(dev, results, torch.float32, "small",
                          [80, 48, 32, 16], [160, 96, 64, 32], 4, 64, p,
                          counters)
    check_varlen_mask(dev)
    check_mma_dropout(dev, results)
    log("[varlen] every pack within tolerance, on K1/K2 with the frontier "
        "arrays and never the plain version: OK")
    return out


# -- phase 14: the rest of the degree-1 training surface ---------------------
SPARSE_SHAPE = (50304, 2048)    # Embedding(sparse=True) at GPT's vocab


def _smoothed_ce(logits, labels, eps):
    """torch's own f32 cross entropy with label smoothing, mean over the
    labels that are not -100: the JAX formula's value (smoothing over
    n_class, the mean over valid labels), computed another way."""
    return torch.nn.functional.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]), labels.reshape(-1),
        ignore_index=-100, label_smoothing=eps)


def surface_gpt(counters, steps=8, warm=4):
    """14.1 and 14.2: gpt_1p3b trained by the trainer on cross_entropy with
    label smoothing 0.1 and every 97th label at ignore_index; then one
    step under collect_operator_stats, one under the tensor checker, and
    one with a NaN in a weight that must raise."""
    from paddle_tpu_torch.amp import debugging
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_1p3b
    from paddle_tpu_torch.nn import functional as PF

    cfg = gpt_1p3b(dtype="bfloat16")
    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    crit = lambda logits, y: PF.cross_entropy(logits, y,  # noqa: E731
                                              label_smoothing=0.1)
    opt, step = _trainer(model, crit=crit)
    batch = _lm_batch(21, 4, 2048, cfg.vocab_size, model.device)
    batch["y"].view(-1)[::97] = -100
    losses, secs = [], []
    for i in range(steps):
        if i == warm:
            for c in counters:
                c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(batch)))
        secs.append(time.perf_counter() - t0)
    launches = {c.__name__: c.launches for c in counters}
    n, L = steps - warm, cfg.num_layers
    want = {"flash_attention_fwd": L * n, "flash_attention_bwd": L * n,
            "fused_adam": n}
    with torch.no_grad():
        logits = model(batch["x"])
        ours = float(PF.cross_entropy(logits, batch["y"],
                                      label_smoothing=0.1))
        ref = float(_smoothed_ce(logits, batch["y"], 0.1))
    del logits
    rel = abs(ours - ref) / abs(ref)
    log("[train-surface] gpt_1p3b, cross_entropy(label_smoothing=0.1, "
        f"{int((batch['y'] == -100).sum())} labels ignored): " + json.dumps(
            dict(losses=losses, step_ms=[t * 1e3 for t in secs],
                 step_ms_p50=float(np.percentile(secs[warm:], 50)) * 1e3,
                 launches=launches, loss_port=ours, loss_torch_f32=ref,
                 rel=rel)))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train-surface losses: {losses}")
    _expect_launches(launches, want, "train-surface gpt_1p3b")
    if rel > 1e-5:
        raise AssertionError(f"train-surface: loss off by {rel}")
    base_ms = secs[-1] * 1e3
    debugging.enable_operator_stats_collection()
    try:
        step(batch)
        torch.cuda.synchronize()
    finally:
        stats = debugging.disable_operator_stats_collection()
    mm = {op: n for op, by in stats.items() for dt, n in by.items()
          if dt == "bfloat16" and op in ("mm", "addmm", "bmm", "matmul")}
    k12 = {op: dict(stats.get(op, {})) for op in ("flash_attention_fwd",
                                                   "flash_attention_bwd")}
    log(f"[train-surface] operator stats of one step: {len(stats)} ops; "
        f"bf16 matmuls {json.dumps(mm)}; K1/K2 {json.dumps(k12)}")
    if not mm or any(sum(v.values()) != L for v in k12.values()):
        raise AssertionError(f"operator stats miss the bf16 matmuls or K1/K2 "
                             f"({L} each): {mm}, {k12}")
    checker = debugging.TensorCheckerConfig()
    debugging.enable_tensor_checker(checker)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        checked_ms = (time.perf_counter() - t0) * 1e3
    finally:
        debugging.disable_tensor_checker()
    log(f"[train-surface] a clean step under the tensor checker: no raise, "
        f"{checked_ms:.1f} ms (without it {base_ms:.1f} ms)")
    with torch.no_grad():    # written with the checker off: it is a NaN
        model.gpt.layers[1].mlp.fc1.weight.view(-1)[7] = float("nan")
    debugging.enable_tensor_checker(checker)
    try:
        try:
            step(batch)
        except FloatingPointError as e:
            log(f"[train-surface] a NaN in layer 1's fc1 weight: {e}")
            if "op '" not in str(e):
                raise AssertionError(f"the checker's error names no op: {e}")
        else:
            raise AssertionError("a NaN weight passed the tensor checker")
    finally:
        debugging.disable_tensor_checker()
    return launches


def surface_sparse(dev):
    """14.3: Embedding(50304, 2048, sparse=True) (f32) on the ids of a
    4 x 2048 batch. SGD (rate 1) and Adam(lazy_mode=True) (rate 0.01), 5
    steps each, card against CPU within 1e-5, and Adam(lazy_mode=False)
    against the dense-gradient Adam within 1e-6, on the loss sum(e(ids) *
    G) for a fixed G: its
    weight gradient (G's rows summed over repeated ids) is the same on
    both sides, where a forward through a matmul would hand Adam, which
    turns a gradient's rounding near zero into a whole step
    (g / (|g| + eps)), cuBLAS's and MKL's rounding to compare. SGD with
    ClipGradByGlobalNorm over the sparse embedding and a dense Linear
    (the same loss + sum((Linear(X) - T)^2) / 8 for a fixed X) against
    the all-dense model within 1e-6 (weights and global norm). Weights
    are compared as the repo's optimizer checks compare them (K8's,
    tests/test_torch_fused_optimizer.py): the largest difference over the
    tensor's largest magnitude. On the card a repeated id's gradient sums
    by atomics, so its rounding, and the weights' last bits, vary from
    run to run (3.0e-7 and 1.2e-6 of the largest change in two runs).
    Adam's step hardly depends on its gradient's scale (m / sqrt(v)), so
    both Adam comparisons also hold its moments at the looked-up rows to
    the same bars, over their own largest magnitudes: the moments are
    linear (moment1) and quadratic (moment2) in the gradient, so a wrong
    scale (a repeated id counted twice, say) shows there."""
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn.common import Embedding
    from paddle_tpu_torch.optimizer import SGD, Adam

    torch.backends.cuda.matmul.allow_tf32 = False
    V, Hd = SPARSE_SHAPE
    ids = torch.tensor(np.random.RandomState(22).randint(0, V, (4, 2048)))
    G = torch.tensor(np.random.RandomState(27).randn(4, 2048, Hd).astype(
        np.float32))
    X = torch.tensor(np.random.RandomState(23).randn(4, 2048, 8).astype(
        np.float32))
    T = torch.tensor(np.random.RandomState(26).randn(4, 2048, 1).astype(
        np.float32))
    w0 = Embedding(V, Hd, padding_idx=-1, device="cpu",
                   generator=torch.Generator().manual_seed(24)).weight.detach()
    touched = ids.unique()

    def run(where, sparse, make, clip=None, steps=5):
        emb = Embedding(V, Hd, padding_idx=-1, sparse=sparse, device=where)
        with torch.no_grad():
            emb.weight.copy_(w0.to(where))
        lin = None if clip is None else torch.nn.Linear(8, 1, device=where)
        params = list(emb.parameters())
        if lin is not None:
            with torch.no_grad():
                lin.weight.fill_(0.5)
                lin.bias.fill_(0.1)
            params += list(lin.parameters())
        opt = make(params, clip)
        x = ids.to(where)
        for _ in range(steps):
            loss = (emb(x) * G.to(where)).sum()
            if lin is not None:
                loss = loss + (lin(X.to(where)) - T.to(where)).square(
                    ).sum() / 8
            loss.backward()
            opt.step()
            opt.clear_grad()
        st = opt.state_dict()
        moments = {m: st[f"param_0.{m}"][touched.to(where)].cpu()
                   for m in ("moment1", "moment2") if f"param_0.{m}" in st}
        return emb.weight.detach().cpu(), opt.grad_norm, moments

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def rel_moments(a, b):
        return {m: rel(a[2][m], b[2][m]) for m in ("moment1", "moment2")}

    sgd = lambda ps, c: SGD(1.0, parameters=ps, grad_clip=c)  # noqa: E731
    lazy = lambda ps, c: Adam(0.01, parameters=ps,  # noqa: E731
                              lazy_mode=True)
    dense_adam = lambda ps, c: Adam(0.01, parameters=ps)  # noqa: E731
    out = {"sgd_card_vs_cpu": rel(run(dev, True, sgd)[0],
                                  run("cpu", True, sgd)[0])}
    a, b = run(dev, True, lazy), run("cpu", True, lazy)
    out["adam_lazy_card_vs_cpu"] = rel(a[0], b[0])
    out["adam_lazy_moments_card_vs_cpu"] = rel_moments(a, b)
    a, b = run(dev, True, dense_adam), run(dev, False, dense_adam)
    out["adam_densified_vs_dense"] = rel(a[0], b[0])
    out["adam_densified_moments_vs_dense"] = rel_moments(a, b)
    (a, na, _), (b, nb, _) = (run(dev, sp, sgd, ClipGradByGlobalNorm(1.0))
                              for sp in (True, False))
    out["clip_mixed_vs_dense"] = dict(weights=rel(a, b),
                                      norms=[float(na), float(nb)])
    log("[train-surface] sparse embedding 50304 x 2048 f32: "
        + json.dumps(out))
    if not (out["sgd_card_vs_cpu"] <= 1e-5
            and out["adam_lazy_card_vs_cpu"] <= 1e-5
            and max(out["adam_lazy_moments_card_vs_cpu"].values()) <= 1e-5
            and out["adam_densified_vs_dense"] <= 1e-6
            and max(out["adam_densified_moments_vs_dense"].values()) <= 1e-6
            and out["clip_mixed_vs_dense"]["weights"] <= 1e-6
            and abs(float(na) - float(nb)) <= 1e-6 * float(nb)):
        raise AssertionError(f"train-surface sparse: {out}")


def surface_tiny(counters, p, steps=3):
    """14.4: gpt_tiny in bf16 (head dim 16: the mma.sync bodies) with
    hidden and attention dropout ``p`` (0.1: their dropout instances; 0:
    the others), 3 AdamW steps on an 8 x 128 batch: finite losses, K1 and
    K2 launched once a layer a step, each a dropout variant iff p > 0."""
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             GPTPretrainingCriterion,
                                             gpt_tiny)

    cfg = gpt_tiny(dtype="bfloat16", hidden_dropout=p, attention_dropout=p)
    model = GPTForCausalLM(cfg, device="cuda", seed=3)
    opt, step = _trainer(model, crit=GPTPretrainingCriterion(cfg))
    batch = _lm_batch(25, TINY_SHAPE[0], TINY_SHAPE[1], cfg.vocab_size,
                      model.device)
    for c in counters:
        c.launches = 0
    losses = [float(step(batch)) for _ in range(steps)]
    launches = {c.__name__: c.launches for c in counters}
    log(f"[train-surface] gpt_tiny bf16, dropout {p} (D = 16): losses "
        f"{losses}, launches {launches}")
    n = steps * cfg.num_layers
    if not all(np.isfinite(losses)):
        raise AssertionError(f"gpt_tiny with dropout {p}: losses {losses}")
    m = n if p else 0
    _expect_launches(launches, {"flash_attention_fwd": n,
                                "flash_attention_bwd": n,
                                "flash_attention_fwd_dropout": m,
                                "flash_attention_bwd_dropout": m},
                     f"gpt_tiny with dropout {p}")
    return launches


def surface_hook_cost(calls=200000):
    """14.5: the host cost of ``counted``'s wrapper with amp.debugging off
    (``after_call`` None): a wrapped no-op against the bare one, each
    timed over ``calls`` calls (best of 3) on the host's clock."""
    from paddle_tpu_torch.ops import kernels

    def noop(*a):
        return a

    wrapped = kernels.hooked(noop)
    if kernels.after_call is not None:
        raise AssertionError("amp.debugging's hook is still installed")
    x = torch.empty(1, device="cuda")

    def best(fn):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(x, x, x)
            ts.append(time.perf_counter() - t0)
        return min(ts) / calls * 1e9

    bare, hooked = best(noop), best(wrapped)
    log(f"[train-surface] counted's wrapper with the hooks off: "
        f"{hooked - bare:.1f} ns a kernel call over the bare call "
        f"({hooked:.1f} vs {bare:.1f} ns, a no-op body, {calls} calls, "
        f"best of 3, host clock)")


def phase_train_surface(dev, paths):
    """Phase 14 (14.1 to 14.5 above). Returns the launches by path."""
    surface_hook_cost()
    out = {"train_surface": surface_gpt(paths["train_surface"])}
    gc.collect()
    torch.cuda.empty_cache()
    surface_sparse(dev)
    gc.collect()
    torch.cuda.empty_cache()
    out["train_surface_tiny_plain"] = surface_tiny(
        paths["train_surface_tiny_plain"], 0.0)
    out["train_surface_tiny"] = surface_tiny(paths["train_surface_tiny"],
                                             DROPOUT_P)
    log("[train-surface] cross_entropy options, operator stats, the tensor "
        "checker, sparse embedding updates and D = 16 dropout training: OK")
    return out


# -- phase 15: checkpoints and telemetry ------------------------------------
def _ckpt_trainer(cfg, seed, device):
    """gpt_1p3b-width training as a user builds it: AdamW with f32 masters,
    clip 1.0, a warmup-then-cosine schedule, through ParallelEngine."""
    from paddle_tpu_torch.distributed.engine import ParallelEngine
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             GPTPretrainingCriterion)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr

    model = GPTForCausalLM(cfg, device=device, seed=seed)
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(3e-4, T_max=8),
                            warmup_steps=2, start_lr=3e-5, end_lr=3e-4)
    opt = AdamW(learning_rate=sched, weight_decay=0.01,
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0),
                parameters=model.parameters())
    crit = GPTPretrainingCriterion(cfg)
    eng = ParallelEngine(model, opt)
    return model, opt, eng, eng.train_step(
        lambda m, b: crit(m(b["x"]), b["y"]))


def _ckpt_state(model, opt):
    """{name: tensor} of everything a resume must reproduce: parameters,
    masters, moments, and both dropout generators' states."""
    out = {f"param {n}": p.detach() for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        if id(p) in opt._master_weights:
            out[f"master {n}"] = opt._master_weights[id(p)]
        for k, v in opt._states.get(id(p), {}).items():
            out[f"{k} {n}"] = v
    out["hidden dropout generator"] = \
        model.gpt.embeddings.dropout.generator.get_state()
    out["attention dropout generator"] = \
        model.gpt.layers[0].attn._attn_gen.get_state()
    return out


def _ckpt_anatomy(eng, tmp, cuda, reps=200):
    """Seconds of a synchronous save's parts (device-to-host copy, the
    crc32s, the npz write, its fsync) on the engine's state, and
    microseconds of the per-step telemetry's parts over ``reps`` calls."""
    import os

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed.checkpoint.save_state_dict import (
        collect_shards, crc32_all)
    from paddle_tpu_torch.distributed.engine import _Scalars
    from paddle_tpu_torch.observability import healthmon

    out = {}
    t0 = time.perf_counter()
    _, shards, _ = collect_shards(eng._checkpoint_state()[0])
    t1 = time.perf_counter()
    crc32_all(shards.values())
    t2 = time.perf_counter()
    path = str(Path(tmp) / "anatomy.npz")
    with open(path, "wb") as f:
        np.savez(f, **shards)
        t3 = time.perf_counter()
        f.flush()
        os.fsync(f.fileno())
    t4 = time.perf_counter()
    os.remove(path)
    del shards
    out["save_s"] = dict(device_to_host=t1 - t0, crc32=t2 - t1,
                         npz_write=t3 - t2, fsync=t4 - t3)
    dev = eng.device
    x = torch.ones((), device=dev)
    mon = healthmon.HealthMonitor(flight_on_spike=False)

    def us(fn):
        fn()
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) / reps * 1e6

    out["telemetry_us"] = dict(
        scalars_to_host=us(lambda: _Scalars((x, x, None), 0)),
        allocator_stats=us(lambda: torch.cuda.memory_stats(dev))
        if cuda else 0.0,
        registry_snapshot=us(lambda: obs.get_registry().snapshot()),
        health_observe=us(lambda: mon.observe(loss=1.0, grad_norm=1.0,
                                              step_seconds=0.1)))
    return out


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).iterdir())


def phase_train_ckpt(counters, layers=4, steps=8, device="cuda", cfg=None,
                     B=4, S=2048):
    """Phase 15 (module docstring): run A with a synchronous checkpoint
    after step 4 and an async one after step 6, run B resumed from step 4
    and held to A bit for bit, a failed commit, the telemetry checks.
    Returns run A's launches. ``device="cpu"`` with a small ``cfg`` is a
    dry run of the same logic, without the checks only a card can pass
    (kernel launches, allocator gauges, MFU)."""
    import dataclasses
    import shutil
    import tempfile
    import urllib.request

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed import failpoints as fp
    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         latest_committed)
    from paddle_tpu_torch.models.gpt import gpt_1p3b
    from paddle_tpu_torch.observability import catalog, goodput, healthmon
    from paddle_tpu_torch.ops.kernels import flash_attention as K1
    from paddle_tpu_torch.ops.kernels.fused_adam import fused_adam

    cuda = device == "cuda"
    cfg = cfg or dataclasses.replace(
        gpt_1p3b(dtype="bfloat16", hidden_dropout=0.1,
                 attention_dropout=0.1), num_layers=layers)
    batches = [_lm_batch(300 + i, B, S, cfg.vocab_size, device)
               for i in range(steps)]
    tmp = tempfile.mkdtemp(prefix="train_ckpt_")
    base = str(Path(tmp) / "run")
    c4 = str(Path(tmp) / "step4")
    obs.reset_registry()
    goodput.detach()
    out = {}
    try:
        mgr = CheckpointManager(base, keep_last_k=2, async_save=True)
        led = goodput.current()
        model, opt, eng, step = _ckpt_trainer(cfg, 0, device)
        # the telemetry's host cost: its per-step calls, timed
        host = []

        def timed(fn):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    host.append(time.perf_counter() - t0)
            return wrapper

        eng._note_step = timed(eng._note_step)
        eng._flush_pending_scalars = timed(eng._flush_pending_scalars)
        for c in counters:
            c.launches = 0
        losses, norms, entries = [], [], []
        for i in range(steps):
            if cuda:
                torch.cuda.synchronize()
            entries.append(time.perf_counter())
            losses.append(float(step(batches[i])))
            norms.append(float(opt.grad_norm))
            if i == 3:
                t0 = time.perf_counter()
                eng.save_checkpoint(c4)
                out["sync_save_s"] = time.perf_counter() - t0
                gold4 = {k: v.clone() for k, v in
                         _ckpt_state(model, opt).items()}
            if i == 5:
                t0 = time.perf_counter()
                eng.save_checkpoint(manager=mgr)
                out["async_stall_s"] = time.perf_counter() - t0
                gold6 = {n: p.detach().clone()
                         for n, p in model.named_parameters()}
        launches = {c.__name__: c.launches for c in counters}
        telemetry_us = sum(host) / steps * 1e6
        t0 = time.perf_counter()
        mgr.wait()
        out["async_wait_s"] = time.perf_counter() - t0
        snap = eng.metrics_snapshot()["metrics"]
        ck = snap["paddle_tpu_ckpt_save_seconds"]["series"]
        out["async_write_s"] = next(r["value"] for r in ck
                                    if r["labels"]["phase"] == "write")
        out["bytes"] = _dir_bytes(c4)
        gold = _ckpt_state(model, opt)

        # -- telemetry --------------------------------------------------
        def one(name):
            return snap[name]["series"][0]["value"]

        n = cfg.num_params()
        tps = B * S / (entries[-1] - entries[-2])
        want_mfu = (6 * n + 12 * cfg.num_layers * cfg.hidden_size * S) \
            * tps / 989e12
        mem = {r["labels"]["stat"] for r in snap.get(
            "paddle_tpu_device_memory_bytes", {"series": []})["series"]}
        mon = healthmon.HealthMonitor(warmup=2, flight_on_spike=False)
        with fp.scoped("health.loss_spike=corrupt@3"):
            spikes = [e["kind"] for i in range(3) for e in mon.observe(
                loss=losses[i], grad_norm=norms[i], step=i + 1)]
        with obs.serve_metrics(0) as srv:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/metrics",
                    timeout=30) as resp:
                text = resp.read().decode()
        typed = {ln.split()[2] for ln in text.splitlines()
                 if ln.startswith("# TYPE ")}
        train_names = {m.name for m in catalog.train_metrics(
            obs.MetricsRegistry()).values()}
        schema = json.loads(Path(catalog.SCHEMA_PATH).read_text())
        tel = dict(steps=one("paddle_tpu_train_steps_total"),
                   tokens=one("paddle_tpu_train_tokens_total"),
                   loss=one("paddle_tpu_train_loss"),
                   mfu=one("paddle_tpu_train_mfu"), mfu_formula=want_mfu,
                   device_memory=sorted(mem),
                   health_events=eng._health.event_count(),
                   injected=spikes, scraped_train_names=len(
                       train_names & typed), telemetry_host_us=telemetry_us)
        log("[train-ckpt] run A " + json.dumps(dict(
            config="gpt_1p3b", layers=cfg.num_layers,
            params=n, dropout=0.1, batch=[B, S], losses=losses,
            launches=launches, **tel)))
        bad = []
        if tel["steps"] != steps or tel["tokens"] != steps * B * S:
            bad.append(f"steps / tokens {tel['steps']} / {tel['tokens']}")
        if tel["loss"] != losses[-1]:
            bad.append(f"loss gauge {tel['loss']} != {losses[-1]}")
        if cuda and not abs(tel["mfu"] - want_mfu) <= 0.02 * want_mfu:
            bad.append(f"mfu {tel['mfu']} against {want_mfu}")
        if cuda and mem != {"bytes_in_use", "peak_bytes_in_use",
                            "bytes_limit"}:
            bad.append(f"device memory gauges {mem}")
        if tel["health_events"] or spikes != ["loss_spike"]:
            bad.append(f"health events {tel['health_events']}, injected "
                       f"{spikes}")
        if not train_names <= typed or not train_names <= set(schema):
            bad.append(f"/metrics lacks {sorted(train_names - typed)}")
        L = cfg.num_layers
        # a dropout launch counts under K1 / K2 and under its variant
        want = {K1.flash_attention_fwd.__name__: L * steps,
                K1.flash_attention_bwd.__name__: L * steps,
                K1.flash_attention_fwd_dropout.__name__: L * steps,
                K1.flash_attention_bwd_dropout.__name__: L * steps,
                fused_adam.__name__: steps}
        if cuda and launches != want:
            bad.append(f"launches {launches}, expected {want}")
        if not all(np.isfinite(losses)):
            bad.append(f"non-finite losses {losses}")
        if bad:
            raise AssertionError("train-ckpt telemetry: " + "; ".join(bad))

        # -- run B: a fresh model from another seed, resumed ---------------
        model_b, opt_b, eng_b, step_b = _ckpt_trainer(cfg, 1, device)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = eng_b.restore_checkpoint(c4)
        if cuda:
            torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        restored = _ckpt_state(model_b, opt_b)
        diff4 = [k for k in gold4 if not torch.equal(gold4[k], restored[k])]
        losses_b = [float(step_b(batches[i])) for i in range(4, steps)]
        got = _ckpt_state(model_b, opt_b)
        diff = [k for k in gold if not torch.equal(gold[k], got[k])]
        lr_a, lr_b = opt._lr.state_dict(), opt_b._lr.state_dict()
        log("[train-ckpt] run B from step 4 " + json.dumps(dict(
            meta_step=meta["step"], losses=losses_b, gold=losses[4:],
            step_count=[opt._step_count, opt_b._step_count],
            lr=[lr_a, lr_b], restored_unequal=len(diff4),
            unequal=len(diff), tensors=len(gold))))
        if diff4 or diff or losses_b != losses[4:] or lr_a != lr_b or \
                opt._step_count != opt_b._step_count or meta["step"] != 4:
            gaps = {k: float((gold[k].float() - got[k].float()).abs().max())
                    for k in diff[:8]}
            raise AssertionError(
                f"the resumed run differs from the uninterrupted one: "
                f"restored {diff4[:4]}, losses {losses_b} against "
                f"{losses[4:]}, largest gaps {gaps}, LR {lr_a} / {lr_b}")
        del gold4, gold, restored, got
        shutil.rmtree(c4)
        log("[train-ckpt] where a save and a step's telemetry go "
            + json.dumps(_ckpt_anatomy(eng, tmp, cuda)))

        # -- a failed commit leaves step 6 the newest, and it restores ------
        raised = False
        with fp.scoped("ckpt.commit=raise"):
            eng_b.save_checkpoint(manager=mgr, step=steps + 1)
            try:
                mgr.wait()
            except fp.FailpointError:
                raised = True
        latest = latest_committed(base)
        meta6 = eng_b.restore_checkpoint(latest)
        bad6 = [n for n, p in model_b.named_parameters()
                if not torch.equal(p, gold6[n])]
        summ = led.summary()["segments"] if led is not None else {}
        log("[train-ckpt] failed commit " + json.dumps(dict(
            raised=raised, latest=Path(latest).name, meta_step=meta6["step"],
            unequal=len(bad6), goodput={k: summ.get(k, 0.0) for k in (
                "compile", "step_compute", "ckpt_stall", "restore")})))
        if not raised or not latest.endswith("step_00000006") or bad6 or \
                meta6["step"] != 6:
            raise AssertionError("a failed commit did not leave step 6 "
                                 "the newest loadable checkpoint")
        if not (summ.get("restore", 0) > 0 and summ.get("ckpt_stall", 0) > 0):
            raise AssertionError(f"goodput journal lacks restore / "
                                 f"ckpt_stall: {summ}")
        mgr.close()
        gb = out["bytes"] / 1e9
        log("[train-ckpt] " + json.dumps(dict(
            checkpoint_bytes=out["bytes"],
            sync_save_s=out["sync_save_s"],
            sync_save_gb_s=gb / out["sync_save_s"],
            async_stall_s=out["async_stall_s"],
            async_stall_gb_s=gb / out["async_stall_s"],
            async_write_s=out["async_write_s"],
            async_write_gb_s=gb / out["async_write_s"],
            restore_s=out["restore_s"], restore_gb_s=gb / out["restore_s"],
            telemetry_host_us_per_step=telemetry_us)))
        log("[train-ckpt] the resume equals the uninterrupted run bit for "
            "bit, the failed commit falls back, telemetry holds: OK")
        return launches
    finally:
        goodput.detach()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 16: hybrid parallelism (tensor and data parallel GPT) -------------
# Each run's ranks are processes the port's launcher starts, sharing the
# one card; their collectives go over gloo (staged through host memory),
# so their times say nothing about NCCL. Run: (mode, ranks, dp, mp,
# layers, dtype, steps, the global batch [B, S]).
HYBRID_RUNS = {
    "mp2-fp32": (2, 1, 2, 2, "float32", 3, (4, 2048)),
    "mp2-bf16": (2, 1, 2, 8, "bfloat16", 5, (4, 2048)),
    "dp2mp2": (4, 2, 2, 4, "bfloat16", 3, (4, 2048)),
}
HYBRID_SEED, HYBRID_BATCH_SEED, HYBRID_ATTN_SEED = 0, 21, 0x48_3021
HYBRID_TIMEOUT_S = 600        # a launch; every gloo group: 300 s


def _hybrid_cfg(layers, dtype, dropout=0.0):
    """gpt_1p3b's widths at ``layers`` layers."""
    import dataclasses

    from paddle_tpu_torch.models.gpt import gpt_1p3b

    return dataclasses.replace(
        gpt_1p3b(dtype=dtype, hidden_dropout=dropout,
                 attention_dropout=dropout), num_layers=layers)


def _hybrid_trainer(model, mesh=None):
    """The hybrid runs' step: AdamW (lr 3e-4, decay 0.01, f32 masters for
    bf16 weights), clip 1.0, through ParallelEngine over ``mesh``."""
    from paddle_tpu_torch.distributed.engine import ParallelEngine
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=3e-4, weight_decay=0.01,
                multi_precision=model.config.dtype != "float32",
                grad_clip=ClipGradByGlobalNorm(1.0),
                parameters=model.named_parameters())
    crit = GPTPretrainingCriterion(model.config)
    eng = ParallelEngine(model, opt, mesh)
    return opt, eng.train_step(lambda m, b: crit(m(b["x"]), b["y"]))


def _hybrid_reference(cfg, steps, B, S, params=False):
    """The degree-1 run a hybrid run is held to: the same model, seed,
    batch and step in one process (the parent). (losses, the parameters
    in the JAX layout on the host, or None)."""
    from paddle_tpu_torch.convert import export_jax_state_dict
    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    model = GPTForCausalLM(cfg, device="cuda", seed=HYBRID_SEED)
    _, step = _hybrid_trainer(model)
    batch = _lm_batch(HYBRID_BATCH_SEED, B, S, cfg.vocab_size, model.device)
    losses = [float(step(batch)) for _ in range(steps)]
    state = export_jax_state_dict(model, tensors=True) if params else None
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    return losses, state


def _launch_ranks(n, mode, out_dir):
    """``python -m paddle_tpu_torch.distributed.launch --nproc_per_node n
    chip_smoke.py --hybrid-rank mode``: fresh processes (the parent holds
    a CUDA context, so none is forked from it), each rank's output in
    out_dir/logs/<mode>/workerlog.<rank>; a rank that fails or hangs
    fails the launch. Returns each rank's result (its JSON file)."""
    logs = out_dir / "logs" / mode
    for f in out_dir.glob(f"{mode}.rank*.json"):
        f.unlink()
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(n), "--log_dir", str(logs),
           str(Path(__file__).resolve()), "--hybrid-rank", mode,
           "--hybrid-dir", str(out_dir)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, start_new_session=True)
    try:
        rc = proc.wait(timeout=HYBRID_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
        rc = "timeout"
    secs = time.perf_counter() - t0
    if rc != 0:
        for f in sorted(logs.glob("workerlog.*")):
            log(f"[train-hybrid] {mode} {f.name}, last lines:\n"
                + "\n".join(f.read_text().splitlines()[-25:]))
        raise AssertionError(f"train-hybrid {mode}: the launcher returned "
                             f"{rc} after {secs:.1f}s")
    res = [json.loads((out_dir / f"{mode}.rank{r}.json").read_text())
           for r in range(n)]
    log(f"[train-hybrid] {mode}: {n} rank(s) in {secs:.1f}s (launch "
        f"included)")
    return res


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def phase_train_hybrid(counters):
    """Phase 16 (see the module docstring): NCCL at world 1; ranks
    sharing the card refused (the port's check and NCCL's own error);
    mp 2 fp32 at 2 layers, mp 2 bf16 at 8 layers (dropout 0, then 0.1)
    and dp 2 x mp 2 bf16 at 4 layers against degree-1 runs of the same
    model in this process. Returns the kernels' launches per rank of the
    runs, by path."""
    out_dir = Path(__file__).resolve().parent / "build" / "hybrid"
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"[train-hybrid] {card}; every multi-rank time below is of ranks "
        f"sharing this one card over gloo (collectives staged through "
        f"host memory): not NCCL's speed")
    r = _launch_ranks(1, "nccl1", out_dir)[0]
    log("[train-hybrid] nccl1 " + json.dumps(r))
    for r in _launch_ranks(2, "nccl-shared", out_dir):
        log("[train-hybrid] nccl-shared " + json.dumps(r))
    launches = {}
    for mode, (n, dp, mp, layers, dtype, steps, (B, S)) in \
            HYBRID_RUNS.items():
        refs = {}
        for p in ((0.0, 0.1) if mode == "mp2-bf16" else (0.0,)):
            cfg = _hybrid_cfg(layers, dtype, p)
            losses, state = _hybrid_reference(cfg, steps, B, S,
                                              params=dtype == "float32")
            refs[str(p)] = losses
            if state is not None:
                torch.save(state, out_dir / f"{mode}.ref.pt")
            log(f"[train-hybrid] {mode} degree-1 reference, dropout {p}: "
                f"losses {losses}")
        (out_dir / f"{mode}.ref.json").write_text(json.dumps(refs))
        res = _launch_ranks(n, mode, out_dir)
        for rk in res:
            log(f"[train-hybrid] {mode} rank {rk['rank']} ({card}): "
                + json.dumps(rk))
        for rk in res[1:]:
            for key in ("losses",):
                if rk[key] != res[0][key]:
                    raise AssertionError(f"{mode}: rank {rk['rank']}'s "
                                         f"{key} differ from rank 0's")
        launches[mode] = [run["launches"] for run in res[0]["runs"]]
        (out_dir / f"{mode}.ref.pt").unlink(missing_ok=True)
    log("[train-hybrid] nccl at world 1, the refusals, mp 2 fp32 / bf16 "
        "and dp 2 x mp 2 within their gates of degree 1; replicated "
        "parameters bit-equal across ranks; launches as expected: OK")
    return {"train_hybrid": launches["mp2-bf16"][0],
            "train_hybrid_dropout": launches["mp2-bf16"][1],
            "train_hybrid_fp32": launches["mp2-fp32"][0],
            "train_hybrid_dp2mp2": launches["dp2mp2"][0]}


# -- the ranks (chip_smoke.py --hybrid-rank MODE, under the launcher) ---------
def _hybrid_world(mode):
    from paddle_tpu_torch.distributed import collective as C

    if mode == "nccl1":
        return C.init_parallel_env(backend="nccl")
    return C.init_parallel_env(backend="gloo", device="cuda", timeout=300)


def _rank_nccl1(out):
    """World 1 on NCCL: every collective of the API on a CUDA tensor is
    the identity (through NCCL), then one GPT step under a degree-1 HCG
    bit-equal to the same step without fleet."""
    from paddle_tpu_torch.convert import export_jax_state_dict
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import compat, fleet
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.observability import commledger as cl

    g = C.get_group(0)
    if not (g.backend == "nccl" and g.process_group is not None
            and torch.distributed.get_backend() == "nccl"):
        raise AssertionError(f"nccl1: world group {g}")
    x = torch.arange(1, 9, dtype=torch.float32, device="cuda").reshape(2, 4)
    checks = {}
    with cl.capture() as led:
        for name, op in (("sum", C.ReduceOp.SUM), ("max", C.ReduceOp.MAX),
                         ("min", C.ReduceOp.MIN), ("prod", C.ReduceOp.PROD),
                         ("avg", C.ReduceOp.AVG)):
            y = x.clone()
            C.all_reduce(y, op)
            checks["all_reduce_" + name] = torch.equal(y, x)
        parts = []
        checks["all_gather"] = torch.equal(C.all_gather(parts, x, axis=1),
                                           x) and len(parts) == 1
        checks["reduce_scatter"] = torch.equal(C.reduce_scatter(x), x)
        checks["all_to_all"] = torch.equal(C.all_to_all(x), x)
        y = x.clone()
        checks["broadcast"] = torch.equal(C.broadcast(y, 0), x)
        y = x.clone()
        checks["reduce"] = torch.equal(C.reduce(y, 0), x)
        y = torch.empty_like(x)
        checks["scatter"] = torch.equal(C.scatter(y, [x], 0), x)
        y = torch.empty_like(x)
        C.send(x, 0)
        checks["send_recv"] = torch.equal(C.recv(y, 0), x)
        checks["ppermute"] = torch.equal(C.ppermute(x, [(0, 0)]), x)
        checks["t_shims"] = all(torch.equal(f(x, g), x) for f in (
            C.t_psum, C.t_pmean, C.t_pmax, C.t_pmin, C.t_all_gather,
            C.t_psum_scatter, C.t_all_to_all))
        checks["alltoall_single"] = torch.equal(
            compat.alltoall_single(None, x), x)
        C.barrier()
        checks["all_gather_object"] = C.all_gather_object([], {"r": 0}) == [
            {"r": 0}]
        checks["broadcast_object_list"] = C.broadcast_object_list(
            [{"a": 1}]) == [{"a": 1}]
    torch.cuda.synchronize()
    if not all(checks.values()):
        raise AssertionError(f"nccl1: collectives not identities: {checks}")
    if led.host_bytes() != 0 or not len(led):
        raise AssertionError("nccl1: the NCCL collectives staged bytes or "
                             "booked nothing")
    # one GPT step without fleet, then under a degree-1 HCG
    cfg = _hybrid_cfg(2, "bfloat16")
    batch = _lm_batch(HYBRID_BATCH_SEED, 4, 2048, cfg.vocab_size, "cuda")
    runs = []
    for hcg in (None, "fleet"):
        mesh = None
        if hcg:
            hcg = fleet.init(is_collective=True,
                             strategy=fleet.DistributedStrategy())
            mesh = hcg.mesh
        model = GPTForCausalLM(cfg, device="cuda", seed=HYBRID_SEED)
        _, step = _hybrid_trainer(model, mesh)
        loss = float(step(batch))
        runs.append((loss, export_jax_state_dict(model, tensors=True)))
        del model, step
    (l0, p0), (l1, p1) = runs
    bit_equal = l0 == l1 and all(torch.equal(p0[k], p1[k]) for k in p0)
    if not bit_equal:
        raise AssertionError(f"nccl1: the degree-1 HCG step differs from "
                             f"the step without fleet ({l0} vs {l1})")
    out.update(backend="nccl", collectives=checks, ledger_records=len(led),
               gpt_step_loss=l0, hcg_step_bit_equal=bit_equal)


def _rank_nccl_shared(out):
    """Two ranks on the one card: init_parallel_env() (no backend named)
    refuses, and NCCL itself, asked anyway, reports the duplicate GPU."""
    import datetime

    from paddle_tpu_torch.distributed import collective as C

    try:
        C.init_parallel_env()
        raise AssertionError("init_parallel_env() accepted ranks sharing "
                             "a card")
    except RuntimeError as e:
        if "share" not in str(e):
            raise
        out["port_refusal"] = str(e).splitlines()[0][:200]
    dist = torch.distributed
    try:
        dist.init_process_group(
            "nccl", timeout=datetime.timedelta(seconds=60),
            device_id=torch.device("cuda", 0))
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        raise AssertionError("NCCL ran two ranks on one card")
    except RuntimeError as e:
        msg = [ln for ln in str(e).splitlines() if "Duplicate GPU" in ln]
        if not msg:
            raise
        out["nccl_error"] = msg[0].strip()


def _check_rank_attention(model, batch, p, h0):
    """Layer 0's attention on this rank's heads: K1 (with dropout p at
    this rank's head offset) against the plain version, per tile."""
    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    layer = model.gpt.layers[0]
    with torch.no_grad():
        x = layer.ln1(model.gpt.embeddings(batch["x"]))
        B, S = x.shape[:2]
        D = model.config.head_dim
        qkv = layer.attn.qkv_proj(x).reshape(B, S, -1, 3 * D)
        q, k, v = (t.contiguous() for t in qkv.split(D, dim=-1))
        kw = dict(dropout=p, seed=HYBRID_ATTN_SEED if p else None,
                  head_offset=h0)
        out, _ = K1.flash_attention_fwd_lse(q, k, v, True, **kw)
        ref, _ = K1.flash_attention_dense(q, k, v, True, **kw)
    e = _errs(out, ref)
    if not e[3] <= TOL[torch.bfloat16]:
        raise AssertionError(f"layer 0 attention off by {e[3]} per tile")
    return {"rel_err": e[3], "max_abs_err": e[0], "heads": q.shape[2],
            "head_offset": h0}


def _replicated_equal(model, group):
    """Are the parameters that are not mp shards (LayerNorms, position
    embeddings, row biases) bit-equal on every rank of ``group``?"""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers import \
        mp_sharded

    reps = [p.detach().reshape(-1) for p in model.parameters()
            if not mp_sharded(p)]
    # bits as int32 (gloo gathers no int16)
    flat = torch.cat([t.view(torch.int16).int() if t.dtype == torch.bfloat16
                      else t.view(torch.int32) for t in reps])
    got = C.t_all_gather(flat, group, tiled=False)
    return all(torch.equal(got[0], got[i]) for i in range(1, group.nranks))


def _comm_closed_form(model, b, S, dp, ledger):
    """A step's booked payload bytes by (group, op) against the closed
    form: on mp, 4 L b S H e (two forward and two backward activation
    all-reduces a layer) + 2 b S H e (the embedding's and the tied head's)
    + 2 b S 4 (the cross entropy's sums) + 4 (K8's sharded squared sum);
    pmax b S 4 (the cross entropy's max); on dp (dp > 1), each local
    gradient once, in its parameter's dtype; on the world, the loss's
    mean (4)."""
    cfg = model.config
    L, H = cfg.num_layers, cfg.hidden_size
    e = 2 if cfg.dtype == "bfloat16" else 4
    booked = {}
    for r in ledger.records:
        key = f"{r.axis}/{r.op}"
        booked[key] = booked.get(key, 0) + r.payload_bytes
    want = {"mp/psum": 4 * L * b * S * H * e + 2 * b * S * H * e
            + 2 * b * S * 4 + 4, "mp/pmax": b * S * 4, "world/psum": 4}
    if dp > 1:
        want["dp/psum"] = sum(p.numel() * p.element_size()
                              for p in model.parameters())
    return booked, want


def _params_rel(mine, ref):
    """The gathered parameters' relative L2 distance from degree 1's:
    over all of them together ("all", the gate), and the worst tensor
    with its own (printed: a zero-initialised bias after a few AdamW
    steps is a few lr in size, and its elements whose gradient is near 0
    take steps of up to lr from f32 summation noise, Adam's g / (|g| +
    eps), as tests/test_torch_gpt.py's gate explains)."""
    d2 = r2 = 0.0
    worst = (0.0, None)
    for k in ref:
        d = float((mine[k].double() - ref[k].double()).norm())
        r = float(ref[k].double().norm())
        d2, r2 = d2 + d * d, r2 + r * r
        worst = max(worst, (d / max(r, 1e-30), k))
    return {"all": math.sqrt(d2 / r2), "worst_tensor": worst[1],
            "worst_tensor_rel": worst[0]}


def _rank_train(mode, out, out_dir):
    """One hybrid run on this rank (HYBRID_RUNS[mode]); for mp2-bf16 a
    second run with dropout 0.1."""
    from paddle_tpu_torch.convert import export_jax_state_dict
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.observability import commledger as cl
    from paddle_tpu_torch.ops.kernels import flash_attention as K1
    from paddle_tpu_torch.ops.kernels.fused_adam import fused_adam

    n, dp, mp, layers, dtype, steps, (B, S) = HYBRID_RUNS[mode]
    refs = json.loads((out_dir / f"{mode}.ref.json").read_text())
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    hcg = fleet.init(is_collective=True, strategy=strategy)
    rank = C.get_rank()
    counters = [K1.flash_attention_fwd, K1.flash_attention_bwd, fused_adam,
                K1.flash_attention_fwd_dropout,
                K1.flash_attention_bwd_dropout]
    runs = []
    for p in ((0.0, 0.1) if mode == "mp2-bf16" else (0.0,)):
        cfg = _hybrid_cfg(layers, dtype, p)
        model = GPTForCausalLM(cfg, device="cuda", seed=HYBRID_SEED)
        opt, step = _hybrid_trainer(model, hcg.mesh)
        batch = _lm_batch(HYBRID_BATCH_SEED, B, S, cfg.vocab_size, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        staged0 = C.staging_stats()
        losses, secs = [], []
        for i in range(steps):
            C.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == steps - 1:
                with cl.capture() as led:
                    losses.append(float(step(batch)))
            else:
                losses.append(float(step(batch)))
            secs.append(time.perf_counter() - t0)
        staged = {k: C.staging_stats()[k] - staged0[k] for k in staged0}
        got = {c.__name__: c.launches for c in counters}
        want = {K1.flash_attention_fwd.__name__: layers * steps,
                K1.flash_attention_bwd.__name__: layers * steps,
                fused_adam.__name__: steps,
                K1.flash_attention_fwd_dropout.__name__:
                    layers * steps if p else 0,
                K1.flash_attention_bwd_dropout.__name__:
                    layers * steps if p else 0}
        _expect_launches(got, want, f"{mode} rank {rank}")
        ref = refs[str(p)]
        gate = 1e-4 if dtype == "float32" else 2e-2
        rel = max(_rel(a, b) for a, b in zip(losses, ref))
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
                and rel <= gate):
            raise AssertionError(f"{mode} dropout {p}: losses {losses}, "
                                 f"degree 1 {ref}, worst relative {rel}")
        mp_group = hcg.get_model_parallel_group()
        rep_equal = _replicated_equal(model, mp_group)
        every_equal = _replicated_equal(model, C.get_group(0)) \
            if dp > 1 else None
        if not rep_equal or every_equal is False:
            raise AssertionError(f"{mode}: replicated parameters differ "
                                 f"across ranks")
        b = B // dp
        booked, want_bytes = _comm_closed_form(model, b, S, dp, led)
        if booked != want_bytes:
            raise AssertionError(f"{mode}: booked {booked} bytes a step, "
                                 f"the closed form {want_bytes}")
        local = {k: v[rank // mp * b:(rank // mp + 1) * b] if dp > 1 else v
                 for k, v in batch.items()}
        attn = _check_rank_attention(model, local, p,
                                     model.gpt.layers[0].attn.head_offset)
        timed = secs[1:]
        params_err = None
        if dtype == "float32":
            mine = export_jax_state_dict(model, tensors=True)
            if rank == 0:
                params_err = _params_rel(
                    mine, torch.load(out_dir / f"{mode}.ref.pt"))
                if not params_err["all"] <= 1e-4:
                    raise AssertionError(f"{mode}: the gathered parameters "
                                         f"{params_err} (relative L2) from "
                                         f"degree 1")
        runs.append(dict(
            dropout=p, losses=losses, degree1_losses=ref,
            loss_rel_err=rel, step_ms=[t * 1e3 for t in secs],
            step_ms_p50=float(np.percentile(timed, 50)) * 1e3,
            card_tokens_per_s=B * S / float(np.percentile(timed, 50)),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            comm_payload_bytes_last_step=booked,
            comm_closed_form=want_bytes,
            comm_host_bytes_last_step=led.host_bytes(),
            staging_s_per_step=staged["seconds"] / steps,
            staged_parts_s_per_step={
                k: staged[k + "_seconds"] / steps
                for k in ("d2h", "gloo", "h2d")},
            staged_bytes_per_step=staged["bytes"] / steps,
            replicated_bit_equal=rep_equal, all_ranks_equal=every_equal,
            launches=got, attention=attn, params_rel_l2=params_err))
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    out.update(mode=mode, dp=dp, mp=mp, layers=layers, dtype=dtype,
               batch=[B, S], runs=runs, launches=runs[0]["launches"],
               losses=[r["losses"] for r in runs])


def hybrid_rank(mode, out_dir):
    """One rank of a train-hybrid or train-llama-hybrid launch: its result to
    out_dir/<mode>.rank<r>.json; any failure exits non-zero."""
    out_dir = Path(out_dir)
    if mode == "nccl-shared":
        out = {"rank": int(os.environ["RANK"])}
        _rank_nccl_shared(out)
    else:
        from paddle_tpu_torch.distributed import collective as C

        _hybrid_world(mode)
        out = {"rank": C.get_rank(), "world": C.get_world_size()}
        if mode == "nccl1":
            _rank_nccl1(out)
        elif mode.startswith("llama-"):
            _rank_llama(mode, out, out_dir)
        elif mode == "pipe":
            _rank_pipe(out, out_dir)
        else:
            _rank_train(mode, out, out_dir)
        C.barrier()
        C.destroy_process_group()
    (out_dir / f"{mode}.rank{out['rank']}.json").write_text(json.dumps(out))


# -- phase 17: Llama under tensor and sequence parallelism, recompute ---------
# Llama-7B's published widths (Touvron et al. 2023; llama_7b()) cut in
# depth, ranks sharing the one card over gloo as in phase 16. Run: (layers,
# dtype, steps) on the global batch LLAMA_BATCH; every run is mp 2.
LLAMA_HYBRID_RUNS = {
    "llama-mp2-fp32": (2, "float32", 3),     # (a)
    "llama-mp2-bf16": (8, "bfloat16", 5),    # (b), then (c) and (e)
    "llama-sp": (8, "bfloat16", 3),          # (d), then under recompute
}
LLAMA_BATCH, LLAMA_EVAL = (4, 2048), (4, 256)
LLAMA_SEED, LLAMA_BATCH_SEED, LLAMA_EVAL_SEED, LLAMA_SP_SEED = 0, 25, 26, 27
# the lr of Llama's early warmup (its 3e-4 peak comes after 2000 warmup
# steps, Touvron et al. 2023): at 3e-4 a fresh 7B-width model learns the
# one batch in a step (loss 11.17 -> 0.36) and the runs compare a
# degenerate trajectory, where mp 2's bf16 rounding moved step 1's loss
# by 1.8e-3 on the H100
LLAMA_LR = 1e-5
# losses: |a - b| / max(|b|, 1) (one batch is learnt in a few steps: a
# loss near 0 is held absolutely)
LLAMA_GATES = {"float32": 1e-6, "bfloat16": 1e-3}
# (a)'s gathered parameters against degree 1's, relative L2 over all of
# them and of the worst tensor: f32 sums in another order (the
# row-parallel products' halves) read 7.6e-8 and 2.9e-7 on the H100 at
# LLAMA_LR. A fault that left one layer's norm weights unchanged would read
# about 3e-5 on that tensor (3 AdamW steps of about lr an element, on
# weights of 1), over the tensor gate
LLAMA_PARAMS_GATE, LLAMA_PARAMS_TENSOR_GATE = 1e-6, 1e-5
# (e) eval_step's logits (relative L2 over tiles of 64 positions, a row's
# logits whole). mp 2 rounds each row-parallel product's two halves to the
# model's dtype before their sum, where degree 1 rounds the whole once: in
# bf16 that alone moves the logits, so mp 2 is held against degree 1's
# forward with o_proj and down_proj computed the same way
# (_row_products_split), and the reading against degree 1's plain forward
# is printed beside, with the split forward's own reading against it
LLAMA_EVAL_GATES = {"float32": TOL[torch.float32], "bfloat16": 2e-2}


def _llama_cfg(layers, dtype):
    from paddle_tpu_torch.models.llama import llama_7b

    return llama_7b(num_layers=layers, dtype=dtype)


def _llama_logits(model, ids, rc):
    """The training forward, each decoder layer under fleet.recompute
    when ``rc`` (without it: ``model(ids)``'s operations)."""
    from paddle_tpu_torch.distributed.fleet import recompute

    x = model.llama.embed_tokens(ids)
    for layer in model.llama.layers:
        x = recompute(layer, x) if rc else layer(x)
    return model._logits(model.llama.norm(x))


@contextlib.contextmanager
def _row_products_split(model):
    """Degree 1's o_proj and down_proj computed as mp 2's row-parallel
    linears compute them: the product over each half of the input
    features (contiguous, as a rank holds them), each rounded to the
    model's dtype, then the two summed in that dtype (the all-reduce)."""
    import torch.nn.functional as F

    def split(mod, x):
        k = x.shape[-1] // 2
        w = mod.weight
        out = (F.linear(x[..., :k].contiguous(), w[:, :k].contiguous())
               + F.linear(x[..., k:].contiguous(), w[:, k:].contiguous()))
        return out if mod.bias is None else out + mod.bias

    mods = [m for layer in model.llama.layers
            for m in (layer.self_attn.o_proj, layer.mlp.down_proj)]
    for m in mods:
        m.forward = lambda x, m=m: split(m, x)
    try:
        yield
    finally:
        for m in mods:
            del m.forward


def _adamw(model):
    """AdamW (lr LLAMA_LR, decay 0.01, f32 masters for bf16 weights),
    clip 1.0: phase 17's optimizer."""
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    bf16 = next(model.parameters()).dtype != torch.float32
    return AdamW(learning_rate=LLAMA_LR, weight_decay=0.01,
                 multi_precision=bf16,
                 grad_clip=ClipGradByGlobalNorm(1.0),
                 parameters=model.named_parameters())


def _llama_trainer(model, mesh=None, rc=False):
    from paddle_tpu_torch.distributed.engine import ParallelEngine
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion

    opt = _adamw(model)
    crit = LlamaPretrainingCriterion(model.config)
    eng = ParallelEngine(model, opt, mesh)
    return opt, eng, eng.train_step(
        lambda m, b: crit(_llama_logits(m, b["x"], rc), b["y"]))


def _digests(state):
    """sha256 of each tensor's bits (a state of CPU tensors)."""
    import hashlib

    out = {}
    for k, t in state.items():
        bits = t.contiguous().view(torch.int16 if t.element_size() == 2
                                   else torch.int32)
        out[k] = hashlib.sha256(bits.numpy().tobytes()).hexdigest()
    return out


class _SPBlock(torch.nn.Module):
    """tests/test_sharding_sp.py's SPBlock at Llama-7B's MLP widths, its
    norm LlamaRMSNorm (K3 on sequence shards): the sequence (dim 1)
    scattered, norm, column / row sequence-parallel linears with a ReLU
    between, the sequence gathered; the norm's weight marked."""

    def __init__(self, h, f, dtype):
        super().__init__()
        from paddle_tpu_torch.distributed.fleet.utils import \
            sequence_parallel_utils as spu
        from paddle_tpu_torch.models.llama import LlamaRMSNorm

        kw = dict(device="cuda", dtype=dtype)
        self.spu = spu
        self.norm = LlamaRMSNorm(h, 1e-5, **kw)
        self.fc1 = spu.ColumnSequenceParallelLinear(
            h, f, gather_output=False, seq_axis=1, **kw)
        self.fc2 = spu.RowSequenceParallelLinear(
            f, h, input_is_parallel=True, seq_axis=1, **kw)
        spu.mark_as_sequence_parallel_parameter(self.norm.weight)

    def forward(self, x):
        x = self.spu.scatter(x, axis=1)
        x = torch.relu(self.fc1(self.norm(x)))
        return self.spu.gather(self.fc2(x), axis=1)


class _SPStack(torch.nn.Module):
    """``layers`` SPBlocks; with ``rc`` each under fleet.recompute. At
    degree 1 (no mp group) it is the dense stack. Weights from a seeded
    generator, each full tensor drawn and the rank's slice kept."""

    def __init__(self, layers, dtype, rc=False):
        super().__init__()
        from paddle_tpu_torch.models.llama import _draw, llama_7b

        cfg = llama_7b()
        self.rc = rc
        self.blocks = torch.nn.ModuleList(
            [_SPBlock(cfg.hidden_size, cfg.intermediate_size, dtype)
             for _ in range(layers)])
        g = torch.Generator(device="cuda").manual_seed(LLAMA_SEED)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("norm.weight"):
                    p.fill_(1.0)
                elif name.endswith("bias"):
                    p.zero_()
                else:
                    _draw(p, 0.02, g)

    def forward(self, x):
        from paddle_tpu_torch.distributed.fleet import recompute

        for b in self.blocks:
            x = recompute(b, x) if self.rc else b(x)
        return x


def _sp_batch(dtype):
    g = torch.Generator(device="cuda").manual_seed(LLAMA_SP_SEED)
    B, S = LLAMA_BATCH
    return {k: torch.randn(B, S, 4096, device="cuda", generator=g).to(dtype)
            for k in ("x", "y")}


def _sp_trainer(model, mesh=None):
    from paddle_tpu_torch.distributed.engine import ParallelEngine

    opt = _adamw(model)
    eng = ParallelEngine(model, opt, mesh)
    return opt, eng.train_step(
        lambda m, b: torch.mean((m(b["x"]).float() - b["y"].float()) ** 2))


def _llama_mp2_shapes(layers=8):
    """Llama-7B's parameters at ``layers`` layers on one rank of mp 2
    (the port's layout, in model order) and which are mp shards."""
    cfg = _llama_cfg(layers, "bfloat16")
    h, m, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    layer = [((h,), False), ((h // 2, h), True), ((h // 2, h), True),
             ((h // 2, h), True), ((h, h // 2), True), ((h,), False),
             ((m // 2, h), True), ((m // 2, h), True), ((h, m // 2), True)]
    rows = [((V // 2, h), True)] + layer * layers + [((h,), False),
                                                     ((V // 2, h), True)]
    return [s for s, _ in rows], [f for _, f in rows]


def phase_train_llama_hybrid(dev, results):
    """Phase 17 (see the module docstring): K8's split reduce at a Llama
    mp 2 rank's shapes, then (a) mp 2 fp32, (b) mp 2 bf16 with (e) its
    eval_step and (c) its recompute run, (d) the SP stack, each launch of
    two ranks held to degree-1 runs made in this process first (and freed
    before the ranks start). Returns the kernels' launches a rank by
    path."""
    from paddle_tpu_torch.convert import export_jax_state_dict
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    out_dir = Path(__file__).resolve().parent / "build" / "llama_hybrid"
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"[train-llama-hybrid] {card}; Llama-7B widths, ranks sharing this "
        f"one card over gloo (collectives staged through host memory): "
        f"not NCCL's speed")
    check_fused_adam_split(dev, results, shapes=_llama_mp2_shapes(),
                           what="one mp 2 rank of Llama-7B at 8 layers")
    B, S = LLAMA_BATCH
    launches = {}
    for mode, (layers, dtype, steps) in LLAMA_HYBRID_RUNS.items():
        ref = {}
        t0 = time.perf_counter()
        if mode == "llama-sp":
            model = _SPStack(layers, torch.bfloat16)
            step = _sp_trainer(model)[1]
            batch = _sp_batch(torch.bfloat16)
            ref["losses"] = [float(step(batch)) for _ in range(steps)]
            del model, step, batch
            gc.collect()
            torch.cuda.empty_cache()
        else:
            cfg = _llama_cfg(layers, dtype)
            model = LlamaForCausalLM(cfg, device="cuda", seed=LLAMA_SEED)
            if dtype == "float32":
                ref["init"] = _digests(export_jax_state_dict(model,
                                                             tensors=True))
            ev = _lm_batch(LLAMA_EVAL_SEED, *LLAMA_EVAL, cfg.vocab_size,
                           "cuda")
            with torch.no_grad():
                plain = model(ev["x"])
                with _row_products_split(model):
                    split = model(ev["x"])
            e = _errs(split[:, :, None], plain[:, :, None])
            ref["eval_split_vs_plain"] = dict(rel_err=e[3],
                                              max_abs_err=e[0])
            torch.save({"plain": plain.cpu(), "split": split.cpu()},
                       out_dir / f"{mode}.eval.pt")
            del plain, split
            # the step holds the engine, its model and optimizer: freed
            # with it below
            step = _llama_trainer(model)[2]
            batch = _lm_batch(LLAMA_BATCH_SEED, B, S, cfg.vocab_size, "cuda")
            ref["losses"] = [float(step(batch)) for _ in range(steps)]
            if dtype == "float32":
                torch.save(export_jax_state_dict(model, tensors=True),
                           out_dir / f"{mode}.ref.pt")
            del model, step, batch
            gc.collect()
            torch.cuda.empty_cache()
        log(f"[train-llama-hybrid] {mode} degree-1 reference in "
            f"{time.perf_counter() - t0:.1f}s: "
            + json.dumps({k: v for k, v in ref.items() if k != "init"}))
        (out_dir / f"{mode}.ref.json").write_text(json.dumps(ref))
        res = _launch_ranks(2, mode, out_dir)
        for rk in res:
            log(f"[train-llama-hybrid] {mode} rank {rk['rank']} ({card}): "
                + json.dumps(rk))
        if res[1]["losses"] != res[0]["losses"]:
            raise AssertionError(f"{mode}: rank 1's losses differ from "
                                 f"rank 0's")
        launches[mode] = [run["launches"] for run in res[0]["runs"]]
        for f in out_dir.glob(f"{mode}.*.pt"):
            f.unlink()
    log("[train-llama-hybrid] mp 2 fp32 / bf16, recompute, eval_step and "
        "the SP stack within their gates of degree 1; replicated and "
        "marked parameters bit-equal across ranks; bytes at the closed "
        "form; launches as expected: OK")
    return {"train_llama_hybrid": launches["llama-mp2-bf16"][0],
            "train_llama_hybrid_recompute": launches["llama-mp2-bf16"][1],
            "train_llama_hybrid_fp32": launches["llama-mp2-fp32"][0],
            "train_llama_sp": launches["llama-sp"][0],
            "train_llama_sp_recompute": launches["llama-sp"][1]}


def _llama_closed_form(cfg, b, S, rc, ledger):
    """A Llama step's booked payload bytes by (group, op) against the
    closed form at dp 1: on mp, (7 L + 2) b S H e all-reduced (a layer's
    two forward and five backward activation all-reduces: o and down
    forward, the q / k / v / gate / up inputs' gradients; the
    embedding's and the head input's gradient), 2 L b S H e more under
    recompute (the replayed forwards), + 2 b S 4 (the cross entropy's
    sums) + 4 (K8's sharded squared sum); b S 4 maxed; on the world the
    loss's mean (4)."""
    L, H = cfg.num_layers, cfg.hidden_size
    e = 2 if cfg.dtype == "bfloat16" else 4
    act = b * S * H * e
    want = {"mp/psum": (7 * L + 2 + (2 * L if rc else 0)) * act
            + 2 * b * S * 4 + 4, "mp/pmax": b * S * 4, "world/psum": 4}
    return _booked(ledger), want


def _sp_closed_form(layers, b, S, rc, ledger):
    """An SP stack step's booked payload bytes: a block's fc1 input, its
    gathered output and (but the first block's) the scatter's gradient
    all-gathered from the shard [b, S / 2, H], and fc2's gradient too;
    fc2's output and fc1's input gradient reduce-scattered whole
    [b, S, H]; under recompute the replayed forward's two all-gathers and
    one reduce-scatter a block more; the marked parameters' gradients
    (norm weight and fc2 bias, H each a block) summed over mp, + 4 (K8's
    sharded squared sum); the loss's mean (4). bf16 throughout."""
    H, e, L = 4096, 2, layers
    shard, whole = b * (S // 2) * H * e, b * S * H * e
    want = {"mp/all_gather": (4 * L - 1 + (2 * L if rc else 0)) * shard,
            "mp/reduce_scatter": (2 * L + (L if rc else 0)) * whole,
            "mp/psum": 2 * L * H * e + 4, "world/psum": 4}
    return _booked(ledger), want


def _booked(ledger):
    booked = {}
    for r in ledger.records:
        key = f"{r.axis}/{r.op}"
        booked[key] = booked.get(key, 0) + r.payload_bytes
    return booked


def _check_rank_kernels(model, ids):
    """This rank's K1/K2 on layer 0's attention (its heads) and K3 on
    layer 0's input, each against its plain version: (K1, K2 per tile;
    K3 forward, its gradient) errors."""
    from paddle_tpu_torch.ops.kernels import flash_attention as K1
    from paddle_tpu_torch.ops.nn_ops import fused_rope

    out = {}
    layer = model.llama.layers[0]
    with torch.no_grad():
        x = model.llama.embed_tokens(ids)
        h = layer.input_layernorm(x)
        B, S = h.shape[:2]
        att = layer.self_attn
        D = model.config.head_dim
        q = att.q_proj(h).view(B, S, att.num_local_heads, D)
        k = att.k_proj(h).view(B, S, att.num_local_kv_heads, D)
        v = att.v_proj(h).view(B, S, att.num_local_kv_heads, D)
        q, k = fused_rope(q, k, att.rope_cos[:S], att.rope_sin[:S])
        q, k, v = (t.contiguous() for t in (q, k, v))
        o, lse = K1.flash_attention_fwd_lse(q, k, v, True)
        ro, _ = K1.flash_attention_dense(q, k, v, True)
        g = torch.Generator(device="cuda").manual_seed(17)
        do = torch.randn(o.shape, device="cuda", generator=g).to(o.dtype)
        grads = K1.flash_attention_bwd(q, k, v, o, lse, do, True)
        rgrads = K1.flash_attention_bwd_dense(q, k, v, do, True)
    e1 = _errs(o, ro)
    e2 = [_errs(a, b) for a, b in zip(grads, rgrads)]
    out["k1_k2"] = dict(shape=list(q.shape), k1_rel_err=e1[3],
                        k1_max_abs_err=e1[0],
                        k2_rel_err=max(e[3] for e in e2),
                        k2_max_abs_err=max(e[0] for e in e2))
    del q, k, v, o, lse, ro, do, grads, rgrads
    bad = [k for k, v in (("k1", e1[3]), ("k2", out["k1_k2"]["k2_rel_err"]))
           if not v <= TOL[x.dtype]]
    if bad:
        raise AssertionError(f"kernels off their plain versions on this "
                             f"rank's shapes: {bad}: {out}")
    out.update(_check_k3(x, layer.input_layernorm))
    return out


def _check_k3(rows, norm):
    """K3 on ``rows`` ([..., H]: all of a rank's, or its sequence shard)
    with ``norm``'s weight and epsilon against its plain version, forward
    and gradient."""
    from paddle_tpu_torch.ops.kernels import rms_norm as K3

    rows = rows.detach().reshape(-1, rows.shape[-1]).contiguous()
    rows.requires_grad_(True)
    w = norm.weight.detach().clone().requires_grad_(True)
    got = K3.rms_norm(rows, w, norm._epsilon)
    ref = K3.rms_norm_dense(rows, w, norm._epsilon)
    g = torch.Generator(device="cuda").manual_seed(18)
    go = torch.randn(got.shape, device="cuda", generator=g).to(got.dtype)
    dx, dw = torch.autograd.grad(got, (rows, w), go)
    rx, rw = torch.autograd.grad(ref, (rows, w), go)
    ef = _errs(got[None, :, None], ref[None, :, None])
    eg = max(_errs(dx[None, :, None], rx[None, :, None])[3],
             _errs(dw[None, None, None], rw[None, None, None])[3])
    out = {"k3": dict(shape=list(rows.shape), fwd_rel_err=ef[3],
                      fwd_max_abs_err=ef[0], grad_rel_err=eg)}
    if not (ef[3] <= TOL[rows.dtype] and eg <= TOL[rows.dtype]):
        raise AssertionError(f"K3 off its plain version on this rank's "
                             f"rows: {out}")
    return out


def _timed_steps(step, batch, steps):
    """Run ``steps`` steps, each timed from a barrier and a sync; the
    last under a comm capture. (losses, seconds, its ledger, bytes and
    seconds staged a step)."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.observability import commledger as cl

    staged0 = C.staging_stats()
    losses, secs = [], []
    led = None
    for i in range(steps):
        C.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == steps - 1:
            with cl.capture() as led:
                losses.append(float(step(batch)))
        else:
            losses.append(float(step(batch)))
        secs.append(time.perf_counter() - t0)
    staged = {k: (C.staging_stats()[k] - staged0[k]) / steps
              for k in staged0}
    return losses, secs, led, staged


def _run_stats(B, S, secs, staged, led):
    p50 = float(np.percentile(secs[1:], 50))
    return dict(step_ms=[t * 1e3 for t in secs], step_ms_p50=p50 * 1e3,
                card_tokens_per_s=B * S / p50,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                staged_bytes_per_step=staged["bytes"],
                staging_s_per_step=staged["seconds"],
                staged_parts_s_per_step={
                    k: staged[k + "_seconds"] for k in ("d2h", "gloo",
                                                        "h2d")},
                comm_host_bytes_last_step=led.host_bytes())


def _max_diff(a, b):
    """(largest |a - b| over the tensors, its first tensor's name)."""
    worst = (0.0, None)
    for k in a:
        d = (a[k].float() - b[k].float()).abs().max().item()
        if d > worst[0]:
            worst = (d, k)
    return worst


def _rank_llama(mode, out, out_dir):
    """One rank of a phase-17 launch (LLAMA_HYBRID_RUNS[mode])."""
    from paddle_tpu_torch.convert import export_jax_state_dict
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.engine import P
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import flash_attention as K1
    from paddle_tpu_torch.ops.kernels import rms_norm as K3
    from paddle_tpu_torch.ops.kernels.fused_adam import fused_adam

    layers, dtype, steps = LLAMA_HYBRID_RUNS[mode]
    ref = json.loads((out_dir / f"{mode}.ref.json").read_text())
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2}
    hcg = fleet.init(is_collective=True, strategy=strategy)
    rank, mp_group = C.get_rank(), hcg.get_model_parallel_group()
    counters = [K1.flash_attention_fwd, K1.flash_attention_bwd, K3.rms_norm,
                fused_adam]
    B, S = LLAMA_BATCH
    gate = LLAMA_GATES[dtype]
    runs = []
    for rc in ((False,) if dtype == "float32" else (False, True)):
        eng = None
        if mode == "llama-sp":
            model = _SPStack(layers, torch.bfloat16, rc=rc)
            opt, step = _sp_trainer(model, hcg.mesh)
            batch = _sp_batch(torch.bfloat16)
        else:
            cfg = _llama_cfg(layers, dtype)
            model = LlamaForCausalLM(cfg, device="cuda", seed=LLAMA_SEED)
            opt, eng, step = _llama_trainer(model, hcg.mesh, rc)
            batch = _lm_batch(LLAMA_BATCH_SEED, B, S, cfg.vocab_size, "cuda")
        want_ref = ref["losses"]
        run = {"recompute": rc}
        if "init" in ref:
            init = _digests(export_jax_state_dict(model, tensors=True))
            run["init_bit_equal"] = init == ref["init"]
            if not run["init_bit_equal"]:
                raise AssertionError(f"{mode}: the seeded mp 2 model's "
                                     f"slices differ from degree 1's")
        if mode != "llama-sp" and not rc:
            # (e): eval_step over the fresh model, the batch spec'd, the
            # vocab's mp shards gathered: the rank's own forward gathered
            # bit for bit, and degree 1's forward within LLAMA_EVAL_GATES
            # (in bf16 degree 1's with its row products split as mp 2's
            # are; the largest difference over the largest logit, and the
            # reading against degree 1's plain forward, printed beside)
            ev = _lm_batch(LLAMA_EVAL_SEED, *LLAMA_EVAL, cfg.vocab_size,
                           "cuda")
            fwd = eng.eval_step(lambda m, b: m(b["x"]),
                                batch_specs=(P(), P()))
            logits = fwd(ev, out_spec=P(None, None, "mp"))
            with torch.no_grad():
                own = C.t_all_gather(model(ev["x"]), mp_group, axis=-1)
            refs = torch.load(out_dir / f"{mode}.eval.pt")
            held = "split" if dtype == "bfloat16" else "plain"
            errs = {k: _errs(logits[:, :, None], v.cuda()[:, :, None])
                    for k, v in refs.items()}
            e = errs[held]
            run["eval"] = dict(
                shape=list(logits.shape), held_against=held, rel_err=e[3],
                max_abs_err=e[0], max_abs_over_max=e[0] / e[1],
                rel_err_by_reference={k: v[3] for k, v in errs.items()},
                split_vs_plain=ref["eval_split_vs_plain"],
                own_forward_bit_equal=torch.equal(logits, own))
            if not (run["eval"]["own_forward_bit_equal"]
                    and e[3] <= LLAMA_EVAL_GATES[dtype]):
                raise AssertionError(f"{mode}: eval_step's logits "
                                     f"{run['eval']} against the rank's "
                                     f"forward and degree 1's")
            # the eval step holds the engine: freed with it below
            del logits, refs, own, fwd
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        losses, secs, led, staged = _timed_steps(step, batch, steps)
        got = {c.__name__: c.launches for c in counters}
        if mode == "llama-sp":
            want_l = {"rms_norm": layers * steps * (2 if rc else 1),
                      "flash_attention_fwd": 0, "flash_attention_bwd": 0,
                      "fused_adam": steps}
            booked, want_b = _sp_closed_form(layers, B, S, rc, led)
        else:
            want_l = {"flash_attention_fwd": layers * steps * (2 if rc
                                                                else 1),
                      "flash_attention_bwd": layers * steps,
                      "rms_norm": (2 * layers * (2 if rc else 1) + 1) * steps,
                      "fused_adam": steps}
            booked, want_b = _llama_closed_form(cfg, B, S, rc, led)
        run.update(_run_stats(B, S, secs, staged, led))
        _expect_launches(got, want_l, f"{mode} rank {rank} recompute {rc}")
        if booked != want_b:
            raise AssertionError(f"{mode} recompute {rc}: booked {booked} "
                                 f"bytes a step, the closed form {want_b}")
        rel = max(abs(a - b) / max(abs(b), 1.0)
                  for a, b in zip(losses, want_ref))
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
                and rel <= gate):
            raise AssertionError(f"{mode} recompute {rc}: losses {losses}, "
                                 f"degree 1 {want_ref}, worst |a - b| / "
                                 f"max(|b|, 1) {rel} > {gate}")
        if not _replicated_equal(model, mp_group):
            raise AssertionError(f"{mode}: replicated parameters differ "
                                 f"across ranks")
        mine = {n: p.detach().cpu().clone() for n, p in
                model.named_parameters()}
        if rc:
            # against the run without recompute in this process: expected
            # bit-equal (the replay repeats the forward's operations)
            first = runs[0]
            run["losses_bit_equal_to_plain"] = losses == first["losses"]
            diff = _max_diff(mine, plain_params)
            run["params_bit_equal_to_plain"] = diff[0] == 0.0
            run["largest_param_diff"] = diff
            log(f"[train-llama-hybrid] {mode} rank {rank}: recompute "
                f"against the plain run: losses bit-equal "
                f"{run['losses_bit_equal_to_plain']}, parameters bit-equal "
                f"{run['params_bit_equal_to_plain']}, largest difference "
                f"{diff[0]} (first in {diff[1]})")
        else:
            plain_params = mine
        if mode != "llama-sp":
            run["kernels"] = _check_rank_kernels(model, batch["x"])
        else:
            # K3 on this rank's sequence shard of the first block's input
            r, x = hcg.get_model_parallel_rank(), batch["x"]
            half = x.shape[1] // 2
            run["kernels"] = _check_k3(x[:, r * half:(r + 1) * half],
                                       model.blocks[0].norm)
        if dtype == "float32":
            full = export_jax_state_dict(model, tensors=True)
            if rank == 0:
                run["params_rel_l2"] = _params_rel(
                    full, torch.load(out_dir / f"{mode}.ref.pt"))
                prel = run["params_rel_l2"]
                if not (prel["all"] <= LLAMA_PARAMS_GATE
                        and prel["worst_tensor_rel"]
                        <= LLAMA_PARAMS_TENSOR_GATE):
                    raise AssertionError(f"{mode}: the gathered parameters "
                                         f"{prel} (relative L2) from "
                                         f"degree 1")
            del full
        run.update(losses=losses, degree1_losses=want_ref, loss_rel_err=rel,
                   comm_payload_bytes_last_step=booked,
                   comm_closed_form=want_b, launches=got,
                   replicated_bit_equal=True)
        runs.append(run)
        del model, opt, eng, step, batch
        gc.collect()
        torch.cuda.empty_cache()
    out.update(mode=mode, mp=2, layers=layers, dtype=dtype,
               batch=[B, S], runs=runs, losses=[r["losses"] for r in runs])


# -- phase 18: the pipeline and ZeRO -------------------------------------------
# gpt_1p3b's widths (h 2048, 16 heads of 128, vocab 50304, tied embeddings)
# as GPTForCausalLMPipe at mp 2 x pp 2 x sharding 2 with two virtual stages:
# 8 ranks sharing the card over gloo through the port's launcher, as phase 16
# launches its ranks (build/pipe). The strategy's ZeRO knobs: comm_overlap
# with 25 MB buckets; every run: micro-batch 1 x 2048, accumulate_steps 2
# (the global batch PIPE_BATCH, phases 16-17's), AdamW (lr 1e-5, decay
# 0.01, f32 masters for bf16), clip 1.0, against a degree-1 GPTForCausalLM
# of the same seed and batch made in this process first.
PIPE_HYBRID = {"dp_degree": 1, "mp_degree": 2, "pp_degree": 2,
               "sharding_degree": 2,
               "pp_configs": {"num_virtual_pipeline_stages": 2},
               "sharding_configs": {"comm_overlap": True,
                                    "comm_buffer_size_MB": 25.0}}
PIPE_M, PIPE_MICRO, PIPE_VPP = 2, 1, 2
PIPE_BATCH = (4, 2048)
# run: (layers, dtype, sharding stage, steps); (a) then (b) at stage 2 and 3
PIPE_RUNS = {"fp32-s2": (4, "float32", 2, 3),
             "bf16-s2": (8, "bfloat16", 2, 5),
             "bf16-s3": (8, "bfloat16", 3, 5)}
PIPE_LR = 1e-5
# losses, relative: (a) in fp32 the pipeline sums the same terms in another
# order; (b) bf16 as phase 16's gate
PIPE_GATES = {"float32": 1e-5, "bfloat16": 2e-2}
# (a)'s parameters against degree 1's, relative L2 over all of them: 3 AdamW
# steps at PIPE_LR move a LayerNorm weight of 1 by about 3e-5, so a chunk
# that missed its update or its sync reads above it
PIPE_PARAMS_GATE = 1e-5


def _pipe_adamw(model):
    """Phase 18's optimizer (the comment above PIPE_HYBRID)."""
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    bf16 = next(model.parameters()).dtype != torch.float32
    return AdamW(learning_rate=PIPE_LR, weight_decay=0.01,
                 multi_precision=bf16, grad_clip=ClipGradByGlobalNorm(1.0),
                 parameters=model.named_parameters())


def _pipe_reference(cfg, steps, params):
    """Degree 1: GPTForCausalLM of the pipe's seed on the whole batch through
    ParallelEngine, in this process. (losses, the parameters in the JAX
    pipeline's stacked layout on the host, or None)."""
    from paddle_tpu_torch.convert import export_jax_state_dict
    from paddle_tpu_torch.distributed.engine import ParallelEngine
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             GPTPretrainingCriterion)

    model = GPTForCausalLM(cfg, device="cuda", seed=HYBRID_SEED)
    crit = GPTPretrainingCriterion(cfg)
    step = ParallelEngine(model, _pipe_adamw(model), None).train_step(
        lambda m, b: crit(m(b["x"]), b["y"]))
    batch = _lm_batch(HYBRID_BATCH_SEED, *PIPE_BATCH, cfg.vocab_size,
                      "cuda")
    losses = [float(step(batch)) for _ in range(steps)]
    state = None
    if params:
        state = _flat_to_pipe(export_jax_state_dict(model, tensors=True),
                              cfg.num_layers, PIPE_VPP)
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    return losses, state


def _flat_to_pipe(state, layers, vpp):
    """GPTForCausalLM's JAX-layout state under the JAX GPTForCausalLMPipe's
    names: the blocks stacked [vpp, layers / vpp, ...]."""
    out, rows = {}, {}
    for k, v in state.items():
        if k.startswith("gpt.layers."):
            _, _, i, rest = k.split(".", 3)
            rows.setdefault("blocks__" + rest.replace(".", "__"), {})[
                int(i)] = v
        elif k.startswith("gpt.embeddings."):
            out["prologue.0." + k[len("gpt.embeddings."):]] = v
        elif k.startswith("gpt.final_ln."):
            out["epilogue.0." + k[len("gpt.final_ln."):]] = v
        else:
            raise KeyError(f"no pipeline name for {k}")
    for k, r in rows.items():
        full = torch.stack([r[i] for i in range(layers)])
        out[k] = full.reshape((vpp, layers // vpp) + tuple(full.shape[1:]))
    return out


def phase_train_pipe(counters):
    """Phase 18 (the module docstring): the degree-1 references here, then
    one launch of the 8 ranks running (a) and (b). Returns the kernels'
    launches per rank a run, by path."""
    out_dir = Path(__file__).resolve().parent / "build" / "pipe"
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"[train-pipe] {card}; 8 ranks sharing this card over gloo "
        f"(collectives and p2p staged through host memory): not NCCL's "
        f"speed")
    refs = {}
    for run, (layers, dtype, _, steps) in PIPE_RUNS.items():
        key = f"{layers}-{dtype}"
        if key in refs:
            continue
        cfg = _hybrid_cfg(layers, dtype)
        losses, state = _pipe_reference(cfg, steps, dtype == "float32")
        refs[key] = losses
        if state is not None:
            torch.save(state, out_dir / f"{key}.ref.pt")
        log(f"[train-pipe] degree-1 GPTForCausalLM, {layers} layers "
            f"{dtype}: losses {losses}")
    (out_dir / "pipe.ref.json").write_text(json.dumps(refs))
    res = _launch_ranks(8, "pipe", out_dir)
    log(f"[train-pipe] rank 0 ({card}): " + json.dumps(res[0]["runs"]))
    keys = ("step_ms_p50", "card_tokens_per_s", "peak_mem_gib",
            "state_bytes", "staging_s_per_step", "staged_parts_s_per_step",
            "staged_bytes_per_step", "comm_payload_bytes_last_step",
            "attention", "k8")
    for rk in res[1:]:
        log(f"[train-pipe] rank {rk['rank']} {rk['coords']} ({card}): "
            + json.dumps({run: {k: r[k] for k in keys}
                          for run, r in rk["runs"].items()}))
    for run in PIPE_RUNS:
        if any(rk["runs"][run]["losses"] != res[0]["runs"][run]["losses"]
               for rk in res):
            raise AssertionError(f"train-pipe {run}: the ranks' losses "
                                 f"differ")
    for rk in res:
        s2, s3 = rk["runs"]["bf16-s2"], rk["runs"]["bf16-s3"]
        if s3["losses"] != s2["losses"] or s3["digest"] != s2["digest"]:
            raise AssertionError(f"train-pipe rank {rk['rank']}: stage 3 "
                                 f"is not bit-equal to stage 2 (losses "
                                 f"{s3['losses']} vs {s2['losses']})")
    for f in out_dir.glob("*.ref.pt"):
        f.unlink()
    log("[train-pipe] (a) fp32 within 1e-5 of degree 1 and its parameters "
        "within 1e-5 relative L2; (b) stage 3 bit-equal to stage 2, both "
        "within 2e-2 of degree 1; K1/K2 blocks x microbatches a step and "
        "K8 one a step on every rank, K1/K2 on each rank's first block and "
        "K8's call on each rank's shards against their plain versions; the "
        "booked bytes at their closed forms: OK")
    r0 = res[0]["runs"]
    return {"train_pipe": r0["bf16-s2"]["launches"],
            "train_pipe_s3": r0["bf16-s3"]["launches"],
            "train_pipe_fp32": r0["fp32-s2"]["launches"]}


def _pipe_closed_form(model, eng, hcg, dtype, ledger):
    """A step's booked payload bytes on this rank by (group, op) against
    the closed form, with b the micro-batch, M the microbatches, K this
    rank's blocks, e the dtype's bytes: mp: 4 K M b S H e (each block's
    two forward and two backward activation all-reduces) + on stage 0 M b
    S H e (the vocab-parallel embedding) + on the last stage M (b S H e +
    2 b S 4) (the tied head's input gradient, the cross entropy's sums)
    all-reduced and M b S 4 maxed; pp: an activation b S H e sent for
    every forward but the last virtual stage's and a gradient for every
    backward but the first's (M (2 vpp - 1) a rank at pp 2), the loss's
    4; pp_shared: the tied embedding's local gradient; sharding: every
    plan entry's local gradient reduce-scattered, its shard all-gathered
    (stage 2 after the update, stage 3 at the step's entry); dp+sharding:
    the gradients outside the plan (an mp-split bias: its one dim is
    mp's) averaged; world: K8's squared sum and the loss's mean (4
    each)."""
    cfg = model.config
    S, H = PIPE_BATCH[1], cfg.hidden_size
    b, M, K = PIPE_MICRO, PIPE_M, len(model.blocks)
    e = 2 if dtype == "bfloat16" else 4
    P, V = model.get_num_stages(), model.get_num_virtual_stages()
    first, last = model.is_first_stage(), model.is_last_stage()
    act = b * S * H * e
    booked = {}
    for r in ledger.records:
        key = f"{r.axis}/{r.op}"
        booked[key] = booked.get(key, 0) + r.payload_bytes
    want = {"mp/psum": 4 * K * M * act + (M * act if first else 0)
            + (M * (act + 2 * b * S * 4) if last else 0),
            "pp/ppermute": act * M * (2 * V - int(first) - int(last)),
            "pp/psum": 4, "world/psum": 8}
    if last:
        want["mp/pmax"] = M * b * S * 4
    zs, n = eng._zstep, hcg.get_sharding_parallel_world_size()

    def local(p):
        # a stage-3 parameter is its shard between steps
        e = zs.entry(p)
        return p.numel() * p.element_size() * (n if e and e[1] else 1)
    tied = [p for p in model.parameters()
            if getattr(p, "pp_shared", None) is not None]
    if tied:
        want["pp_shared/psum"] = sum(local(p) for p in tied)
    whole = sum(local(p) for p in model.parameters()
                if zs.entry(p) is not None)
    want["sharding/reduce_scatter"] = whole
    want["sharding/all_gather"] = whole // n
    rest = sum(p.numel() * p.element_size() for p in model.parameters()
               if zs.entry(p) is None)
    if rest:
        want["dp+sharding/psum"] = rest
    return booked, want


def _pipe_digest(model):
    """sha256 of this rank's parameters."""
    import hashlib

    h = hashlib.sha256()
    for name, p in model.named_parameters():
        t = p.detach().contiguous()
        bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
        h.update(name.encode())
        h.update(bits.cpu().numpy().tobytes())
    return h.hexdigest()


def _pipe_params_rel(model, hcg, ref_path):
    """The parameters against degree 1's (a pipe of this rank's chunks
    loaded from its state): relative L2 over every element counted once
    over the ranks (an mp replica on mp rank 0, the tied copy on stage 0,
    sharding rank 0) and the worst tensor's, the largest on any rank."""
    from paddle_tpu_torch.convert import load_jax_state_dict
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers import \
        mp_sharded
    from paddle_tpu_torch.models.gpt import GPTForCausalLMPipe

    torch.set_grad_enabled(False)
    ref = GPTForCausalLMPipe(model.config, device="cuda", seed=HYBRID_SEED)
    load_jax_state_dict(ref, torch.load(ref_path, mmap=True))
    c = hcg.mesh.coords
    d2 = r2 = 0.0
    worst = 0.0
    refs = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        q = refs[name]
        d = float((p.detach().double() - q.double()).norm()) ** 2
        r = float(q.double().norm()) ** 2
        worst = max(worst, math.sqrt(d / max(r, 1e-30)))
        once = (c.get("sharding", 0) == 0
                and (mp_sharded(p) or c.get("mp", 0) == 0)
                and (getattr(p, "pp_shared", None) is None
                     or model.is_first_stage()))
        if once:
            d2, r2 = d2 + d, r2 + r
    sums = torch.tensor([d2, r2, worst], dtype=torch.float64)
    got = C.t_all_gather(sums, C.get_group(0), tiled=False)
    del ref
    torch.set_grad_enabled(True)
    return {"all": math.sqrt(float(got[:, 0].sum() / got[:, 1].sum())),
            "worst_tensor_rel": float(got[:, 2].max())}


def _check_pipe_attention(model, seed=HYBRID_ATTN_SEED):
    """K1 and K2 on this rank's first block: its ln1 and qkv on a seeded
    hidden state [1, S, H], the rank's heads, a seeded dO, against the
    plain versions (K2: dq, dk, dv, the worst per tile)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    blk = model.blocks[str(model.chunk_blocks[0][0])]
    w = blk.ln1.weight
    g = torch.Generator(device=w.device).manual_seed(seed)
    S, D = PIPE_BATCH[1], model.config.head_dim
    with torch.no_grad():
        x = torch.randn(1, S, model.config.hidden_size, generator=g,
                        device=w.device, dtype=w.dtype)
        qkv = blk.attn.qkv_proj(blk.ln1(x)).reshape(1, S, -1, 3 * D)
        q, k, v = (t.contiguous() for t in qkv.split(D, dim=-1))
        out, lse = K1.flash_attention_fwd_lse(q, k, v, True)
        ref, _ = K1.flash_attention_dense(q, k, v, True)
        do = torch.randn(out.shape, generator=g, device=w.device,
                         dtype=out.dtype)
        grads = K1.flash_attention_bwd(q, k, v, out, lse, do, True)
        rgrads = K1.flash_attention_bwd_dense(q, k, v, do, True)
    e = _errs(out, ref)
    e2 = [_errs(a, b) for a, b in zip(grads, rgrads)]
    res = {"block": model.chunk_blocks[0][0], "heads": q.shape[2],
           "k1_rel_err": e[3], "k1_max_abs_err": e[0],
           "k2_rel_err": max(t[3] for t in e2),
           "k2_max_abs_err": max(t[0] for t in e2)}
    if not (e[3] <= TOL[w.dtype] and res["k2_rel_err"] <= TOL[w.dtype]):
        raise AssertionError(f"block {res['block']}'s attention off its "
                             f"plain version per tile: {res}")
    return res


class _K8Probe:
    """K8 on the call the main path makes. While it is entered, the
    optimizer's K8 is wrapped: the call made when ``armed`` takes copies
    of its inputs before the kernel runs (the rank's ZeRO shards, the
    16-byte-aligned bucket views and copies of them, the whole
    parameters, as the step passes them) and keeps the tensors the
    kernel writes. ``check`` runs the plain version on the copies with
    the same scalars and split reduce (a collective: every rank checks)
    and holds the kernel's f32 masters, moments and parameters within
    1e-6 of each tensor's largest magnitude, bf16 parameters within one
    ulp of it (the clip's coefficient may differ in its last bit, as in
    check_fused_adam) and the norms within 1e-5. The copies are made
    inside the armed step, which its time includes."""

    def __init__(self):
        import paddle_tpu_torch.optimizer as O

        self._mod = O
        self.armed = False
        self.call = None

    def __enter__(self):
        real = self._real = self._mod.fused_adam

        def watched(params, grads, masters, moments1, moments2, decays,
                    **kw):
            if not self.armed:
                return real(params, grads, masters, moments1, moments2,
                            decays, **kw)
            self.armed = False

            def copies(ts):
                return [None if t is None else t.detach().clone()
                        for t in ts]
            plain = [copies(ts) for ts in (params, grads, masters, moments1,
                                           moments2)]
            norm = real(params, grads, masters, moments1, moments2, decays,
                        **kw)
            self.call = dict(live=[list(params), list(masters),
                                   list(moments1), list(moments2)],
                             plain=plain, decays=list(decays), kw=kw,
                             norm=norm,
                             shards=sum(not isinstance(t, torch.nn.Parameter)
                                        for t in params),
                             views=sum(g._base is not None for g in grads))
            return norm

        self._mod.fused_adam = watched
        return self

    def __exit__(self, *exc):
        self._mod.fused_adam = self._real
        return False

    def check(self):
        from paddle_tpu_torch.ops.kernels.fused_adam import fused_adam_dense

        c, self.call = self.call, None
        if c is None:
            raise AssertionError("K8 was not called in the watched step")
        p, g, mw, m1, m2 = c["plain"]
        rnorm = fused_adam_dense(p, g, mw, m1, m2, c["decays"], **c["kw"])
        torch.cuda.synchronize()
        rel, scaled, abs_err = 0.0, 0.0, 0.0
        for xs, rs in zip(c["live"], (p, mw, m1, m2)):
            for x, r in zip(xs, rs):
                if x is None:
                    continue
                d = (x.float() - r.float()).abs().max().item()
                top = max(r.float().abs().max().item(), 1e-30)
                abs_err = max(abs_err, d)
                if x.dtype == torch.float32:
                    rel = max(rel, d / top)
                else:
                    scaled = max(scaled, d / (2.0 ** (math.floor(
                        math.log2(top)) - 7)))
        norm = c["norm"]
        res = dict(tensors=len(p), shards=c["shards"], grad_views=c["views"],
                   elements=sum(t.numel() for t in p), rel=rel,
                   ulps_at_max=scaled, max_abs_err=abs_err,
                   norm_err=(abs(norm.item() - rnorm.item()) / rnorm.item()
                             if norm is not None else 0.0))
        if not (rel <= 1e-6 and scaled <= 1.0 and res["norm_err"] <= 1e-5):
            raise AssertionError(f"K8 off its plain version on this rank's "
                                 f"call: {res}")
        return res


def _rank_pipe(out, out_dir):
    """This rank's runs of phase 18 (PIPE_RUNS), one after another."""
    import copy

    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.gpt import GPTForCausalLMPipe
    from paddle_tpu_torch.observability import memledger as ml
    from paddle_tpu_torch.ops.kernels import flash_attention as K1
    from paddle_tpu_torch.ops.kernels.fused_adam import fused_adam

    refs = json.loads((out_dir / "pipe.ref.json").read_text())
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = copy.deepcopy(PIPE_HYBRID)
    strategy.pipeline_configs = {"accumulate_steps": PIPE_M,
                                 "micro_batch_size": PIPE_MICRO}
    hcg = fleet.init(is_collective=True, strategy=strategy)
    sc = strategy.hybrid_configs["sharding_configs"]
    rank = C.get_rank()
    counters = [K1.flash_attention_fwd, K1.flash_attention_bwd, fused_adam]
    B, S = PIPE_BATCH
    runs = {}
    for run, (layers, dtype, stage, steps) in PIPE_RUNS.items():
        sc["sharding_stage"] = stage
        cfg = _hybrid_cfg(layers, dtype)
        model = GPTForCausalLMPipe(cfg, device="cuda", seed=HYBRID_SEED)
        dm = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(_pipe_adamw(model))
        batch = _lm_batch(HYBRID_BATCH_SEED, B, S, cfg.vocab_size, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        probe, calls = _K8Probe(), [0]

        def step(bt):
            calls[0] += 1
            probe.armed = calls[0] == steps
            return dm.train_batch([bt["x"], bt["y"]], opt)
        for c in counters:
            c.launches = 0
        with probe:
            losses, secs, led, staged = _timed_steps(step, batch, steps)
        got = {c.__name__: c.launches for c in counters}
        k8 = probe.check()
        eng = dm._engine
        K = len(model.blocks)
        _expect_launches(got, {K1.flash_attention_fwd.__name__:
                               K * PIPE_M * steps,
                               K1.flash_attention_bwd.__name__:
                               K * PIPE_M * steps,
                               fused_adam.__name__: steps},
                         f"train-pipe {run} rank {rank}")
        ref = refs[f"{layers}-{dtype}"]
        rel = max(_rel(a, b) for a, b in zip(losses, ref))
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
                and rel <= PIPE_GATES[dtype]):
            raise AssertionError(f"train-pipe {run}: losses {losses}, "
                                 f"degree 1 {ref}, worst relative {rel}")
        booked, want = _pipe_closed_form(model, eng, hcg, dtype, led)
        if booked != want:
            raise AssertionError(f"train-pipe {run} rank {rank}: booked "
                                 f"{booked} bytes a step, the closed form "
                                 f"{want}")
        acct = ml.account_engine(eng).components
        measured = {k: acct[k] for k in ("params", "optimizer_state",
                                         "master_weights")}
        closed = eng.zero_closed_form()
        if measured != closed:
            raise AssertionError(f"train-pipe {run} rank {rank}: model "
                                 f"state {measured} bytes, the plan's "
                                 f"closed form {closed}")
        res = dict(_run_stats(B, S, secs, staged, led), losses=losses,
                   degree1_losses=ref, loss_rel_err=rel, launches=got,
                   comm_payload_bytes_last_step=booked,
                   state_bytes=measured, k8=k8,
                   bubble=eng._metrics["pp_bubble"].value(
                       pp_vpp=str(PIPE_VPP)),
                   buckets=eng._bucket_plan.num_buckets)
        # stage 3's parameters whole for the checks, released after
        eng._zstep.gather()
        res.update(tied_equal=_pipe_tied_equal(model, hcg),
                   attention=_check_pipe_attention(model),
                   digest=_pipe_digest(model))
        eng._zstep.after_update({})
        if not res["tied_equal"]:
            raise AssertionError(f"train-pipe {run}: the tied embedding's "
                                 f"copies differ")
        if dtype == "float32":
            res["params_rel_l2"] = _pipe_params_rel(
                model, hcg, out_dir / f"{layers}-{dtype}.ref.pt")
            if not res["params_rel_l2"]["all"] <= PIPE_PARAMS_GATE:
                raise AssertionError(f"train-pipe {run}: parameters "
                                     f"{res['params_rel_l2']} from degree 1")
        runs[run] = res
        del model, dm, opt, eng
        gc.collect()
        torch.cuda.empty_cache()
    out.update(coords=hcg.mesh.coords, runs=runs)


def _pipe_tied_equal(model, hcg):
    """The tied embedding's copies on stage 0 and the last stage
    bit-equal (gathered over the shared group)."""
    from paddle_tpu_torch.distributed import collective as C

    g = hcg.get_pipe_shared_group()
    tied = [p for p in model.parameters()
            if getattr(p, "pp_shared", None) is not None]
    if g.nranks <= 1 or not tied:
        return True
    flat = torch.cat([p.detach().float().reshape(-1) for p in tied])
    got = C.t_all_gather(flat, g, tiled=False)
    return bool(torch.equal(got[0], got[-1]))


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
                  ("paged_attention", "tile_wgmma_kernel", "merge_splits",
                   "f32_tile_kernel")),
                 ("K9 weight_only_linear", ("::gemv_cluster_kernel<",
                                            "::tile_kernel<",
                                            "::wgmma_kernel<",
                                            "::split_sum_kernel<")))


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


def profile_serve(eng, sched, tag="serve"):
    """The same schedule again on the warmed engine, graphed: under
    torch.profiler (device time), then under cProfile (the host's own
    time by function; the token reads' wait on the card among them)."""
    import cProfile
    import pstats

    _profiled(lambda: serve(eng, sched)[1], tag)
    prof = cProfile.Profile()
    prof.enable()
    wall = serve(eng, sched)[1]
    prof.disable()
    rows = sorted(((tt, nc, f"{Path(f).name}:{ln}({fn})")
                   for (f, ln, fn), (_, nc, tt, _, _)
                   in pstats.Stats(prof).stats.items()), reverse=True)
    log(f"[{tag}] host profile (cProfile, one graphed run, wall "
        f"{wall:.4f} s): " + json.dumps(
            [{"fn": name, "calls": nc, "self_ms": 1e3 * tt}
             for tt, nc, name in rows[:24]]))


def _profiled(run, tag):
    """``run()`` (which returns its wall seconds) under torch.profiler:
    device time by kernel name and the device's busy share of the wall
    (one stream, so kernel times add up without overlap)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()
    _log_profile(prof, wall, tag)


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


def check_k9_build(_build):
    """Every K9 kernel built with 0 spill bytes and no wgmma serialised
    by ptxas; each route's dynamic shared memory at the main path's
    shapes and the TMA edge, the wrapper's count equal to the C
    library's; the wgmma body's registers."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import weight_only_linear as K9

    rep = _build.ptxas_report("weight_only_linear")
    bad = {fn: r for fn, r in rep.items()
           if r.get("spill_stores", 1) or r.get("spill_loads", 1)}
    if not rep or bad:
        raise AssertionError(f"K9 built with spills (or no ptxas log): {bad}")
    text = _build._target("weight_only_linear").with_suffix(".log") \
        .read_text()
    serial = [ln for ln in text.splitlines() if "serialized" in ln]
    if serial:
        raise AssertionError(f"K9: ptxas serialised wgmma: {serial}")
    wg = {fn[-40:]: r for fn, r in rep.items() if "wgmma_kernel" in fn}
    if len(wg) != 2:
        raise AssertionError(f"K9's wgmma body (int8, int4) not built: {wg}")
    # gemv_cluster_kernel<MR, INT4, READ>: MR 8 / 16, int8 / int4, the
    # body and its read-only form
    gv = {fn[-40:]: r for fn, r in rep.items()
          if "gemv_cluster_kernel" in fn}
    if len(gv) != 8:
        raise AssertionError(f"K9's gemv body (8 / 16 rows, int8 / int4, "
                             f"its read form) not built: {gv}")
    c_smem = _build.library("weight_only_linear").weight_only_linear_smem
    c_smem.argtypes = [ctypes.c_int] * 4
    c_smem.restype = ctypes.c_int
    smem = {}
    for M, dt in ((8, torch.bfloat16), (16, torch.bfloat16),
                  (2048, torch.bfloat16),
                  (8192, torch.bfloat16), (2048, torch.float32)):
        for K, N in WO_SHAPES[:4]:
            for int4 in (False, True):
                plan = K9.weight_only_route(M, N, K, int4, dt)
                ours = K9.route_smem(plan, int4)
                theirs = c_smem(K9._BODIES[plan.body], plan.rows, plan.ks,
                                int(int4))
                if ours != theirs:
                    raise AssertionError(f"K9 {plan}: the wrapper counts "
                                         f"{ours} bytes of shared memory, "
                                         f"the library {theirs}")
                smem[f"M{M} {str(dt)[6:]} K{K} N{N} int{4 if int4 else 8}"] \
                    = dict(plan._asdict(), smem=ours,
                           grid=K9.route_grid(plan, M, N))
    log(f"[build] K9 routes, dynamic shared memory and grids: "
        f"{json.dumps(smem)}")
    log(f"[build] K9 wgmma body (int8, int4): {json.dumps(wg)}")
    log(f"[build] K9 gemv body: {json.dumps(gv)}")
    log(f"[build] every K9 kernel ({len(rep)}) built with 0 spill bytes "
        f"and no serialised wgmma: OK")


def k10_ptxas(_build):
    """Registers and spill bytes of K10's kernels by body: the product
    kernel and the pre-pass kernels it runs behind, each pre-pass kernel
    in its bf16 and its fp32 instance (the wgmma body's pre-pass on
    16-byte row loads)."""
    rep = _build.ptxas_report("llm_int8_linear")
    pre = {"wgmma": {"colmax_vec_kernel": "17colmax_vec_kernel{}E",
                     "outlier_kernel": "14outlier_kernelE",
                     "quant_kernel": "12quant_kernel{}Lb1E"},
           "gemv": {"small_prepass_kernel": "20small_prepass_kernel{}E"},
           "mma": {"colmax_kernel": "13colmax_kernel{}E",
                   "outlier_kernel": "14outlier_kernelE",
                   "quant_kernel": "12quant_kernel{}Lb0E"}}
    want = {"wgmma": {"wgmma_kernel": "12wgmma_kernelE"},
            "gemv": {"gemv_kernel<8>": "11gemv_kernelILi8EE",
                     "gemv_kernel<16>": "11gemv_kernelILi16EE"},
            "mma": {"gemm_kernel": "11gemm_kernelE"}}
    for body, kernels in pre.items():
        for name, key in kernels.items():
            if "{}" not in key:
                want[body][name] = key
                continue
            for dt, code in (("bf16", "I13__nv_bfloat16"), ("f32", "If")):
                want[body][f"{name} {dt}"] = key.format(code)
    return {body: {name: next((r for fn, r in rep.items() if key in fn),
                              None) for name, key in kernels.items()}
            for body, kernels in want.items()}


def check_k10_build(_build):
    """K10's bodies built (the wgmma body with no wgmma serialised by
    ptxas); their registers and spills."""
    rep = k10_ptxas(_build)
    missing = [f"{b} {k}" for b, ks in rep.items() for k, r in ks.items()
               if r is None]
    if missing:
        raise AssertionError(f"K10 kernels not built: {missing}")
    text = _build._target("llm_int8_linear").with_suffix(".log").read_text()
    serial = [ln for ln in text.splitlines() if "serialized" in ln]
    if serial:
        raise AssertionError(f"K10: ptxas serialised wgmma: {serial}")
    log(f"[build] K10 bodies (registers, spills): {json.dumps(rep)}: OK")


def check_tile_spills(_build):
    """Every K1 tile the library lists is a fwd_wgmma<D, W, BN> instance
    that ptxas built with 0 spill bytes."""

    from paddle_tpu_torch.ops.kernels.flash_attention import fwd_tiles

    insts = flash_instances(_build.ptxas_report("flash_attention"))
    built = {(r["n"], *r["tile"]): r["rep"] for r in insts
             if r["tile"] and not (r["drop"] or r["ranges"])}
    drop = {r["label"]: r["rep"] for r in insts if r["drop"] or r["ranges"]}
    # the dropout instances (the Hopper bodies: K1's default tiles, K2's
    # dq and dk/dv; the bf16 mma.sync bodies at D = 16 and 32, K2's in one
    # launch; the fp32 bodies at NI head-dim elements a lane), the
    # Hopper bodies' frontier-array instances (K2's in one launch) and the
    # mma bodies' no-dropout ones: their spills are recorded, not gated
    log("[build] dropout and frontier-array instances (K1 default tiles, "
        "K2 dq and dk/dv or both in one launch, the mma bodies at D = 16 / "
        "32, the fp32 bodies at NI = 1, 2, 4 head-dim elements a lane): "
        + json.dumps(drop))
    mma = {r["label"]: r["rep"] for r in insts
           if r["kind"] == "mma" and not r["drop"]}
    log("[build] the mma bodies' no-dropout instances: " + json.dumps(mma))
    want = [f"{b}_mma D={D}" + " dropout" * kd for b in ("fwd", "bwd")
            for D in (16, 32) for kd in (0, 1)] + [
        f"{b}_wgmma D={D}" + " dropout" * kd + " ranges"
        for b in ("fwd", "bwd") for D in (64, 128) for kd in (0, 1)]
    if sorted(set(want) - set(drop) - set(mma)):
        raise AssertionError(f"instances not built: "
                             f"{sorted(set(want) - set(drop) - set(mma))}")
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


def mma_times(root):
    """``--mma-times``: K1 and K2 of the checkout at ``root`` (its own
    paddle_tpu_torch and build) timed from CUDA graphs, causal bf16,
    without and with dropout 0.1: the mma bodies at MMA_SHAPES (K2's dq
    and dk/dv parts too, and the pre-pass where the build has one), the
    Hopper bodies at DROPOUT_CASES' bf16 shapes and at the VARLEN_PACKS
    (``pack_times``; "varlen" also at D = 64 without dropout); SDPA
    beside the mma shapes. The first shape is timed twice and its first
    pass dropped (the first shape a process times reads slow). One JSON
    line."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    if Path(K1.__file__).resolve().parents[3] != Path(root).resolve():
        raise AssertionError(f"imported {K1.__file__}, not {root}'s")
    _build.build_all()
    # the one-launch mma backward (this checkout's) has no pre-pass
    fused = "dkv_role" in (Path(root) / "paddle_tpu_torch" / "csrc" /
                           "flash_attention.cu").read_text()
    dev, dt = torch.device("cuda", 0), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(16)
    shapes = [(B, S, H, H, D) for B, S, H, D in MMA_SHAPES] + [
        (B, S, H, KV, D) for _, B, S, H, KV, D, t in DROPOUT_CASES
        if t == dt]
    rows = []
    for i, (B, S, H, KV, D) in enumerate(shapes[:1] + shapes):
        q, k, v, do, _, _ = _flash_inputs(dev, dt, B, S, S, H, KV, D, False, g)
        qt, kt, vt, skw = _sdpa_args(q, k, v, True, None, None)
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        dot = do.transpose(1, 2).contiguous()
        for p in (0.0, DROPOUT_P):
            kw = dict(dropout=p, seed=DROPOUT_SEED + 16 if p else None)
            out, lse = K1.flash_attention_fwd_lse(q, k, v, True, **kw)
            r = dict(shape=[B, S, H, D], kv_heads=KV, dropout=p,
                     fwd_ms=cuda_ms(lambda: K1.flash_attention_fwd_lse(
                         q, k, v, True, **kw)),
                     bwd_ms=cuda_ms(lambda: K1.flash_attention_bwd(
                         q, k, v, out, lse, do, True, **kw)),
                     **_k2_split(K1, q, k, v, out, lse, do, True, None, None,
                                 K1._drop_args(p, kw["seed"], "K2"),
                                 mma=fused and D <= 32))
            if D <= 32:
                r["sdpa_fwd_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, dropout_p=p, **skw))
                r["sdpa_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(qg, kg, vg, dropout_p=p,
                                                   **skw),
                    (qg, kg, vg), dot)) - r["sdpa_fwd_ms"]
            if i:
                rows.append(r)
            del out, lse
        del q, k, v, do, qt, kt, vt, qg, kg, vg, dot
        torch.cuda.empty_cache()
    for name in VARLEN_PACKS:
        for D, p in ((128, 0.0), (128, DROPOUT_P)) + (
                ((64, 0.0),) if name == "varlen" else ()):
            rows.append(pack_times(dev, name, D, p))
    print(json.dumps({"root": root, "rows": rows}), flush=True)


def pack_times(dev, name, D, p):
    """K1 and K2 of a VARLEN_PACKS pack (16 heads of ``D``, bf16, causal,
    dropout ``p``) on the frontier arrays, from CUDA graphs: K2 whole, its
    parts (``_k2_split``) and its dq and dk/dv roles in two launches after
    the pre-pass; the library's varlen flash forward and backward. A row
    of ``--mma-times``."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops.kernels import flash_attention as K1

    q_lens, k_lens = VARLEN_PACKS[name]
    dt = torch.bfloat16
    q, k, v, do, cu_q, cu_k = _varlen_pack(dev, dt, k_lens, 16, D, 13,
                                           q_lens)
    Tq, Tk = q.shape[0], k.shape[0]
    qr, kr = A.varlen_ranges(cu_q, cu_k, Tq, Tk, True, dev)
    q4, k4, v4, do4 = (t[None] for t in (q, k, v, do))
    seed = VARLEN_SEED if p else None
    kk = dict(dropout=p, seed=seed, q_ranges=qr, kv_ranges=kr)
    o4, lse = K1.flash_attention_fwd_lse(q4, k4, v4, **kk)
    drop = K1._drop_args(p, seed, "K2")
    args = (q4, k4, v4, o4, lse, do4, False, 1.0 / D ** 0.5, None, None)
    work = K1._k2(*args, drop=drop, qr=qr, kr=kr)[3]

    def two_launches():
        K1._k2(*args, parts=K1.PREPASS | K1.DQ, work=work, drop=drop, qr=qr,
               kr=kr)
        K1._k2(*args, parts=K1.DKV, work=work, drop=drop, qr=qr, kr=kr)

    lib_fwd, lib_bwd = _varlen_library(q, k, v, do, cu_q, cu_k, p)
    r = dict(pack=name, shape=[1, Tq, 16, D], skv=Tk, kv_heads=16,
             dropout=p,
             fwd_ms=cuda_ms(lambda: K1.flash_attention_fwd_lse(
                 q4, k4, v4, **kk)),
             bwd_ms=cuda_ms(lambda: K1.flash_attention_bwd(
                 q4, k4, v4, o4, lse, do4, **kk)),
             **_k2_split(K1, q4, k4, v4, o4, lse, do4, False, None, None,
                         drop, qr=qr, kr=kr),
             bwd_two_launches_ms=cuda_ms(two_launches),
             library_fwd_ms=cuda_ms(lib_fwd), library_bwd_ms=cuda_ms(lib_bwd))
    del q, k, v, do, q4, k4, v4, do4, o4, lse, work
    torch.cuda.empty_cache()
    return r


def k10_times(root):
    """``--k10-times``: K10 of the checkout at ``root`` (its own
    paddle_tpu_torch and build) timed from CUDA graphs at LLM_INT8_SHAPES,
    bf16, threshold 6.0, with 8 planted outlier columns and with none
    (the weights rotated through 3 copies, past the L2): the call, its
    pre-pass apart (``k10_prepass_ms``: the kernels but the product),
    torch._int_mm on the same xq and q (M > 16) and F.linear on a bf16
    copy of the dequantized weight; the body and CTAs where the checkout
    routes. The first shape is timed twice and its first pass dropped.
    One JSON line."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import llm_int8_linear as K10

    if Path(K10.__file__).resolve().parents[3] != Path(root).resolve():
        raise AssertionError(f"imported {K10.__file__}, not {root}'s")
    _build.library("llm_int8_linear")
    dev, thr = torch.device("cuda", 0), 6.0
    g = torch.Generator(device=dev).manual_seed(17)
    cases = [(shape, planted) for shape in LLM_INT8_SHAPES
             for planted in (True, False)]
    rows = []
    for i, ((M, K, N), planted) in enumerate(cases[:1] + cases):
        x, q, s = _llm_int8_inputs(dev, M, K, N, torch.bfloat16, planted, g)
        qi = itertools.cycle([q] + [q.clone() for _ in range(2)])
        call = lambda: K10.llm_int8_linear(x, next(qi), s,  # noqa: E731
                                           None, thr)
        r = dict(shape=[M, K, N], planted=planted, ms=cuda_ms(call),
                 prepass_ms=k10_prepass_ms(call)[0])
        if hasattr(K10, "llm_int8_route"):
            plan = K10.llm_int8_route(M, N, K)
            r.update(body=plan.body, tiles=K10.route_tiles(plan, M, N))
        _, parts = K10.llm_int8_linear(x, q, s, None, thr, parts=True)
        xq = parts["xq"].contiguous()
        r["int_mm_ms"] = (cuda_ms(lambda: torch._int_mm(xq, next(qi).t()))
                          if M > 16 else None)
        wl = (q.float() * s[:, None]).to(torch.bfloat16)
        li = itertools.cycle([wl] + [wl.clone() for _ in range(2)])
        r["flinear_ms"] = cuda_ms(lambda: F.linear(x, next(li)))
        if i:
            rows.append(r)
        del x, q, s, qi, call, parts, xq, wl, li
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "rows": rows}), flush=True)


def compare_roots(roots):
    """``--compare``: ``mma_times`` and ``k10_times`` of each checkout
    root in turn, each in a process of its own, then the K1 / K2 and K10
    ms side by side by shape."""
    for kind in ("mma", "k10"):
        runs = []
        for root in roots:
            res = subprocess.run([sys.executable,
                                  str(Path(__file__).resolve()),
                                  f"--{kind}-times", root],
                                 capture_output=True, text=True)
            if res.returncode:
                raise AssertionError(f"--{kind}-times {root} failed: "
                                     f"{res.stderr[-4000:]}")
            runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
            log(f"[compare] {root}: " + json.dumps(runs[-1]["rows"]))
        for i, r in enumerate(runs[0]["rows"]):
            cols = {key: [run["rows"][i].get(key) for run in runs]
                    for key in r if key == "ms" or key.endswith("_ms")}
            what = (f"K10 {r['shape']} planted {r['planted']}"
                    if kind == "k10" else
                    f"{r.get('pack', '')} {r['shape']} kv {r['kv_heads']} "
                    f"p {r['dropout']}")
            log(f"[compare] {what} (roots {', '.join(roots)}): "
                + json.dumps(cols))


def compare_train(roots):
    """``--compare-train``: the train-gpt phase of each checkout root in
    turn, each root's own ``chip_smoke.py`` in a process of its own (its
    package, its build), then each run's step ms side by side: the cost
    of what one root adds to every step (its telemetry, say)."""
    runs = []
    for root in roots:
        res = subprocess.run([sys.executable, "chip_smoke.py", "--phases",
                              "build,train-gpt"], cwd=root,
                             capture_output=True, text=True)
        if res.returncode:
            raise AssertionError(f"train-gpt in {root} failed: "
                                 f"{res.stderr[-4000:]}")
        rows = [json.loads(ln.split("[train-gpt] ", 1)[1])
                for ln in res.stdout.splitlines()
                if ln.startswith("[train-gpt] {")]
        runs.append({r["dropout"]: r for r in rows})
        for r in rows:
            log(f"[compare-train] {root} dropout {r['dropout']}: "
                + json.dumps({k: r[k] for k in ("step_ms_p50", "step_ms",
                                                "mfu", "peak_mem_gib")}))
    for p in sorted(runs[0]):
        log(f"[compare-train] dropout {p} step ms p50 (roots "
            f"{', '.join(roots)}): "
            + json.dumps([run[p]["step_ms_p50"] for run in runs]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="depth of the 7B-width serving, generate and "
                    "weight-only runs")
    ap.add_argument("--phases",
                    default="build,kernels,masked-attention,parity,serve,"
                            "serve-disagg,serve-prefix-spec,"
                            "generate,weight-only,load-serve,train-parity,"
                            "train,train-autotune,gpt-parity,train-gpt,"
                            "varlen,train-surface,train-ckpt,train-hybrid,"
                            "train-llama-hybrid,train-pipe")
    ap.add_argument("--profile", action="store_true",
                    help="serve the schedule once more (and the prefix and "
                    "draft configuration's), run 16 more decode steps of "
                    "each generate run and two more train steps under "
                    "torch.profiler, and print device time by kernel")
    ap.add_argument("--k1-probe", action="store_true",
                    help="the train-autotune phase's second process: one K1 "
                    "call with FLAGS_use_autotune on, over the cache file "
                    "$PADDLE_TPU_TORCH_AUTOTUNE_CACHE names")
    ap.add_argument("--compare",
                    help="developer: comma-separated checkout roots (e.g. "
                    "build/parent,.,.,build/parent); K1/K2 of each timed in "
                    "turn at the mma shapes, the Hopper dropout cases and "
                    "the varlen packs, and K10 at LLM_INT8_SHAPES, each "
                    "root in its own process, printed side by side")
    ap.add_argument("--compare-train",
                    help="developer: comma-separated checkout roots; the "
                    "train-gpt phase of each in turn (its own chip_smoke.py "
                    "and build), step ms p50 printed side by side")
    ap.add_argument("--compare-serve",
                    help="developer: comma-separated checkout roots; the "
                    "serve phase of each in turn (its own chip_smoke.py and "
                    "build), graphed tokens/s and TPOT p50 side by side")
    ap.add_argument("--hybrid-rank", help=argparse.SUPPRESS)
    ap.add_argument("--hybrid-dir", help=argparse.SUPPRESS)
    ap.add_argument("--mma-times", help=argparse.SUPPRESS)
    ap.add_argument("--k10-times", help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = args.phases.split(",")

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; it runs the port on one card")
    repo = Path(args.mma_times or args.k10_times
                or Path(__file__).resolve().parent)
    if args.compare:
        compare_roots(args.compare.split(","))
        return
    if args.compare_train:
        compare_train(args.compare_train.split(","))
        return
    if args.compare_serve:
        compare_serve(args.compare_serve.split(","))
        return
    if not (repo / "paddle_tpu_torch").is_dir():
        sys.exit("chip_smoke.py: run it from the root of a checkout "
                 "(paddle_tpu_torch/ not found beside it)")
    sys.path.insert(0, str(repo))
    if args.hybrid_rank:
        # one rank of the train-hybrid phase, under the port's launcher
        hybrid_rank(args.hybrid_rank, args.hybrid_dir)
        return
    if args.k1_probe:
        k1_probe()
        return
    if args.mma_times:
        mma_times(args.mma_times)
        return
    if args.k10_times:
        k10_times(args.k10_times)
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
        flash_attention_bwd, flash_attention_bwd_dropout,
        flash_attention_bwd_varlen, flash_attention_fwd,
        flash_attention_fwd_dropout, flash_attention_fwd_varlen)
    from paddle_tpu_torch.ops.kernels.fused_adam import fused_adam
    from paddle_tpu_torch.ops.kernels.llm_int8_linear import llm_int8_linear
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        ragged_paged_attention
    from paddle_tpu_torch.ops.kernels.rms_norm import rms_norm
    from paddle_tpu_torch.ops.kernels.weight_only_linear import (
        weight_only_linear, weight_only_linear_wgmma)

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f}s")
    # registers and spills of the attention kernels and K9 (nvcc -Xptxas -v)
    for src in ("flash_attention", "paged_attention", "weight_only_linear",
                "llm_int8_linear"):
        for fn, rep in _build.ptxas_report(src).items():
            log(f"[build] ptxas {fn}: {json.dumps(rep)}")
    check_tile_spills(_build)
    check_k9_build(_build)
    check_k10_build(_build)

    dev = torch.device("cuda", 0)
    results = []
    clock = [time.perf_counter()]

    def tick(what):
        """Log the seconds since the last tick (a phase's wall time)."""
        now = time.perf_counter()
        log(f"[time] {what}: {now - clock[0]:.1f}s")
        clock[0] = now

    k7 = {}   # K7's numbers: the kernels phase's, then train-autotune's
    llm_int8_path = {"llm_int8_linear": None}
    if "kernels" in phases:
        llm_int8_path = check_llm_int8(dev, results, [llm_int8_linear])
        check_weight_only(dev, results)
        check_rms(dev, results)
        check_attention(dev, results)
        check_decode(dev, results)
        check_flash(dev, results)
        check_flash_tiles(dev, results, k7)
        check_flash_dropout(dev, results)
        check_fused_adam(dev, results)
        check_fused_adam_split(dev, results)
        check_head_offset(dev, results)
        for r in read_ceiling(dev):
            log("[kernels] read ceiling " + json.dumps(r))
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
        tick("kernels")
    if "masked-attention" in phases:
        phase_masked_attention(dev)
    if "parity" in phases:
        phase_parity()
        weight_only_parity()
    tick("masked-attention, parity")
    # each path is driven with its kernels' counts set to 0 just before
    # it and read just after: serving (with the prefix cache and a draft
    # too) runs K3, K4, K5; static-cache generation K3, K6; paged
    # generation K3, K5; weight-only serving and generation K9 beside
    # those (its wgmma body counted on its own too); training K3, K1, K2,
    # K8
    paths = {"serve": [rms_norm, ragged_paged_attention,
                       paged_decode_attention],
             # the phase-split fleet's serve (1 prefill + 1 decode replica)
             "serve_disagg": [rms_norm, ragged_paged_attention,
                              paged_decode_attention],
             "serve_prefix_spec": [rms_norm, ragged_paged_attention,
                                   paged_decode_attention],
             "generate_static": [rms_norm, decode_attention],
             "generate_paged": [rms_norm, paged_decode_attention],
             "train": [rms_norm, flash_attention_fwd, flash_attention_bwd,
                       fused_adam],
             "train_autotune": [rms_norm, flash_attention_fwd,
                                flash_attention_bwd, fused_adam,
                                measure_flash_blocks],
             # GPT (LayerNorm, no K3): both runs of train-gpt read these
             "train_gpt": [flash_attention_fwd, flash_attention_bwd,
                           fused_adam, flash_attention_fwd_dropout,
                           flash_attention_bwd_dropout],
             # the varlen pack through flash_attn_unpadded (both runs)
             "varlen": [flash_attention_fwd, flash_attention_bwd,
                        flash_attention_fwd_varlen,
                        flash_attention_bwd_varlen,
                        flash_attention_fwd_dropout,
                        flash_attention_bwd_dropout],
             "train_surface": [flash_attention_fwd, flash_attention_bwd,
                               fused_adam],
             # gpt_tiny in bf16 with dropout: the mma bodies' kDrop
             "train_surface_tiny": [flash_attention_fwd, flash_attention_bwd,
                                    flash_attention_fwd_dropout,
                                    flash_attention_bwd_dropout,
                                    fused_adam],
             # gpt_tiny in bf16 without dropout: the mma bodies' others
             "train_surface_tiny_plain": [flash_attention_fwd,
                                          flash_attention_bwd,
                                          flash_attention_fwd_dropout,
                                          flash_attention_bwd_dropout,
                                          fused_adam],
             # gpt_1p3b's widths at 4 layers with dropout, checkpointed
             # and resumed: run A's 8 steps
             "train_ckpt": [flash_attention_fwd, flash_attention_bwd,
                            flash_attention_fwd_dropout,
                            flash_attention_bwd_dropout, fused_adam],
             # phase 16: one rank of mp 2 (gpt_1p3b, bf16) at dropout 0
             "train_hybrid": [flash_attention_fwd, flash_attention_bwd,
                              fused_adam, flash_attention_fwd_dropout,
                              flash_attention_bwd_dropout],
             # phase 17: one rank of mp 2 (Llama-7B widths, bf16, 8
             # layers), then the same under recompute; the fp32 run; the
             # SP stack and it under recompute
             "train_llama_hybrid": [rms_norm, flash_attention_fwd,
                                    flash_attention_bwd, fused_adam],
             "train_llama_hybrid_recompute": [rms_norm, flash_attention_fwd,
                                              flash_attention_bwd,
                                              fused_adam],
             "train_llama_hybrid_fp32": [rms_norm, flash_attention_fwd,
                                         flash_attention_bwd, fused_adam],
             "train_llama_sp": [rms_norm, flash_attention_fwd,
                                flash_attention_bwd, fused_adam],
             "train_llama_sp_recompute": [rms_norm, flash_attention_fwd,
                                          flash_attention_bwd, fused_adam],
             # phase 18: one rank of mp 2 x pp 2 x sharding 2, vpp 2
             # (gpt_1p3b, bf16, 8 layers) at stage 2, then 3; the fp32 run
             "train_pipe": [flash_attention_fwd, flash_attention_bwd,
                            fused_adam],
             "weight_only_generate_static": [rms_norm, decode_attention,
                                             weight_only_linear,
                                             weight_only_linear_wgmma],
             "weight_only_generate_paged": [rms_norm, paged_decode_attention,
                                            weight_only_linear,
                                            weight_only_linear_wgmma],
             "weight_only_serve": [rms_norm, ragged_paged_attention,
                                   paged_decode_attention,
                                   weight_only_linear,
                                   weight_only_linear_wgmma],
             "weight_only_int4_generate_static": [rms_norm,
                                                  decode_attention,
                                                  weight_only_linear,
                                                  weight_only_linear_wgmma],
             # a saved 7B-width model served from its params file
             "load_serve": [rms_norm, decode_attention]}
    by_path = {p: {c.__name__: None for c in cs} for p, cs in paths.items()}
    # nn.quant.llm_int8_linear at Llama-7B's widths (the kernels phase)
    by_path["llm_int8"] = llm_int8_path
    # the bf16 runs' summaries, printed beside the weight-only ones
    bf16 = {"serve": [], "generate": [], "generate_outs": {}}
    if {"serve", "serve-disagg", "serve-prefix-spec", "generate",
            "weight-only"} & set(phases):
        model = build_7b(args.layers)
        if "serve" in phases:
            by_path["serve"], bf16["serve"] = phase_serve(
                model, paths["serve"], args.profile)
            gc.collect()
            torch.cuda.empty_cache()
        if "serve-disagg" in phases:
            by_path["serve_disagg"] = phase_serve_disagg(
                model, paths["serve_disagg"])
            gc.collect()
            torch.cuda.empty_cache()
        if "serve-prefix-spec" in phases:
            by_path["serve_prefix_spec"] = phase_serve_prefix_spec(
                model, paths["serve_prefix_spec"], args.profile)
        if "generate" in phases:
            launches, bf16["generate"], bf16["generate_outs"] = \
                phase_generate(model, paths, args.profile)
            by_path.update(("generate_" + k, v) for k, v in launches.items())
        if "weight-only" in phases:
            # quantizes the shared model in place: after every bf16 path
            by_path.update(phase_weight_only(model, paths, bf16,
                                             args.profile))
        del model
        gc.collect()
        torch.cuda.empty_cache()
        if "weight-only" in phases:
            model = build_7b(args.layers)
            by_path.update(phase_weight_only_int4(model, paths, bf16,
                                                  args.profile))
            del model
            gc.collect()
            torch.cuda.empty_cache()
        tick("serve, serve-disagg, serve-prefix-spec, generate, "
             "weight-only")
    if "load-serve" in phases:
        by_path["load_serve"] = phase_load_serve(paths["load_serve"])
    if "train-parity" in phases:
        phase_train_parity()
    tick("load-serve, train-parity")
    train_losses = None
    if "train" in phases:
        by_path["train"], train_losses = phase_train(paths["train"],
                                                     args.profile)
        torch.cuda.empty_cache()
    if "train-autotune" in phases:
        by_path["train_autotune"] = phase_train_autotune(
            paths["train_autotune"], k7, train_losses)
    tick("train, train-autotune")
    if "gpt-parity" in phases:
        phase_gpt_parity()
    by_path["train_gpt_dropout"] = dict(by_path["train_gpt"])
    if "train-gpt" in phases:
        by_path.update(phase_train_gpt(paths["train_gpt"]))
        gc.collect()
        torch.cuda.empty_cache()
    by_path["varlen_dropout"] = dict(by_path["varlen"])
    if "varlen" in phases:
        by_path.update(phase_varlen(dev, results, paths["varlen"]))
    if "train-surface" in phases:
        by_path.update(phase_train_surface(dev, paths))
    if "train-ckpt" in phases:
        by_path["train_ckpt"] = phase_train_ckpt(paths["train_ckpt"])
        gc.collect()
        torch.cuda.empty_cache()
    tick("gpt-parity, train-gpt, varlen, train-surface, train-ckpt")
    if "train-hybrid" in phases:
        by_path.update(phase_train_hybrid(paths["train_hybrid"]))
        gc.collect()
        torch.cuda.empty_cache()
        tick("train-hybrid")
    if "train-llama-hybrid" in phases:
        by_path.update(phase_train_llama_hybrid(dev, results))
        gc.collect()
        torch.cuda.empty_cache()
        tick("train-llama-hybrid")
    if "train-pipe" in phases:
        by_path.update(phase_train_pipe(paths["train_pipe"]))
        tick("train-pipe")

    # one entry per kernel: the main path's dtype (bf16) at its main shape
    main_shape = {"rms_norm": [2048, 4096],
                  "ragged_paged_attention": [8, 256, 32, 128],
                  "paged_decode_attention": [8, 1, 32, 128],
                  "decode_attention": [8, 1, 32, 128],
                  "flash_attention_fwd": [4, 2048, 32, 128],
                  "flash_attention_bwd": [4, 2048, 32, 128],
                  "flash_attention_fwd_dropout": [4, 2048, 16, 128],
                  "flash_attention_bwd_dropout": [4, 2048, 16, 128],
                  "flash_attention_fwd_varlen": [1, 4608, 16, 128],
                  "flash_attention_bwd_varlen": [1, 4608, 16, 128],
                  "flash_attention_fwd_dropout_mma": TINY_SHAPE,
                  "flash_attention_bwd_dropout_mma": TINY_SHAPE,
                  "flash_attention_fwd_mma": TINY_SHAPE,
                  "flash_attention_bwd_mma": TINY_SHAPE,
                  "fused_adam": [_FUSED_ADAM_N],
                  "weight_only_linear": [8, 4096, 11008],
                  "weight_only_linear_wgmma": [2048, 4096, 11008],
                  "llm_int8_linear": [2048, 4096, 11008]}
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
        # K1/K2's dropout variants, on gpt_1p3b's second train-gpt run
        "flash_attention_fwd_dropout": (
            "paddle_tpu_torch/csrc/flash_attention.cu", f"{flash}:432",
            "train_gpt_dropout"),
        "flash_attention_bwd_dropout": (
            "paddle_tpu_torch/csrc/flash_attention.cu", f"{flash}:307",
            "train_gpt_dropout"),
        # K1/K2 with the per-sequence frontiers: the varlen pack (phase 13)
        "flash_attention_fwd_varlen": (
            "paddle_tpu_torch/csrc/flash_attention.cu", f"{flash}:432",
            "varlen"),
        "flash_attention_bwd_varlen": (
            "paddle_tpu_torch/csrc/flash_attention.cu", f"{flash}:307",
            "varlen"),
        # the mma bodies' dropout instances (bf16, D = 16 / 32), counted by
        # the dropout variants' counters on gpt_tiny's run (phase 14.4),
        # where only the D = 16 mma body runs
        "flash_attention_fwd_dropout_mma": (
            "paddle_tpu_torch/csrc/flash_attention.cu", f"{flash}:432",
            "train_surface_tiny", "flash_attention_fwd_dropout"),
        "flash_attention_bwd_dropout_mma": (
            "paddle_tpu_torch/csrc/flash_attention.cu", f"{flash}:307",
            "train_surface_tiny", "flash_attention_bwd_dropout"),
        # their no-dropout instances, on gpt_tiny's run without dropout
        "flash_attention_fwd_mma": (
            "paddle_tpu_torch/csrc/flash_attention.cu", f"{flash}:432",
            "train_surface_tiny_plain", "flash_attention_fwd"),
        "flash_attention_bwd_mma": (
            "paddle_tpu_torch/csrc/flash_attention.cu", f"{flash}:307",
            "train_surface_tiny_plain", "flash_attention_bwd"),
        "fused_adam": ("paddle_tpu_torch/csrc/fused_adam.cu",
                       "paddle_tpu/optimizer/__init__.py:211", "train"),
        "weight_only_linear": ("paddle_tpu_torch/csrc/weight_only_linear.cu",
                               "paddle_tpu/nn/quant.py:78",
                               "weight_only_serve"),
        # K9's wgmma body (bf16 M > 16: the unified rounds and prefill)
        "weight_only_linear_wgmma": (
            "paddle_tpu_torch/csrc/weight_only_linear.cu",
            "paddle_tpu/nn/quant.py:78", "weight_only_serve"),
        # port-only: LLM.int8's int8 product (the JAX package leaves it to
        # XLA), on nn.quant.llm_int8_linear's path
        "llm_int8_linear": ("paddle_tpu_torch/csrc/llm_int8_linear.cu",
                            "paddle_tpu/nn/quant.py:97", "llm_int8")}
    kernels = []
    for name, (src, repl, path, *counter) in meta.items():
        counter = counter[0] if counter else name
        # the wgmma body's rows are K9's own, at M > 16 in bf16
        mine = [r for r in results if r["name"] == name or (
            name == "weight_only_linear_wgmma" and r.get("body") == "wgmma")]
        main = [r for r in mine if r["shape"] == main_shape[name]
                and r["dtype"] == "bfloat16" and "blocks" not in r
                and ("kv_heads" not in r or r["kv_heads"] == r["shape"][2])
                and not r.get("diagnostic")
                and r.get("bits", 8) == 8 and not r.get("bias")]
        row = main[0] if main else {}
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=by_path[path][counter],
            launches_by_path={p: n[counter] for p, n in by_path.items()
                              if counter in n},
            max_abs_err=max((r["max_abs_err"] for r in mine), default=None),
            ms=row.get("ms"), plain_ms=row.get("plain_ms"),
            bound_ms=row.get("bound_ms"), bound_by=row.get("bound_by"),
            library_ms=row.get("library_ms"), shape=main_shape[name],
            dtype="bfloat16",
            **{k: row[k] for k in ("body", "splits", "cluster", "kernels",
                                   "workspace_bytes", "ptxas", "tiles",
                                   "prepass_ms") if k in row}))
    kernels.append(k7_entry(k7, results,
                            by_path["train_autotune"]["measure_flash_blocks"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

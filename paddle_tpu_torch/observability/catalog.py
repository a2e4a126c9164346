"""The metric catalog: every instrument the engines emit, in one place.

Names, label sets, units, and bucket lattices are API — dashboards and
the scrape config key on them — so they are defined HERE once, mirrored
into ``schema.json``, and pinned by a tier-1 test
(tests/test_torch_observability.py): adding/renaming a metric without
updating the schema fails CI instead of silently breaking dashboards.

Counterpart of ``paddle_tpu/observability/catalog.py``, whole and
unchanged, help strings included: the port's ``schema.json`` is the JAX
package's, so one dashboard reads both. Of these sets the port
publishes ``train_metrics`` (its memory-ledger series with
``mem_ledger``; less the comm / pipeline / MoE series, which wait on
ROADMAP.md queue 1, items 8-10), ``serving_metrics`` (the serving
engine, the KV migrator and the router; no collective series),
``health_metrics``, ``ckpt_metrics``, ``goodput_metrics`` and
``timeseries_metrics``.

All metrics live in the global registry (one process = one exposition);
concurrent engines share series, which is the Prometheus model.
"""
from __future__ import annotations

from typing import Dict

from .metrics import (DEFAULT_LATENCY_BUCKETS, MetricsRegistry,
                      get_registry)

__all__ = ["train_metrics", "serving_metrics", "comm_metrics",
           "mem_metrics", "ckpt_metrics", "goodput_metrics",
           "health_metrics", "offload_metrics", "timeseries_metrics",
           "fleet_metrics", "SCHEMA_PATH"]

SCHEMA_PATH = __file__.rsplit("/", 1)[0] + "/schema.json"

# Sub-second lattice for decode-side latencies (TPOT sits at ~1-50ms on
# chip): denser low end than the generic latency lattice.
_FAST_BUCKETS = (0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1,
                 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def comm_metrics(reg: MetricsRegistry = None) -> Dict[str, object]:
    """Register (get-or-create) the communication-ledger instrument
    set — shared by the train and serving engines (both publish their
    compiled programs' static comm ledgers through it)."""
    r = reg or get_registry()
    return {
        "comm_bytes": r.counter(
            "paddle_tpu_comm_bytes_total",
            "bytes-on-wire per participant, from the static comm "
            "ledger of every executed compiled program (closed-form "
            "ring accounting; see observability/commledger.py)",
            labelnames=("axis", "op"), unit="bytes"),
        "comm_ops": r.counter(
            "paddle_tpu_comm_ops_total",
            "collectives issued per executed compiled program, from "
            "the static comm ledger (per traced call site; scan "
            "bodies count once)", labelnames=("axis", "op")),
        "comm_exposed_seconds": r.gauge(
            "paddle_tpu_comm_exposed_seconds",
            "per-axis comm wall time EXPOSED on the step's critical "
            "path: t(full step) - t(step with this axis's collectives "
            "ablated), from profile_exposed_comm()",
            labelnames=("axis",), unit="s"),
        "comm_replay_seconds": r.gauge(
            "paddle_tpu_comm_replay_seconds",
            "per-axis total comm time: wall time of a standalone "
            "back-to-back replay of the axis's ledger collectives "
            "(nothing to hide behind)", labelnames=("axis",), unit="s"),
        "comm_exposed_fraction": r.gauge(
            "paddle_tpu_comm_exposed_fraction",
            "exposed / max(replay, exposed) per axis: 1.0 = the "
            "axis's comm is fully serialized on the critical path, "
            "0.0 = fully hidden behind compute",
            labelnames=("axis",)),
        "grad_sync_exposed": r.gauge(
            "paddle_tpu_grad_sync_exposed_seconds",
            "exposed comm seconds summed over the data-parallel axes "
            "(dp/sharding) — the T3-overlap headline: how much of "
            "gradient synchronization the step fails to hide",
            unit="s"),
        "comm_quant_ratio": r.gauge(
            "paddle_tpu_comm_quant_ratio",
            "realized wire compression per axis of the last compiled "
            "program: quantized bytes-on-wire (int8/fp8 payload + "
            "bf16 scale sidecars) / the uncompressed-equivalent bytes "
            "— ~0.25-0.27 for int8 over fp32 at practical chunk "
            "sizes; only published for axes carrying quantized "
            "collectives (distributed/quant_comm.py)",
            labelnames=("axis",)),
    }


def mem_metrics(reg: MetricsRegistry = None) -> Dict[str, object]:
    """Register (get-or-create) the HBM memory-ledger instrument set —
    shared by the train and serving engines (both store per-executable
    memory ledgers and a model-state accounting;
    observability/memledger.py)."""
    r = reg or get_registry()
    return {
        "mem_temp": r.gauge(
            "paddle_tpu_mem_temp_bytes",
            "scratch bytes one execution of the compiled program peaks "
            "through mid-step (activations, remat windows, collective "
            "staging), per device — XLA buffer assignment via "
            "memory_analysis()", labelnames=("program",), unit="bytes"),
        "mem_argument": r.gauge(
            "paddle_tpu_mem_argument_bytes",
            "input buffer bytes the compiled program reads (params, "
            "optimizer state, batch), per device",
            labelnames=("program",), unit="bytes"),
        "mem_output": r.gauge(
            "paddle_tpu_mem_output_bytes",
            "result buffer bytes the compiled program writes, per "
            "device", labelnames=("program",), unit="bytes"),
        "mem_alias": r.gauge(
            "paddle_tpu_mem_alias_bytes",
            "bytes shared between arguments and outputs by donation "
            "(buffer aliasing; counted in both classes, subtracted "
            "once from the peak)", labelnames=("program",),
            unit="bytes"),
        "mem_code": r.gauge(
            "paddle_tpu_mem_generated_code_bytes",
            "the executable's own code + embedded constants, per "
            "device", labelnames=("program",), unit="bytes"),
        "mem_state": r.gauge(
            "paddle_tpu_mem_state_bytes",
            "measured per-device model-state footprint by component "
            "(params / grads / optimizer_state / master_weights / "
            "activation_ckpt / host_state), addressable-shard bytes — "
            "ZeRO scatter, pp x vpp chunk ownership, and the host-"
            "offload tier's host-resident split included "
            "(memledger.account_engine)", labelnames=("component",),
            unit="bytes"),
        "mem_drift": r.gauge(
            "paddle_tpu_mem_analytic_drift",
            "(analytic - measured) / measured of the auto_tuner memory "
            "model vs the measured state accounting — the gauge that "
            "validates hbm_gb pruning against reality"),
        "mem_live": r.gauge(
            "paddle_tpu_mem_live_bytes",
            "device bytes held by live jax arrays at the last step "
            "boundary (memledger.live_bytes; the watermark source on "
            "backends without memory_stats)", unit="bytes"),
        "mem_live_peak": r.gauge(
            "paddle_tpu_mem_live_peak_bytes",
            "high-water mark of paddle_tpu_mem_live_bytes over the "
            "engine's lifetime, sampled at step boundaries",
            unit="bytes"),
    }


def offload_metrics(reg: MetricsRegistry = None) -> Dict[str, object]:
    """Register (get-or-create) the host-memory offload tier's
    instrument set — shared by the train engine (optimizer moments /
    AMP masters / EF residuals / stored param shards,
    distributed/host_offload.py) and the serving engine (cold KV page
    spill, ``component="kv_page"``). Transfer gauges are CUMULATIVE
    closed-form byte/op totals (per-device addressable-shard bytes per
    slot; page_bytes per spilled page) — bench lines pin them against
    the analytic form exactly."""
    r = reg or get_registry()
    return {
        "bytes": r.gauge(
            "paddle_tpu_offload_transfer_bytes",
            "cumulative host<->device transfer bytes of the offload "
            "tier by state component and direction (d2h = page-out / "
            "spill, h2d = prefetch / fault-back), booked at the "
            "closed form: per-device addressable-shard bytes per slot "
            "(memledger.shard_bytes), page_bytes per KV page",
            labelnames=("component", "direction"), unit="bytes"),
        "ops": r.gauge(
            "paddle_tpu_offload_transfer_ops",
            "cumulative offload-tier transfers by component and "
            "direction (one op per slot / per KV page)",
            labelnames=("component", "direction")),
        "host": r.gauge(
            "paddle_tpu_offload_host_bytes",
            "per-device state bytes currently resident on the host "
            "tier by component — what HBM is NOT holding between "
            "steps (mirrors memledger's host_state accounting "
            "component)", labelnames=("component",), unit="bytes"),
        "prefetch_seconds": r.gauge(
            "paddle_tpu_offload_prefetch_seconds",
            "wall seconds the last dispatch spent re-placing host-"
            "tier state on device (also journaled as an OVERLAPPED "
            "goodput segment, like the async checkpoint writer)",
            unit="s"),
        "spilled_pages": r.gauge(
            "paddle_tpu_offload_spilled_pages",
            "cold KV-cache pages currently resident on the host tier "
            "(spilled out of the fixed device page pool by LRU "
            "eviction; they fault back through the normal page "
            "allocation on a prefix hit)"),
    }


def ckpt_metrics(reg: MetricsRegistry = None) -> Dict[str, object]:
    """Register (get-or-create) the checkpoint instrument set —
    published by :class:`distributed.checkpoint.CheckpointManager`
    after every commit (and on ``publish()`` so the age gauge keeps
    counting between saves)."""
    r = reg or get_registry()
    return {
        "age": r.gauge(
            "paddle_tpu_ckpt_last_save_age_seconds",
            "seconds since the last COMMITTED checkpoint (refreshed on "
            "every commit and CheckpointManager.publish(); growing "
            "without bound = saves are failing or stopped)", unit="s"),
        "save_seconds": r.gauge(
            "paddle_tpu_ckpt_save_seconds",
            "wall time of the last completed checkpoint save by phase: "
            "snapshot = device->host shard copy (the only stall the "
            "step loop sees in async mode), write = the commit "
            "protocol's file I/O, total = snapshot + write",
            labelnames=("phase",), unit="s"),
        "save_bytes": r.gauge(
            "paddle_tpu_ckpt_save_bytes",
            "bytes this process's shards contributed to the last "
            "completed checkpoint save", unit="bytes"),
        "last_step": r.gauge(
            "paddle_tpu_ckpt_last_committed_step",
            "training step of the newest committed checkpoint"),
        "pending": r.gauge(
            "paddle_tpu_ckpt_async_pending",
            "async checkpoint saves snapshotted but not yet committed "
            "(writer-thread queue depth; stuck >0 = storage stalled)"),
        "saves": r.counter(
            "paddle_tpu_ckpt_saves_total",
            "checkpoint saves by outcome (committed = the COMMIT "
            "marker hit disk)", labelnames=("result",)),
    }


def goodput_metrics(reg: MetricsRegistry = None) -> Dict[str, object]:
    """Register (get-or-create) the run-level goodput instrument set —
    published by the attached :class:`observability.goodput.
    GoodputLedger` (wall-clock attribution across restarts; the
    crash-durable journal under the checkpoint base dir is the source
    of truth, these gauges are its live view)."""
    r = reg or get_registry()
    return {
        "goodput_segments": r.gauge(
            "paddle_tpu_goodput_segment_seconds",
            "cumulative run wall time attributed to each goodput "
            "segment (compile / step_compute / ckpt_stall / ckpt_async "
            "/ restore / recovery_restart / input_wait / idle), "
            "restart-spanning (observability/goodput.py journal)",
            labelnames=("segment",), unit="s"),
        "goodput_pct": r.gauge(
            "paddle_tpu_goodput_pct",
            "productive step seconds / run wall seconds x 100, across "
            "restart boundaries — the run-level goodput headline",
            unit="pct"),
        "goodput_wall": r.gauge(
            "paddle_tpu_goodput_wall_seconds",
            "wall seconds since the run's first journal record, "
            "crashes and restarts included", unit="s"),
        "goodput_restarts": r.gauge(
            "paddle_tpu_goodput_restarts",
            "process restarts the run's goodput journal has absorbed "
            "(each closed a recovery_restart segment)"),
    }


def health_metrics(reg: MetricsRegistry = None) -> Dict[str, object]:
    """Register (get-or-create) the training health-monitor instrument
    set (observability/healthmon.py: rolling median+MAD anomaly events
    over loss / grad-norm / step time, cross-host straggler skew)."""
    r = reg or get_registry()
    return {
        "events": r.counter(
            "paddle_tpu_health_events_total",
            "health anomaly events by kind: loss_spike / "
            "grad_norm_spike / loss_nonfinite / step_time_stall "
            "(robust rolling median+MAD detection; each event also "
            "lands in the goodput journal and may dump a flight "
            "record)", labelnames=("kind",)),
        "loss_z": r.gauge(
            "paddle_tpu_health_loss_zscore",
            "robust z-score of the last observed loss against its "
            "rolling window (0 while the window is warming up)"),
        "grad_norm_z": r.gauge(
            "paddle_tpu_health_grad_norm_zscore",
            "robust z-score of the last observed global grad-norm "
            "against its rolling window"),
        "step_time_z": r.gauge(
            "paddle_tpu_health_step_time_zscore",
            "robust z-score of the last observed step time against "
            "its rolling window"),
        "degraded": r.gauge(
            "paddle_tpu_health_degraded",
            "1 while the health monitor is within degraded_window_s "
            "of its last anomaly event (mirrors the /healthz "
            "component verdict), else 0"),
        "step_time_skew": r.gauge(
            "paddle_tpu_health_step_time_skew",
            "(slowest host's step time - median) / median across the "
            "pod, from observe_pod_skew's cross-host all_gather — "
            "0 on a single process; a persistently hot value names a "
            "straggler host"),
        "slowest_host": r.gauge(
            "paddle_tpu_health_slowest_host",
            "process index of the slowest host in the last "
            "observe_pod_skew exchange"),
    }


def timeseries_metrics(reg: MetricsRegistry = None) -> Dict[str, object]:
    """Register (get-or-create) the metrics-journal sampler's own
    instrument set (observability/timeseries.py): the sampler's cost
    is itself a metric — and therefore itself journaled — so the
    bounded-overhead contract is observable from the journal alone."""
    r = reg or get_registry()
    return {
        "ts_samples": r.counter(
            "paddle_tpu_timeseries_samples_total",
            "registry samples journaled to metrics.jsonl by this "
            "process's background sampler"),
        "ts_journal_bytes": r.gauge(
            "paddle_tpu_timeseries_journal_bytes",
            "current on-disk size of the metrics.jsonl journal "
            "(bounded by retention_samples + compaction)",
            unit="bytes"),
        "ts_sample_seconds": r.gauge(
            "paddle_tpu_timeseries_sample_seconds",
            "cumulative wall seconds the sampler thread spent taking "
            "and journaling samples (the per-sample overhead bound "
            "bench gates = this / samples_total)", unit="s"),
        "ts_compactions": r.counter(
            "paddle_tpu_timeseries_compactions_total",
            "journal compactions run (atomic rewrite keeping the "
            "newest half of the retention budget behind a 'c' "
            "marker)"),
    }


def fleet_metrics(reg: MetricsRegistry = None) -> Dict[str, object]:
    """Register (get-or-create) the fleet collector's self-accounting
    set (observability/fleet.py — the collector process's OWN
    registry; member metrics pass through merged, not re-registered)."""
    r = reg or get_registry()
    return {
        "members": r.gauge(
            "paddle_tpu_fleet_members",
            "fleet members by rollup verdict at the last /healthz "
            "evaluation (degraded covers member-reported degradation, "
            "unreachable scrape targets, and stale liveness ages)",
            labelnames=("state",)),
        "scrapes": r.counter(
            "paddle_tpu_fleet_scrapes_total",
            "member scrape attempts by result",
            labelnames=("result",)),
        "series": r.gauge(
            "paddle_tpu_fleet_merged_series",
            "per-host series feeding the merged fleet exposition at "
            "the last merge"),
        "collect_seconds": r.gauge(
            "paddle_tpu_fleet_collect_seconds",
            "wall seconds of the last scrape sweep over all "
            "url-bearing members", unit="s"),
    }


def train_metrics(reg: MetricsRegistry = None) -> Dict[str, object]:
    """Register (get-or-create) the training instrument set."""
    r = reg or get_registry()
    out = comm_metrics(r)
    out.update(mem_metrics(r))
    out.update({f"offload_{k}": v for k, v in offload_metrics(r).items()})
    out.update({f"ckpt_{k}": v for k, v in ckpt_metrics(r).items()})
    out.update(goodput_metrics(r))
    out.update({f"health_{k}": v for k, v in health_metrics(r).items()})
    out.update(timeseries_metrics(r))
    out.update({
        "step_seconds": r.histogram(
            "paddle_tpu_train_step_seconds",
            "wall time of one compiled train step (dispatch to return; "
            "on async backends steady-state throughput is the "
            "tokens_per_sec gauge, measured between step entries)",
            unit="s", buckets=DEFAULT_LATENCY_BUCKETS),
        "steps": r.counter(
            "paddle_tpu_train_steps_total", "compiled train steps run"),
        "tokens": r.counter(
            "paddle_tpu_train_tokens_total",
            "training tokens consumed (samples when the batch carries "
            "no token ids)"),
        "tokens_per_sec": r.gauge(
            "paddle_tpu_train_tokens_per_sec",
            "tokens/s over the last inter-step interval (this process)",
            unit="tokens/s"),
        "pod_tokens_per_sec": r.gauge(
            "paddle_tpu_train_pod_tokens_per_sec",
            "tokens/s summed across all hosts (set by pod_throughput(), "
            "an explicit cross-host all_gather)", unit="tokens/s"),
        "loss": r.gauge(
            "paddle_tpu_train_loss",
            "last fetched train loss (one-step lag: fetched at the next "
            "step so telemetry never blocks the dispatch)"),
        "grad_norm": r.gauge(
            "paddle_tpu_train_grad_norm",
            "last fetched global gradient norm (pre-clip, all shards)"),
        "grad_buckets": r.gauge(
            "paddle_tpu_train_grad_buckets",
            "gradient-sync buckets the compiled step issues per-bucket "
            "DP/sharding collectives over (T3-style overlap, "
            "sharding_configs['comm_overlap']; 0 = the unbucketed "
            "end-of-backward tail sync — distributed/grad_buckets.py)"),
        "quant_residual_norm": r.gauge(
            "paddle_tpu_train_quant_residual_norm",
            "global L2 norm of the quantized-collective error-feedback "
            "residuals after the last step (gradient mass carried in "
            "the compensation state; fetched with the loss's one-step "
            "lag — only published when quant_comm grad_sync runs with "
            "error_feedback on; distributed/quant_comm.py)"),
        "mfu": r.gauge(
            "paddle_tpu_train_mfu",
            "model-FLOPs utilization estimate (6N convention; 0 on "
            "CPU where peak FLOPs are unknown)"),
        "pp_bubble": r.gauge(
            "paddle_tpu_train_pp_bubble_fraction",
            "analytic pipeline bubble fraction of the attached "
            "schedule, (S-1)/(vpp*M+S-1) — published per step when a "
            "pipelined model is attached, labeled by the virtual-stage "
            "count (realized bubble: tools/pp_schedule_measure.py)",
            labelnames=("pp_vpp",)),
        "compiles": r.counter(
            "paddle_tpu_compiles_total",
            "XLA compiles at instrumented launch sites",
            labelnames=("site",)),
        "cache_hits": r.counter(
            "paddle_tpu_compile_cache_hits_total",
            "compiled-program cache hits at instrumented launch sites",
            labelnames=("site",)),
        "device_memory": r.gauge(
            "paddle_tpu_device_memory_bytes",
            "per-device memory stats from the jax runtime",
            labelnames=("device", "stat"), unit="bytes"),
        "moe_expert_load": r.gauge(
            "paddle_tpu_moe_expert_load",
            "fraction of routed-and-kept tokens landing on each "
            "expert last step, summed over the batch-sharding axes "
            "(1/E everywhere = perfectly balanced routing; fetched "
            "with the loss's one-step lag — observability/moestats.py)",
            labelnames=("layer", "expert")),
        "moe_drop_rate": r.gauge(
            "paddle_tpu_moe_token_drop_rate",
            "fraction of routing slots (tokens x top_k) dropped at "
            "capacity last step, per MoE layer",
            labelnames=("layer",)),
        "moe_aux_loss": r.gauge(
            "paddle_tpu_moe_aux_loss",
            "load-balance auxiliary loss of the last step "
            "(unscaled, averaged over ep ranks), per MoE layer",
            labelnames=("layer",)),
    })
    return out


def serving_metrics(reg: MetricsRegistry = None) -> Dict[str, object]:
    """Register (get-or-create) the serving instrument set."""
    r = reg or get_registry()
    out = comm_metrics(r)
    out.update(mem_metrics(r))
    out.update({f"offload_{k}": v for k, v in offload_metrics(r).items()})
    out.update(timeseries_metrics(r))
    out.update({
        "ttft": r.histogram(
            "paddle_tpu_serving_ttft_seconds",
            "time to first token: submit() to the prefill sample",
            unit="s", buckets=DEFAULT_LATENCY_BUCKETS),
        "tpot": r.histogram(
            "paddle_tpu_serving_tpot_seconds",
            "time per output token after the first, per finished "
            "request", unit="s", buckets=_FAST_BUCKETS),
        "prefill_seconds": r.histogram(
            "paddle_tpu_serving_prefill_seconds",
            "prefill latency per request: one bucketed admission-time "
            "prefill (legacy), or admit to first token across the "
            "scheduled chunks (chunked mode)", unit="s",
            buckets=DEFAULT_LATENCY_BUCKETS),
        "decode_round_seconds": r.histogram(
            "paddle_tpu_serving_decode_round_seconds",
            "one shared chunked decode round for the in-flight batch",
            unit="s", buckets=DEFAULT_LATENCY_BUCKETS),
        "unified_round_seconds": r.histogram(
            "paddle_tpu_serving_unified_round_seconds",
            "one unified mixed prefill-chunk + decode dispatch "
            "(chunked-prefill mode: the fixed [B, Sc] ragged program)",
            unit="s", buckets=DEFAULT_LATENCY_BUCKETS),
        "prefill_chunks": r.counter(
            "paddle_tpu_serving_prefill_chunks_total",
            "prompt chunks fed through the unified step (chunked-"
            "prefill mode; per-chunk token counts ride the request "
            "traces' prefill_chunk spans)"),
        "prefill_stall": r.counter(
            "paddle_tpu_serving_prefill_page_stall_total",
            "rounds a mid-prefill row could not reserve its next "
            "chunk's pages and waited (incremental page reservation; "
            "sustained growth means the pool is undersized for the "
            "admitted mix)"),
        "queue_depth": r.gauge(
            "paddle_tpu_serving_queue_depth",
            "requests waiting for admission"),
        "active_slots": r.gauge(
            "paddle_tpu_serving_active_slots",
            "in-flight batch rows currently serving a request"),
        "free_pages": r.gauge(
            "paddle_tpu_serving_free_pages",
            "physical KV pages on the free list"),
        "page_occupancy": r.gauge(
            "paddle_tpu_serving_page_occupancy",
            "fraction of the physical page pool in use (trash page "
            "excluded)"),
        "requests": r.counter(
            "paddle_tpu_serving_requests_total",
            "request lifecycle events: submitted / admitted / "
            "backfilled (admitted while other rows were mid-decode) / "
            "evicted (finished, pages freed)",
            labelnames=("event",)),
        "shed": r.counter(
            "paddle_tpu_serving_shed_total",
            "requests shed by graceful degradation, by reason: "
            "queue_full (bounded admission queue at max_queue on "
            "submit) / deadline (admission deadline expired while "
            "queued). Shed requests never reach prefill, so their "
            "latency is excluded from the TTFT histogram",
            labelnames=("reason",)),
        "tokens": r.counter(
            "paddle_tpu_serving_tokens_total",
            "tokens produced, by phase", labelnames=("phase",)),
        "compiles": r.counter(
            "paddle_tpu_compiles_total",
            "XLA compiles at instrumented launch sites",
            labelnames=("site",)),
        "cache_hits": r.counter(
            "paddle_tpu_compile_cache_hits_total",
            "compiled-program cache hits at instrumented launch sites",
            labelnames=("site",)),
        "prefix_hit_rate": r.gauge(
            "paddle_tpu_serving_prefix_cache_hit_rate",
            "cumulative prefix-cache hit rate: page-aligned prompt "
            "chunks served from cached KV pages over chunks looked "
            "up at admission (inference/serving.py prefix_cache)"),
        "prefix_pages": r.gauge(
            "paddle_tpu_serving_prefix_cache_pages",
            "registered prefix-cache pages by state: active (held by "
            "at least one slot) / idle (refcount 0, parked on the "
            "reclaim LRU)", labelnames=("state",)),
        "prefix_events": r.counter(
            "paddle_tpu_serving_prefix_cache_events_total",
            "prefix-cache lifecycle events: hit (page mapped into an "
            "admitted slot, zero copy) / registered (completed page "
            "published under its prefix hash) / cow (copy-on-write of "
            "a shared page before a divergent write) / reclaimed "
            "(idle page evicted to the free list under pool "
            "pressure)", labelnames=("event",)),
        "spec_accept_rate": r.gauge(
            "paddle_tpu_serving_spec_accept_rate",
            "cumulative speculative-decoding acceptance: draft tokens "
            "matching the target's greedy argmax chain over draft "
            "tokens proposed"),
        "spec_tokens_per_step": r.gauge(
            "paddle_tpu_serving_spec_tokens_per_step",
            "decode tokens committed per decode-row verify step with "
            "speculative decoding (accepted run + the bonus token; "
            "1.0 means no speculation win)"),
        "stage_seconds": r.histogram(
            "paddle_tpu_serving_request_stage_seconds",
            "per-request lifecycle stage latency (spans): queued = "
            "submit→admit, prefill = admit→first token, decode = "
            "first token→finish, e2e = submit→finish "
            "(observability/spans.py; Chrome-trace export via "
            "ServingEngine.export_request_traces)",
            unit="s", labelnames=("stage",),
            buckets=DEFAULT_LATENCY_BUCKETS),
        "trace_parse_errors": r.counter(
            "paddle_tpu_serving_trace_parse_errors_total",
            "trace identities rejected at submit(), by reason: "
            "malformed_traceparent (header failed the W3C grammar or "
            "carried an all-zero id) / invalid_trace_id (bare trace "
            "id not 32 hex). The request is served under a freshly "
            "minted trace id either way — this counter is how router-"
            "injected headers stay debuggable",
            labelnames=("reason",)),
        "prefix_hash_entries": r.gauge(
            "paddle_tpu_serving_prefix_hash_entries",
            "entries in the prefix-cache page hash table (content-"
            "addressed registered pages; the idle-list length rides "
            "paddle_tpu_serving_prefix_cache_pages{state=\"idle\"}) — "
            "the state router prefix-affinity steering reads"),
        "migrations": r.counter(
            "paddle_tpu_serving_migrations_total",
            "KV page migrations between disaggregated replicas, by "
            "result: ok (imported by a decode replica) / refused "
            "(decode replica had no free slot or pages — backpressure) "
            "/ crc_error (a transferred page payload failed its crc32 "
            "and the request was retried on a fresh replica)",
            labelnames=("result",)),
        "migration_bytes": r.counter(
            "paddle_tpu_serving_migration_bytes_total",
            "bytes moved by KV page migration, ledger-exact at the "
            "closed form pages x page_bytes + the block-table row "
            "(inference/disagg.py; also booked on the comm ledger "
            "under axis \"migrate\")"),
        "migration_seconds": r.histogram(
            "paddle_tpu_serving_migration_seconds",
            "one request's KV page migration: export on the prefill "
            "replica through crc-verified import on the decode "
            "replica", unit="s", buckets=DEFAULT_LATENCY_BUCKETS),
        "router_requests": r.counter(
            "paddle_tpu_router_requests_total",
            "front-door placements per replica, by decision: affinity "
            "(prefix-affinity steering matched registered pages) / "
            "least_loaded (fallback placement) / retry (resubmitted "
            "after a migration crc failure)",
            labelnames=("replica", "decision")),
        "phase_slots": r.gauge(
            "paddle_tpu_router_phase_slots",
            "fleet phase occupancy: in-flight batch rows summed over "
            "the replicas of each phase (prefill / decode / unified)",
            labelnames=("phase",)),
    })
    return out

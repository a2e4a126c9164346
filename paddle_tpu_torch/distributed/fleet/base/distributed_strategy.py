"""DistributedStrategy (counterpart of
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``: the same
plain-Python keys and defaults). The port runs dp and mp; a strategy
that turns on anything else reaches an engine or a wrapper that raises
naming the ROADMAP.md item it waits on.
"""
from __future__ import annotations

from typing import Any, Dict

__all__ = ["DistributedStrategy"]

_HYBRID_DEFAULTS = {
    "dp_degree": 1,
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
    # expert parallelism: stacked [E, d, h] MoE expert weights shard
    # over the 'ep' mesh axis and token dispatch/combine is an
    # all_to_all on it (incubate/.../moe/moe_layer.py). Like dp, 'ep'
    # splits the token batch — the engine treats it as a data axis.
    "ep_degree": 1,
    "order": ["dp", "pp", "sharding", "sep", "ep", "mp"],
    # mp_async_allreduce (reference hybrid_configs:1808): overlap the
    # TP/SP collectives with the matmuls they feed via the chunked ring
    # decompositions in distributed/collective_matmul.py
    "mp_configs": {"mp_async_allreduce": False},
    # num_virtual_pipeline_stages (vpp): circular interleaved pipeline
    # schedule — each pp stage holds vpp non-contiguous layer chunks and
    # activations make vpp circuits of the ICI ring, shrinking the
    # bubble to (S-1)/(vpp*M+S-1) (meta_parallel/parallel_layers/
    # pp_layers.py). Requires num_layers % (pp*vpp) == 0 and
    # accumulate_steps % pp == 0.
    "pp_configs": {"num_virtual_pipeline_stages": 1},
    # ep_async_dispatch: fuse the MoE dispatch/combine all_to_alls with
    # the expert GEMMs as a chunked ppermute ring
    # (distributed/collective_matmul.py moe_a2a_ffn) so the ICI
    # exchange hides behind the per-chunk expert FFN; unfused fallback
    # outside SPMD or when E doesn't chunk over the ring.
    "moe_configs": {"ep_async_dispatch": False},
    # comm_overlap (reference sharding_configs surface): T3-style
    # bucketed backward grad sync — the stage-2 reduce-scatter / DP
    # grad all-reduce issues per layer-grained bucket (the pp stacked-
    # params seam for pipelined models, size-targeted param_spec groups
    # for flat ones) instead of one exposed end-of-backward tail;
    # comm_buffer_size_MB targets the per-bucket payload
    # (distributed/grad_buckets.py). Bit-exact loss/param parity vs
    # the unbucketed path.
    # sharding_stage (reference group_sharded levels os/os_g/p_g_os):
    # 1/2 shard optimizer state (and scatter grads) over 'sharding';
    # 3 additionally stores PARAMETERS shard-only (dim-0 scattered over
    # the sharding group, engine._ZeroPlan store_sharded) and
    # all-gathers them just-in-time at forward entry — per signature
    # bucket when comm_overlap's plan exists (the T3 mirror of the
    # backward reduce-scatter; the pp stacked-params seam gathers as a
    # lax.scan with scan_trips-exact ledger bytes), per parameter
    # otherwise. stage3_release_after_forward picks the gather grain:
    # True (default) = the bucketed just-in-time schedule, each
    # bucket's full image an independent XLA temp released after its
    # last (backward) use; False = one per-parameter gather wave at
    # step entry, the whole image alive across the step (the stage-2
    # style schedule, fewer/larger nodes). Both are bit-exact data
    # movement — loss/params match stage 2 and each other.
    "sharding_configs": {"comm_overlap": False,
                         "comm_buffer_size_MB": 25.0,
                         "sharding_stage": 2,
                         "stage3_release_after_forward": True},
    # quant_comm: int8 (or fp8 e4m3) wire compression for the grad
    # reduce-scatter/pmean buckets (grad_sync — rides comm_overlap's
    # bucket plan, with a per-bucket error-feedback residual carried as
    # training state) and the collective-matmul ring ticks (mp_rings).
    # Per-chunk symmetric scales over a fixed `chunk` lattice with a
    # bf16 scale sidecar; dtype "none" = full-precision wire
    # (bit-identical to the pre-knob behavior). See
    # distributed/quant_comm.py.
    # param_gather additionally ships the ZeRO stage-2/3 param
    # all-gather quantized with each rank's OWN shard spliced back
    # exactly (no error accumulation in the authoritative state).
    "quant_comm": {"dtype": "none", "grad_sync": True, "mp_rings": True,
                   "param_gather": True, "chunk": 256,
                   "error_feedback": True,
                   "stochastic_rounding": False},
}


class _SubConfig(dict):
    __getattr__ = dict.get

    def __setattr__(self, k, v):
        self[k] = v


class DistributedStrategy:
    def __init__(self):
        self._hybrid_configs: Dict[str, Any] = dict(_HYBRID_DEFAULTS)
        # nested sub-configs must not alias the class-level defaults
        for k in ("mp_configs", "pp_configs", "moe_configs",
                  "sharding_configs", "quant_comm"):
            self._hybrid_configs[k] = _SubConfig(_HYBRID_DEFAULTS[k])
        self.pipeline_configs: Dict[str, Any] = {
            "micro_batch_size": 1, "accumulate_steps": 1}
        self.amp = False
        self.amp_configs: Dict[str, Any] = {}
        self.recompute = False
        self.recompute_configs: Dict[str, Any] = {}
        self.sharding = False
        self.sharding_configs: Dict[str, Any] = {}
        self.gradient_merge = False
        self.gradient_merge_configs: Dict[str, Any] = {}
        self.lamb = False
        self.dgc = False
        self.heter_ccl_mode = False
        self.find_unused_parameters = False
        self.tensor_parallel = False
        self.tensor_parallel_configs: Dict[str, Any] = {}
        self.gradient_scale_configs: Dict[str, Any] = {"scale_strategy": "avg"}

    @property
    def hybrid_configs(self):
        return self._hybrid_configs

    @hybrid_configs.setter
    def hybrid_configs(self, configs: Dict[str, Any]):
        for k, v in configs.items():
            if k in ("mp_configs", "pp_configs", "moe_configs",
                     "sharding_configs", "quant_comm") \
                    and isinstance(v, dict):
                merged = _SubConfig(self._hybrid_configs.get(k, {}))
                merged.update(v)
                self._hybrid_configs[k] = merged
            else:
                self._hybrid_configs[k] = v

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self._hybrid_configs})"

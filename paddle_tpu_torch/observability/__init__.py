"""Telemetry for the port (counterpart of ``paddle_tpu/observability/``,
its single-process half).

One process-wide ``MetricsRegistry`` (metrics.py, names and labels from
catalog.py, pinned by ``schema.json`` — the JAX package's file) that
``distributed.engine.ParallelEngine`` and
``inference.ServingEngine`` instrument into: per-step wall
time, tokens/s, loss, grad-norm, MFU (flops.py), device memory and the
batch-signature counters, TTFT / TPOT and the serving gauges; plus

- **trace**      — ``annotate``: ``torch.profiler.record_function``
  ranges and host region stacks that ``flight.dump()`` reports,
- **goodput**    — a crash-durable journal booking every second of a
  run to compile / step_compute / ckpt_stall / ckpt_async / restore /
  ... segments (``goodput_pct`` across restarts),
- **healthmon**  — rolling robust (median + MAD) spike events over
  loss / grad-norm / step time, a degraded ``/healthz`` component,
- **timeseries** — a sampled, crash-durable ``metrics.jsonl``,
- **exporter**   — ``/metrics`` and ``/healthz`` over HTTP on a
  loopback port,
- **spans**      — per-request serving traces (``RequestTrace``,
  ``SpanRing``, W3C traceparent identity; ``ServingEngine``),
- **memledger**  — per-site memory ledgers, model-state accounting, the
  roofline verdict, ``pool_pages="auto"`` sizing (``mem_ledger=True`` on
  either engine),
- **commledger** — the ledger core (records, captures, closed-form wire
  bytes), which books the KV page migrations of ``inference/disagg.py``.

The engines' scalars reach the registry without a device sync in a
step or a graphed round (``ParallelEngine`` and ``ServingEngine``
docstrings). Not ported yet: the comm ledger's collective capture and
exposed-comm replay, the fleet collector, MoE stats and the watchdog
(ROADMAP.md queue 1, items 8-10).
"""
from __future__ import annotations

from .metrics import (Counter, Gauge, Histogram, JsonlSink,  # noqa: F401
                      MetricsRegistry, DEFAULT_LATENCY_BUCKETS,
                      get_registry, parse_prometheus_text,
                      reset_registry)
from .trace import annotate, current_regions  # noqa: F401
from .flight import FlightRecorder, dump as dump_flight_record, \
    get_recorder  # noqa: F401
from . import flops  # noqa: F401
from . import goodput  # noqa: F401
from . import healthmon  # noqa: F401
from . import timeseries  # noqa: F401
from . import spans  # noqa: F401
from . import memledger  # noqa: F401
from . import commledger  # noqa: F401
from .goodput import GoodputLedger  # noqa: F401
from .healthmon import HealthMonitor  # noqa: F401
from .timeseries import MetricsSampler  # noqa: F401
from .exporter import MetricsServer, serve_metrics  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "JsonlSink",
    "DEFAULT_LATENCY_BUCKETS", "get_registry", "reset_registry",
    "parse_prometheus_text", "annotate", "current_regions",
    "FlightRecorder", "dump_flight_record", "get_recorder", "flops",
    "cross_host_sum", "process_count", "goodput", "GoodputLedger",
    "healthmon", "HealthMonitor", "timeseries", "MetricsSampler",
    "MetricsServer", "serve_metrics", "spans", "memledger", "commledger",
]


def process_count() -> int:
    """Processes of the job: the world size of an initialized
    ``torch.distributed`` group, else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def cross_host_sum(value: float) -> float:
    """Sum a host-local scalar across every process (an all-reduce over
    the world group of ``distributed/collective.py``; identity for one
    process)."""
    if process_count() == 1:
        return float(value)
    import torch

    from ..distributed import collective as C

    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=C.comm_device())
    return float(C.t_psum(t, C.get_group(0)).item())

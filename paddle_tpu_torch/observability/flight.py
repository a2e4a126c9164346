"""Stall flight-records: the last-N metric snapshots + in-flight named
regions + all-thread stacks, dumped to disk when something hangs
(counterpart of ``paddle_tpu/observability/flight.py``; the device
memory context reads ``torch.cuda.memory_stats`` where the JAX package
read ``jax.Device.memory_stats``).

(reference: CommTaskManager's FLAGS_enable_async_trace dump — when an
NCCL collective times out the manager serializes the in-flight task
queue so the post-mortem shows WHAT was queued, not just that the pod
died. TPU-native equivalent: collectives are compiled into the step, so
the record instead captures the registry's recent snapshots (what the
workload was doing), the semantic region stacks (where in the framework
each thread is), raw python stacks (ground truth), and a memory context
(the paddle_tpu_mem_* / device_memory gauges + fresh per-device
memory_stats — OOM-adjacent stalls answer "how full was HBM").)

The ring is fed automatically: every ``MetricsRegistry.snapshot()``
pushes into it, and the instrumented engines snapshot once per
step/round. ``dump()`` is called by the watchdog's timeout handler
before it raises or tears down — and can be called manually from a
debugger or signal handler.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, Optional

__all__ = ["FlightRecorder", "get_recorder", "dump"]

DEFAULT_DIR_ENV = "PADDLE_TPU_FLIGHT_DIR"
_DEFAULT_DIR = "./flight_records"


def _memory_context() -> Dict[str, Any]:
    """Current memory picture for the flight record: the live values of
    every ``paddle_tpu_mem_*`` / ``paddle_tpu_device_memory_bytes``
    gauge plus fresh per-device ``memory_stats()`` — so an OOM-adjacent
    stall dump answers "how full was HBM" without replaying the
    snapshot ring. Best-effort and lock-timeout-guarded: the dumping
    thread may be the one that wedged while HOLDING the registry lock,
    and a post-mortem must never deadlock on it."""
    out: Dict[str, Any] = {"gauges": {}, "device_memory_stats": {}}
    try:
        from .metrics import get_registry

        reg = get_registry()
        gauges: Dict[str, Any] = {}
        locked = reg._lock.acquire(timeout=0.5)
        try:
            for name, m in list(reg._metrics.items()):
                if not (name.startswith("paddle_tpu_mem_")
                        or name == "paddle_tpu_device_memory_bytes"):
                    continue
                for key, s in list(m._series.items()):
                    lbl = ",".join(f"{k}={v}" for k, v
                                   in zip(m.labelnames, key))
                    gauges[name + (f"{{{lbl}}}" if lbl else "")] = \
                        s[0] if isinstance(s, list) else None
        finally:
            if locked:
                reg._lock.release()
        out["gauges"] = gauges
    except Exception:
        pass
    try:
        import torch

        if torch.cuda.is_initialized():
            out["device_memory_stats"] = {
                str(i): _cuda_memory_stats(i)
                for i in range(torch.cuda.device_count())}
    except Exception:
        pass
    return out


def _cuda_memory_stats(index: int) -> Dict[str, int]:
    """The JAX runtime's ``memory_stats`` keys for CUDA device
    ``index``: bytes the caching allocator holds for tensors now and at
    its peak, and the card's total memory."""
    import torch

    st = torch.cuda.memory_stats(index)
    _, total = torch.cuda.mem_get_info(index)
    return {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total)}


class FlightRecorder:
    """Bounded ring of registry snapshots + a post-mortem dumper."""

    def __init__(self, maxlen: int = 32):
        self._ring: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self.last_dump_path: Optional[str] = None

    def push(self, snapshot: Dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(snapshot)

    def snapshots(self):
        with self._lock:
            return list(self._ring)

    def thread_stacks(self) -> Dict[str, Any]:
        """Python stacks of every live thread (the os-level ground truth
        under the semantic region stacks)."""
        names = {t.ident: t.name for t in threading.enumerate()}
        out = {}
        for tid, frame in sys._current_frames().items():
            out[f"{names.get(tid, 'unknown')} ({tid})"] = \
                traceback.format_stack(frame)
        return out

    def record(self, reason: str = "") -> Dict[str, Any]:
        """Assemble the flight record (without writing it)."""
        from . import trace

        return {
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "inflight_regions": trace.current_regions(),
            "thread_stacks": self.thread_stacks(),
            # memory context (observability/memledger gauges + device
            # stats): OOM-adjacent stalls carry how full HBM was
            "memory": _memory_context(),
            "snapshots": self.snapshots(),
        }

    def dump(self, path: Optional[str] = None, reason: str = "") -> str:
        """Write the flight record; returns the path. Directory from
        ``PADDLE_TPU_FLIGHT_DIR`` (default ./flight_records)."""
        if path is None:
            d = os.environ.get(DEFAULT_DIR_ENV, _DEFAULT_DIR)
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"flight_{os.getpid()}_{int(time.time() * 1e3)}.json")
        rec = self.record(reason)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
        # dump() runs on watchdog/monitor threads while owners read
        # the path from the main thread
        with self._lock:
            self.last_dump_path = path
        return path


_recorder = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _recorder


def attach(registry) -> None:
    """Wire a registry's snapshot() into the ring (metrics.get_registry
    does this for the global registry)."""
    registry._flight = _recorder


def dump(path: Optional[str] = None, reason: str = "") -> str:
    """Module-level shortcut the watchdog timeout handler calls."""
    return _recorder.dump(path, reason)

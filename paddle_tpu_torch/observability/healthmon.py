"""Training health monitor: rolling robust anomaly detection over
loss, global grad-norm, and step time (counterpart of
``paddle_tpu/observability/healthmon.py``, the same detectors: the same
series give the same events; the port's tests feed it explicit step
times, never the wall clock).

Production stability monitoring (the TeleChat3-class training reports)
is event-shaped: a human asks "did anything go wrong overnight", not
"what was the loss at step 41237". This module watches the per-step
scalars the engine already fetches (one-step lag, never on the hot
path) with ROBUST rolling statistics — median + MAD over a bounded
window, so a single outlier cannot drag the baseline the way a mean/
stddev would — and publishes **events**, not curves:

- ``loss_spike`` / ``grad_norm_spike``: the value sits more than
  ``z_threshold`` robust z-scores above the window median AND more
  than ``min_rel`` relatively above it (the second guard keeps a
  near-constant window, where MAD ~ 0, from flagging noise),
- ``loss_nonfinite``: NaN/Inf loss — always an event, no statistics,
- ``step_time_stall``: step time blows past the same two guards with
  deliberately coarser defaults (host noise is real; a stall is 3x,
  not 10%).

On an event: it lands in a bounded ring + the
``paddle_tpu_health_events_total{kind}`` counter, is journaled to the
attached goodput ledger (run_report draws the timeline), flips
``/healthz`` to degraded for ``degraded_window_s`` via the exporter's
provider protocol, and — for loss/grad events — dumps a stall-style
flight record (rate-limited) so the post-mortem holds the metric ring
around the spike.

Detection arms only after ``warmup`` observations per signal, so the
deterministic bench/smoke lines (a handful of steps) run entirely
unarmed and MUST report zero events — ``bench_compare`` gates the
``*_health_spike_events`` lines at exactly 0.

Deliberate spike injection for tests rides the failpoint table
(``health.loss_spike=corrupt@N`` perturbs the N-th OBSERVED loss —
telemetry-only: the training state never sees it).

Cross-host stragglers: ``observe_pod_skew`` publishes ``step_time_skew``
= (slowest - median) / median plus the slowest host id. In the port it
is single-process (skew 0, host 0); across processes it raises until
the communication base is ported (ROADMAP.md queue 1, item 8).

Everything is host-side python on fetched scalars; nothing here adds
ops to compiled programs.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["RollingRobust", "HealthMonitor", "get_monitor",
           "reset_monitor"]

# 1.4826 * MAD estimates the stddev of a normal sample — the usual
# consistency constant, so z_threshold reads in "sigmas"
_MAD_SIGMA = 1.4826


class RollingRobust:
    """Bounded window with median + MAD (both O(W log W) on demand —
    W is small; one evaluation per step is noise). Window reads copy
    under a lock: the train loop pushes while sampler/monitor threads
    may evaluate."""

    def __init__(self, window: int = 32):
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=int(window))

    def __len__(self):
        with self._lock:
            return len(self._buf)

    def push(self, v: float) -> None:
        with self._lock:
            self._buf.append(float(v))

    def median_mad(self):
        """(median, MAD) of the current window; (0, 0) when empty."""
        with self._lock:
            xs = sorted(self._buf)
        if not xs:
            return 0.0, 0.0
        med = _median(xs)
        mad = _median(sorted(abs(x - med) for x in xs))
        return med, mad

    def zscore(self, v: float) -> float:
        """Robust z of ``v`` against the window (0 when unarmed)."""
        if not len(self):
            return 0.0
        med, mad = self.median_mad()
        sigma = _MAD_SIGMA * mad
        if sigma <= 0.0:
            sigma = max(abs(med) * 1e-3, 1e-12)
        return (float(v) - med) / sigma


def _median(xs: List[float]) -> float:
    n = len(xs)
    mid = n // 2
    return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])


class _Signal:
    __slots__ = ("name", "window", "z_threshold", "min_rel", "flight")

    def __init__(self, name, window, z_threshold, min_rel, flight):
        self.name = name
        self.window = window
        self.z_threshold = z_threshold
        self.min_rel = min_rel
        self.flight = flight


class HealthMonitor:
    """Rolling spike/stall detection + the health event ring.

    Defaults are deliberately conservative: a real loss spike (the
    classic data-corruption / optimizer-blow-up signature) is orders
    of magnitude, not percent — ``z_threshold=6`` with ``min_rel=0.5``
    catches it the step it lands while a smoothly-descending curve
    (which only moves DOWN relative to its median) never fires.
    """

    def __init__(self, window: int = 32, warmup: int = 8,
                 z_threshold: float = 6.0, min_rel: float = 0.5,
                 step_time_z: float = 8.0, step_time_min_rel: float = 2.0,
                 event_ring: int = 256, degraded_window_s: float = 60.0,
                 flight_min_interval_s: float = 30.0,
                 flight_on_spike: bool = True):
        self.warmup = max(int(warmup), 1)
        self.degraded_window_s = float(degraded_window_s)
        self.flight_on_spike = bool(flight_on_spike)
        self.flight_min_interval_s = float(flight_min_interval_s)
        self._signals = {
            "loss": _Signal("loss", RollingRobust(window), z_threshold,
                            min_rel, True),
            "grad_norm": _Signal("grad_norm", RollingRobust(window),
                                 z_threshold, min_rel, True),
            "step_time": _Signal("step_time", RollingRobust(window),
                                 step_time_z, step_time_min_rel, False),
        }
        self._events: deque = deque(maxlen=int(event_ring))
        self._lock = threading.Lock()
        self._last_event_ts: Optional[float] = None
        self._last_flight_ts: Optional[float] = None
        self.last_flight_record: Optional[str] = None
        self._reg = None
        self._m: Dict[str, Any] = {}

    # -- metric plumbing -------------------------------------------------
    def _metrics(self) -> Dict[str, Any]:
        """health_* instruments against the CURRENT global registry
        (re-fetched after a reset_registry so long-lived monitors keep
        publishing into the registry that is actually exported)."""
        from .catalog import health_metrics
        from .metrics import get_registry

        reg = get_registry()
        if reg is not self._reg:
            self._m = health_metrics(reg)
            self._reg = reg
        return self._m

    # -- observation -----------------------------------------------------
    def observe(self, loss: Optional[float] = None,
                grad_norm: Optional[float] = None,
                step_seconds: Optional[float] = None,
                step: Optional[int] = None) -> List[Dict[str, Any]]:
        """Feed the per-step scalars (any subset); returns the events
        this observation raised (usually [])."""
        from ..distributed import failpoints as _fp

        m = self._metrics()
        fired: List[Dict[str, Any]] = []
        if loss is not None and _fp.active("health.loss_spike"):
            # deterministic telemetry-only spike injection: fires on
            # the armed corrupt action's @n schedule
            if _fp.hit("health.loss_spike", b"\0") != b"\0":
                loss = abs(float(loss)) * 1e3 + 1e3
        if loss is not None and not math.isfinite(float(loss)):
            fired.append(self._event("loss_nonfinite", float("nan"),
                                     0.0, 0.0, 0.0, step))
            loss = None
        for name, value, gauge, kind in (
                ("loss", loss, "loss_z", "loss_spike"),
                ("grad_norm", grad_norm, "grad_norm_z",
                 "grad_norm_spike"),
                ("step_time", step_seconds, "step_time_z",
                 "step_time_stall")):
            if value is None:
                continue
            value = float(value)
            sig = self._signals[name]
            armed = len(sig.window) >= self.warmup
            z = sig.window.zscore(value) if armed else 0.0
            m[gauge].set(z)
            med, mad = sig.window.median_mad()
            # one-sided: only an UPWARD excursion is an anomaly (loss
            # and grad norm falling, or steps speeding up, is health)
            if armed and z > sig.z_threshold and \
                    value > med * (1.0 + sig.min_rel) + 1e-12:
                fired.append(self._event(kind, value, med, mad, z,
                                         step, flight=sig.flight))
            sig.window.push(value)
        m["degraded"].set(1.0 if self.status() != "ok" else 0.0)
        return fired

    def _event(self, kind: str, value: float, median: float,
               mad: float, z: float, step: Optional[int],
               flight: bool = False) -> Dict[str, Any]:
        now = time.time()
        ev: Dict[str, Any] = {"kind": kind, "ts": now,
                              "value": value, "median": median,
                              "mad": mad, "z": round(z, 2)}
        if step is not None:
            ev["step"] = int(step)
        m = self._metrics()
        m["events"].inc(kind=kind)
        # the spike post-mortem: a flight record freezes the metric
        # ring + thread/region state around the event (rate-limited so
        # a spiking run does not bury the disk in dumps)
        dump_now = False
        if flight and self.flight_on_spike:
            # atomic check-and-reserve of the rate-limit slot: two
            # concurrent observers must not both dump
            with self._lock:
                dump_now = (self._last_flight_ts is None or
                            now - self._last_flight_ts >=
                            self.flight_min_interval_s)
                if dump_now:
                    self._last_flight_ts = now
        if dump_now:
            try:
                from . import flight as _flight

                record = _flight.dump(
                    reason=f"healthmon: {kind} value={value:.6g} "
                           f"median={median:.6g} z={z:.1f}"
                           + (f" step={step}" if step is not None
                              else ""))
                ev["flight_record"] = record
                with self._lock:
                    self.last_flight_record = record
            except Exception:
                pass    # the post-mortem must never take the run down
        # durable: the goodput journal carries the event timeline
        try:
            from . import goodput as _gp

            _gp.note_event(kind, **{k: v for k, v in ev.items()
                                    if k != "kind"})
        except Exception:
            pass
        with self._lock:
            self._events.append(ev)
            self._last_event_ts = now
        return ev

    # -- health surface --------------------------------------------------
    def status(self) -> str:
        """"ok", or "degraded" within ``degraded_window_s`` of the last
        event — surfaced on /healthz via the exporter provider."""
        with self._lock:
            last = self._last_event_ts
        if last is not None and \
                time.time() - last <= self.degraded_window_s:
            return "degraded"
        return "ok"

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def event_count(self, kind: Optional[str] = None) -> int:
        with self._lock:
            return sum(1 for e in self._events
                       if kind is None or e["kind"] == kind)

    def reset(self) -> None:
        """Drop windows, events, and the degraded state (tests)."""
        with self._lock:
            for sig in self._signals.values():
                sig.window = RollingRobust(sig.window._buf.maxlen)
            self._events.clear()
            self._last_event_ts = None
            self._last_flight_ts = None

    def register_healthz(self, component: str = "healthmon"):
        """Register this monitor as a /healthz component (weakref: the
        provider prunes itself once the owner is gone). Engines call
        this with their own per-run monitor so a spike degrades the
        endpoint without sharing detection windows across runs."""
        import weakref

        from . import exporter as _exporter

        ref = weakref.ref(self)

        def _provider():
            mon = ref()
            if mon is None:
                return None
            return {"component": component, "status": mon.status()}

        _exporter.add_health_provider(_provider)
        return _provider

    # -- cross-host stragglers -------------------------------------------
    def observe_pod_skew(self, step_seconds: float) -> Dict[str, float]:
        """Publish the straggler gauges: ``step_time_skew`` = (slowest -
        median) / median, ``slowest_host`` = its process index.
        Single-process: skew 0, host 0. More than one process raises:
        the all-gather waits on ROADMAP.md queue 1, item 8."""
        from . import process_count

        m = self._metrics()
        if process_count() > 1:
            raise NotImplementedError(
                "observe_pod_skew across processes is not ported yet: "
                "ROADMAP.md queue 1, item 8 (the communication base)")
        times = [float(step_seconds)]
        med = _median(sorted(times))
        slowest = max(range(len(times)), key=lambda i: times[i])
        skew = (times[slowest] - med) / med if med > 0 else 0.0
        m["step_time_skew"].set(skew)
        m["slowest_host"].set(float(slowest))
        return {"step_time_skew": skew,
                "slowest_host": float(slowest),
                "host_step_seconds": times}


# ---------------------------------------------------------------------------
# the process-wide default monitor (standalone/manual use; /healthz
# reports it). ParallelEngine deliberately does NOT use it: each engine
# owns a PER-RUN HealthMonitor so detection windows never mix runs —
# a fresh model's first loss judged against another run's converged
# baseline would be a guaranteed false spike.
# ---------------------------------------------------------------------------
_monitor: Optional[HealthMonitor] = None
_monitor_lock = threading.Lock()


def _health_provider():
    mon = _monitor
    if mon is None:
        return None
    return {"component": "healthmon", "status": mon.status()}


def get_monitor() -> HealthMonitor:
    """The process-wide health monitor; created on first use and
    registered as a /healthz component provider."""
    global _monitor
    with _monitor_lock:
        if _monitor is None:
            _monitor = HealthMonitor()
            from . import exporter as _exporter

            _exporter.add_health_provider(_health_provider)
        return _monitor


def reset_monitor() -> HealthMonitor:
    """Fresh monitor state (tests): windows/events dropped, provider
    registration kept."""
    mon = get_monitor()
    mon.reset()
    return mon

"""Thread-safe metrics registry: Counter / Gauge / Histogram with labels.

The production-telemetry layer the reference ships as
profiler_statistic summaries + the serving runtime's perf counters,
redesigned for a pull/push hybrid: every metric lives in one in-process
``MetricsRegistry`` and is exported three ways —

- ``snapshot()``       — the in-process API (dict of plain values; the
  flight recorder keeps the last N of these, bench.py emits them),
- ``prometheus_text()``— Prometheus/OpenMetrics text exposition for a
  scrape endpoint (``parse_prometheus_text`` round-trips it in tests),
- ``JsonlSink``        — append-one-JSON-object-per-snapshot to disk
  (the bench.py lineage: machine-parsable longitudinal records).

Histograms use FIXED buckets so percentile estimates are rank-stable
and mergeable across hosts (Megatron/vLLM-style p50/p99 TTFT / TPOT /
step-time reporting); ``percentile`` linearly interpolates within the
winning bucket. All mutation goes through one lock per registry —
ServingEngine worker threads, the watchdog monitor thread, and the
train loop share the global registry safely.

Everything here is host-side python on fetched scalars.

Counterpart of ``paddle_tpu/observability/metrics.py``, the same code:
the same updates give the same Prometheus text in both packages.
"""
from __future__ import annotations

import json
import math
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "reset_registry", "JsonlSink",
    "parse_prometheus_text", "DEFAULT_LATENCY_BUCKETS",
]

# Fixed latency lattice (seconds): 100us .. 10min, roughly x2.5 steps.
# Wide enough for decode TPOT (~ms) through multi-host train steps (~s)
# without per-deployment tuning; fixed so percentiles stay comparable
# across runs and mergeable across hosts.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
    600.0)


def _label_key(labelnames: Sequence[str], labels: Dict[str, str]):
    # equal sizes and every declared name present == the same name sets
    if len(labels) == len(labelnames):
        try:
            return tuple([str(labels[k]) for k in labelnames])
        except KeyError:
            pass
    raise ValueError(
        f"labels {sorted(labels)} do not match the declared "
        f"labelnames {sorted(labelnames)}")


class _Metric:
    """Base: one named metric holding one series per label combination."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.Lock, unit: str = ""):
        self.name = name
        self.help = help
        self.unit = unit
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._series: Dict[Tuple[str, ...], Any] = {}

    def _get(self, labels: Dict[str, str]):
        key = _label_key(self.labelnames, labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = self._new_series()
        return s

    def _new_series(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def spec(self) -> Dict[str, Any]:
        """The schema row dashboards key on (tests pin these)."""
        return {"type": self.kind, "labels": sorted(self.labelnames),
                "unit": self.unit, "help": self.help}


class Counter(_Metric):
    """Monotonic count (requests, tokens, evictions, compiles)."""

    kind = "counter"

    def _new_series(self):
        return [0.0]

    def inc(self, n: float = 1.0, **labels):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._get(labels)[0] += n

    def value(self, **labels) -> float:
        with self._lock:
            return self._get(labels)[0]


class Gauge(_Metric):
    """Point-in-time value (queue depth, occupancy, loss, memory)."""

    kind = "gauge"

    def _new_series(self):
        return [0.0]

    def set(self, v: float, **labels):
        with self._lock:
            self._get(labels)[0] = float(v)

    def inc(self, n: float = 1.0, **labels):
        with self._lock:
            self._get(labels)[0] += n

    def dec(self, n: float = 1.0, **labels):
        self.inc(-n, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._get(labels)[0]


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self, nbuckets: int):
        self.counts = [0] * (nbuckets + 1)     # +1 = +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf


class Histogram(_Metric):
    """Fixed-bucket histogram with interpolated percentiles.

    ``buckets`` are inclusive upper bounds; an implicit +Inf bucket
    catches the tail. Fixed buckets keep p50/p99 stable under load and
    let pod-level aggregation sum counts across hosts.
    """

    kind = "histogram"

    def __init__(self, name, help, labelnames, lock, unit="",
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, labelnames, lock, unit)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.buckets = bs
        # the snapshot's bucket keys
        self._bucket_keys = tuple(str(ub) for ub in bs)

    def _new_series(self):
        return _HistSeries(len(self.buckets))

    def observe(self, v: float, **labels):
        v = float(v)
        with self._lock:
            s = self._get(labels)
            i = 0
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    break
            else:
                i = len(self.buckets)
            s.counts[i] += 1
            s.sum += v
            s.count += 1
            s.min = min(s.min, v)
            s.max = max(s.max, v)

    def count(self, **labels) -> int:
        with self._lock:
            return self._get(labels).count

    def percentile(self, q: float, **labels) -> float:
        """Estimate the q-th percentile (q in [0, 100]) from bucket
        counts, linearly interpolated inside the winning bucket and
        clamped to the observed min/max."""
        with self._lock:
            return self._percentile(self._get(labels), q)

    def _percentile(self, s: _HistSeries, q: float) -> float:
        if not s.count:
            return 0.0
        rank = q / 100.0 * s.count
        cum = 0
        for i, c in enumerate(s.counts):
            if not c:
                continue
            if cum + c >= rank:
                lo = 0.0 if i == 0 else self.buckets[i - 1]
                hi = (self.buckets[i] if i < len(self.buckets)
                      else s.max)
                frac = (rank - cum) / c
                v = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                return min(max(v, s.min), s.max)
            cum += c
        return s.max

    def _snapshot_row(self, key, s: _HistSeries) -> Dict[str, Any]:
        """One series' snapshot row (the lock held by the caller)."""
        return {"labels": dict(zip(self.labelnames, key)),
                "count": s.count, "sum": s.sum,
                "min": s.min if s.count else 0.0,
                "max": s.max if s.count else 0.0,
                "buckets": {**dict(zip(self._bucket_keys, s.counts)),
                            "+Inf": s.counts[-1]},
                **{f"p{q}": self._percentile(s, q) for q in (50, 90, 99)}}


class MetricsRegistry:
    """One process-wide home for every metric (thread-safe).

    ``counter``/``gauge``/``histogram`` are get-or-create: a second
    registration with the same name returns the SAME object, and a
    conflicting re-registration (different type/labels/buckets) raises —
    two subsystems can never silently fork a metric.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._flight = None          # set by flight.attach()
        # wall-clock of the last snapshot(): the engines snapshot once
        # per step/tick, so its age distinguishes a hung process from
        # an idle one (the /healthz payload, exporter.py)
        self._last_snapshot_ts: Optional[float] = None

    # -- registration ---------------------------------------------------
    def _register(self, cls, name, help, labelnames, unit, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                same = (type(m) is cls
                        and m.labelnames == tuple(labelnames)
                        and (not isinstance(m, Histogram) or
                             m.buckets == tuple(sorted(
                                 float(b) for b in kw.get(
                                     "buckets",
                                     DEFAULT_LATENCY_BUCKETS)))))
                if not same:
                    raise ValueError(
                        f"metric {name!r} re-registered with a "
                        f"conflicting spec (was {m.spec()})")
                return m
            m = cls(name, help, labelnames, self._lock, unit, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = (), unit: str = "") -> Counter:
        return self._register(Counter, name, help, labelnames, unit)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = (), unit: str = "") -> Gauge:
        return self._register(Gauge, name, help, labelnames, unit)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (), unit: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._register(Histogram, name, help, labelnames, unit,
                              buckets=buckets)

    # -- export ---------------------------------------------------------
    def snapshot(self, touch: bool = True) -> Dict[str, Any]:
        """Plain-dict view of every series (the in-process API).

        Also appended to the attached flight recorder's ring, so any
        code path that snapshots keeps the stall flight-record fresh.
        ``touch=False`` (the scrape path) skips the liveness timestamp
        so an external scraper's own reads never mask a hung engine.
        """
        out: Dict[str, Any] = {"ts": time.time(), "metrics": {}}
        with self._lock:
            for name, m in self._metrics.items():
                entry: Dict[str, Any] = dict(m.spec())
                if isinstance(m, Histogram):
                    series = [m._snapshot_row(key, s)
                              for key, s in m._series.items()]
                else:
                    series = [{"labels": dict(zip(m.labelnames, key)),
                               "value": s[0]}
                              for key, s in m._series.items()]
                entry["series"] = series
                out["metrics"][name] = entry
        if self._flight is not None:
            self._flight.push(out)
        if touch:
            with self._lock:
                self._last_snapshot_ts = out["ts"]
        return out

    def snapshot_age_seconds(self) -> Optional[float]:
        """Seconds since the last snapshot() on this registry, or None
        before the first one — the /healthz liveness signal (an engine
        ticking keeps this fresh; a hung step lets it grow)."""
        with self._lock:
            ts = self._last_snapshot_ts
        return None if ts is None else max(time.time() - ts, 0.0)

    def schema(self) -> Dict[str, Any]:
        """{name: spec} for every registered metric — compared against
        the checked-in schema.json so dashboards don't silently break."""
        with self._lock:
            return {name: m.spec()
                    for name, m in sorted(self._metrics.items())}

    def prometheus_text(self, prefixes: Optional[Sequence[str]] = None
                        ) -> str:
        """Prometheus text exposition of the current state.

        ``prefixes`` filters the exposition to metric names starting
        with any of the given prefixes (the exporter's ``?names=``
        query) — still a ``snapshot(touch=False)`` read, so a
        filtered scrape never masks a hung engine. Histogram series
        additionally expose ``<name>_min``/``<name>_max`` rows (an
        extension beyond standard exposition): together with the
        fixed bucket lattice they make cross-host merges percentile-
        exact (observability/fleet.py)."""
        snap = self.snapshot(touch=False)
        lines: List[str] = []
        for name, entry in sorted(snap["metrics"].items()):
            if prefixes is not None and \
                    not any(name.startswith(p) for p in prefixes):
                continue
            if entry["help"]:
                lines.append(f"# HELP {name} {entry['help']}")
            lines.append(f"# TYPE {name} {entry['type']}")
            for row in entry["series"]:
                lbl = _fmt_labels(row["labels"])
                if entry["type"] == "histogram":
                    cum = 0
                    for ub, c in row["buckets"].items():
                        cum += c
                        le = _fmt_labels({**row["labels"], "le": ub})
                        lines.append(f"{name}_bucket{le} {cum}")
                    lines.append(f"{name}_sum{lbl} {row['sum']:.9g}")
                    lines.append(f"{name}_count{lbl} {row['count']}")
                    if row["count"]:
                        # repr: shortest round-trip form — the merge
                        # clamp must see the EXACT observed extrema
                        lines.append(
                            f"{name}_min{lbl} {row['min']!r}")
                        lines.append(
                            f"{name}_max{lbl} {row['max']!r}")
                else:
                    lines.append(f"{name}{lbl} {row['value']:.9g}")
        return "\n".join(lines) + "\n"


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _escape(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def parse_prometheus_text(text: str) -> Dict[str, Dict[Tuple, float]]:
    """Parse exposition text back to {name: {label-items-tuple: value}}
    (the round-trip check for the scrape endpoint; histogram buckets
    come back as <name>_bucket rows keyed on their ``le`` label)."""
    out: Dict[str, Dict[Tuple, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, val = line.rsplit(" ", 1)
        if "{" in head:
            name, rest = head.split("{", 1)
            body = rest.rsplit("}", 1)[0]
            labels = []
            for part in _split_labels(body):
                k, v = part.split("=", 1)
                labels.append((k, v[1:-1]))
            key = tuple(sorted(labels))
        else:
            name, key = head, ()
        out.setdefault(name, {})[key] = float(val)
    return out


def _split_labels(body: str) -> List[str]:
    parts, depth, cur = [], False, []
    for ch in body:
        if ch == '"':
            depth = not depth
        if ch == "," and not depth:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts


class JsonlSink:
    """Append registry snapshots to a JSONL file (one object per line,
    the bench.py emission format). ``read`` round-trips the file."""

    def __init__(self, path: str):
        self.path = str(path)

    def write(self, snapshot: Dict[str, Any]) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(snapshot) + "\n")

    @staticmethod
    def read(path: str) -> List[Dict[str, Any]]:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out


_global_registry: Optional[MetricsRegistry] = None
_global_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem instruments into."""
    global _global_registry
    with _global_lock:
        if _global_registry is None:
            _global_registry = MetricsRegistry()
            from . import flight

            flight.attach(_global_registry)
        return _global_registry


def reset_registry() -> MetricsRegistry:
    """Drop every metric (tests; a fresh registry is re-attached to the
    flight recorder so stall records keep flowing)."""
    global _global_registry
    with _global_lock:
        _global_registry = None
    return get_registry()

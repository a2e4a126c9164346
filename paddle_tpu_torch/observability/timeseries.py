"""Crash-durable sampled metrics journal: the registry, over time
(counterpart of ``paddle_tpu/observability/timeseries.py``, the same code
and journal format).

``MetricsRegistry`` is a point-in-time surface — a scrape or a
snapshot shows NOW, and a crashed process takes its history with it.
This module gives every run a durable time axis: a background sampler
thread snapshots the registry every ``interval_s`` seconds and appends
one compact JSON line per sample to ``<dir>/metrics.jsonl`` with the
same flush-first discipline as ``goodput.jsonl`` (each line is written
and flushed before the sampler sleeps again, so a SIGKILL — the
preemption model — never loses a completed sample; the reader skips a
truncated tail line instead of failing). ``tools/fleet_report.py``
and ``tools/run_report.py --merge`` read these journals per host to
reconstruct fleet history no live process can serve.

Journal format (one JSON object per line)::

    {"ev": "run", "ts": ..., "pid": ..., "interval_s": ..., "resumed": b}
    {"ev": "s", "ts": ..., "seq": n, "m": {name: {"t": type, "s": [
        [<labels-dict>, <value-or-histogram-state>], ...]}}}
    {"ev": "c", "ts": ..., "kept": k, "dropped": d}      # compaction

Scalar series journal their float value; histogram series journal the
full mergeable state (count / sum / min / max / per-bucket counts), so
offline percentile reconstruction matches the live registry exactly.

Retention is bounded: when the journal exceeds ``retention_samples``
in-file samples the sampler thread compacts it — newest samples are
kept verbatim, the oldest are dropped behind a ``c`` marker, and the
rewrite goes through a temp file + ``os.replace`` so a kill during
compaction leaves either the old or the new journal, never a torn one.

Query API: ``read_journal`` (lenient), ``query`` (label-filtered
(ts, value) points over a time range) and ``resample`` (alignment to
a fixed step grid) — enough for skew/trend reports without a TSDB.

The sampler publishes its own cost into the registry it samples
(``paddle_tpu_timeseries_*``: samples, journal bytes, cumulative
sample seconds, compactions — catalog.timeseries_metrics), so the
overhead bound is itself observable. Everything here is host-side
python; the sampler never touches the step, so attaching it cannot
change what the step computes.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .metrics import MetricsRegistry, get_registry

__all__ = ["MetricsSampler", "JOURNAL_NAME", "read_journal", "samples",
           "query", "resample", "attach_dir", "attach", "current",
           "detach"]

JOURNAL_NAME = "metrics.jsonl"

# journal-growth bound: compaction triggers when the in-file sample
# count crosses this (the newest half survives verbatim)
DEFAULT_RETENTION_SAMPLES = 4096


def _compact_snapshot(snap: Dict[str, Any]) -> Dict[str, Any]:
    """Strip a registry snapshot to its journal form: per metric the
    type tag + per-series labels and mergeable state (help strings and
    derived percentiles stay out of the journal)."""
    out: Dict[str, Any] = {}
    for name, entry in snap["metrics"].items():
        rows = []
        for row in entry["series"]:
            if entry["type"] == "histogram":
                rows.append([row["labels"], {
                    "count": row["count"], "sum": row["sum"],
                    "min": row["min"], "max": row["max"],
                    "buckets": row["buckets"]}])
            else:
                rows.append([row["labels"], row["value"]])
        if rows:
            out[name] = {"t": entry["type"], "s": rows}
    return out


class MetricsSampler:
    """Background registry sampler journaling to ``<dir>/metrics.jsonl``.

    One sampler per journal path per process (``attach_dir`` is
    get-or-create, mirroring the goodput ledger); a fresh process
    appending to an existing journal writes a ``resumed`` run header so
    readers see restart boundaries. ``close()`` stops the thread and
    closes the handle; an unwritable directory disables the sampler
    instead of taking the run down.
    """

    def __init__(self, path: str, registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 5.0,
                 retention_samples: int = DEFAULT_RETENTION_SAMPLES):
        from .catalog import timeseries_metrics

        self.path = str(path)
        self.registry = registry or get_registry()
        self.interval_s = max(float(interval_s), 0.01)
        self.retention_samples = max(int(retention_samples), 16)
        self._metrics = timeseries_metrics(self.registry)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seq = 0
        self._samples_in_file = 0
        self._journal_bytes = 0
        self._overhead_s = 0.0
        self._compactions = 0
        resumed = os.path.exists(self.path) and \
            os.path.getsize(self.path) > 0
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if resumed:
            prior = read_journal(self.path)
            self._seq = 1 + max(
                (int(r.get("seq", -1)) for r in prior
                 if r.get("ev") == "s"), default=-1)
            self._samples_in_file = sum(
                1 for r in prior if r.get("ev") == "s")
            try:
                self._journal_bytes = os.path.getsize(self.path)
            except OSError:
                self._journal_bytes = 0
        self._f = open(self.path, "a")
        self._append(json.dumps(
            {"ev": "run", "ts": time.time(), "pid": os.getpid(),
             "interval_s": self.interval_s, "resumed": resumed}) + "\n")

    # -- journal I/O -----------------------------------------------------
    def _append(self, line: str) -> None:
        """One pre-serialized line + flush on the held-open handle:
        flushed bytes reach the kernel, so a SIGKILL never loses them
        (the same contract as the goodput ledger's ``_append``)."""
        with self._lock:
            f = self._f
            if f is None:
                return
            try:
                f.write(line)
                f.flush()
            except (OSError, ValueError):
                return      # a dead journal must never take the run down
            self._journal_bytes += len(line)

    # -- sampling --------------------------------------------------------
    def sample_now(self) -> Dict[str, Any]:
        """Take and journal one sample; returns the journaled record.
        Runs on the sampler thread every ``interval_s`` (callers may
        also invoke it directly for an on-demand point)."""
        t0 = time.perf_counter()
        with self._lock:
            seq = self._seq
            self._seq += 1
        # scrape-path snapshot: sampling must never refresh the
        # liveness age a /healthz probe keys on
        snap = self.registry.snapshot(touch=False)
        rec = {"ev": "s", "ts": snap["ts"], "seq": seq,
               "m": _compact_snapshot(snap)}
        self._append(json.dumps(rec) + "\n")
        overhead = time.perf_counter() - t0
        with self._lock:
            self._samples_in_file += 1
            self._overhead_s += overhead
            need_compact = self._samples_in_file > self.retention_samples
            journal_bytes = self._journal_bytes
            overhead_total = self._overhead_s
        m = self._metrics
        m["ts_samples"].inc()
        m["ts_journal_bytes"].set(journal_bytes)
        m["ts_sample_seconds"].set(overhead_total)
        if need_compact:
            self._compact()
        return rec

    def _compact(self) -> None:
        """Rewrite the journal keeping the newest half of the retained
        sample budget (plus run headers and prior compaction markers),
        atomically: temp file, flush+fsync, ``os.replace``. Runs only
        on the sampler thread; the shared handle swaps under the lock,
        all filesystem work stays outside it."""
        records = read_journal(self.path)
        keep_n = max(self.retention_samples // 2, 1)
        sample_idx = [i for i, r in enumerate(records)
                      if r.get("ev") == "s"]
        dropped = set(sample_idx[:-keep_n]) if \
            len(sample_idx) > keep_n else set()
        if not dropped:
            return
        kept = [r for i, r in enumerate(records) if i not in dropped]
        kept.append({"ev": "c", "ts": time.time(),
                     "kept": len(sample_idx) - len(dropped),
                     "dropped": len(dropped)})
        tmp = self.path + ".compact.tmp"
        try:
            with open(tmp, "w") as f:
                for r in kept:
                    f.write(json.dumps(r) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            return
        with self._lock:
            old, self._f = self._f, None
        try:
            old.close()
        except OSError:
            pass
        new_bytes = 0
        try:
            os.replace(tmp, self.path)
            new_f = open(self.path, "a")
            new_bytes = os.path.getsize(self.path)
        except OSError:
            new_f = None
        with self._lock:
            self._f = new_f
            self._samples_in_file = len(sample_idx) - len(dropped)
            self._journal_bytes = new_bytes
            self._compactions += 1
        self._metrics["ts_compactions"].inc()

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "MetricsSampler":
        """Start the background sampler thread (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="metrics-sampler", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_now()

    def stats(self) -> Dict[str, Any]:
        """Live sampler accounting (the bench ``timeseries`` section):
        samples journaled this process, journal bytes on disk,
        cumulative sampler overhead seconds, compactions run."""
        with self._lock:
            return {"samples": self._seq,
                    "journal_bytes": self._journal_bytes,
                    "overhead_seconds": round(self._overhead_s, 6),
                    "compactions": self._compactions}

    def query(self, name: str, labels: Optional[Dict[str, str]] = None,
              t0: Optional[float] = None, t1: Optional[float] = None,
              field: str = "value") -> List[Tuple[float, float]]:
        """Range-query this sampler's own journal (see module
        ``query``)."""
        return query(read_journal(self.path), name, labels=labels,
                     t0=t0, t1=t1, field=field)

    def close(self) -> None:
        """Stop the thread (bounded join) and close the journal."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        with self._lock:
            f, self._f = self._f, None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass

    def __enter__(self) -> "MetricsSampler":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# offline reading + range queries
# ---------------------------------------------------------------------------
def read_journal(path: str) -> List[Dict[str, Any]]:
    """Parse a metrics journal leniently: a SIGKILL may truncate the
    final line mid-write — skip anything unparsable instead of failing
    (every COMPLETED sample is recovered; only the torn tail is lost)."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return out


def samples(records: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Just the sample records, journal order."""
    return [r for r in records if r.get("ev") == "s"]


def _labels_match(row_labels: Dict[str, str],
                  want: Optional[Dict[str, str]]) -> bool:
    if not want:
        return True
    return all(str(row_labels.get(k)) == str(v)
               for k, v in want.items())


def query(records: Iterable[Dict[str, Any]], name: str,
          labels: Optional[Dict[str, str]] = None,
          t0: Optional[float] = None, t1: Optional[float] = None,
          field: str = "value") -> List[Tuple[float, float]]:
    """(ts, value) points for one metric across the journal's samples.

    ``labels`` is a subset filter (a series matches when every given
    pair matches); multiple matching series per sample are SUMMED —
    the per-host rollup a lane plot wants. For histogram series
    ``field`` picks the journaled component (``count`` / ``sum`` /
    ``min`` / ``max``); scalars ignore it. ``t0``/``t1`` bound the
    inclusive time range.
    """
    pts: List[Tuple[float, float]] = []
    for r in samples(records):
        ts = float(r.get("ts", 0.0))
        if t0 is not None and ts < t0:
            continue
        if t1 is not None and ts > t1:
            continue
        entry = r.get("m", {}).get(name)
        if entry is None:
            continue
        acc, hit = 0.0, False
        for row_labels, v in entry.get("s", ()):
            if not _labels_match(row_labels, labels):
                continue
            hit = True
            if isinstance(v, dict):
                acc += float(v.get(field if field != "value"
                                   else "count", 0.0))
            else:
                acc += float(v)
        if hit:
            pts.append((ts, acc))
    return pts


def resample(points: List[Tuple[float, float]], step: float,
             t0: Optional[float] = None, t1: Optional[float] = None,
             how: str = "last", ffill: bool = False
             ) -> List[Tuple[float, Optional[float]]]:
    """Align points onto a fixed ``step`` grid (bins at
    ``floor(ts / step) * step``) so journals sampled on different
    clocks line up for cross-host comparison.

    ``how`` reduces the points inside one bin: ``last`` (gauges),
    ``mean``, ``max``, ``min``, ``sum``. Empty bins carry ``None``, or
    the previous bin's value with ``ffill=True``.
    """
    if step <= 0:
        raise ValueError(f"resample step must be > 0, got {step}")
    if how not in ("last", "mean", "max", "min", "sum"):
        raise ValueError(f"unknown resample reduction {how!r}")
    pts = [(ts, v) for ts, v in points
           if (t0 is None or ts >= t0) and (t1 is None or ts <= t1)]
    if not pts:
        return []
    bins: Dict[float, List[float]] = {}
    for ts, v in pts:
        bins.setdefault((ts // step) * step, []).append(v)
    lo = min(bins) if t0 is None else (t0 // step) * step
    hi = max(bins) if t1 is None else (t1 // step) * step
    out: List[Tuple[float, Optional[float]]] = []
    prev: Optional[float] = None
    b = lo
    while b <= hi + 1e-9:
        vs = bins.get(b)
        if vs:
            v = {"last": vs[-1], "mean": sum(vs) / len(vs),
                 "max": max(vs), "min": min(vs),
                 "sum": sum(vs)}[how]
            prev = v
        else:
            v = prev if ffill else None
        out.append((round(b, 9), v))
        b += step
    return out


# ---------------------------------------------------------------------------
# process-current sampler (mirrors the goodput ledger's attach model:
# same base dir -> same live sampler, never a second thread)
# ---------------------------------------------------------------------------
_current: Optional[MetricsSampler] = None
_by_path: Dict[str, MetricsSampler] = {}
_attach_lock = threading.Lock()


def attach_dir(base: str, interval_s: float = 5.0,
               registry: Optional[MetricsRegistry] = None,
               retention_samples: int = DEFAULT_RETENTION_SAMPLES
               ) -> MetricsSampler:
    """Get-or-create the sampler journaling at ``<base>/metrics.jsonl``
    (started) and make it the process-current one. Within a process
    the same base always returns the SAME live sampler; a fresh
    process appending to an existing journal records a resumed run
    header, so the reader sees restart boundaries."""
    path = os.path.abspath(os.path.join(str(base), JOURNAL_NAME))
    global _current
    with _attach_lock:
        smp = _by_path.get(path)
        if smp is None:
            smp = _by_path[path] = MetricsSampler(
                path, registry=registry, interval_s=interval_s,
                retention_samples=retention_samples).start()
        _current = smp
        return smp


def attach(sampler: Optional[MetricsSampler]) -> None:
    """Make ``sampler`` the process-current one (tests; None detaches)."""
    global _current
    with _attach_lock:
        _current = sampler


def current() -> Optional[MetricsSampler]:
    return _current


def detach() -> None:
    attach(None)

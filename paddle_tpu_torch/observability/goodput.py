"""Run-level goodput ledger: wall-clock attribution across restarts
(counterpart of ``paddle_tpu/observability/goodput.py``, the same code
and journal format: ``summarize`` reads either package's journal).

The instrument panel (flops / commledger / memledger / roofline) sees
everything *inside* a step; this module accounts where every second of
a whole — possibly crash-interrupted — run goes. Production training
reports treat goodput (productive step time / total wall time) as a
first-class requirement at scale: a run that computes at 55% MFU but
spends 30% of its life recompiling, stalled on checkpoints, or
restarting after preemptions is a slow run, and none of the per-step
instruments can see it.

Every second is attributed to a CLOSED set of segments::

    compile           a step of a new batch signature, or the first
                      after a restore (the port's eager step builds
                      kernels, searches tiles and grows the allocator
                      there, as the JAX step traced and compiled)
    step_compute      the productive step's dispatch window
    ckpt_stall        checkpoint work the step loop WAITS on (device->
                      host snapshot; the whole commit in sync mode)
    ckpt_async        background checkpoint writes (overlapped: runs on
                      the writer thread, excluded from the wall sum)
    restore           loading a committed checkpoint back into engines
    recovery_restart  crash-to-resume downtime: the dangling tail of a
                      killed run, closed by the NEXT process
    input_wait        host-side batch production the caller wraps
    idle              unattributed wall time (synthesized at read time)

Segments are recorded through the same region mechanism as
``trace.annotate`` (the flight record shows the current segment) and
append to a crash-durable JSONL journal under the checkpoint base dir:
one ``b`` (begin) line flushed BEFORE a segment runs and one ``e``
(end) line when it closes, so a SIGKILL mid-segment leaves a parseable
journal whose dangling tail the relaunched process closes as
``recovery_restart`` (``attach_dir`` on the same base dir — wired into
``resume_latest`` and ``CheckpointManager``). ``goodput_pct`` therefore
spans restart boundaries: productive step seconds over the wall clock
of the whole run, crashes included.

Foreground segments never overlap: an inner segment (e.g. ``compile``
inside a step) PAUSES the outer one — the journal's closed foreground
intervals are disjoint, so their sum plus ``idle`` equals wall time
exactly. Background segments (``ckpt_async``) carry ``"bg": 1`` and are
reported separately as overlapped seconds.

All host-side wall-clock bookkeeping (``time.time`` — comparable
across processes, unlike perf_counter); nothing here touches traced
code, and an unattached process pays one ``None`` check per segment.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["SEGMENTS", "GoodputLedger", "attach_dir", "attach",
           "current", "detach", "segment", "note_event", "read_journal",
           "summarize", "JOURNAL_NAME"]

# the closed segment taxonomy (idle is synthesized at read time from
# wall - sum(closed foreground segments), never written to the journal)
SEGMENTS = ("compile", "step_compute", "ckpt_stall", "ckpt_async",
            "restore", "recovery_restart", "input_wait", "idle")

JOURNAL_NAME = "goodput.jsonl"


class GoodputLedger:
    """One run's wall-clock journal (append-only JSONL, crash-durable).

    Opening a path whose journal already holds events from a PREVIOUS
    process is a resume: the dangling tail (a crashed segment's ``b``
    without its ``e``, or the gap after the last event) is closed as
    ``recovery_restart`` spanning crash-to-resume. Within one process,
    re-attaching the same path reuses the live ledger (``attach_dir``)
    so a second CheckpointManager never fakes a restart.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        # foreground segment stack: [(name, t0, meta)] — an inner
        # begin closes the outer's elapsed part; the outer resumes
        # when the inner ends (disjoint closed intervals by design)
        self._stack: List[Any] = []
        self._totals: Dict[str, float] = {}
        self._bg_totals: Dict[str, float] = {}
        self._events = 0
        self._start_ts: Optional[float] = None
        self._restarts = 0
        prior = read_journal(self.path) if os.path.exists(self.path) \
            else []
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._f = open(self.path, "a")
        now = time.time()
        if prior:
            self._replay(prior)
            # crash-to-resume downtime: from the last thing the dead
            # process journaled (a dangling begin, or its last event)
            # to this process's first breath
            tail = _tail_ts(prior)
            if tail is not None and now > tail:
                self._append({"ev": "e", "seg": "recovery_restart",
                              "t0": tail, "t1": now})
                self._totals["recovery_restart"] = \
                    self._totals.get("recovery_restart", 0.0) \
                    + (now - tail)
            self._restarts += 1
        if self._start_ts is None:
            self._start_ts = now
        self._append({"ev": "run", "ts": now, "pid": os.getpid(),
                      "resumed": bool(prior)})

    def _replay(self, records: List[Dict[str, Any]]) -> None:
        for r in records:
            if r.get("ev") == "run" and self._start_ts is None:
                self._start_ts = float(r["ts"])
            elif r.get("ev") == "e":
                tot = self._bg_totals if r.get("bg") else self._totals
                tot[r["seg"]] = tot.get(r["seg"], 0.0) \
                    + max(float(r["t1"]) - float(r["t0"]), 0.0)
            if r.get("ev") == "run" and r.get("resumed"):
                self._restarts += 1
            if r.get("ev") == "h":
                self._events += 1

    # -- journal I/O -----------------------------------------------------
    def _append(self, rec: Dict[str, Any]) -> None:
        """One JSON line + flush: flushed bytes reach the kernel, so a
        SIGKILL (the preemption model) never loses them; only a machine
        crash could, and the resume path tolerates any truncated tail."""
        try:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        except (OSError, ValueError):
            pass        # a dead journal must never take the run down

    def _close_interval(self, seg: str, t0: float, t1: float,
                        bg: bool = False, **extra) -> None:
        if t1 <= t0:
            return
        rec = {"ev": "e", "seg": seg, "t0": t0, "t1": t1}
        if bg:
            rec["bg"] = 1
        rec.update(extra)
        self._append(rec)
        tot = self._bg_totals if bg else self._totals
        tot[seg] = tot.get(seg, 0.0) + (t1 - t0)

    # -- the segment protocol --------------------------------------------
    def begin(self, seg: str, **meta) -> None:
        now = time.time()
        with self._lock:
            if self._stack:
                name, t0, m = self._stack[-1]
                self._close_interval(name, t0, now, **m)
            rec = {"ev": "b", "seg": seg, "ts": now}
            rec.update(meta)
            self._append(rec)
            self._stack.append((seg, now, meta))

    def end(self) -> None:
        now = time.time()
        with self._lock:
            if not self._stack:
                return
            name, t0, meta = self._stack.pop()
            self._close_interval(name, t0, now, **meta)
            if self._stack:
                # resume the paused outer segment from here
                name, _, m = self._stack[-1]
                self._stack[-1] = (name, now, m)

    def record_overlapped(self, seg: str, t0: float, t1: float) -> None:
        """A background-thread interval (``ckpt_async``): journaled with
        ``bg: 1``, excluded from the foreground wall identity."""
        with self._lock:
            self._close_interval(seg, t0, t1, bg=True)

    def note_event(self, kind: str, **payload) -> None:
        """Durable anomaly/event record (the health monitor's spike
        events ride here so run_report can draw the timeline)."""
        rec = {"ev": "h", "kind": kind, "ts": time.time()}
        rec.update(payload)
        with self._lock:
            self._append(rec)
            self._events += 1

    # -- reporting -------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """Live totals (open segments counted up to now)."""
        now = time.time()
        with self._lock:
            totals = dict(self._totals)
            if self._stack:
                name, t0, _ = self._stack[-1]
                totals[name] = totals.get(name, 0.0) + (now - t0)
            return _summarize(totals, dict(self._bg_totals),
                              self._start_ts or now, now,
                              self._restarts, self._events)

    def publish(self, metrics: Dict[str, Any]) -> None:
        """Refresh the goodput gauges (catalog.goodput_metrics set)."""
        s = self.summary()
        for seg in SEGMENTS:
            metrics["goodput_segments"].set(
                s["segments"].get(seg, 0.0), segment=seg)
        metrics["goodput_pct"].set(s["goodput_pct"])
        metrics["goodput_wall"].set(s["wall_seconds"])
        metrics["goodput_restarts"].set(float(s["restarts"]))

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass


def _tail_ts(records: List[Dict[str, Any]]) -> Optional[float]:
    """The last instant the (dead) writer journaled anything."""
    last = None
    for r in records:
        for k in ("ts", "t1"):
            v = r.get(k)
            if isinstance(v, (int, float)):
                last = v if last is None else max(last, v)
    return last


def _summarize(totals: Dict[str, float], bg: Dict[str, float],
               start: float, end: float, restarts: int,
               events: int) -> Dict[str, Any]:
    wall = max(end - start, 0.0)
    fg_sum = sum(totals.values())
    segments = {seg: round(totals.get(seg, 0.0), 6) for seg in SEGMENTS
                if totals.get(seg)}
    segments["idle"] = round(max(wall - fg_sum, 0.0), 6)
    productive = totals.get("step_compute", 0.0)
    return {
        "wall_seconds": round(wall, 6),
        "segments": segments,
        "segment_pct": {seg: round(100.0 * v / wall, 2) if wall else 0.0
                        for seg, v in segments.items()},
        "overlapped_seconds": {seg: round(v, 6)
                               for seg, v in sorted(bg.items())},
        "productive_step_seconds": round(productive, 6),
        "goodput_pct": round(100.0 * productive / wall, 2) if wall
        else 0.0,
        "restarts": int(restarts),
        "events": int(events),
    }


def read_journal(path: str) -> List[Dict[str, Any]]:
    """Parse a journal leniently: a SIGKILL may truncate the final
    line mid-write — skip anything unparsable instead of failing the
    resume."""
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


def summarize(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Offline summary of a read journal (tools/run_report.py): same
    shape as ``GoodputLedger.summary``, computed purely from closed
    intervals."""
    totals: Dict[str, float] = {}
    bg: Dict[str, float] = {}
    start = end = None
    restarts = events = 0
    for r in records:
        ev = r.get("ev")
        if ev == "run":
            ts = float(r.get("ts", 0.0))
            start = ts if start is None else min(start, ts)
            if r.get("resumed"):
                restarts += 1
        elif ev == "e":
            tot = bg if r.get("bg") else totals
            tot[r["seg"]] = tot.get(r["seg"], 0.0) \
                + max(float(r["t1"]) - float(r["t0"]), 0.0)
        elif ev == "h":
            events += 1
        t = _tail_ts([r])
        if t is not None:
            end = t if end is None else max(end, t)
    if start is None:
        start = end = 0.0
    return _summarize(totals, bg, start, end if end is not None
                      else start, restarts, events)


# ---------------------------------------------------------------------------
# process-current ledger (the engines/checkpoint layers instrument
# against whatever is attached; unattached = everything is a no-op)
# ---------------------------------------------------------------------------
_current: Optional[GoodputLedger] = None
_by_path: Dict[str, GoodputLedger] = {}
_attach_lock = threading.Lock()


def attach_dir(base: str) -> GoodputLedger:
    """Get-or-create the ledger journaling at ``<base>/goodput.jsonl``
    and make it the process-current one. Within a process the same base
    always returns the SAME live ledger (no fake restarts); a fresh
    process opening an existing journal closes its dangling tail as
    ``recovery_restart``."""
    path = os.path.abspath(os.path.join(str(base), JOURNAL_NAME))
    global _current
    with _attach_lock:
        led = _by_path.get(path)
        if led is None:
            led = _by_path[path] = GoodputLedger(path)
        _current = led
        return led


def attach(ledger: Optional[GoodputLedger]) -> None:
    """Make ``ledger`` the process-current one (tests; None detaches)."""
    global _current
    with _attach_lock:
        _current = ledger


def current() -> Optional[GoodputLedger]:
    return _current


def detach() -> None:
    attach(None)


@contextlib.contextmanager
def segment(name: str, **meta):
    """The instrumentation hook: a no-op when no ledger is attached
    (one None check), else one journaled foreground segment. The name
    also rides the ``trace.annotate`` host region stack so a stall
    flight record shows which goodput segment every thread was in."""
    led = _current
    if led is None:
        yield
        return
    from . import trace

    led.begin(name, **meta)
    try:
        with trace.annotate(f"goodput:{name}"):
            yield
    finally:
        led.end()


def note_event(kind: str, **payload) -> None:
    """Durable event on the current ledger (no-op when unattached)."""
    led = _current
    if led is not None:
        led.note_event(kind, **payload)

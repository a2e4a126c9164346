"""Per-request lifecycle spans for the serving engine (counterpart of
``paddle_tpu/observability/spans.py``, the same code).

Every ``ServingRequest`` gets a ``RequestTrace``: a list of named spans
(queued → prefill → decode, plus one span per shared decode round the
request was in flight for — and, under chunked prefill, one
``prefill_chunk`` span per scheduled chunk carrying the chunk index +
token count, plus ``preempt`` instants when a page-starved row bounces
back to the queue) on the ``time.perf_counter`` clock. Finished traces
land in a bounded ``SpanRing`` so a long-running engine keeps the
last-N request histories without growing memory.

Exports:

- ``SpanRing.to_chrome_trace()`` — Chrome ``chrome://tracing`` /
  Perfetto JSON ("X" complete events, one ``tid`` lane per request,
  zero-length spans as "i" instants, timestamps rebased to the earliest
  span),
- per-stage latency percentiles via the
  ``paddle_tpu_serving_request_stage_seconds{stage}`` histogram
  (observed by the engine as each span closes).

Every trace carries W3C-traceparent identity so a request can be
stitched across replicas (``inference/router.py`` and the
disaggregated prefill/decode split of ``inference/disagg.py``): a
32-hex ``trace_id`` shared by every span of the request, a 16-hex root
``span_id`` per trace, and an optional ``parent_span_id`` naming the
caller's span elsewhere. ``format_traceparent`` / ``parse_traceparent``
round-trip the ``00-<trace>-<span>-01`` header form;
``ServingEngine.submit`` accepts either piece and generates what is
missing.

Host-side Python on perf_counter floats only: nothing here reads the
device.
"""
from __future__ import annotations

import json
import os
import random
import re
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Span", "RequestTrace", "SpanRing", "make_trace_id",
           "make_span_id", "format_traceparent", "parse_traceparent"]

# the per-request lifecycle stages, in order (the stage histogram's
# label values; "decode_round" additionally marks shared-round spans)
STAGES = ("queued", "prefill", "decode", "e2e")

# W3C trace-context identity: trace_id is 32 lowercase hex chars,
# span_id 16; the traceparent header is version 00 with the sampled
# flag set (we always record).
_TRACE_ID_RE = re.compile(r"^[0-9a-f]{32}$")
_SPAN_ID_RE = re.compile(r"^[0-9a-f]{16}$")
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


# ids come from a generator seeded from os.urandom once a process (and
# again in a forked child, so two workers never share a stream): a span
# is made for every request in every round, and a system-call per id
# costs the serving loop, which waits on it, measurably
_ids = random.Random(os.urandom(32))


def _reseed_ids() -> None:
    _ids.seed(os.urandom(32))


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reseed_ids)


def make_trace_id() -> str:
    """A fresh 32-hex W3C trace id (random, never all-zero)."""
    tid = _ids.getrandbits(128)
    return f"{tid:032x}" if tid else make_trace_id()


def make_span_id() -> str:
    """A fresh 16-hex W3C span id (random, never all-zero)."""
    sid = _ids.getrandbits(64)
    return f"{sid:016x}" if sid else make_span_id()


def format_traceparent(trace_id: str, span_id: str) -> str:
    """``00-<trace_id>-<span_id>-01`` (version 00, sampled)."""
    if not _TRACE_ID_RE.match(trace_id):
        raise ValueError(f"invalid trace_id {trace_id!r} (want 32 hex)")
    if not _SPAN_ID_RE.match(span_id):
        raise ValueError(f"invalid span_id {span_id!r} (want 16 hex)")
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(header: str) -> Tuple[str, str]:
    """``(trace_id, span_id)`` out of a traceparent header; raises
    ValueError on a malformed header or an all-zero id (the spec's
    invalid sentinel)."""
    m = _TRACEPARENT_RE.match(str(header).strip().lower())
    if not m:
        raise ValueError(f"malformed traceparent {header!r}")
    _ver, trace_id, span_id, _flags = m.groups()
    if not int(trace_id, 16) or not int(span_id, 16):
        raise ValueError(f"all-zero id in traceparent {header!r}")
    return trace_id, span_id


class Span:
    """One named interval; ``end`` stays None while open. Every span
    carries its own 16-hex ``span_id`` and its parent's (the trace
    root for engine-created stage spans) so exported traces stitch
    across processes."""

    __slots__ = ("name", "t0", "t1", "meta", "span_id",
                 "parent_span_id")

    def __init__(self, name: str, t0: float,
                 t1: Optional[float] = None,
                 meta: Optional[Dict[str, Any]] = None,
                 span_id: Optional[str] = None,
                 parent_span_id: Optional[str] = None):
        self.name = name
        self.t0 = float(t0)
        self.t1 = None if t1 is None else float(t1)
        self.meta = meta or {}
        self.span_id = span_id or make_span_id()
        self.parent_span_id = parent_span_id

    @property
    def seconds(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0

    def to_dict(self) -> Dict[str, Any]:
        d = {"name": self.name, "t0": self.t0, "t1": self.t1,
             "seconds": self.seconds, "span_id": self.span_id}
        if self.parent_span_id is not None:
            d["parent_span_id"] = self.parent_span_id
        if self.meta:
            d["meta"] = dict(self.meta)
        return d


class RequestTrace:
    """The span set of one serving request (rid keys the trace).

    ``trace_id`` (32 hex, auto-generated when the caller brings none)
    names the request across processes; ``span_id`` is the trace's
    root span (every stage span created here is its child) and
    ``parent_span_id`` the submitting caller's span in ANOTHER
    process, straight off an incoming traceparent header.
    """

    __slots__ = ("rid", "spans", "meta", "trace_id", "span_id",
                 "parent_span_id")

    def __init__(self, rid: int, meta: Optional[Dict[str, Any]] = None,
                 trace_id: Optional[str] = None,
                 parent_span_id: Optional[str] = None):
        self.rid = rid
        self.spans: List[Span] = []
        self.meta = meta or {}
        if trace_id is not None and not _TRACE_ID_RE.match(trace_id):
            raise ValueError(
                f"invalid trace_id {trace_id!r} (want 32 hex)")
        if parent_span_id is not None and \
                not _SPAN_ID_RE.match(parent_span_id):
            raise ValueError(
                f"invalid parent_span_id {parent_span_id!r} "
                f"(want 16 hex)")
        self.trace_id = trace_id or make_trace_id()
        self.span_id = make_span_id()
        self.parent_span_id = parent_span_id

    @property
    def traceparent(self) -> str:
        """The header to propagate DOWNSTREAM of this request (names
        this trace's root span as the parent)."""
        return format_traceparent(self.trace_id, self.span_id)

    def begin(self, name: str, t0: float,
              meta: Optional[Dict[str, Any]] = None) -> Span:
        sp = Span(name, t0, meta=meta, parent_span_id=self.span_id)
        self.spans.append(sp)
        return sp

    def end(self, name: str, t1: float) -> Optional[Span]:
        """Close the most recent open span named ``name``; returns it
        (None when no such span is open — callers treat that as a
        stage the request never entered)."""
        for sp in reversed(self.spans):
            if sp.name == name and sp.t1 is None:
                sp.t1 = float(t1)
                return sp
        return None

    def add(self, name: str, t0: float, t1: float,
            meta: Optional[Dict[str, Any]] = None) -> Span:
        sp = Span(name, t0, t1, meta, parent_span_id=self.span_id)
        self.spans.append(sp)
        return sp

    def span(self, name: str) -> Optional[Span]:
        for sp in self.spans:
            if sp.name == name:
                return sp
        return None

    def to_dict(self) -> Dict[str, Any]:
        d = {"rid": self.rid, "meta": dict(self.meta),
             "trace_id": self.trace_id, "span_id": self.span_id,
             "traceparent": self.traceparent,
             "spans": [s.to_dict() for s in self.spans]}
        if self.parent_span_id is not None:
            d["parent_span_id"] = self.parent_span_id
        return d


class SpanRing:
    """Bounded ring of finished request traces (thread-safe)."""

    def __init__(self, maxlen: int = 256):
        self._ring: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def __len__(self):
        with self._lock:
            return len(self._ring)

    def add(self, trace: RequestTrace) -> None:
        with self._lock:
            self._ring.append(trace)

    def traces(self) -> List[RequestTrace]:
        with self._lock:
            return list(self._ring)

    def to_dicts(self) -> List[Dict[str, Any]]:
        return [t.to_dict() for t in self.traces()]

    def to_chrome_trace(self, path: Optional[str] = None,
                        extra: Optional[List[RequestTrace]] = None
                        ) -> Dict[str, Any]:
        """Chrome-trace JSON of every finished trace (plus ``extra``
        in-flight ones): one ``tid`` lane per request, "X" complete
        events in microseconds rebased to the earliest span. Writes to
        ``path`` when given; always returns the dict."""
        traces = self.traces() + list(extra or [])
        events: List[Dict[str, Any]] = []
        t_base = min((s.t0 for t in traces for s in t.spans),
                     default=0.0)
        for tr in traces:
            events.append({"ph": "M", "name": "thread_name", "pid": 0,
                           "tid": tr.rid,
                           "args": {"name": f"req{tr.rid}"}})
            ident = {"trace_id": tr.trace_id, "span_id": tr.span_id}
            if tr.parent_span_id is not None:
                ident["parent_span_id"] = tr.parent_span_id
            for sp in tr.spans:
                if sp.t1 is None:
                    continue
                if sp.t1 == sp.t0:
                    # zero-length span = a point event (a shed
                    # decision, an eviction): Chrome "i" instant
                    # events render as markers instead of vanishing
                    # as 0-width "X" slices
                    events.append({
                        "ph": "i", "cat": "serving", "name": sp.name,
                        "pid": 0, "tid": tr.rid, "s": "t",
                        "ts": (sp.t0 - t_base) * 1e6,
                        "args": {**tr.meta, **sp.meta, **ident},
                    })
                    continue
                events.append({
                    "ph": "X", "cat": "serving", "name": sp.name,
                    "pid": 0, "tid": tr.rid,
                    "ts": (sp.t0 - t_base) * 1e6,
                    "dur": sp.seconds * 1e6,
                    "args": {**tr.meta, **sp.meta, **ident},
                })
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc

"""Multi-replica serving front door: admission routing and phase
placement (counterpart of ``paddle_tpu/inference/router.py``).

One :class:`Router` fronts N :class:`~.serving.ServingEngine` replicas,
unified or split by phase into prefill and decode pools (the
disaggregated topology of inference/disagg.py; on one card, engines on
the same device). Placement of a new request walks three signals in
order:

1. **Health**: replicas whose ``health()`` is "degraded" (shedding, or
   the queue at its bound), or that an attached ``collector`` calls
   degraded (any object with ``member_health(name)``; the JAX
   ``FleetCollector`` waits on ROADMAP.md queue 1, item 11), are skipped
   while a healthy candidate exists; a fully degraded pool still serves.
2. **Prefix affinity**: the prompt's page-aligned rolling prefix hashes
   (the ones the prefix cache registers pages under) against each
   candidate's cache; the replica holding the longest run wins.
3. **Least-loaded**: otherwise the fewest queued + active rows, then the
   most free pages.

Every placement increments
``paddle_tpu_router_requests_total{replica, decision}`` and each tick
sets ``paddle_tpu_router_phase_slots{phase}``.

Tracing: the router mints one W3C trace a request (or adopts the
client's ``traceparent``) and hands the same header to every hop:
placement, migration (the engines carry the exported identity) and
retries, so the replicas' Chrome traces stitch on ``trace_id``.

The HTTP front door (:class:`RouterServer`, stdlib only): handler
threads never touch an engine. ``POST /v1/generate`` enqueues onto a
thread-safe inbox and waits on an Event; the one serving loop
(:meth:`Router.step`, driven by the caller, :meth:`Router.run` or
:meth:`RouterServer.serve_pending`) drains the inbox, places, steps
every replica, pumps migrations and completes the waiting requests.
"""
from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.enforce import enforce
from ..observability.catalog import serving_metrics as _serving_metrics
from ..observability.spans import (format_traceparent, make_span_id,
                                   make_trace_id)
from .disagg import KVMigrator

__all__ = ["Replica", "Router", "RouterServer"]


class Replica:
    """One named engine behind the front door. The router reads its
    health, load and prefix cache through the in-process handle."""

    def __init__(self, name: str, engine):
        self.name = str(name)
        self.engine = engine

    @property
    def phase(self) -> str:
        return self.engine.phase or "unified"

    def load(self) -> Tuple[int, int]:
        """Ordering key: fewest queued+active rows first, then most
        free pages (negated)."""
        eng = self.engine
        return (len(eng.queue) + eng.num_active, -eng._avail_pages())


class _Pending:
    """One blocked HTTP request: handler thread fills it in, parks on
    ``done``; the serving loop completes it."""

    __slots__ = ("body", "traceparent", "done", "result", "error")

    def __init__(self, body: Dict[str, Any],
                 traceparent: Optional[str]):
        self.body = body
        self.traceparent = traceparent
        self.done = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[str] = None


class Router:
    """The placement brain + serving loop over a replica fleet.

    ``replicas`` is ``[(name, engine), ...]``. Prefill-phase replicas
    require at least one decode-phase replica to stream to; the router
    then owns a :class:`KVMigrator` and pumps it every step. An
    attached ``collector`` (any object with ``member_health(name)``
    returning ``{"status": ...}``) overlays health from outside the
    process: a member it calls degraded is skipped like one whose
    engine says so."""

    def __init__(self, replicas: Sequence[Tuple[str, Any]],
                 collector=None, affinity: bool = True):
        self._metrics = _serving_metrics()
        self.replicas = [Replica(n, e) for n, e in replicas]
        enforce(self.replicas, "Router needs at least one replica")
        enforce(len({r.name for r in self.replicas})
                == len(self.replicas),
                "replica names must be unique — they key placement "
                "counters and the gid map")
        self._by_name = {r.name: r for r in self.replicas}
        self._name_of = {id(r.engine): r.name for r in self.replicas}
        # the admission pool: anything that can run a prefill
        self.frontdoor = [r for r in self.replicas
                          if r.engine.phase != "decode"]
        enforce(self.frontdoor,
                "Router needs a prefill-capable (phase None or "
                '"prefill") replica to admit prompts into')
        prefill = [r.engine for r in self.replicas
                   if r.engine.phase == "prefill"]
        decode = [r.engine for r in self.replicas
                  if r.engine.phase == "decode"]
        if prefill:
            enforce(decode, 'phase="prefill" replicas park every '
                    'request for migration; the fleet needs a '
                    'phase="decode" replica to stream KV pages to')
        self._prefill_engines = prefill
        self.migrator = KVMigrator(decode) if decode else None
        self.collector = collector
        self.affinity = bool(affinity)
        self._next_gid = 0
        # gid -> {"replica", "rid", "traceparent", "prompt", ...} while
        # in flight; resolved requests move to _results
        self._placed: Dict[int, Dict[str, Any]] = {}
        self._results: Dict[int, Any] = {}
        # HTTP front door plumbing: handler threads put _Pending here
        # (thread-safe Queue); ONLY the serving loop drains it
        self._inbox: "queue.Queue[_Pending]" = queue.Queue()
        self._http_pending: Dict[int, _Pending] = {}

    # -- placement -------------------------------------------------------

    def _healthy(self, r: Replica) -> bool:
        if r.engine.health() != "ok":
            return False
        if self.collector is not None:
            if self.collector.member_health(r.name)["status"] != "ok":
                return False
        return True

    def _place(self, prompt: np.ndarray,
               exclude: Optional[str] = None) -> Tuple[Replica, str]:
        """Pick the replica for one prompt: health filter, then prefix
        affinity, then least-loaded."""
        pool = [r for r in self.frontdoor if r.name != exclude] \
            or self.frontdoor
        cands = [r for r in pool if self._healthy(r)] or pool
        if self.affinity and len(cands) > 1:
            best, best_run = None, 0
            for r in cands:
                eng = r.engine
                if not eng.prefix:
                    continue
                run = eng.prefix_match(eng._prefix_hashes(prompt))
                if run > best_run:
                    best, best_run = r, run
            if best is not None:
                return best, "affinity"
        return min(cands, key=Replica.load), "least_loaded"

    # -- submission ------------------------------------------------------

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               traceparent: Optional[str] = None) -> int:
        """Place one request on the fleet; returns its global id. The
        router-level trace identity (minted here unless the caller
        sent a ``traceparent``) follows the request across every
        replica hop, including retries."""
        gid = self._next_gid
        self._next_gid += 1
        if traceparent is None:
            traceparent = format_traceparent(make_trace_id(),
                                             make_span_id())
        arr = np.asarray(prompt, np.int64).reshape(-1)
        r, decision = self._place(arr)
        rid = r.engine.submit(arr, max_new_tokens=max_new_tokens,
                              eos_token_id=eos_token_id,
                              trace_id=traceparent)
        self._metrics["router_requests"].inc(replica=r.name,
                                             decision=decision)
        self._placed[gid] = {
            "replica": r.name, "rid": rid, "traceparent": traceparent,
            "prompt": arr, "max_new_tokens": max_new_tokens,
            "eos_token_id": eos_token_id,
        }
        return gid

    def _retry(self, gid: int, info: Dict[str, Any]) -> None:
        """Resubmit after a corrupt/refused migration, preferring a
        replica other than the one the request just failed on. Greedy
        prefill restart recommits the same tokens, so the retry is
        exact; the original trace identity rides along."""
        rec = self._placed[gid]
        r, _ = self._place(rec["prompt"], exclude=rec["replica"])
        rid = r.engine.submit(rec["prompt"],
                              max_new_tokens=rec["max_new_tokens"],
                              eos_token_id=rec["eos_token_id"],
                              trace_id=rec["traceparent"])
        self._metrics["router_requests"].inc(replica=r.name,
                                             decision="retry")
        rec["replica"] = r.name
        rec["rid"] = rid

    # -- the serving loop ------------------------------------------------

    def _gid_at(self, engine, rid: int) -> Optional[int]:
        name = self._name_of[id(engine)]
        for gid, rec in self._placed.items():
            if rec["replica"] == name and rec["rid"] == rid:
                return gid
        return None

    def _on_migration(self, ev: Dict[str, Any]) -> None:
        gid = self._gid_at(ev["src"], ev["src_rid"])
        if gid is None:       # directly-submitted (non-router) request
            return
        if ev["status"] == "ok":
            rec = self._placed[gid]
            rec["replica"] = self._name_of[id(ev["dst"])]
            rec["rid"] = ev["dst_rid"]
        else:                 # crc_error / refused: restart from scratch
            self._retry(gid, ev.get("request", {}))

    def _drain_http(self) -> None:
        while True:
            try:
                p = self._inbox.get_nowait()
            except queue.Empty:
                return
            try:
                gid = self.submit(
                    p.body["prompt"],
                    max_new_tokens=p.body.get("max_new_tokens"),
                    eos_token_id=p.body.get("eos_token_id"),
                    traceparent=p.traceparent)
            except Exception as e:   # malformed body fails ONE request
                p.error = str(e)
                p.done.set()
                continue
            self._http_pending[gid] = p

    def _collect(self) -> None:
        for gid, rec in list(self._placed.items()):
            eng = self._by_name[rec["replica"]].engine
            req = eng.finished.get(rec["rid"])
            if req is None:
                continue
            self._results[gid] = req
            del self._placed[gid]
            p = self._http_pending.pop(gid, None)
            if p is not None:
                p.result = {
                    "gid": gid,
                    "tokens": [int(t) for t in req.new_tokens],
                    "shed_reason": req.shed_reason,
                    "trace_id": req.trace_id,
                    "traceparent": req.traceparent,
                }
                p.done.set()

    def _note_tick(self) -> None:
        occ: Dict[str, int] = {}
        for r in self.replicas:
            occ[r.phase] = occ.get(r.phase, 0) + r.engine.num_active
        for ph, n in occ.items():
            self._metrics["phase_slots"].set(n, phase=ph)

    def step(self) -> None:
        """One fleet tick: drain the HTTP inbox, step every replica,
        pump migrations, collect finished requests, note gauges."""
        self._drain_http()
        for r in self.replicas:
            r.engine.step()
        if self.migrator is not None:
            for ev in self.migrator.pump(self._prefill_engines):
                self._on_migration(ev)
        self._collect()
        self._note_tick()

    def run(self, max_steps: Optional[int] = None) -> Dict[int, Any]:
        """Step until every placed request finishes (or ``max_steps``);
        returns {gid: ServingRequest}."""
        steps = 0
        while self._placed:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return dict(self._results)

    def result(self, gid: int):
        """The finished ServingRequest for ``gid`` (None while in
        flight)."""
        return self._results.get(gid)

    @property
    def pending(self) -> int:
        return len(self._placed) + self._inbox.qsize()

    # -- introspection ---------------------------------------------------

    def healthz(self) -> Dict[str, Any]:
        """The fleet rollup a load balancer polls: degraded when any
        replica is (matching the engines' /healthz contract)."""
        reps: Dict[str, Any] = {}
        n_bad = 0
        for r in self.replicas:
            h = r.engine.health()
            if self.collector is not None:
                overlay = self.collector.member_health(r.name)
                if overlay["status"] != "ok":
                    h = "degraded"
            n_bad += h != "ok"
            reps[r.name] = {
                "phase": r.phase, "health": h,
                "active": r.engine.num_active,
                "queued": len(r.engine.queue),
                "free_pages": r.engine._avail_pages(),
            }
        return {"status": "degraded" if n_bad else "ok",
                "replicas": reps, "pending": len(self._placed)}

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "submitted": self._next_gid,
            "in_flight": len(self._placed),
            "finished": len(self._results),
        }
        if self.migrator is not None:
            out["migrated"] = self.migrator.migrated
            out["migration_wire_bytes"] = self.migrator.wire_bytes
        return out


class RouterServer:
    """stdlib-HTTP front door over a :class:`Router`.

    ``POST /v1/generate`` with ``{"prompt": [ids...],
    "max_new_tokens": n}`` (optional ``traceparent`` header) blocks
    until the fleet finishes the request, then returns its tokens and
    trace identity. ``GET /healthz`` returns the fleet rollup, ``GET
    /stats`` the placement counters. Handler threads only enqueue and
    wait — the caller keeps driving ``router.step()`` (or
    :meth:`serve_pending`), preserving the engines' one-loop
    discipline."""

    def __init__(self, router: Router, port: int = 0,
                 host: str = "127.0.0.1", timeout_s: float = 120.0):
        self.router = router
        rt = router
        tmo = float(timeout_s)

        class _Handler(BaseHTTPRequestHandler):
            def _reply(self, code: int, obj: Dict[str, Any]) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, rt.healthz())
                elif self.path == "/stats":
                    self._reply(200, rt.stats())
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/v1/generate":
                    self._reply(404, {"error": "not found"})
                    return
                n = int(self.headers.get("Content-Length") or 0)
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._reply(400, {"error": "body is not JSON"})
                    return
                if "prompt" not in body:
                    self._reply(400, {"error": 'missing "prompt"'})
                    return
                pend = _Pending(body,
                                self.headers.get("traceparent"))
                rt._inbox.put(pend)
                if not pend.done.wait(tmo):
                    self._reply(504, {"error": "serving loop timeout"})
                    return
                if pend.error is not None:
                    self._reply(400, {"error": pend.error})
                    return
                self._reply(200, pend.result)

            def log_message(self, fmt, *args):
                pass

        self._srv = ThreadingHTTPServer((host, port), _Handler)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def serve_pending(self, max_steps: int = 10000) -> None:
        """Drive the serving loop until the inbox and fleet drain —
        the blocking companion to a burst of HTTP submissions."""
        steps = 0
        while self.router.pending and steps < max_steps:
            self.router.step()
            steps += 1

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "RouterServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

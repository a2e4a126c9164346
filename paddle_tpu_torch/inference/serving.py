"""Continuous-batching serving engine over the paged KV cache
(counterpart of ``paddle_tpu/inference/serving.py``).

The scheduler is the JAX engine's, decision for decision, so the two
commit the same token streams and keep the same counters: one fixed
page pool with a trash page (id P-1), B batch slots, admission in FIFO
order while pages last, eviction and backfill.

- Legacy mode (``prefill_chunk=None``): each arrival is prefilled at
  admission at ``[1, Sb]`` (Sb on the power-of-two lattice) through the
  paged decode attention (K5); then the batch decodes together.
- Chunked mode (``prefill_chunk``): prompts feed ONE unified ``[B, Sc]``
  step in page-aligned chunks under ``prefill_token_budget``, decode
  rows riding in the same launch; its attention is the ragged paged
  kernel (K4). Rounds with no chunk to feed run the ``[B, 1]`` decode
  step (K5) ``decode_chunk`` times. Pages are reserved per chunk; a
  page-starved engine preempts the youngest mid-prefill row.

Prefix cache (``prefix_cache=True``, chunked mode): pages are
ref-counted and content-addressed. A rolling hash per full page-aligned
prompt chunk keys each completed page; admission maps the longest cached
prefix into the new row's block table (a reference each, no copy) and
the chunk planner starts at the first cold chunk. Registered pages are
immutable: the one write that can land in one, the full-prompt hit's
refeed of its last token, copies the page first (copy-on-write).
Released pages that are registered park on an LRU that the allocator
reclaims, oldest first, under pool pressure. With ``host_spill_pages``
a reclaimed page's rows go to host memory under the same hash and fault
back into a fresh page when a later prompt hits it.

Speculative decoding (``draft_predictor`` + ``spec_tokens=k``, greedy,
chunked mode): the draft's KV pools share the engine's page ids and
tables in the draft's geometry and dtype. Each round the draft proposes
k greedy tokens per decode row (k+1 ``[B, 1]`` steps), ONE verify
forward on the unified ``[B, Sc]`` shape takes the argmax at every
position, and the host commits the longest matching run plus one token,
so the committed ids equal plain greedy decoding's.

Shedding: ``max_queue`` sheds a submit into a full queue
(``queue_full``), ``admission_deadline_s`` sheds a queued request whose
wait passed its deadline (``deadline``) before any prefill; shed
requests land in ``finished`` with no tokens, and ``health()`` reads
"degraded" for ``degraded_window_s`` after a shed.

Where the JAX engine jits each step per lattice key with the pools
donated, the port captures each round's body as a CUDA graph per key
and replays it (``core/cuda_graphs.py``; on the CPU the body runs
eagerly): the ``decode_chunk`` steps, the unified ``[B, Sc]`` forward
and its sample, and with speculation the verify step (``unified_spec``),
the draft's k+1 proposal steps (``draft_propose``) and its prompt-chunk
feed (``draft_chunk``). A round's inputs are static buffers refreshed
from the host's arrays before it. The pools are the engine's own,
updated in place where JAX donated them, so they keep their addresses
and a page copy, spill or fault between two replays leaves every graph
valid. ``stats`` notes every launch site with its shape key, as the JAX
engine notes its compiled programs, so a fixed shape lattice after
warmup stays checkable. The legacy per-arrival prefill stays eager.

Telemetry, as the JAX engine's: TTFT / TPOT / stage / round
histograms, queue, slot and page gauges and lifecycle counters in the
process-wide registry (``observability.catalog.serving_metrics``), one
``RequestTrace`` of spans per request (queued, prefill or its chunks,
decode rounds, decode, e2e; shed and preempt instants) kept in a
bounded ``SpanRing`` with Chrome-trace export, W3C trace identity on
``submit`` (a ``traceparent`` header or bare ids), ``health()`` on the
exporter's ``/healthz``, and the ``PADDLE_TPU_TIMESERIES_DIR`` sampler.
All of it is host-side, on the host clock at points where the engine
already reads tokens back: no round gains a device sync. With
``mem_ledger=True`` each launch site gets a memory ledger at its first
execution (``observability/memledger.py``) and ``pool_pages="auto"``
sizes the pool from the card's free memory. No round of one engine
issues a collective, so ``comm_ledger(site)`` is None for each.

Disaggregated phases (``phase="prefill"`` / ``"decode"``,
``inference/disagg.py`` and ``inference/router.py``): a prefill replica
parks each row at its first committed token; ``export_request`` reads
its committed pages out in place, ``import_request`` writes them into a
decode replica's pool in place, so every captured graph stays valid.
"""
from __future__ import annotations

import inspect
import os
import threading
import time
import weakref
from collections import Counter, OrderedDict, deque
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.bucketing import bucket as _bucket
from ..core.cuda_graphs import StepGraphs
from ..core.enforce import enforce
from ..observability import memledger as _ml
from ..observability.catalog import serving_metrics as _serving_metrics
from ..observability.spans import (RequestTrace, SpanRing,
                                   format_traceparent as
                                   _format_traceparent,
                                   parse_traceparent as
                                   _parse_traceparent)

__all__ = ["ServingEngine", "ServingRequest"]

# Least seconds between two registry snapshots of the serving ticks. A
# snapshot (every metric's rows, every histogram's percentiles) is the
# costliest host work of a tick, and the serving loop waits on it
# between two rounds: at one a tick it costs graphed serve tokens/s
# measurably (PERF.md, the serving telemetry). The snapshot also stamps
# /healthz's liveness, which is then never older than this plus a round.
SNAPSHOT_EVERY_S = 0.1


@dataclass
class ServingRequest:
    """One serving request and (once finished) its result."""

    rid: int
    prompt: np.ndarray                   # [L] int prompt tokens
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    new_tokens: List[int] = field(default_factory=list)
    # host clock (perf_counter): TTFT = t_first_token - t_submit;
    # TPOT = (t_finish - t_first_token) / (n_tokens - 1)
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_finish: float = 0.0
    # why this request was load-shed (None = served); the admission
    # deadline in the t_submit clock
    shed_reason: Optional[str] = None
    deadline: Optional[float] = None
    # W3C trace identity (observability/spans.py): trace_id spans
    # replicas, span_id is this request's root span in this engine,
    # parent_span_id the submitting caller's span
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    parent_span_id: Optional[str] = None

    @property
    def shed(self) -> bool:
        return self.shed_reason is not None

    @property
    def traceparent(self) -> Optional[str]:
        """The ``00-<trace_id>-<span_id>-01`` header for work downstream
        of this request (None before submit stamps the identity)."""
        if self.trace_id is None or self.span_id is None:
            return None
        return _format_traceparent(self.trace_id, self.span_id)

    @property
    def output_ids(self) -> np.ndarray:
        """prompt + generated tokens."""
        return np.concatenate([np.asarray(self.prompt, np.int64),
                               np.asarray(self.new_tokens, np.int64)])


class _Slot:
    """Host-side state of one in-flight batch row."""

    __slots__ = ("req", "pages", "pos", "state", "fed", "chunks", "seq",
                 "hashes", "registered", "hit_pages")

    def __init__(self, req: ServingRequest, pages: List[int],
                 state: str = "decode", seq: int = 0):
        self.req = req
        self.pages = pages
        # cache position the NEXT decode input token is written at
        self.pos = len(req.prompt)
        # "prefill" while prompt tokens remain unfed (chunked mode), then
        # "decode"; legacy slots are born "decode" (prefilled at admit);
        # "migrate" on a prefill replica once the first token is sampled
        self.state = state
        self.fed = 0            # prompt tokens already written
        self.chunks = 0         # chunks fed (the spans' chunk index)
        self.seq = seq          # admission order (scheduler fairness)
        # prefix cache: the rolling hash per full page-aligned prompt
        # chunk (None with the cache off), the leading pages already
        # registered, and how many arrived as hits
        self.hashes: Optional[List[int]] = None
        self.registered = 0
        self.hit_pages = 0


class ServingEngine:
    """Continuous batching over a Predictor with a paged KV cache.

    >>> pred = create_predictor(Config().set_model(m).enable_paged_kv(64))
    >>> eng = ServingEngine(pred, max_batch=8, prefill_chunk=256,
    ...                     prefix_cache=True, draft_predictor=draft,
    ...                     spec_tokens=4)
    >>> rid = eng.submit(prompt_ids, max_new_tokens=64)
    >>> done = eng.run()          # {rid: ServingRequest}
    """

    def __init__(self, predictor, max_batch: Optional[int] = None,
                 pool_pages: Optional[int] = None, decode_chunk: int = 1,
                 trace_ring: int = 256, mem_ledger: bool = False,
                 max_queue: Optional[int] = None,
                 admission_deadline_s: Optional[float] = None,
                 degraded_window_s: float = 30.0,
                 prefill_chunk: Optional[int] = None,
                 prefill_token_budget: Optional[int] = None,
                 prefix_cache: bool = False,
                 draft_predictor=None, spec_tokens: int = 0,
                 host_spill_pages: int = 0,
                 phase: Optional[str] = None,
                 debug_invariants: bool = False):
        cfg = predictor.config
        enforce(cfg._kv_page_size,
                "ServingEngine serves over the paged KV cache; call "
                "Config.enable_paged_kv(page_size) before create_predictor")
        self.pred = predictor
        self.device = predictor.device
        self.page = int(cfg._kv_page_size)
        mcfg = predictor._model.config
        self.M = int(cfg.max_length or mcfg.max_position_embeddings)
        self.npages = -(-self.M // self.page)
        self.B = int(max_batch or cfg.max_batch_size)
        enforce(self.B >= 1 and decode_chunk >= 1,
                "max_batch and decode_chunk must be >= 1")
        self.chunk = int(decode_chunk)
        # Sc: power-of-two lattice AND a multiple of the page size, so
        # chunk frontiers land on page boundaries
        self.chunked = prefill_chunk is not None
        if self.chunked:
            enforce(int(prefill_chunk) >= 1, "prefill_chunk must be >= 1")
            self.Sc = min(_bucket(int(prefill_chunk), lo=self.page),
                          _bucket(self.M, lo=self.page))
            enforce("valid" in inspect.signature(
                predictor._model.forward).parameters,
                "prefill_chunk needs a model whose forward accepts the "
                "unified ragged metadata kwarg `valid` (see "
                "models/llama.py)")
            self.prefill_budget = int(prefill_token_budget or self.Sc)
            enforce(self.prefill_budget >= 1,
                    "prefill_token_budget must be >= 1")
        else:
            self.Sc = 0
            self.prefill_budget = 0
        # disaggregated serving (inference/disagg.py moves the pages): a
        # "prefill" replica parks each row at its first sampled token,
        # holding its committed pages for export; a "decode" replica only
        # adopts migrated rows (submit is refused). None = unified.
        enforce(phase in (None, "prefill", "decode"),
                'ServingEngine phase must be None, "prefill", or '
                '"decode"')
        self.phase = phase
        if phase == "prefill":
            enforce(self.chunked,
                    'phase="prefill" runs the chunked unified step; set '
                    "prefill_chunk")
        if phase is not None:
            enforce(draft_predictor is None,
                    "disaggregated phases do not carry the draft pools; "
                    "run speculative decoding on unified replicas")
        self._admit_seq = 0
        # chunked-mode backpressure: while an active row is page-stalled,
        # admissions pause so freed pages reach the oldest stalled row
        self._page_stalled = False
        self._dtype = predictor.dtype
        # one pool for the engine's lifetime. pool_pages="auto" sizes it
        # from the card's free memory (memledger.suggest_pool_pages:
        # weights and any other engine's pool already taken off, 10%
        # margin), capped at the geometric maximum the batch can
        # reference; off the card it falls back to the geometric default.
        geom = self.B * self.npages + 1
        if pool_pages == "auto":
            fit = _ml.suggest_pool_pages(self.device, self._page_bytes(),
                                         0)
            want = min(fit, geom) if fit else geom
        else:
            want = pool_pages or geom
        self.P = _bucket(int(want), lo=8)
        self.trash = self.P - 1
        self._free_pages = list(range(self.P - 1))
        # prefix cache: ref-counted, content-addressed pages. _hash_page
        # maps the rolling prefix hash of a completed page-aligned chunk
        # to the page holding its KV, _page_hash is the inverse, _lru
        # holds registered pages at refcount 0 (still hit-able, reclaimed
        # oldest first). All allocator state moves under one lock.
        self.prefix = bool(prefix_cache)
        if self.prefix:
            enforce(self.chunked,
                    "prefix_cache needs chunked prefill (prefill_chunk): "
                    "cache hits are whole page-aligned chunks the chunk "
                    "planner skips")
        self._lock = threading.RLock()
        self._refcount = [0] * self.P
        self._hash_page: Dict[int, int] = {}
        self._page_hash: Dict[int, int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._pfx = {"lookups": 0, "hits": 0, "cow": 0, "reclaimed": 0,
                     "registered": 0, "skipped_tokens": 0,
                     "fed_tokens": 0}
        # host tier: up to host_spill_pages reclaimed pages keep their
        # rows in host memory under the same prefix hash and fault back
        # through admission. A hash lives on the device or on the host,
        # never both. Reclaim only stages (page, hash) under the lock;
        # _alloc_pages reads the rows after releasing it and before the
        # pages are handed out, so nothing has rewritten them yet.
        self.spill_pages = int(host_spill_pages or 0)
        enforce(self.spill_pages == 0 or self.prefix,
                "host_spill_pages rides the prefix cache (pages are keyed "
                "by prefix hash); set prefix_cache=True")
        self._spilled: "OrderedDict[int, Any]" = OrderedDict()
        self._spill_pending: List[Tuple[int, int]] = []
        self._spill_ledger: Dict[Tuple[str, str], int] = {}
        self._spill_counts = {"spilled": 0, "faulted": 0, "dropped": 0}
        # pool-accounting invariant checked after every admit, finish
        # and preempt
        self.debug = bool(debug_invariants) or bool(int(os.environ.get(
            "PADDLE_TPU_SERVING_DEBUG", "0") or 0))
        shape = (self.P, mcfg.num_kv_heads, self.page, mcfg.head_dim)
        # pools live on the model's device and are written in place
        self.pools = [(torch.zeros(shape, dtype=self._dtype,
                                   device=self.device),
                       torch.zeros(shape, dtype=self._dtype,
                                   device=self.device))
                      for _ in range(mcfg.num_layers)]
        self.tables = np.full((self.B, self.npages), self.trash, np.int32)
        self.slots: List[Optional[_Slot]] = [None] * self.B
        self.queue: deque = deque()
        self.finished: Dict[int, ServingRequest] = {}
        self.stats = predictor.stats
        # telemetry (observability/catalog.py serving_metrics): host-side,
        # so the rounds and their graphs are untouched
        self._metrics = _serving_metrics()
        self._stats_reported = (self.stats.compiles, self.stats.cache_hits)
        # per-request traces: live ones by rid, finished ones in a ring
        self.traces = SpanRing(maxlen=trace_ring)
        self._live_traces: Dict[int, RequestTrace] = {}
        self._round = 0
        # comm ledgers by site: no round of one engine issues a
        # collective, so none is ever stored (comm_ledger returns None)
        self._ledgers: Dict[Any, Any] = {}
        # memory ledgers by site, made at a site's first execution
        self._mem_on = bool(mem_ledger) or bool(int(os.environ.get(
            "PADDLE_TPU_MEM_LEDGER", "0") or 0))
        self._mem_ledgers: Dict[Any, Any] = {}
        # the bytes each recent decode round moved (roofline_report)
        self._decode_bytes: deque = deque(maxlen=4096)
        self._weight_bytes = sum(_ml.shard_bytes(p)
                                 for p in self.pred._params)
        self._live_peak = 0
        self._last_snapshot = -float("inf")
        # the rounds' graphs and static buffers: the engine's own, since
        # they hold its pools' addresses
        self._graphs = StepGraphs(self.device, self.stats)
        # launches per round kind: "prefill", "unified", "decode",
        # "unified_spec", "draft_propose", "draft_chunk"; and "preempted"
        self.rounds: Counter = Counter()
        self.gen = cfg.generation
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(self.gen.seed))
        self._next_rid = 0
        # speculative decoding: the draft's pools share the engine's page
        # ids and tables (so prefix hits and copy-on-write cover them)
        self.spec = int(spec_tokens or 0)
        enforce((draft_predictor is None) == (self.spec == 0),
                "speculative decoding needs BOTH draft_predictor and "
                "spec_tokens >= 1 (or neither)")
        self._draft = draft_predictor
        if draft_predictor is not None:
            enforce(self.chunked,
                    "speculative decoding rides the unified chunked step; "
                    "set prefill_chunk")
            enforce(not self.gen.temperature,
                    "speculative decoding is greedy-verify only "
                    "(temperature=0): acceptance compares the draft "
                    "against the target argmax chain")
            enforce(self.spec >= 1 and self.spec + 1 <= self.Sc,
                    f"spec_tokens must satisfy 1 <= k <= Sc-1 (k+1 verify "
                    f"positions ride one [B, {self.Sc}] row)")
            dcfg = draft_predictor._model.config
            enforce("valid" in inspect.signature(
                draft_predictor._model.forward).parameters,
                "the draft model's forward must accept the unified ragged "
                "metadata kwarg `valid` (see models/llama.py)")
            enforce(dcfg.vocab_size == mcfg.vocab_size,
                    "draft and target models must share a vocabulary")
            enforce(int(dcfg.max_position_embeddings) >= self.M,
                    "draft max_position_embeddings must cover the "
                    "engine's max_length")
            enforce(draft_predictor.device == self.device,
                    f"the draft predictor lives on "
                    f"{draft_predictor.device}, the engine on "
                    f"{self.device}; move it to the engine's device")
            self._draft_dtype = draft_predictor.dtype
            dshape = (self.P, dcfg.num_kv_heads, self.page, dcfg.head_dim)
            self.draft_pools = [
                (torch.zeros(dshape, dtype=self._draft_dtype,
                             device=self.device),
                 torch.zeros(dshape, dtype=self._draft_dtype,
                             device=self.device))
                for _ in range(dcfg.num_layers)]
        self._spec = {"proposed": 0, "accepted": 0, "rounds": 0,
                      "committed": 0}
        if self.prefix:
            # the JAX engine compiles its page-copy program here with a
            # trash self-copy; the same no-op copy notes the same keys
            self._copy_page(self.trash, self.trash)
        # load shedding at submit (a full queue) and at admission (a
        # passed deadline), before any prefill is spent
        self.max_queue = int(max_queue) if max_queue else None
        self.admission_deadline_s = admission_deadline_s
        self._degraded_window = float(degraded_window_s)
        self._last_shed_time: Optional[float] = None
        # /healthz reports "degraded" while this engine sheds; the
        # provider holds the engine weakly, so a dead engine is pruned
        from ..observability import exporter as _exporter

        ref = weakref.ref(self)

        def _health_provider():
            eng = ref()
            if eng is None:
                return None
            return {"component": "serving", "status": eng.health()}

        self._health_provider = _health_provider
        _exporter.add_health_provider(_health_provider)
        # durable metrics history: PADDLE_TPU_TIMESERIES_DIR attaches the
        # registry sampler (PADDLE_TPU_TIMESERIES_S sets its interval)
        self.sampler = None
        ts_dir = os.environ.get("PADDLE_TPU_TIMESERIES_DIR")
        if ts_dir:
            from ..observability import timeseries as _ts

            try:
                self.sampler = _ts.attach_dir(
                    ts_dir, interval_s=float(os.environ.get(
                        "PADDLE_TPU_TIMESERIES_S", "5.0")))
            except (OSError, ValueError):
                self.sampler = None    # unwritable dir: serve anyway

    def _page_bytes(self) -> int:
        """Bytes one page takes across every layer's K and V pools."""
        mcfg = self.pred._model.config
        return (2 * mcfg.num_layers * mcfg.num_kv_heads * self.page
                * mcfg.head_dim * self._dtype.itemsize)

    # -- admission -------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None,
               parent_span_id: Optional[str] = None) -> int:
        """Queue one request; returns its rid. Admission happens inside
        step()/run(), when a slot and enough free pages exist. With
        ``max_queue`` set, a full queue sheds the request at once (it
        lands in ``finished`` with ``shed_reason="queue_full"`` and no
        tokens); ``deadline_s`` (default: ``admission_deadline_s``)
        bounds its wait for admission.

        ``trace_id`` is a 32-hex W3C trace id or a whole ``traceparent``
        header (whose span becomes the parent); ``parent_span_id`` gives
        or overrides the caller's 16-hex span. What is missing is minted;
        a malformed header or an invalid bare id is replaced by a fresh
        id and counted on ``paddle_tpu_serving_trace_parse_errors_total``
        (never raised). ``trace_context(rid)`` reads the identity back."""
        enforce(self.phase != "decode",
                'a phase="decode" replica only adopts migrated requests '
                "(import_request); route submissions to a prefill or "
                "unified replica")
        ids = np.asarray(prompt).reshape(-1).astype(np.int64)
        n_new = int(max_new_tokens if max_new_tokens is not None
                    else self.gen.max_new_tokens)
        eos = eos_token_id if eos_token_id is not None \
            else self.gen.eos_token_id
        L = len(ids)
        enforce(L >= 1 and n_new >= 1, "empty prompt / max_new_tokens")
        enforce(L + n_new <= self.M,
                f"prompt ({L}) + max_new_tokens ({n_new}) exceeds cache "
                f"length {self.M}; raise Config.max_length")
        enforce(self._pages_needed(L, n_new) <= self.P - 1,
                f"request needs {self._pages_needed(L, n_new)} pages but "
                f"the pool only has {self.P - 1}; raise pool_pages")
        if trace_id is not None and "-" in trace_id:
            # a whole traceparent header: its span is the parent unless
            # one is given; a malformed header mints a fresh id instead
            try:
                tid, parent = _parse_traceparent(trace_id)
            except ValueError:
                self._metrics["trace_parse_errors"].inc(
                    reason="malformed_traceparent")
                trace_id = None
            else:
                trace_id = tid
                if parent_span_id is None:
                    parent_span_id = parent
        rid = self._next_rid
        self._next_rid += 1
        now = time.perf_counter()
        dls = deadline_s if deadline_s is not None \
            else self.admission_deadline_s
        req = ServingRequest(rid, ids, n_new, eos, t_submit=now,
                             deadline=(now + dls) if dls is not None
                             else None)
        meta = {"prompt_len": L, "max_new_tokens": n_new}
        try:
            tr = RequestTrace(rid, meta=meta, trace_id=trace_id,
                              parent_span_id=parent_span_id)
        except ValueError:
            # bare ids that fail W3C validation: a fresh identity
            self._metrics["trace_parse_errors"].inc(
                reason="invalid_trace_id")
            tr = RequestTrace(rid, meta=meta)
        req.trace_id = tr.trace_id
        req.span_id = tr.span_id
        req.parent_span_id = tr.parent_span_id
        tr.begin("queued", now)
        self._live_traces[rid] = tr
        self._metrics["requests"].inc(event="submitted")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self._shed(req, "queue_full")
            return rid
        self.queue.append(req)
        self._metrics["queue_depth"].set(len(self.queue))
        return rid

    def _shed(self, req: ServingRequest, reason: str):
        """Load-shed a queued request: it finishes with no tokens and no
        first-token time, so it stays out of the TTFT histogram; the
        decision is a zero-length "shed" span (a Chrome instant) on its
        trace."""
        req.shed_reason = reason
        req.t_finish = time.perf_counter()
        self.finished[req.rid] = req
        self._last_shed_time = req.t_finish
        self._metrics["shed"].inc(reason=reason)
        tr = self._live_traces.pop(req.rid, None)
        if tr is not None:
            # the queued span closes but is not observed on the stage
            # histogram: shed latency stays out of the percentiles
            sp = tr.end("queued", req.t_finish)
            tr.meta["shed_reason"] = reason
            tr.add("shed", req.t_finish, req.t_finish,
                   {"reason": reason,
                    "queued_seconds": (sp.seconds if sp is not None
                                       else 0.0)})
            self.traces.add(tr)

    def health(self) -> str:
        """"ok", or "degraded" while the engine sheds load (a shed within
        ``degraded_window_s``, or the admission queue at its bound)."""
        if self.max_queue is not None and \
                len(self.queue) >= self.max_queue:
            return "degraded"
        if self._last_shed_time is not None and \
                time.perf_counter() - self._last_shed_time \
                <= self._degraded_window:
            return "degraded"
        return "ok"

    def _pages_needed(self, L: int, n_new: int) -> int:
        return -(-(L + n_new) // self.page)

    def _pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page)

    # -- page accounting (ref-counted pool + prefix cache) ----------------
    def _avail_pages(self) -> int:
        """Pages the allocator can produce now: the free list plus the
        idle registered pages the LRU would yield."""
        with self._lock:
            return len(self._free_pages) + len(self._lru)

    def _alloc_pages(self, n: int) -> List[int]:
        """Pop n pages at refcount 1: the free list first, then idle
        cached pages, oldest first. Callers check _avail_pages. Reclaims
        staged for host spill are read out after the lock is released
        and before the pages are handed out."""
        with self._lock:
            out = []
            for _ in range(n):
                if not self._free_pages:
                    self._cache_reclaim()
                pg = self._free_pages.pop()
                self._refcount[pg] = 1
                out.append(pg)
        if self._spill_pending:
            self._drain_spills()
        return out

    def _cache_reclaim(self):
        """Evict the oldest idle cached page: unregister its hash and put
        it on the free list; with the host tier on, stage it for spill."""
        with self._lock:
            enforce(self._lru, "page pool exhausted: allocator asked to "
                    "reclaim with no idle cached pages")
            pg, _ = self._lru.popitem(last=False)
            h = self._page_hash.pop(pg)
            del self._hash_page[h]
            self._pfx["reclaimed"] += 1
            self._metrics["prefix_events"].inc(event="reclaimed")
            if self.spill_pages:
                self._spill_pending.append((pg, h))
            self._free_pages.append(pg)

    def _ref_page(self, pg: int):
        """Take one reference on a cached page (an admission hit); an
        idle page leaves the LRU."""
        with self._lock:
            self._refcount[pg] += 1
            if self._refcount[pg] == 1:
                self._lru.pop(pg, None)

    def _release_pages(self, pages: List[int]):
        """Drop one reference per page. A registered page that idles parks
        on the LRU tail (still hit-able); any other goes back to the free
        list."""
        with self._lock:
            for pg in pages:
                self._refcount[pg] -= 1
                if self._refcount[pg] > 0:
                    continue
                if pg in self._page_hash:
                    self._lru[pg] = None
                else:
                    self._free_pages.append(pg)

    def _register_page(self, h: int, pg: int):
        """Publish a completed page under its prefix hash. The first
        writer wins, so the maps stay a bijection."""
        with self._lock:
            if h in self._hash_page or pg in self._page_hash:
                return
            self._hash_page[h] = pg
            self._page_hash[pg] = h
            self._pfx["registered"] += 1
            self._metrics["prefix_events"].inc(event="registered")

    # -- host spill tier -------------------------------------------------
    def _note_spill(self, direction: str, nbytes: int):
        """Book one transfer and republish the offload gauges: cumulative
        totals set as gauges, one number per (component, direction), as
        the training tier publishes them."""
        with self._lock:
            k = ("kv_page", direction)
            self._spill_ledger[k] = self._spill_ledger.get(k, 0) + nbytes
            host = sum(self._payload_nbytes(p)
                       for p in self._spilled.values())
            vals = dict(self._spill_ledger)
            npages = len(self._spilled)
        m = self._metrics
        for (comp, d), v in vals.items():
            m["offload_bytes"].set(v, component=comp, direction=d)
        m["offload_host"].set(host, component="kv_page")
        m["offload_spilled_pages"].set(npages)

    @staticmethod
    def _payload_nbytes(payload) -> int:
        return sum(a.numel() * a.element_size() for pools in payload
                   if pools for kv in pools for a in kv)

    @staticmethod
    def _read_page(pools, pg: int):
        """Page ``pg`` of every pool in host tensors (pinned on CUDA).
        The device-to-host copy is synchronous here, as the JAX engine's
        ``np.asarray`` is: on the stream it follows every write already
        queued to the page and precedes any later one."""
        def host(a):
            out = torch.empty(a.shape[1:], dtype=a.dtype,
                              pin_memory=a.is_cuda)
            out.copy_(a[pg])
            return out

        return [(host(kp), host(vp)) for kp, vp in pools]

    @staticmethod
    def _write_page(pools, rows, pg: int):
        for (kp, vp), (hk, hv) in zip(pools, rows):
            kp[pg].copy_(hk)
            vp[pg].copy_(hv)

    def _drain_spills(self):
        """Copy staged reclaimed pages to the host. Runs with the lock
        released; the staged pages are unwritten until the next step."""
        with self._lock:
            pending, self._spill_pending = self._spill_pending, []
        for pg, h in pending:
            self.stats.note("page_read", ("target", len(self.pools),
                                          str(self._dtype)))
            target = self._run_site(
                ("page_read",), lambda: self._read_page(self.pools, pg),
                params=False, writes_pools=False)
            draft = None
            if self._draft is not None:
                self.stats.note("page_read",
                                ("draft", len(self.draft_pools),
                                 str(self._draft_dtype)))
                draft = self._run_site(
                    ("page_read_draft",),
                    lambda: self._read_page(self.draft_pools, pg),
                    draft=True, params=False, writes_pools=False)
            payload = (target, draft)
            with self._lock:
                self._spilled[h] = payload
                self._spill_counts["spilled"] += 1
                dropped = 0
                while len(self._spilled) > self.spill_pages:
                    self._spilled.popitem(last=False)
                    dropped += 1
                self._spill_counts["dropped"] += dropped
            self._note_spill("d2h", self._payload_nbytes(payload))

    def _fault_spilled(self, req: ServingRequest):
        """Fault host-spilled prefix pages back before admission: extend
        the device hit run with spilled hashes, one fresh page each
        (ordinary allocation, which may itself reclaim and spill colder
        pages), write the rows back and register the page idle so that
        _admit_plan pins it like any cached hit."""
        if not self.spill_pages or not self._spilled:
            return
        floor = self._pages_for(min(len(req.prompt), self.Sc)) + 1
        for h in self._prefix_hashes(req.prompt):
            with self._lock:
                if h in self._hash_page:
                    continue          # the device run keeps extending
                payload = self._spilled.pop(h, None)
            if payload is None:
                return                # run over: neither cached nor spilled
            if self._avail_pages() <= floor:
                with self._lock:      # keep it on the host for next time
                    self._spilled[h] = payload
                    self._spilled.move_to_end(h, last=False)
                return
            [pg] = self._alloc_pages(1)
            target, draft = payload
            self.stats.note("page_write", ("target", len(self.pools),
                                           str(self._dtype)))
            self._run_site(("page_write",),
                           lambda: self._write_page(self.pools, target, pg),
                           params=False)
            if self._draft is not None and draft is not None:
                self.stats.note("page_write",
                                ("draft", len(self.draft_pools),
                                 str(self._draft_dtype)))
                self._run_site(
                    ("page_write_draft",),
                    lambda: self._write_page(self.draft_pools, draft, pg),
                    draft=True, params=False)
            self._register_page(h, pg)
            self._release_pages([pg])     # idle + registered: hit-able
            with self._lock:
                self._spill_counts["faulted"] += 1
            self._note_spill("h2d", self._payload_nbytes(payload))

    def spill_stats(self) -> Dict[str, Any]:
        """Host-tier counters: pages spilled, faulted and dropped, the
        resident host pages and bytes, and the cumulative transfer bytes
        per direction."""
        with self._lock:
            out = dict(self._spill_counts)
            out["host_pages"] = len(self._spilled)
            out["host_bytes"] = sum(self._payload_nbytes(p)
                                    for p in self._spilled.values())
            out["transfer_bytes"] = {d: v for (_c, d), v
                                     in self._spill_ledger.items()}
            return out

    def _prefix_hashes(self, prompt: np.ndarray) -> List[int]:
        """Rolling hash per FULL page-aligned prompt chunk: h_j covers
        prompt[:(j+1)*page], so equal hashes mean equal whole prefixes."""
        page = self.page
        arr = np.ascontiguousarray(np.asarray(prompt, np.int64))
        out: List[int] = []
        h = hash(("paddle_tpu_prefix", page))
        for j in range(len(arr) // page):
            h = hash((h, arr[j * page:(j + 1) * page].tobytes()))
            out.append(h)
        return out

    def check_invariants(self):
        """Pool-accounting invariant: the free list, the idle (LRU) pages
        and the refcounted live pages partition the usable pool; every
        page's refcount equals the number of slots holding it; the
        hash<->page maps stay bijective; the host tier owns its hashes
        alone and keeps under its cap. Raises on any violation."""
        with self._lock:
            bad: List[str] = []
            usable = self.P - 1
            free, lru = list(self._free_pages), list(self._lru)
            fs, ls = set(free), set(lru)
            held = Counter(pg for s in self.slots if s is not None
                           for pg in s.pages)
            live = {pg for pg in range(usable) if self._refcount[pg] > 0}
            if len(fs) != len(free):
                bad.append("duplicate pages on the free list")
            if self.trash in fs | ls | live:
                bad.append("trash page entered circulation")
            if fs & ls or fs & live or ls & live:
                bad.append("free/idle/live page sets overlap")
            if len(free) + len(lru) + len(live) != usable:
                bad.append(f"free({len(free)}) + idle({len(lru)}) + "
                           f"live({len(live)}) != pool({usable})")
            if set(held) != live:
                bad.append("refcounted pages != pages held by slots")
            drift = {pg: (int(c), self._refcount[pg])
                     for pg, c in held.items()
                     if self._refcount[pg] != c}
            if drift:
                bad.append(f"refcount drift (held, rc): {drift}")
            if len(self._hash_page) != len(self._page_hash) or \
                    set(self._page_hash) != set(self._hash_page.values()):
                bad.append("prefix hash maps out of sync")
            if not ls <= set(self._page_hash):
                bad.append("LRU page not registered in the cache")
            if set(self._spilled) & set(self._hash_page):
                bad.append("hash both device-registered and host-spilled "
                           "(the tier owns a hash exclusively)")
            if len(self._spilled) > max(self.spill_pages, 0):
                bad.append(f"host tier over its cap: "
                           f"{len(self._spilled)} > {self.spill_pages}")
            enforce(not bad,
                    "serving pool invariant violated: " + "; ".join(bad))

    def prefix_cache_stats(self) -> Dict[str, Any]:
        """Prefix-cache counters: page lookups and hits at admission,
        prompt tokens skipped and fed, copy-on-writes, LRU reclaims,
        registrations, and the registered and idle page counts now."""
        with self._lock:
            out = dict(self._pfx)
            out["hit_rate"] = (out["hits"] / out["lookups"]
                               if out["lookups"] else 0.0)
            out["registered_pages"] = len(self._page_hash)
            out["idle_pages"] = len(self._lru)
            return out

    def spec_stats(self) -> Dict[str, Any]:
        """Speculative-decoding counters: drafts proposed and accepted,
        decode-row verify steps, tokens committed, and the two ratios."""
        out = dict(self._spec)
        out["accept_rate"] = (out["accepted"] / out["proposed"]
                              if out["proposed"] else 0.0)
        out["tokens_per_step"] = (out["committed"] / out["rounds"]
                                  if out["rounds"] else 0.0)
        return out

    def _admit_plan(self, req: ServingRequest):
        """Admission plan, without allocating: (cold pages to allocate
        now, reserve pages the check must also cover, cache-hit pages,
        prefix hashes, fed0 = prompt tokens the cache already holds).
        Legacy: the whole len+new footprint. Chunked: the first chunk's
        pages past the hit run; the rest are reserved per chunk. A full
        prompt hit refeeds the last prompt token (fed0 = L-1) so the
        unified step still samples token 0; its copy-on-write page is
        the reserve."""
        L = len(req.prompt)
        if not self.chunked:
            return (self._pages_needed(L, req.max_new_tokens), 0,
                    [], None, 0)
        if not self.prefix:
            return (self._pages_for(min(L, self.Sc)), 0, [], None, 0)
        hashes = self._prefix_hashes(req.prompt)
        hits: List[int] = []
        with self._lock:
            for h in hashes:
                pg = self._hash_page.get(h)
                if pg is None:
                    break
                hits.append(pg)
        k = len(hits)
        fed0 = k * self.page
        if fed0 >= L:
            fed0 = L - 1
        cold = self._pages_for(min(L, fed0 + self.Sc)) - k
        reserve = 1 if fed0 < k * self.page else 0
        return max(cold, 0), reserve, hits, hashes, fed0

    def _admit(self):
        """FIFO-admit queued requests into free slots while pages last.
        A request whose admission deadline has passed is shed here,
        before any prefill is spent on it."""
        while self.queue:
            req = self.queue[0]
            if req.deadline is not None and \
                    time.perf_counter() > req.deadline:
                self.queue.popleft()
                self._shed(req, "deadline")
                self._metrics["queue_depth"].set(len(self.queue))
                continue
            if self.chunked and self._page_stalled and self.num_active:
                return    # backpressure: stalled elders drain first
            free = [b for b in range(self.B) if self.slots[b] is None]
            if not free:
                return
            # host tier first, so the plan sees faulted pages as hits
            self._fault_spilled(req)
            cold, reserve, hits, hashes, fed0 = self._admit_plan(req)
            with self._lock:
                # idle hit pages count in _avail_pages but the hit itself
                # is about to pin them: charge them
                idle_hits = sum(1 for pg in hits
                                if self._refcount[pg] == 0)
            if cold + reserve + idle_hits > self._avail_pages():
                return                    # head-of-line waits for evictions
            self.queue.popleft()
            b = free[0]
            # a backfill is an admission that joins rows mid-decode
            backfill = self.num_active > 0
            for pg in hits:
                self._ref_page(pg)        # pin BEFORE any reclaim can run
            pages = list(hits) + self._alloc_pages(cold)
            self.tables[b, :] = self.trash
            self.tables[b, :len(pages)] = pages
            slot = _Slot(
                req, pages, state="prefill" if self.chunked else "decode",
                seq=self._admit_seq)
            slot.hashes = hashes
            slot.hit_pages = len(hits)
            slot.registered = len(hits)
            slot.fed = fed0
            self.slots[b] = slot
            self._admit_seq += 1
            m = self._metrics
            m["requests"].inc(event="admitted")
            if hashes is not None:
                self._pfx["lookups"] += len(hashes)
                self._pfx["hits"] += len(hits)
                self._pfx["skipped_tokens"] += fed0
                if hits:
                    m["prefix_events"].inc(len(hits), event="hit")
            if self.debug:
                self.check_invariants()
            if backfill:
                m["requests"].inc(event="backfilled")
            m["queue_depth"].set(len(self.queue))
            tr = self._live_traces.get(req.rid)
            if tr is not None:
                sp = tr.end("queued", time.perf_counter())
                tr.meta["backfill"] = bool(backfill)
                if sp is not None:
                    m["stage_seconds"].observe(sp.seconds, stage="queued")
            if self.chunked:
                # chunks feed in the unified rounds; the prefill stage
                # span (admit -> first token) opens here
                if tr is not None:
                    tr.begin("prefill", time.perf_counter())
            else:
                self._prefill(b)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _prefill(self, b: int):
        """Legacy per-arrival prefill at [1, Sb] into row b's pages."""
        from . import _sample

        slot = self.slots[b]
        req = slot.req
        t0 = time.perf_counter()
        L = len(req.prompt)
        Sb = min(_bucket(L), self.M)
        ids = np.zeros((1, Sb), np.int64)
        ids[0, :L] = req.prompt
        tbl = self._tensor(self.tables[b:b + 1])
        caches = [(kp, vp, tbl) for kp, vp in self.pools]
        self.stats.note("prefill", (1, Sb, self.M, self.page, self.P,
                                    str(ids.dtype), str(self._dtype)))
        ids_t = self._tensor(ids)
        lens = torch.tensor([L], dtype=torch.int32, device=self.device)
        last, _ = self._run_site(
            ("prefill", Sb),
            lambda: self.pred._prefill_step(ids_t, caches, lens),
            reads=[ids_t, tbl, lens], writes=[])
        tok0 = int(_sample(last, self.gen, self._generator)[0])
        req.new_tokens.append(tok0)
        now = time.perf_counter()
        req.t_first_token = now
        self.stats.count_tokens(("prefill", Sb, self.P), 1)
        self.rounds["prefill"] += 1
        m = self._metrics
        m["prefill_seconds"].observe(now - t0)
        m["ttft"].observe(now - req.t_submit)
        m["tokens"].inc(1, phase="prefill")
        tr = self._live_traces.get(req.rid)
        if tr is not None:
            tr.add("prefill", t0, now, {"seq_bucket": Sb})
            m["stage_seconds"].observe(now - t0, stage="prefill")
            tr.begin("decode", now)    # closed at eviction
        if len(req.new_tokens) >= req.max_new_tokens or \
                (req.eos_token_id is not None and tok0 == req.eos_token_id):
            self._finish(b)

    # -- unified chunked-prefill + decode step ---------------------------
    def _extended_tables(self) -> np.ndarray:
        """The model's `valid` contract: one extra trailing table column
        that ALWAYS maps to the trash page (dead-slot writes land there;
        attention slices it back off)."""
        return np.concatenate(
            [self.tables, np.full((self.B, 1), self.trash, np.int32)],
            axis=1)

    def _plan_chunks(self):
        """Pick this round's prefill feeders (admission order) under the
        token budget, reserving pages incrementally: a chunk needs pages
        up to its own frontier, the LAST chunk also the decode tail. A
        page the chunk writes into while shared or registered is copied
        first. Returns (feeders as (row, n_tokens, is_last), stalled)."""
        feeders: List[tuple] = []
        stalled = False
        budget = self.prefill_budget
        rows = sorted((b for b in range(self.B)
                       if self.slots[b] is not None
                       and self.slots[b].state == "prefill"),
                      key=lambda b: self.slots[b].seq)
        for b in rows:
            if budget <= 0:
                break
            s = self.slots[b]
            L = len(s.req.prompt)
            n = min(L - s.fed, self.Sc, budget)
            if n <= 0:
                continue
            last = s.fed + n == L
            want_tokens = (L + s.req.max_new_tokens) if last \
                else (s.fed + n)
            extra = self._pages_for(want_tokens) - len(s.pages)
            # page-aligned frontiers make this fire only on the full
            # prompt hit's refeed (position L-1 in the last hit page)
            cow = self._cow_plan(s, n)
            if max(extra, 0) + len(cow) > self._avail_pages():
                stalled = True
                self._metrics["prefill_stall"].inc()
                continue
            if extra > 0:
                newp = self._alloc_pages(extra)
                self.tables[b, len(s.pages):len(s.pages) + extra] = newp
                s.pages.extend(newp)
            for j in cow:
                self._cow_page(b, j)
            feeders.append((b, n, last))
            budget -= n
        self._page_stalled = stalled
        return feeders, stalled

    # -- copy-on-write ---------------------------------------------------
    def _cow_plan(self, s: _Slot, n: int) -> List[int]:
        """Table columns of ``s`` whose pages the next n-token chunk
        writes into while shared (refcount > 1) or registered."""
        if not self.prefix:
            return []
        jlo = s.fed // self.page
        jhi = (s.fed + n - 1) // self.page
        out: List[int] = []
        with self._lock:
            for j in range(jlo, min(jhi, len(s.pages) - 1) + 1):
                pg = s.pages[j]
                if self._refcount[pg] > 1 or pg in self._page_hash:
                    out.append(j)
        return out

    def _cow_page(self, b: int, j: int):
        """Replace table column j of row b with a private copy of its
        page, then drop the reference on the shared original."""
        s = self.slots[b]
        old = s.pages[j]
        [new] = self._alloc_pages(1)
        self._copy_page(old, new)
        s.pages[j] = new
        self.tables[b, j] = new
        self._release_pages([old])
        self._pfx["cow"] += 1
        self._metrics["prefix_events"].inc(event="cow")

    def _copy_page(self, src: int, dst: int):
        """Copy one physical page in every pool, and in every draft pool
        when speculation is on (they share page ids). In place: the page
        ids are host ints that index views, so nothing reads the device,
        and the copies queue on the current stream, the one the round
        graphs replay on, ahead of the next round's replay. The pools
        keep their addresses, so every captured graph stays valid."""
        def copy(pools):
            for kp, vp in pools:
                kp[dst].copy_(kp[src])
                vp[dst].copy_(vp[src])

        self.stats.note("page_copy",
                        ("target", len(self.pools), str(self._dtype)))
        self._run_site(("page_copy",), lambda: copy(self.pools),
                       params=False)
        if self._draft is not None:
            self.stats.note("page_copy",
                            ("draft", len(self.draft_pools),
                             str(self._draft_dtype)))
            self._run_site(("page_copy_draft",),
                           lambda: copy(self.draft_pools), draft=True,
                           params=False)

    def _unified_buffers(self):
        kw = {"device": self.device}
        return SimpleNamespace(
            ids=torch.zeros(self.B, self.Sc, dtype=torch.int64, **kw),
            starts=torch.zeros(self.B, dtype=torch.int32, **kw),
            nvalid=torch.zeros(self.B, dtype=torch.int32, **kw),
            tbl=torch.zeros(self.B, self.npages + 1, dtype=torch.int32, **kw),
            toks=torch.zeros(self.B, dtype=torch.int64, **kw))

    def _unified_body(self, s):
        """The unified step on its static buffers: the [B, Sc] forward at
        per-row (start, valid) metadata, then each row's sample at its
        LAST valid slot (a decode row's next token, a final chunk's
        first token; the host ignores the others)."""
        from . import _sample

        caches = [(kp, vp, s.tbl) for kp, vp in self.pools]
        logits, _ = self.pred._model(s.ids, caches=caches, offset=s.starts,
                                     valid=s.nvalid)
        idx = (s.nvalid.long() - 1).clamp(min=0)
        last = logits[torch.arange(self.B, device=self.device), idx]
        s.toks.copy_(_sample(last, self.gen, self._generator))

    # -- speculative decoding --------------------------------------------
    def _propose_key(self):
        return (self.B, self.spec, self.M, self.page, self.P,
                str(self._draft_dtype))

    def _propose_buffers(self):
        kw = {"device": self.device}
        return SimpleNamespace(
            tok=torch.zeros(self.B, dtype=torch.int64, **kw),
            pos=torch.zeros(self.B, dtype=torch.int32, **kw),
            tbl=torch.zeros(self.B, self.npages, dtype=torch.int32, **kw),
            out=torch.zeros(self.B, self.spec + 1, dtype=torch.int64, **kw))

    def _propose_body(self, s):
        """k+1 greedy [B, 1] draft steps: the last one writes the k-th
        proposal's KV, so a fully accepted run leaves no gap in the
        draft cache (its emission is discarded). Positions clamp at M-1:
        a row near its token budget drafts past its horizon, and the
        host never accepts those lanes."""
        model = self._draft._model
        caches = [(kp, vp, s.tbl) for kp, vp in self.draft_pools]
        tok, pos = s.tok, s.pos
        for i in range(self.spec + 1):
            logits, _ = model(tok[:, None], caches=caches, offset=pos)
            tok = torch.argmax(logits[:, -1].float(), dim=-1)
            s.out[:, i] = tok
            pos = (pos + 1).clamp(max=self.M - 1)

    def _propose(self, k_use: Dict[int, int]):
        """Run the draft's proposal steps for this round's decode rows;
        the [B, k+1] proposals stay on the device, where the verify step
        reads them. Also writes each row's last committed token into the
        draft KV (the draft cache stays one committed token behind the
        target's). The JAX step runs the rows at valid 0 or 1 through
        the ragged kernel; here rows that do not propose get an all-trash
        table row (their writes land in the trash page, their outputs
        are never read) and the steps attend through the decode kernel
        (K5), which gives a proposing row the same keys."""
        B = self.B
        tok = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int32)
        tbl = np.full((B, self.npages), self.trash, np.int32)
        for b, ku in k_use.items():
            if ku <= 0:
                continue
            s = self.slots[b]
            tok[b] = s.req.new_tokens[-1]
            pos[b] = s.pos + len(s.req.new_tokens) - 1
            tbl[b] = self.tables[b]
        key = self._propose_key()
        self.stats.note("draft_propose", key)
        st = self._graphs.buffers("draft_propose", key,
                                  self._propose_buffers)
        st.tok.copy_(torch.from_numpy(tok))
        st.pos.copy_(torch.from_numpy(pos))
        st.tbl.copy_(torch.from_numpy(tbl))
        self._run_site(
            ("draft_propose",),
            lambda: self._graphs.step("draft_propose", key,
                                      self._propose_body),
            reads=[st.tok, st.pos, st.tbl], writes=[st.out], draft=True)
        self.rounds["draft_propose"] += 1

    def _spec_buffers(self):
        s = self._unified_buffers()
        kw = {"device": self.device}
        # slots 1..k of a decode row that take a proposal
        s.dmask = torch.zeros(self.B, self.spec, dtype=torch.bool, **kw)
        s.props = self._graphs.buffers("draft_propose", self._propose_key(),
                                       self._propose_buffers).out
        # [0]: the argmax at every slot; [1]: the ids it verified
        s.out = torch.zeros(2, self.B, self.Sc, dtype=torch.int64, **kw)
        return s

    def _spec_body(self, s):
        """The verify step: the proposals into slots 1..k of their decode
        rows, the same [B, Sc] forward as the unified step, and the
        greedy argmax at EVERY slot, so a decode row feeding its last
        token and k proposals gets all k+1 verify tokens at once."""
        k = self.spec
        s.ids[:, 1:k + 1] = torch.where(s.dmask, s.props[:, :k],
                                        s.ids[:, 1:k + 1])
        caches = [(kp, vp, s.tbl) for kp, vp in self.pools]
        logits, _ = self.pred._model(s.ids, caches=caches, offset=s.starts,
                                     valid=s.nvalid)
        s.out[0].copy_(torch.argmax(logits.float(), dim=-1))
        s.out[1].copy_(s.ids)

    def _draft_chunk_body(self, s):
        """The prompt chunks through the draft's layers, writing its KV.
        Its logits are never read (XLA drops them from the JAX step), so
        the LM head is not run."""
        caches = [(kp, vp, s.tbl) for kp, vp in self.draft_pools]
        self._draft._model.llama(s.ids, caches, offset=s.starts,
                                 valid=s.nvalid)

    def _draft_feed(self, feeders, ids: np.ndarray, starts: np.ndarray,
                    tbl: np.ndarray):
        """Mirror this round's prompt chunks into the draft pools (decode
        rows at valid 0: their draft KV advances in _propose). Hit pages
        already hold the draft KV of the request that fed them first:
        the pools share page ids."""
        nvf = np.zeros((self.B,), np.int32)
        for b, n, _last in feeders:
            nvf[b] = n
        key = (self.B, self.Sc, self.M, self.page, self.P,
               str(self._draft_dtype))
        self.stats.note("draft_chunk", key)
        st = self._graphs.buffers("draft_chunk", key,
                                  self._unified_buffers)
        st.ids.copy_(torch.from_numpy(ids))
        st.starts.copy_(torch.from_numpy(starts))
        st.nvalid.copy_(torch.from_numpy(nvf))
        st.tbl.copy_(torch.from_numpy(tbl))
        self._run_site(
            ("draft_chunk", self.Sc),
            lambda: self._graphs.step("draft_chunk", key,
                                      self._draft_chunk_body),
            reads=[st.ids, st.starts, st.nvalid, st.tbl], draft=True)
        self.rounds["draft_chunk"] += 1

    @torch.no_grad()
    def _unified_round(self, feeders):
        """One unified launch: every feeder writes its next prompt chunk,
        every decode row advances one token (plain) or up to k+1
        (speculative: its last token and k proposals verified in the same
        launch), dead rows ride along at seq_len 0 — one [B, Sc]
        forward."""
        t0 = time.perf_counter()
        B = self.B
        spec = self._draft is not None
        ids = np.zeros((B, self.Sc), np.int64)
        starts = np.zeros((B,), np.int32)
        nvalid = np.zeros((B,), np.int32)
        feed = {b: n for b, n, _last in feeders}
        decode_rows = []
        k_use: Dict[int, int] = {}
        for b in range(B):
            s = self.slots[b]
            if s is None:
                continue
            if s.state == "decode":
                # spec: draft up to k tokens, never past the row's budget
                # (its last token is never an input)
                ku = 0
                if spec:
                    ku = max(0, min(self.spec, s.req.max_new_tokens
                                    - len(s.req.new_tokens) - 1))
                k_use[b] = ku
                ids[b, 0] = s.req.new_tokens[-1]
                starts[b] = s.pos + len(s.req.new_tokens) - 1
                nvalid[b] = 1 + ku
                decode_rows.append(b)
            elif b in feed:
                n = feed[b]
                ids[b, :n] = s.req.prompt[s.fed:s.fed + n]
                starts[b] = s.fed
                nvalid[b] = n
            # stalled/out-of-budget prefill rows and free slots stay at
            # seq_len 0: writes go to the trash column, output ignored
        tbl = self._extended_tables()
        if spec:
            if any(k_use[b] > 0 for b in decode_rows):
                self._propose(k_use)
            dmask = np.zeros((B, self.spec), bool)
            for b in decode_rows:
                dmask[b, :k_use[b]] = True
            key = (B, self.Sc, self.M, self.page, self.P, str(self._dtype))
            site, make, body = "unified_spec", self._spec_buffers, \
                self._spec_body
        else:
            key = (B, self.Sc, self.M, self.page, self.P,
                   self.gen.temperature, self.gen.top_k, self.gen.top_p,
                   str(self._dtype))
            site, make, body = "unified", self._unified_buffers, \
                self._unified_body
        self.stats.note(site, key)
        st = self._graphs.buffers(site, key, make)
        st.ids.copy_(torch.from_numpy(ids))
        st.starts.copy_(torch.from_numpy(starts))
        st.nvalid.copy_(torch.from_numpy(nvalid))
        st.tbl.copy_(torch.from_numpy(tbl))
        if spec:
            st.dmask.copy_(torch.from_numpy(dmask))
        # the verify step is greedy: it draws nothing from the generator
        self._run_site(
            (site, self.Sc),
            lambda: self._graphs.step(site, key, body,
                                      None if spec else self._generator),
            reads=[st.ids, st.starts, st.nvalid, st.tbl],
            writes=[st.out if spec else st.toks])
        self.rounds[site] += 1
        # mirror the chunks into the draft pools BEFORE commits can
        # retire a feeder (its registered pages must carry draft KV)
        if spec and feeders:
            self._draft_feed(feeders, ids, starts, tbl)
        if spec:
            out = st.out.cpu().numpy()        # the round's one host read
            toks, ids = out[0], out[1]        # [B, Sc] each
        else:
            toks = st.toks.cpu().numpy()      # [B]
        now = time.perf_counter()
        m = self._metrics
        fed_tokens = 0
        for b, n, last_chunk in feeders:
            s = self.slots[b]
            req = s.req
            tr = self._live_traces.get(req.rid)
            if tr is not None:
                # a span per chunk: the Chrome trace shows the chunks
                # interleaved with the decode rounds
                tr.add("prefill_chunk", t0, now,
                       {"chunk": s.chunks, "tokens": n, "start": s.fed})
            s.fed += n
            s.chunks += 1
            fed_tokens += n
            m["prefill_chunks"].inc()
            if self.prefix and s.hashes:
                # pages wholly behind the fed frontier now hold final,
                # immutable KV: publish them under their prefix hash
                full = s.fed // self.page
                for j in range(s.registered, full):
                    self._register_page(s.hashes[j], s.pages[j])
                s.registered = max(s.registered, full)
            if last_chunk:
                tok0 = int(toks[b, nvalid[b] - 1]) if spec \
                    else int(toks[b])
                req.new_tokens.append(tok0)
                req.t_first_token = now
                m["ttft"].observe(now - req.t_submit)
                m["tokens"].inc(1, phase="prefill")
                s.state = "decode"
                if tr is not None:
                    sp = tr.end("prefill", now)
                    if sp is not None:
                        m["prefill_seconds"].observe(sp.seconds)
                        m["stage_seconds"].observe(sp.seconds,
                                                   stage="prefill")
                    tr.begin("decode", now)    # closed at eviction
                if len(req.new_tokens) >= req.max_new_tokens or \
                        (req.eos_token_id is not None
                         and tok0 == req.eos_token_id):
                    self._finish(b)
                elif self.phase == "prefill":
                    # disaggregated: park the row with its committed
                    # pages for export to a decode replica
                    s.state = "migrate"
        if self.prefix:
            self._pfx["fed_tokens"] += fed_tokens
        emitted = 0
        for b in decode_rows:
            req = self.slots[b].req
            acc = 0
            if spec:
                # greedy verify: toks[b, i] is the target argmax after
                # input i, so proposal i is accepted iff it equals the
                # previous committed token's argmax; commit the accepted
                # run plus one token
                ku = k_use[b]
                seq = [int(toks[b, 0])]
                for i in range(1, ku + 1):
                    if int(ids[b, i]) != seq[-1]:
                        break
                    seq.append(int(toks[b, i]))
                acc = len(seq) - 1
                self._spec["proposed"] += ku
                self._spec["accepted"] += acc
            else:
                seq = [int(toks[b])]
            tr = self._live_traces.get(req.rid)
            if tr is not None:
                meta = {"round": self._round, "unified": True}
                if spec:
                    meta.update(proposed=k_use[b], accepted=acc)
                tr.add("decode_round", t0, now, meta)
            for t in seq:
                req.new_tokens.append(t)
                emitted += 1
                if len(req.new_tokens) >= req.max_new_tokens or \
                        (req.eos_token_id is not None
                         and t == req.eos_token_id):
                    self._finish(b)
                    break           # rest of the run is discarded
        if spec and decode_rows:
            # one verify step per decode row a round, so committed/rounds
            # is tokens per step: 1.0 at zero acceptance
            self._spec["rounds"] += len(decode_rows)
            self._spec["committed"] += emitted
        self.stats.count_tokens((site, self.Sc, self.P),
                                fed_tokens + emitted)
        m["unified_round_seconds"].observe(now - t0)
        if emitted:
            m["tokens"].inc(emitted, phase="decode")
        self._round += 1

    def _preempt_youngest(self):
        """Deadlock breaker: bounce the YOUNGEST mid-prefill row (no token
        sampled yet, so restarting its prefill is exact) back to the
        queue head. The oldest row is never preempted. Pages it shares
        with elder rows or the cache survive (refcount-aware release)."""
        rows = [b for b in range(self.B)
                if self.slots[b] is not None
                and self.slots[b].state == "prefill"]
        if len(rows) <= 1:
            return
        b = max(rows, key=lambda b: self.slots[b].seq)
        s = self.slots[b]
        now = time.perf_counter()
        self._release_pages(s.pages)
        self.tables[b, :] = self.trash
        self.slots[b] = None
        self.queue.appendleft(s.req)
        self.rounds["preempted"] += 1
        m = self._metrics
        m["requests"].inc(event="preempted")
        m["queue_depth"].set(len(self.queue))
        tr = self._live_traces.get(s.req.rid)
        if tr is not None:
            tr.end("prefill", now)     # the partial prefill span, kept
            tr.add("preempt", now, now, {"reason": "pages", "fed": s.fed})
            tr.begin("queued", now)
        if self.debug:
            self.check_invariants()

    def _chunked_round(self):
        """One chunked-mode tick: feed chunks through the unified step
        when any are ready (decode rows ride along); otherwise run the
        decode step, except in spec mode, where decode rows always take
        the unified verify step; preempt only when nothing can move."""
        feeders, stalled = self._plan_chunks()
        has_decode = any(s is not None and s.state == "decode"
                         for s in self.slots)
        if feeders or (self._draft is not None and has_decode):
            self._unified_round(feeders)
        elif has_decode:
            self._decode_round()
        elif stalled:
            self._preempt_youngest()

    def _decode_buffers(self):
        kw = {"device": self.device}
        return SimpleNamespace(
            tok=torch.zeros(self.B, dtype=torch.int64, **kw),
            pos=torch.zeros(self.B, dtype=torch.int32, **kw),
            tbl=torch.zeros(self.B, self.npages, dtype=torch.int32, **kw),
            out=torch.zeros(self.B, self.chunk, dtype=torch.int64, **kw))

    def _decode_body(self, s):
        """``decode_chunk`` [B, 1] steps on the static buffers, each
        sampled token into its column of ``out``."""
        from . import _sample

        caches = [(kp, vp, s.tbl) for kp, vp in self.pools]
        tok, pos = s.tok, s.pos
        for i in range(self.chunk):
            logits, _ = self.pred._model(tok[:, None], caches=caches,
                                         offset=pos)
            tok = _sample(logits[:, -1], self.gen, self._generator)
            s.out[:, i] = tok
            pos = pos + 1

    @torch.no_grad()
    def _decode_round(self):
        """``decode_chunk`` [B, 1] decode steps for the whole batch at
        per-row positions. Free slots ride along at position 0 with an
        all-trash table row; stalled mid-prefill rows ride the same way
        (their table rows are masked to trash for this round)."""
        active = [b for b in range(self.B) if self.slots[b] is not None
                  and self.slots[b].state == "decode"]
        if not active:
            return
        t0 = time.perf_counter()
        # captured before evictions can retire the traces
        round_traces = [self._live_traces.get(self.slots[b].req.rid)
                        for b in active]
        tok = np.zeros((self.B,), np.int64)
        pos = np.zeros((self.B,), np.int32)
        for b in active:
            s = self.slots[b]
            tok[b] = s.req.new_tokens[-1]
            pos[b] = s.pos + len(s.req.new_tokens) - 1
        tbl = self.tables
        if self.chunked:
            mid_prefill = [b for b in range(self.B)
                           if self.slots[b] is not None
                           and self.slots[b].state == "prefill"]
            if mid_prefill:
                tbl = self.tables.copy()
                tbl[mid_prefill, :] = self.trash
        key = (self.B, self.M, self.chunk, self.P, self.gen.temperature,
               self.gen.top_k, self.gen.top_p, str(self._dtype))
        self.stats.note("serve_decode", key)
        st = self._graphs.buffers("serve_decode", key, self._decode_buffers)
        st.tok.copy_(torch.from_numpy(tok))
        st.pos.copy_(torch.from_numpy(pos))
        st.tbl.copy_(torch.from_numpy(tbl))
        self._run_site(
            ("decode",),
            lambda: self._graphs.step("serve_decode", key,
                                      self._decode_body, self._generator),
            reads=[st.tok, st.pos, st.tbl], writes=[st.out])
        if self._mem_on:
            self._decode_bytes.append(self._decode_round_bytes(pos))
        toks = st.out.cpu().numpy()                   # [B, chunk]
        self.rounds["decode"] += 1
        emitted = 0
        for b in active:
            req = self.slots[b].req
            for t in toks[b]:
                t = int(t)
                req.new_tokens.append(t)
                emitted += 1
                if len(req.new_tokens) >= req.max_new_tokens or \
                        (req.eos_token_id is not None
                         and t == req.eos_token_id):
                    self._finish(b)
                    break               # rest of the chunk is discarded
        self.stats.count_tokens(("decode", self.B, self.chunk, self.P),
                                emitted)
        m = self._metrics
        now = time.perf_counter()
        m["decode_round_seconds"].observe(now - t0)
        m["tokens"].inc(emitted, phase="decode")
        # one "decode_round" span per request in flight this round
        for tr in round_traces:
            if tr is not None:
                tr.add("decode_round", t0, now,
                       {"round": self._round, "chunk": self.chunk})
        self._round += 1

    def _finish(self, b: int):
        """Evict a finished row: one reference dropped per page
        (registered pages park on the LRU, the rest return to the free
        list), table row to all-trash, slot open for backfill."""
        slot = self.slots[b]
        self._release_pages(slot.pages)
        self.tables[b, :] = self.trash
        self.slots[b] = None
        req = slot.req
        req.t_finish = time.perf_counter()
        self.finished[req.rid] = req
        m = self._metrics
        m["requests"].inc(event="evicted")
        if len(req.new_tokens) > 1 and req.t_first_token:
            m["tpot"].observe((req.t_finish - req.t_first_token)
                              / (len(req.new_tokens) - 1))
        tr = self._live_traces.pop(req.rid, None)
        if tr is not None:
            sp = tr.end("decode", req.t_finish)
            if sp is not None:
                m["stage_seconds"].observe(sp.seconds, stage="decode")
            tr.meta["new_tokens"] = len(req.new_tokens)
            tr.add("e2e", req.t_submit, req.t_finish)
            m["stage_seconds"].observe(req.t_finish - req.t_submit,
                                       stage="e2e")
            self.traces.add(tr)
        if self.debug:
            self.check_invariants()

    # -- disaggregated prefill/decode hooks (inference/disagg.py) --------
    def prefix_match(self, hashes: List[int]) -> int:
        """Leading page-aligned prompt chunks whose KV this replica's
        prefix cache holds: the router's affinity signal (the rolling
        hashes ``_prefix_hashes`` registers pages under)."""
        n = 0
        with self._lock:
            for h in hashes:
                if h not in self._hash_page:
                    break
                n += 1
        return n

    def migratable(self) -> List[int]:
        """rids parked for migration on a prefill replica: prompt fed,
        first token committed, KV pages held for export."""
        return [s.req.rid for s in self.slots
                if s is not None and s.state == "migrate"]

    def can_import(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Whether ``import_request`` would take a request of this
        geometry now (a free slot and its whole page footprint); False
        is the backpressure signal the migrator acts on."""
        if any(s is None for s in self.slots):
            return self._pages_needed(prompt_len, max_new_tokens) \
                <= self._avail_pages()
        return False

    def _host_pages(self, n: int) -> torch.Tensor:
        """Host memory for ``n`` page payloads ([n, 2 * layers, kv_heads,
        page, head_dim]; pinned on a card). It is cut from a block sized
        for a whole row's pages, so the caching host allocator serves
        every migration from blocks of one size: a block is allocated
        once and reused once its tensor is gone."""
        kp = self.pools[0][0]
        shape = (2 * len(self.pools),) + tuple(kp.shape[1:])
        full = torch.empty((self.npages,) + shape, dtype=self._dtype,
                           pin_memory=self.device.type == "cuda")
        return full[:n]

    def _gather_pages(self, pages: List[int]) -> np.ndarray:
        """The pages' rows of every layer's K and V pool as one host
        array [n, 2 * layers, kv_heads, page, head_dim] (K and V
        interleaved by layer; bf16 as its uint16 image). One gather on
        the device, one copy into pinned host memory; the copy is
        synchronous, so it follows every write already queued."""
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        dev = torch.stack([t.index_select(0, idx) for kv in self.pools
                           for t in kv], dim=1)
        host = self._host_pages(len(pages))
        host.copy_(dev)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(np.uint16)
        return host.numpy()

    def _scatter_pages(self, payloads: List[np.ndarray], pages: List[int]):
        """Write page payloads (``_gather_pages``' layout) into pool
        pages ``pages`` in place: host to device (straight from payloads
        that lie in pinned memory, as an in-process export's do, else
        staged through pinned memory), then one indexed copy a pool. On
        a card it waits for the copies, so the caller's host arrays are
        free when it returns."""
        n = len(payloads)
        if not n:
            return
        bf16 = self._dtype == torch.bfloat16
        want = np.uint16 if bf16 else np.dtype(
            str(self._dtype).replace("torch.", ""))
        cuda = self.device.type == "cuda"
        srcs = []
        for arr in payloads:
            enforce(arr.dtype == want,
                    f"page payload dtype {arr.dtype} does not match the "
                    f"pool's {self._dtype}")
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                 if bf16 else np.ascontiguousarray(arr))
            srcs.append(t.view(torch.bfloat16) if bf16 else t)
        if cuda and all(t.is_pinned() for t in srcs):
            dev = torch.empty((n,) + tuple(srcs[0].shape), dtype=self._dtype,
                              device=self.device)
            for j, t in enumerate(srcs):
                dev[j].copy_(t, non_blocking=True)
        else:
            host = self._host_pages(n)
            for j, t in enumerate(srcs):
                host[j].copy_(t)
            dev = host.to(self.device, non_blocking=cuda)
        idx = torch.tensor(pages[:n], dtype=torch.long, device=self.device)
        for i, (kp, vp) in enumerate(self.pools):
            kp.index_copy_(0, idx, dev[:, 2 * i])
            vp.index_copy_(0, idx, dev[:, 2 * i + 1])
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()

    def export_request(self, rid: int) -> Dict[str, Any]:
        """Export one parked row: its committed KV page payloads (one
        [2 * layers, kv_heads, page, head_dim] array a page), its
        block-table row and the host request state; the row is then
        evicted (pages released, slot open for backfill). The pages are
        read in place, so no graph is captured again. Framing (crc32 a
        page, wire bytes) lives in inference/disagg.py."""
        b = next((i for i, s in enumerate(self.slots)
                  if s is not None and s.state == "migrate"
                  and s.req.rid == rid), None)
        enforce(b is not None, f"rid {rid} is not parked for migration")
        s = self.slots[b]
        req = s.req
        k = self._pages_for(len(req.prompt))  # pages with committed KV
        for _ in range(k):
            self.stats.note("page_read", ("target", len(self.pools),
                                          str(self._dtype)))
        rows = self._run_site(("page_read",),
                              lambda: self._gather_pages(s.pages[:k]),
                              params=False, writes_pools=False)
        payloads = [rows[j] for j in range(k)]
        now = time.perf_counter()
        tr = self._live_traces.pop(rid, None)
        if tr is not None:
            tr.end("decode", now)
            tr.add("migrate_out", now, now, {"pages": k})
            self.traces.add(tr)
        pkg = {"rid": rid, "prompt": req.prompt,
               "max_new_tokens": req.max_new_tokens,
               "eos_token_id": req.eos_token_id,
               "new_tokens": list(req.new_tokens),
               "t_submit": req.t_submit,
               "t_first_token": req.t_first_token,
               "trace_id": req.trace_id, "parent_span_id": req.span_id,
               "pages": payloads, "table_row": self.tables[b].copy()}
        self._release_pages(s.pages)
        self.tables[b, :] = self.trash
        self.slots[b] = None
        self._metrics["requests"].inc(event="migrated_out")
        if self.debug:
            self.check_invariants()
        return pkg

    def import_request(self, pkg: Dict[str, Any]) -> Optional[int]:
        """Adopt a migrated request on a decode replica: allocate its
        whole page footprint, write the committed page payloads into the
        pool in place, and seat the row mid-decode where the prefill
        replica stopped. Returns the local rid, or None when this
        replica refuses (no free slot or pages): the migrator's
        backpressure signal. The crc32s are checked before this call
        (inference/disagg.py)."""
        enforce(self.phase != "prefill",
                "a prefill replica cannot adopt migrated rows")
        prompt = np.asarray(pkg["prompt"], np.int64)
        L, n_new = len(prompt), int(pkg["max_new_tokens"])
        free = [b for b in range(self.B) if self.slots[b] is None]
        if not free or self._pages_needed(L, n_new) > \
                self._avail_pages():
            return None
        b = free[0]
        pages = self._alloc_pages(self._pages_needed(L, n_new))
        for _ in pkg["pages"]:
            self.stats.note("page_write", ("target", len(self.pools),
                                           str(self._dtype)))
        self._run_site(("page_write",),
                       lambda: self._scatter_pages(pkg["pages"], pages),
                       params=False)
        self.tables[b, :] = self.trash
        self.tables[b, :len(pages)] = pages
        rid = self._next_rid
        self._next_rid += 1
        req = ServingRequest(rid, prompt, n_new, pkg["eos_token_id"],
                             new_tokens=list(pkg["new_tokens"]),
                             t_submit=pkg["t_submit"],
                             t_first_token=pkg["t_first_token"])
        slot = _Slot(req, pages, state="decode", seq=self._admit_seq)
        slot.fed = L
        self._admit_seq += 1
        self.slots[b] = slot
        tr = RequestTrace(rid, meta={"prompt_len": L,
                                     "max_new_tokens": n_new,
                                     "migrated": True},
                          trace_id=pkg.get("trace_id"),
                          parent_span_id=pkg.get("parent_span_id"))
        req.trace_id = tr.trace_id
        req.span_id = tr.span_id
        req.parent_span_id = tr.parent_span_id
        now = time.perf_counter()
        tr.add("migrate_in", now, now, {"pages": len(pkg["pages"])})
        tr.begin("decode", now)    # closed at eviction
        self._live_traces[rid] = tr
        self._metrics["requests"].inc(event="migrated_in")
        if self.debug:
            self.check_invariants()
        return rid

    # -- driving ---------------------------------------------------------
    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def step(self):
        """One serving tick: admit arrivals, then one shared round, then
        the tick's gauges."""
        self._admit()
        if self.chunked:
            self._chunked_round()
        else:
            self._decode_round()
        self._note_tick()

    def _note_tick(self, force: bool = False):
        """Per-tick occupancy gauges and compile-counter deltas. At most
        every ``SNAPSHOT_EVERY_S`` (always with ``force``), also the
        allocator's live bytes (with the memory ledger on) and one
        registry snapshot into the flight recorder's ring, which this
        returns (else None). Host state only: no device sync."""
        m = self._metrics
        m["queue_depth"].set(len(self.queue))
        m["active_slots"].set(self.num_active)
        with self._lock:
            n_free, n_idle = len(self._free_pages), len(self._lru)
            n_reg = len(self._page_hash)
        m["free_pages"].set(n_free)
        usable = self.P - 1              # the trash page is never handed out
        # idle cached pages are reclaimable: occupancy is what slots hold
        m["page_occupancy"].set(
            (usable - n_free - n_idle) / usable if usable else 0.0)
        if self.prefix:
            lk = self._pfx["lookups"]
            m["prefix_hit_rate"].set(self._pfx["hits"] / lk if lk else 0.0)
            m["prefix_pages"].set(n_reg - n_idle, state="active")
            m["prefix_pages"].set(n_idle, state="idle")
            m["prefix_hash_entries"].set(n_reg)
        if self._draft is not None:
            pr = self._spec["proposed"]
            m["spec_accept_rate"].set(
                self._spec["accepted"] / pr if pr else 0.0)
            rd = self._spec["rounds"]
            m["spec_tokens_per_step"].set(
                self._spec["committed"] / rd if rd else 0.0)
        rc, rh = self._stats_reported
        if self.stats.compiles > rc:
            m["compiles"].inc(self.stats.compiles - rc, site="serving")
        if self.stats.cache_hits > rh:
            m["cache_hits"].inc(self.stats.cache_hits - rh, site="serving")
        self._stats_reported = (self.stats.compiles, self.stats.cache_hits)
        now = time.perf_counter()
        if not force and now - self._last_snapshot < SNAPSHOT_EVERY_S:
            return None
        self._last_snapshot = now
        if self._mem_on:
            lb = _ml.live_bytes(self.device)
            if lb:
                self._live_peak = max(self._live_peak, lb)
                m["mem_live"].set(lb)
                m["mem_live_peak"].set(self._live_peak)
        from ..observability import get_registry

        return get_registry().snapshot()

    def _run_site(self, site, run, reads=(), writes=(), draft=False,
                  params=True, writes_pools=True):
        """Run one launch site. With the memory ledger on, the site's
        first execution is measured into its ledger (memledger.analyze:
        the parameters, pools and ``reads`` it reads, the pools and
        ``writes`` it writes, the pools updated in place, the allocator's
        temporaries) and its gauges published (a site's ledger never
        changes after). Nothing here reads the device."""
        if not self._mem_on:
            return run()
        led = self._mem_ledgers.get(site)
        probe = _ml.TempProbe(self.device) if led is None else None
        out = run()
        if led is None:
            pred = self._draft if draft else self.pred
            pools = [t for kv in (self.draft_pools if draft
                                  else self.pools) for t in kv]
            wr = pools if writes_pools else []
            led = self._mem_ledgers[site] = _ml.analyze(
                "_".join(str(x) for x in site),
                reads=(list(pred._params) if params else []) + pools
                + list(reads),
                writes=wr + list(writes), in_place=wr,
                temp_bytes=probe.temp_bytes())
            led.publish(self._metrics)
        return out

    def comm_ledger(self, site) -> Optional[Any]:
        """The comm ledger of a serving site (sites as ``memory_ledger``'s).
        One engine's rounds run on one card and issue no collective, so
        this is None for every site; migrations book theirs on the
        migrator (inference/disagg.py)."""
        return self._ledgers.get(site)

    # -- memory accounting (observability/memledger) ---------------------
    def memory_ledger(self, site=("decode",)) -> Optional[Any]:
        """The memory ledger of one launch site, made at the site's first
        execution when the engine was built with ``mem_ledger=True`` (or
        PADDLE_TPU_MEM_LEDGER=1). Sites: ("decode",), ("prefill", Sb),
        ("unified", Sc); with speculation ("unified_spec", Sc),
        ("draft_propose",), ("draft_chunk", Sc); ("page_copy",),
        ("page_read",), ("page_write",) and their ``_draft`` twins."""
        return self._mem_ledgers.get(site)

    def memory_summary(self) -> Dict[str, Any]:
        """Every site ledger's byte classes plus the resident state: the
        parameters and the KV page pool, with the per-page cost and the
        pool's geometry that ``pool_pages="auto"`` uses."""
        pool_bytes = sum(_ml.shard_bytes(kp) + _ml.shard_bytes(vp)
                         for kp, vp in self.pools)
        return {
            "executables": {led.program: led.to_dict()
                            for led in self._mem_ledgers.values()},
            "state": {
                "params_bytes": sum(_ml.shard_bytes(p)
                                    for p in self.pred._params),
                "kv_pool_bytes": pool_bytes,
                "page_bytes": self._page_bytes(),
                "pool_pages": self.P,
                "live_peak_bytes": self._live_peak,
            },
        }

    def _decode_round_bytes(self, pos: np.ndarray) -> int:
        """The HBM bytes one decode round must move, from its rows'
        positions ``pos`` [B] (free and stalled rows at 0, on the trash
        page): at each of its ``chunk`` steps the weights once (the
        embedding table counted whole), every row's K and V pages up to
        and including its new token's page (the pages its length covers
        in every layer), and one token's K and V a row written."""
        page_bytes = self._page_bytes()
        lens = pos[:, None].astype(np.int64) + np.arange(1, self.chunk + 1)
        pages = int(((lens + self.page - 1) // self.page).sum())
        return (self.chunk * (self._weight_bytes
                              + self.B * (page_bytes // self.page))
                + pages * page_bytes)

    def roofline_report(self):
        """The roofline verdict of the shared decode round
        (memledger.roofline): 2 N FLOPs a token over the B x chunk round;
        HBM traffic the median of the bytes the decode rounds moved
        (``_decode_round_bytes``; not the decode site's ledger, which
        counts every page of the pools as read and as written); the
        median measured round time; "unknown" off the card. Needs the
        memory ledger on (no traffic is counted without it)."""
        cfg = getattr(self.pred._model, "config", None)
        n_params = None
        fn = getattr(cfg, "num_params", None)
        if callable(fn):
            try:
                n_params = int(fn())
            except Exception:
                n_params = None
        if n_params is None:
            n_params = sum(p.numel() for p in self.pred._params)
        fl = 2.0 * n_params * self.B * self.chunk
        traffic = float(np.median(self._decode_bytes)) \
            if self._decode_bytes else 0.0
        step_s = self._metrics["decode_round_seconds"].percentile(50)
        return _ml.roofline(
            step_seconds=step_s, flops_per_step=fl,
            hbm_traffic_bytes=traffic, wire_bytes=0.0,
            device=self.device, program="decode")

    # -- per-request traces ----------------------------------------------
    def request_traces(self) -> List[Dict[str, Any]]:
        """Finished request traces (the bounded ring), oldest first."""
        return self.traces.to_dicts()

    def export_request_traces(self, path: Optional[str] = None
                              ) -> Dict[str, Any]:
        """Chrome-trace JSON of the finished traces plus those in flight;
        written to ``path`` when given. Every event's args carry the
        request's ``trace_id`` / ``span_id`` (and ``parent_span_id``), so
        traces of different replicas stitch on ``trace_id``."""
        return self.traces.to_chrome_trace(
            path, extra=list(self._live_traces.values()))

    def trace_context(self, rid: int) -> Optional[Dict[str, Any]]:
        """The W3C identity of one request, live or finished (None for
        an unknown rid): {"trace_id", "span_id", "parent_span_id",
        "traceparent"}; ``traceparent`` names this request's root span
        for the next hop."""
        tr = self._live_traces.get(rid)
        if tr is not None:
            return {"trace_id": tr.trace_id, "span_id": tr.span_id,
                    "parent_span_id": tr.parent_span_id,
                    "traceparent": tr.traceparent}
        req = self.finished.get(rid)
        if req is not None and req.trace_id is not None:
            return {"trace_id": req.trace_id, "span_id": req.span_id,
                    "parent_span_id": req.parent_span_id,
                    "traceparent": req.traceparent}
        return None

    def metrics_snapshot(self):
        """The registry's snapshot after this tick's gauges."""
        return self._note_tick(force=True)

    def run(self, max_steps: Optional[int] = None
            ) -> Dict[int, ServingRequest]:
        """Drain the queue and the in-flight batch; returns {rid: request}."""
        steps = 0
        while self.queue or self.num_active:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.finished

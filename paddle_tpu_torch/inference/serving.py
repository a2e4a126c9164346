"""Continuous-batching serving engine over the paged KV cache
(counterpart of ``paddle_tpu/inference/serving.py``).

The scheduler is the JAX engine's, decision for decision, so the two
commit the same token streams: one fixed page pool with a host-side free
list and a trash page (id P-1), B batch slots, admission in FIFO order
while pages last, eviction and backfill.

- Legacy mode (``prefill_chunk=None``): each arrival is prefilled at
  admission at ``[1, Sb]`` (Sb on the power-of-two lattice) through the
  paged decode attention (K5); then the batch decodes together.
- Chunked mode (``prefill_chunk``): prompts feed ONE unified ``[B, Sc]``
  step in page-aligned chunks under ``prefill_token_budget``, decode
  rows riding in the same launch; its attention is the ragged paged
  kernel (K4). Rounds with no chunk to feed run the ``[B, 1]`` decode
  step (K5) ``decode_chunk`` times. Pages are reserved per chunk; a
  page-starved engine preempts the youngest mid-prefill row.

Where the JAX engine jits the decode-chunk scan and the unified step per
lattice key with the pools donated, the port captures each round's body
(the ``decode_chunk`` steps in one graph; the unified ``[B, Sc]``
forward and its sample in another) as a CUDA graph per key and replays
it (``core/cuda_graphs.py``; on the CPU the body runs eagerly). A
round's inputs are static buffers refreshed from the host's arrays
before it: tokens, positions, chunk ids, starts, valid counts and the
block table as the scheduler left it. The pools are the engine's own,
updated in place where JAX donated them. The sampled tokens come back
to the host once a round. ``stats`` notes every launch site with its
shape key, as the JAX engine notes its compiled programs, so a fixed
shape lattice after warmup stays checkable. The legacy per-arrival
prefill stays eager.

Not ported yet (ROADMAP.md): the prefix cache, speculative decoding,
host spill, disaggregated phases, shedding and deadlines, request
traces, metrics and the memory and comm ledgers.
"""
from __future__ import annotations

import time
from collections import Counter, deque
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.bucketing import bucket as _bucket
from ..core.cuda_graphs import StepGraphs
from ..core.enforce import enforce

__all__ = ["ServingEngine", "ServingRequest"]


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

    @property
    def output_ids(self) -> np.ndarray:
        """prompt + generated tokens."""
        return np.concatenate([np.asarray(self.prompt, np.int64),
                               np.asarray(self.new_tokens, np.int64)])


class _Slot:
    """Host-side state of one in-flight batch row."""

    __slots__ = ("req", "pages", "pos", "state", "fed", "seq")

    def __init__(self, req: ServingRequest, pages: List[int],
                 state: str = "decode", seq: int = 0):
        self.req = req
        self.pages = pages
        # cache position the NEXT decode input token is written at
        self.pos = len(req.prompt)
        # "prefill" while prompt tokens remain unfed (chunked mode), then
        # "decode"; legacy slots are born "decode" (prefilled at admit)
        self.state = state
        self.fed = 0            # prompt tokens already written
        self.seq = seq          # admission order (scheduler fairness)


class ServingEngine:
    """Continuous batching over a Predictor with a paged KV cache.

    >>> pred = create_predictor(Config().set_model(m).enable_paged_kv(64))
    >>> eng = ServingEngine(pred, max_batch=8, prefill_chunk=256)
    >>> rid = eng.submit(prompt_ids, max_new_tokens=64)
    >>> done = eng.run()          # {rid: ServingRequest}
    """

    def __init__(self, predictor, max_batch: Optional[int] = None,
                 pool_pages: Optional[int] = None, decode_chunk: int = 1,
                 prefill_chunk: Optional[int] = None,
                 prefill_token_budget: Optional[int] = None):
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
            self.prefill_budget = int(prefill_token_budget or self.Sc)
            enforce(self.prefill_budget >= 1,
                    "prefill_token_budget must be >= 1")
        else:
            self.Sc = 0
            self.prefill_budget = 0
        self._admit_seq = 0
        # chunked-mode backpressure: while an active row is page-stalled,
        # admissions pause so freed pages reach the oldest stalled row
        self._page_stalled = False
        self._dtype = predictor.dtype
        geom = self.B * self.npages + 1
        self.P = _bucket(int(pool_pages or geom), lo=8)
        self.trash = self.P - 1
        self._free_pages = list(range(self.P - 1))
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
        # the rounds' graphs and static buffers: the engine's own, since
        # they hold its pools' addresses
        self._graphs = StepGraphs(self.device, self.stats)
        # launches per round kind: "prefill", "unified", "decode"
        self.rounds: Counter = Counter()
        self.gen = cfg.generation
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(self.gen.seed))
        self._next_rid = 0

    # -- admission -------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None) -> int:
        """Queue one request; returns its rid. Admission happens inside
        step()/run(), when a slot and enough free pages exist."""
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
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(ServingRequest(rid, ids, n_new, eos,
                                         t_submit=time.perf_counter()))
        return rid

    def _pages_needed(self, L: int, n_new: int) -> int:
        return -(-(L + n_new) // self.page)

    def _pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page)

    def _avail_pages(self) -> int:
        return len(self._free_pages)

    def _alloc_pages(self, n: int) -> List[int]:
        return [self._free_pages.pop() for _ in range(n)]

    def _release_pages(self, pages: List[int]):
        self._free_pages.extend(pages)

    def _admit_plan(self, req: ServingRequest) -> int:
        """Pages to allocate at admission: the whole len+new footprint in
        legacy mode, only the first chunk's pages in chunked mode (the
        rest are reserved per chunk by _plan_chunks)."""
        L = len(req.prompt)
        if not self.chunked:
            return self._pages_needed(L, req.max_new_tokens)
        return self._pages_for(min(L, self.Sc))

    def _admit(self):
        """FIFO-admit queued requests into free slots while pages last."""
        while self.queue:
            req = self.queue[0]
            if self.chunked and self._page_stalled and self.num_active:
                return    # backpressure: stalled elders drain first
            free = [b for b in range(self.B) if self.slots[b] is None]
            if not free:
                return
            cold = self._admit_plan(req)
            if cold > self._avail_pages():
                return                    # head-of-line waits for evictions
            self.queue.popleft()
            b = free[0]
            pages = self._alloc_pages(cold)
            self.tables[b, :] = self.trash
            self.tables[b, :len(pages)] = pages
            self.slots[b] = _Slot(
                req, pages, state="prefill" if self.chunked else "decode",
                seq=self._admit_seq)
            self._admit_seq += 1
            if not self.chunked:
                self._prefill(b)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _prefill(self, b: int):
        """Legacy per-arrival prefill at [1, Sb] into row b's pages."""
        from . import _sample

        slot = self.slots[b]
        req = slot.req
        L = len(req.prompt)
        Sb = min(_bucket(L), self.M)
        ids = np.zeros((1, Sb), np.int64)
        ids[0, :L] = req.prompt
        tbl = self._tensor(self.tables[b:b + 1])
        caches = [(kp, vp, tbl) for kp, vp in self.pools]
        self.stats.note("prefill", (1, Sb, self.M, self.page, self.P,
                                    str(ids.dtype), str(self._dtype)))
        last, _ = self.pred._prefill_step(
            self._tensor(ids), caches,
            torch.tensor([L], dtype=torch.int32, device=self.device))
        tok0 = int(_sample(last, self.gen, self._generator)[0])
        req.new_tokens.append(tok0)
        req.t_first_token = time.perf_counter()
        self.stats.count_tokens(("prefill", Sb, self.P), 1)
        self.rounds["prefill"] += 1
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
        up to its own frontier, the LAST chunk also the decode tail.
        Returns (feeders as (row, n_tokens, is_last), stalled)."""
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
            if max(extra, 0) > self._avail_pages():
                stalled = True
                continue
            if extra > 0:
                newp = self._alloc_pages(extra)
                self.tables[b, len(s.pages):len(s.pages) + extra] = newp
                s.pages.extend(newp)
            feeders.append((b, n, last))
            budget -= n
        self._page_stalled = stalled
        return feeders, stalled

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

    @torch.no_grad()
    def _unified_round(self, feeders):
        """One unified launch: every feeder writes its next prompt chunk,
        every decode row advances one token, dead rows ride along at
        seq_len 0 — one [B, Sc] forward."""
        B = self.B
        ids = np.zeros((B, self.Sc), np.int64)
        starts = np.zeros((B,), np.int32)
        nvalid = np.zeros((B,), np.int32)
        feed = {b: n for b, n, _last in feeders}
        decode_rows = []
        for b in range(B):
            s = self.slots[b]
            if s is None:
                continue
            if s.state == "decode":
                ids[b, 0] = s.req.new_tokens[-1]
                starts[b] = s.pos + len(s.req.new_tokens) - 1
                nvalid[b] = 1
                decode_rows.append(b)
            elif b in feed:
                n = feed[b]
                ids[b, :n] = s.req.prompt[s.fed:s.fed + n]
                starts[b] = s.fed
                nvalid[b] = n
            # stalled/out-of-budget prefill rows and free slots stay at
            # seq_len 0: writes go to the trash column, output ignored
        key = (B, self.Sc, self.M, self.page, self.P, self.gen.temperature,
               self.gen.top_k, self.gen.top_p, str(self._dtype))
        self.stats.note("unified", key)
        st = self._graphs.buffers("unified", key, self._unified_buffers)
        st.ids.copy_(torch.from_numpy(ids))
        st.starts.copy_(torch.from_numpy(starts))
        st.nvalid.copy_(torch.from_numpy(nvalid))
        st.tbl.copy_(torch.from_numpy(self._extended_tables()))
        self._graphs.step("unified", key, self._unified_body,
                          self._generator)
        toks = st.toks.cpu().numpy()
        self.rounds["unified"] += 1
        now = time.perf_counter()
        fed_tokens = 0
        for b, n, last_chunk in feeders:
            s = self.slots[b]
            req = s.req
            s.fed += n
            fed_tokens += n
            if last_chunk:
                tok0 = int(toks[b])
                req.new_tokens.append(tok0)
                req.t_first_token = now
                s.state = "decode"
                if len(req.new_tokens) >= req.max_new_tokens or \
                        (req.eos_token_id is not None
                         and tok0 == req.eos_token_id):
                    self._finish(b)
        emitted = 0
        for b in decode_rows:
            req = self.slots[b].req
            t = int(toks[b])
            req.new_tokens.append(t)
            emitted += 1
            if len(req.new_tokens) >= req.max_new_tokens or \
                    (req.eos_token_id is not None and t == req.eos_token_id):
                self._finish(b)
        self.stats.count_tokens(("unified", self.Sc, self.P),
                                fed_tokens + emitted)

    def _preempt_youngest(self):
        """Deadlock breaker: bounce the YOUNGEST mid-prefill row (no token
        sampled yet, so restarting its prefill is exact) back to the
        queue head. The oldest row is never preempted."""
        rows = [b for b in range(self.B)
                if self.slots[b] is not None
                and self.slots[b].state == "prefill"]
        if len(rows) <= 1:
            return
        b = max(rows, key=lambda b: self.slots[b].seq)
        s = self.slots[b]
        self._release_pages(s.pages)
        self.tables[b, :] = self.trash
        self.slots[b] = None
        self.queue.appendleft(s.req)
        self.rounds["preempted"] += 1

    def _chunked_round(self):
        """One chunked-mode tick: feed chunks through the unified step
        when any are ready (decode rows ride along); otherwise run the
        decode step; preempt only when nothing can move."""
        feeders, stalled = self._plan_chunks()
        has_decode = any(s is not None and s.state == "decode"
                         for s in self.slots)
        if feeders:
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
        self._graphs.step("serve_decode", key, self._decode_body,
                          self._generator)
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

    def _finish(self, b: int):
        """Evict a finished row: pages back to the free list, table row
        to all-trash, slot open for backfill."""
        slot = self.slots[b]
        self._release_pages(slot.pages)
        self.tables[b, :] = self.trash
        self.slots[b] = None
        slot.req.t_finish = time.perf_counter()
        self.finished[slot.req.rid] = slot.req

    # -- driving ---------------------------------------------------------
    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def step(self):
        """One serving tick: admit arrivals, then one shared round."""
        self._admit()
        if self.chunked:
            self._chunked_round()
        else:
            self._decode_round()

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

"""Rolling crash-consistent checkpoint manager with async saves
(counterpart of ``paddle_tpu/distributed/checkpoint/manager.py``, the
same code: the same directory names, retention and gauges).

Owns a base directory of per-step checkpoint dirs::

    <base>/step_00000010/   COMMIT  0.metadata  0_0.distcp  train_meta.json
    <base>/step_00000020/   ...

Each save runs the atomic commit protocol (save_state_dict.py), so the
directory invariant is: every ``step_*`` dir with a ``COMMIT`` marker is
complete and checksum-verifiable; anything else is garbage a crash left
behind (pruned on the next save). Recovery therefore never needs
coordination — :func:`latest_committed` is a pure directory scan any
relaunched process can run.

Async mode: ``save()`` snapshots the tensors to host (the only stall
the train loop sees — one device-to-host copy per tensor at a step
boundary, finished before it returns, so an optimizer step that then
updates the tensors in place cannot reach the checkpoint) and enqueues
the file protocol on one background writer thread; saves commit in
submission order and ``wait()`` joins the queue. Retention keeps the
newest ``keep_last_k`` committed checkpoints (the in-flight one
excluded) so disk stays bounded on long runs.

Telemetry: the ``ckpt_*`` gauges (observability/catalog.py
``ckpt_metrics`` — schema-gated) are published after every commit and
by :meth:`publish`: last-save age / wall seconds by phase / bytes /
pending queue depth / committed step, plus a committed-saves counter.
"""
from __future__ import annotations

import json
import os
import queue
import re
import threading
import time
from typing import Any, Dict, Optional

from .load_state_dict import is_committed
from .save_state_dict import (EXTRA_META_FILE, OLD_SUFFIX, TMP_SUFFIX,
                              collect_shards, write_committed)

__all__ = ["CheckpointManager", "latest_committed", "read_extra_meta",
           "STEP_DIR_RE"]

STEP_DIR_RE = re.compile(
    r"^step_(\d+)(" + re.escape(TMP_SUFFIX) + "|"
    + re.escape(OLD_SUFFIX) + r")?$")


def latest_committed(base: str) -> Optional[str]:
    """Newest committed checkpoint directory under ``base`` (None when
    none exists). Committed ``.tmp``/``.old`` forms count — a crash
    between COMMIT and rename must not lose the save — but the final
    name wins at equal step."""
    best = None
    try:
        names = os.listdir(base)
    except OSError:
        return None
    for name in names:
        m = STEP_DIR_RE.match(name)
        if not m:
            continue
        path = os.path.join(base, name)
        if not is_committed(path):
            continue
        key = (int(m.group(1)), 0 if m.group(2) is None else -1)
        if best is None or key > best[0]:
            best = (key, path)
    return best[1] if best else None


def read_extra_meta(path: str) -> Dict[str, Any]:
    """The ``train_meta.json`` committed with a checkpoint ({} if the
    save carried none)."""
    p = os.path.join(path, EXTRA_META_FILE)
    if not os.path.isfile(p):
        return {}
    with open(p) as f:
        return json.load(f)


class CheckpointManager:
    """Rolling checkpoint directory: atomic per-step saves, keep-last-k
    retention, optional background (async) writes, ckpt_* gauges.

    >>> mgr = CheckpointManager(base, keep_last_k=3, async_save=True)
    >>> mgr.save(state, step=10, extra_meta={"step": 10})   # ~snapshot
    >>> mgr.wait()                                          # committed
    >>> latest_committed(base)
    '<base>/step_00000010'
    """

    def __init__(self, base: str, keep_last_k: int = 3,
                 async_save: bool = False, coordinator_rank: int = 0,
                 metrics_sample_s: Optional[float] = None):
        from ...observability import goodput as _gp
        from ...observability import timeseries as _ts
        from ...observability.catalog import ckpt_metrics

        self.base = base
        self.keep_last_k = max(int(keep_last_k), 1)
        self.async_save = bool(async_save)
        self.coordinator_rank = coordinator_rank
        os.makedirs(base, exist_ok=True)
        self._metrics = ckpt_metrics()
        # run-level goodput ledger lives next to the checkpoints (the
        # crash-durable journal resume_latest continues after a kill);
        # within a process the same base reuses the same live ledger
        try:
            self._goodput = _gp.attach_dir(base)
        except OSError:
            self._goodput = None     # unwritable base: saves will fail
        # optional durable metrics journal next to the goodput ledger
        # (metrics.jsonl, same flush-first crash discipline): sampled
        # every metrics_sample_s seconds when the knob is set
        self._sampler = None
        if metrics_sample_s is not None:
            try:
                self._sampler = _ts.attach_dir(
                    base, interval_s=float(metrics_sample_s))
            except (OSError, ValueError):
                self._sampler = None

        self._queue: "queue.Queue" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._cv = threading.Condition()
        self._pending = 0
        self._errors: list = []
        self._last_commit_time: Optional[float] = None
        self._last_step: Optional[int] = None

    # -- paths -----------------------------------------------------------
    def step_dir(self, step: int) -> str:
        return os.path.join(self.base, f"step_{int(step):08d}")

    def latest_committed(self) -> Optional[str]:
        return latest_committed(self.base)

    def latest_step(self) -> Optional[int]:
        p = self.latest_committed()
        if p is None:
            return None
        m = STEP_DIR_RE.match(os.path.basename(p))
        return int(m.group(1)) if m else None

    # -- saving ----------------------------------------------------------
    def save(self, state_dict: Dict, step: int,
             extra_meta: Optional[Dict[str, Any]] = None) -> None:
        """Checkpoint ``state_dict`` as ``step``. Sync mode returns
        after the commit; async mode returns after the host snapshot
        (the file protocol runs on the writer thread — ``wait()`` to
        join). A failed background save surfaces on the next call or
        ``wait()``."""
        from ...observability import goodput as _gp

        self._raise_pending()
        t0 = time.perf_counter()
        # the device->host snapshot is the only stall the step loop
        # pays in async mode — book it as ckpt_stall either way
        with _gp.segment("ckpt_stall"):
            md, shards, fname = collect_shards(state_dict)
        snap_s = time.perf_counter() - t0
        nbytes = sum(int(a.nbytes) for a in shards.values())
        job = (md, shards, fname, int(step), extra_meta, snap_s, nbytes)
        if not self.async_save:
            # sync mode: the whole commit protocol stalls the loop
            with _gp.segment("ckpt_stall"):
                self._write(*job)
            return
        if self._writer is None or not self._writer.is_alive():
            self._stop.clear()
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True, name="ckpt-writer")
            self._writer.start()
        with self._cv:
            self._pending += 1
            pending = self._pending
        self._queue.put(job)
        self._metrics["pending"].set(float(pending))

    def _writer_loop(self) -> None:
        import time as _time

        while True:
            # bounded get: a get() with no timeout can never observe
            # _stop, and close() would hang behind it forever
            try:
                job = self._queue.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if job is None:
                if self._stop.is_set():
                    return
                # stale wake-up sentinel from an earlier close() whose
                # writer had already exited — not a job, not a stop
                continue
            t0 = _time.time()
            try:
                self._write(*job)
            except BaseException as e:   # surfaced on wait()/next save
                with self._cv:
                    self._errors.append(e)
            finally:
                # background commit: journaled as an OVERLAPPED
                # ckpt_async interval (runs under the step loop, so it
                # is excluded from the foreground wall-sum identity)
                try:
                    if self._goodput is not None:
                        self._goodput.record_overlapped(
                            "ckpt_async", t0, _time.time())
                except Exception:
                    pass
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()

    def _write(self, md, shards, fname, step, extra_meta, snap_s,
               nbytes) -> None:
        t0 = time.perf_counter()
        write_committed(self.step_dir(step), md, shards, fname,
                        coordinator_rank=self.coordinator_rank,
                        extra_meta=extra_meta)
        write_s = time.perf_counter() - t0
        # commit bookkeeping is read by publish()/last_save_step on the
        # train-loop thread while the writer thread commits
        with self._cv:
            self._last_commit_time = time.time()
            self._last_step = step
        self._prune()
        m = self._metrics
        m["saves"].inc(result="committed")
        m["save_seconds"].set(snap_s, phase="snapshot")
        m["save_seconds"].set(write_s, phase="write")
        m["save_seconds"].set(snap_s + write_s, phase="total")
        m["save_bytes"].set(float(nbytes))
        m["last_step"].set(float(step))
        self.publish()

    def _prune(self) -> None:
        """Keep the newest ``keep_last_k`` committed checkpoints; drop
        older ones and any stale crash leftovers (uncommitted tmp/old
        dirs from steps older than the newest committed)."""
        import shutil

        entries = []
        for name in os.listdir(self.base):
            m = STEP_DIR_RE.match(name)
            if m:
                entries.append((int(m.group(1)), m.group(2) or "",
                                os.path.join(self.base, name)))
        committed = sorted((s, p) for s, suf, p in entries
                           if suf == "" and is_committed(p))
        keep = {p for _, p in committed[-self.keep_last_k:]}
        newest = committed[-1][0] if committed else -1
        for s, suf, p in entries:
            if p in keep:
                continue
            if suf == "" and is_committed(p):
                shutil.rmtree(p, ignore_errors=True)   # aged out
            elif s < newest:
                # crash leftover older than a newer committed save
                shutil.rmtree(p, ignore_errors=True)

    def _raise_pending(self) -> None:
        with self._cv:
            err = self._errors.pop(0) if self._errors else None
        if err is not None:
            raise err

    # -- synchronization / teardown -------------------------------------
    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every queued async save committed; re-raises the
        first background error."""
        with self._cv:
            self._cv.wait_for(lambda: self._pending == 0, timeout)
        self._raise_pending()

    def close(self) -> None:
        if self._writer is not None and self._writer.is_alive():
            with self._cv:
                self._cv.wait_for(lambda: self._pending == 0, 30)
            self._stop.set()
            self._queue.put(None)    # wake the bounded get immediately
            self._writer.join(timeout=30)
        self._writer = None

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- telemetry -------------------------------------------------------
    def publish(self) -> None:
        """Refresh the ckpt_last_save_age_seconds gauge (call from the
        step loop or a scrape hook; save() calls it on every commit)."""
        with self._cv:
            last_commit = self._last_commit_time
            pending = self._pending
        if last_commit is not None:
            self._metrics["age"].set(time.time() - last_commit)
        self._metrics["pending"].set(float(pending))

    @property
    def last_save_step(self) -> Optional[int]:
        with self._cv:
            return self._last_step

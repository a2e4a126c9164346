"""Deterministic failpoints: named fault-injection sites for
crash-consistency testing (counterpart of
``paddle_tpu/distributed/failpoints.py``, the same table, grammar and
environment variable; the port's sites are the checkpoint writer's four
``ckpt.*`` and the health monitor's ``health.loss_spike``).

Production fault tolerance is only as real as the faults it has been
tested against, so the checkpoint writer, the TCPStore client, and the
engine's step dispatch each carry *named* failpoints — inert no-ops in
normal operation (one dict lookup against an empty table) that tests or
an operator can arm to raise, hang, corrupt bytes, or SIGKILL the
process at exactly that point:

    PADDLE_TPU_FAILPOINTS="ckpt.write_shard=raise@2;store.set=hang"

Spec grammar (';'-separated entries)::

    <name>=<action>[@<n>]

- ``name``: the failpoint site (see ``KNOWN_SITES``); arbitrary names
  are allowed so tests can add their own sites.
- ``action``: ``raise`` (FailpointError), ``hang`` (sleep, default 3600s
  — the watchdog's prey; ``hang:<seconds>`` overrides), ``corrupt``
  (flip bits in the bytes passing through the site — only meaningful at
  sites that move a payload), ``kill`` (SIGKILL this process: the
  crash-consistency hammer — no atexit, no flushes, exactly like a
  preemption).
- ``@n``: trigger on the n-th hit of the site (1-based) and every hit
  after it; omitted = every hit from the first.

Sites fire via :func:`hit`::

    data = failpoints.hit("ckpt.write_shard", data)   # may raise/kill
    failpoints.hit("store.set")                       # payload-less

Tests prefer the scoped form so one test can never leak an armed
failpoint into the next::

    with failpoints.scoped("ckpt.commit=raise"):
        ...

The table is process-global and read at module import from
``PADDLE_TPU_FAILPOINTS`` (so a subprocess worker is armed by its
environment alone — the SIGKILL integration tests need nothing else).
"""
from __future__ import annotations

import contextlib
import os
import signal
import threading
import time
from typing import Dict, Optional

__all__ = ["FailpointError", "configure", "clear", "scoped", "hit",
           "active", "hit_count", "KNOWN_SITES"]

ENV_VAR = "PADDLE_TPU_FAILPOINTS"

# the instrumented sites shipped in-tree (arbitrary names also work)
KNOWN_SITES = (
    "ckpt.write_shard",     # per-shard npz write (payload: shard bytes)
    "ckpt.write_metadata",  # metadata json write (payload: json bytes)
    "ckpt.commit",          # just before the COMMIT marker is written
    "ckpt.rename",          # just before tmp -> final atomic rename
    "store.set",            # TCPStore.set
    "store.get",            # TCPStore.get
    "engine.step_dispatch",  # ParallelEngine step entry
    "offload.prefetch",     # host-offload per-bucket prefetch (one hit
                            # per bucket per dispatch; host_offload.py)
    # telemetry-only loss perturbation: arm with action "corrupt"
    # (e.g. "health.loss_spike=corrupt@12") to make the health
    # monitor's N-th OBSERVED loss a spike — training state is
    # untouched (observability/healthmon.py)
    "health.loss_spike",
)

_ACTIONS = ("raise", "hang", "corrupt", "kill")


class FailpointError(RuntimeError):
    """Raised by an armed ``raise`` failpoint."""


class _Point:
    __slots__ = ("action", "after", "hangs", "hits")

    def __init__(self, action: str, after: int = 1, hangs: float = 3600.0):
        self.action = action
        self.after = after
        self.hangs = hangs
        self.hits = 0


_lock = threading.Lock()
_points: Dict[str, _Point] = {}
# fast path: hit() checks this bool before taking the lock, so an
# unarmed process pays one attribute read per site
_armed = False


def _parse(spec: str) -> Dict[str, _Point]:
    out: Dict[str, _Point] = {}
    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, rhs = entry.partition("=")
        if not sep or not name.strip():
            raise ValueError(
                f"failpoint entry {entry!r}: expected <name>=<action>[@n]")
        action, _, after_s = rhs.partition("@")
        action = action.strip()
        hangs = 3600.0
        if action.startswith("hang:"):
            hangs = float(action.split(":", 1)[1])
            action = "hang"
        if action not in _ACTIONS:
            raise ValueError(
                f"failpoint {name.strip()!r}: unknown action {action!r} "
                f"(choose from {', '.join(_ACTIONS)})")
        after = int(after_s) if after_s else 1
        if after < 1:
            raise ValueError(
                f"failpoint {name.strip()!r}: @{after} must be >= 1 "
                "(1-based hit count)")
        out[name.strip()] = _Point(action, after, hangs)
    return out


def configure(spec: str) -> None:
    """Arm the failpoint table from a spec string (replaces the current
    table; hit counters reset)."""
    global _armed
    pts = _parse(spec)
    with _lock:
        _points.clear()
        _points.update(pts)
        _armed = bool(_points)


def clear() -> None:
    """Disarm every failpoint."""
    global _armed
    with _lock:
        _points.clear()
        _armed = False


@contextlib.contextmanager
def scoped(spec: str):
    """Arm ``spec`` for the duration of the block, then restore the
    previous table (counters of surviving points reset)."""
    with _lock:
        prev = dict(_points)
    configure(spec)
    try:
        yield
    finally:
        global _armed
        with _lock:
            _points.clear()
            _points.update(prev)
            _armed = bool(_points)


def active(name: str) -> bool:
    """Whether ``name`` is armed (regardless of hit count)."""
    if not _armed:
        return False
    with _lock:
        return name in _points


def hit_count(name: str) -> int:
    """How many times site ``name`` has fired hit() so far."""
    with _lock:
        p = _points.get(name)
        return p.hits if p is not None else 0


def _corrupt(data: bytes) -> bytes:
    """Flip bits across the payload (start, middle, end) so any honest
    checksum catches it regardless of where the reader looks."""
    if not data:
        return data
    buf = bytearray(data)
    for idx in {0, len(buf) // 2, len(buf) - 1}:
        buf[idx] ^= 0xFF
    return bytes(buf)


def hit(name: str, data: Optional[bytes] = None) -> Optional[bytes]:
    """Fire failpoint site ``name``.

    Unarmed: returns ``data`` untouched (the common case — one bool
    read). Armed and at/past its ``@n`` trigger: performs the action.
    ``corrupt`` returns mangled bytes; the other actions never return
    normally (raise / sleep / SIGKILL).
    """
    if not _armed:
        return data
    with _lock:
        p = _points.get(name)
        if p is None:
            return data
        p.hits += 1
        if p.hits < p.after:
            return data
        action, hangs = p.action, p.hangs
    if action == "raise":
        raise FailpointError(f"failpoint {name!r} armed (hit "
                             f"{hit_count(name)})")
    if action == "hang":
        time.sleep(hangs)
        return data
    if action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(60)          # unreachable; SIGKILL delivery is async
    return _corrupt(data) if data is not None else data


# subprocess workers arm themselves from the environment alone
if os.environ.get(ENV_VAR):
    configure(os.environ[ENV_VAR])

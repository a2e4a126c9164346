"""Communication ledger, its single-process core (counterpart of
``paddle_tpu/observability/commledger.py``: ``wire_bytes``,
``CommRecord``, ``CommLedger``, ``capture``, ``note``, ``active``).

A capture collects every transfer noted while it is open, so one run of
a program yields its static ledger of communication: op kind, axes,
local shape, dtype, group size. Recording is host-side bookkeeping and
adds nothing to the device's work.

Byte accounting (per participant; the closed forms the JAX tests pin):

====================  =========================================
op                    wire bytes sent per participant
====================  =========================================
psum (all-reduce)     2 * (p-1)/p * payload
all_gather            (p-1) * payload
reduce_scatter        (p-1)/p * payload
all_to_all            (p-1)/p * payload
ppermute              payload
====================  =========================================

In the port one process serves on one card, so no round of the serving
engine issues a collective: its ``comm_ledger(site)`` is None for every
single-device round. What the ledger books today is the KV page
migration between disaggregated replicas (``inference/disagg.py``): a
point-to-point ``ppermute`` under the ``migrate`` axis per page payload
and block-table row, so ``paddle_tpu_comm_bytes_total{axis="migrate"}``
equals the migration's closed form.

``scan_trips(length)`` stamps the records noted inside it with
``trips=length`` (multiplied under nesting), as the JAX package stamps a
scanned body's collectives; the port's pipeline and bucketed sync issue
each collective itself, one record a call, so they leave it at 1. The
rest of the JAX module raises ``NotImplementedError`` naming the
ROADMAP.md item it waits on: ``quant_wire`` (quantized collectives,
queue 1 item 10), and the exposed-comm attribution — ``ablate``, ``ablating``,
``ablation_token``, ``build_report``, ``replay_callable`` — which
replays collectives over a process group (item 11's multi-process
half). ``distributed/collective.py`` books every collective here,
with the bytes it staged through host memory (``host_bytes``).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = [
    "CommRecord", "CommLedger", "capture", "note", "wire_bytes",
    "active", "open_captures", "carried", "ablate", "ablating",
    "ablation_token", "scan_trips", "quant_wire", "build_report",
    "replay_callable", "OPS",
]

# canonical op kinds the ledger aggregates under (the {op} label of
# paddle_tpu_comm_bytes_total / paddle_tpu_comm_ops_total)
OPS = ("psum", "pmax", "pmin", "all_gather", "reduce_scatter",
       "all_to_all", "ppermute")

_ITEM11 = ("ROADMAP.md queue 1, item 11 (the multi-process run-time "
           "services)")
_ITEM10 = "ROADMAP.md queue 1, item 10 (quantized collectives)"


def wire_bytes(op: str, payload_bytes: float, p: int) -> float:
    """Closed-form bytes-on-wire per participant for ``op`` over a
    group of ``p`` members moving a ``payload_bytes`` local buffer."""
    if p <= 1:
        return 0.0
    if op in ("psum", "pmax", "pmin"):
        return 2.0 * (p - 1) / p * payload_bytes
    if op == "all_gather":
        return float((p - 1) * payload_bytes)
    if op in ("reduce_scatter", "all_to_all"):
        return (p - 1) / p * payload_bytes
    if op == "ppermute":
        return float(payload_bytes)
    raise ValueError(f"unknown collective op kind {op!r}")


def _itemsize(dtype) -> int:
    """Bytes an element of a numpy or torch dtype takes."""
    try:
        return int(np.dtype(dtype).itemsize)
    except TypeError:
        return int(getattr(dtype, "itemsize", 4))


@dataclass(frozen=True)
class CommRecord:
    """One noted transfer: everything needed to re-issue it."""

    op: str                      # canonical kind (OPS)
    axes: Tuple[str, ...]        # axis names of the group
    axis: str                    # display label: "+".join(axes)
    shape: Tuple[int, ...]       # local input shape at the call
    dtype: str
    p: int                       # group size
    payload_bytes: int
    wire_bytes: float
    args: Tuple = ()             # op-specific statics
    trips: int = 1               # executions per program run
    wire_dtype: str = ""         # dtype on the wire (== dtype here)
    payload_ratio: float = 1.0   # compressed / uncompressed wire bytes
    host_bytes: int = 0          # staged through host memory (a host hop)


class CommLedger:
    """The static communication record of ONE program run."""

    def __init__(self):
        self.records: List[CommRecord] = []
        self.open = False            # while its capture is open

    def __len__(self):
        return len(self.records)

    def add(self, rec: CommRecord):
        self.records.append(rec)

    def axis_labels(self) -> List[str]:
        return sorted({r.axis for r in self.records})

    def totals(self) -> Dict[Tuple[str, str], Dict[str, float]]:
        """{(axis, op): {"bytes": wire bytes, "payload_bytes": ...,
        "ops": count}} aggregated per execution of the program."""
        out: Dict[Tuple[str, str], Dict[str, float]] = {}
        for r in self.records:
            t = out.setdefault((r.axis, r.op),
                               {"bytes": 0.0, "payload_bytes": 0,
                                "ops": 0})
            t["bytes"] += r.wire_bytes * r.trips
            t["payload_bytes"] += r.payload_bytes * r.trips
            t["ops"] += r.trips
        return out

    def bytes_for(self, axis: Optional[str] = None,
                  op: Optional[str] = None) -> float:
        return sum(r.wire_bytes * r.trips for r in self.records
                   if (axis is None or r.axis == axis)
                   and (op is None or r.op == op))

    def ops_for(self, axis: Optional[str] = None,
                op: Optional[str] = None) -> int:
        return sum(r.trips for r in self.records
                   if (axis is None or r.axis == axis)
                   and (op is None or r.op == op))

    def host_bytes(self, axis: Optional[str] = None,
                   op: Optional[str] = None) -> int:
        """Bytes the records copied between the card and host memory
        (gloo collectives on CUDA tensors; 0 for direct ones)."""
        return sum(r.host_bytes * r.trips for r in self.records
                   if (axis is None or r.axis == axis)
                   and (op is None or r.op == op))

    def publish(self, bytes_counter, ops_counter) -> None:
        """Add one execution's worth of this program's traffic to the
        registry counters."""
        for (axis, op), t in self.totals().items():
            bytes_counter.inc(t["bytes"], axis=axis, op=op)
            ops_counter.inc(t["ops"], axis=axis, op=op)

    def quant_ratios(self) -> Dict[str, float]:
        """Per-axis compressed / uncompressed-equivalent wire-byte
        ratio of the axes carrying a quantized record; empty while
        nothing is compressed (always, until item 10)."""
        axes = {r.axis for r in self.records if r.payload_ratio != 1.0}
        out: Dict[str, float] = {}
        for axis in axes:
            wire = logical = 0.0
            for r in self.records:
                if r.axis != axis:
                    continue
                w = r.wire_bytes * r.trips
                wire += w
                logical += w / max(r.payload_ratio, 1e-12)
            if logical > 0:
                out[axis] = wire / logical
        return out

    def summary(self) -> Dict[str, Any]:
        return {
            "records": len(self.records),
            "axes": self.axis_labels(),
            "totals": {f"{a}/{o}": t
                       for (a, o), t in sorted(self.totals().items())},
        }


class _State(threading.local):
    def __init__(self):
        self.captures: List[CommLedger] = []
        self.trips: int = 1


_state = _State()


def active() -> bool:
    """True when a capture is open on this thread (or carried into it)."""
    return bool(_state.captures)


class _Capture:
    def __enter__(self) -> CommLedger:
        self.ledger = CommLedger()
        self.ledger.open = True
        _state.captures.append(self.ledger)
        return self.ledger

    def __exit__(self, *exc):
        self.ledger.open = False
        _state.captures.remove(self.ledger)
        return False


def capture() -> _Capture:
    """Context manager collecting every transfer noted inside it on this
    thread, and on the threads it is carried into (``carried``)."""
    return _Capture()


def open_captures() -> Tuple[CommLedger, ...]:
    """This thread's open captures, to hand to ``carried``."""
    return tuple(_state.captures)


@contextlib.contextmanager
def carried(ledgers: Iterable[CommLedger]):
    """Book this thread's transfers also into ``ledgers``, captures that
    another thread opened, for as long as they stay open. An autograd
    Function takes ``open_captures()`` in its forward and carries them
    into its backward, which a CUDA autograd runs on a device thread of
    its own."""
    add = [led for led in ledgers
           if not any(led is c for c in _state.captures)]
    _state.captures.extend(add)
    try:
        yield
    finally:
        for led in add:
            _state.captures.remove(led)


def note(op: str, axes: Iterable[str], shape, dtype, p: int,
         args: Tuple = (), host_bytes: int = 0) -> None:
    """Record one transfer into every open capture; ``host_bytes``: what
    staging it through host memory copied (a host hop)."""
    if not _state.captures:
        return
    axes = tuple(axes)
    payload = int(np.prod(shape)) * _itemsize(dtype) if shape else \
        _itemsize(dtype)
    rec = CommRecord(op=op, axes=axes, axis="+".join(axes),
                     shape=tuple(int(s) for s in shape),
                     dtype=str(dtype), p=int(p),
                     payload_bytes=payload,
                     wire_bytes=wire_bytes(op, payload, int(p)),
                     args=tuple(args), trips=int(_state.trips),
                     wire_dtype=str(dtype), host_bytes=int(host_bytes))
    for led in _state.captures:
        if led.open:
            led.add(rec)


@contextlib.contextmanager
def scan_trips(length: int):
    """While open, every record noted on this thread carries
    ``trips=length`` (multiplicative under nesting): a body issued
    ``length`` times per run, booked once."""
    prev = _state.trips
    _state.trips = prev * max(int(length), 1)
    try:
        yield
    finally:
        _state.trips = prev


def quant_wire(ratio: float):
    raise NotImplementedError(
        f"commledger.quant_wire stamps quantized collectives: not ported "
        f"yet ({_ITEM10})")


def ablate(labels: Iterable[str]):
    raise NotImplementedError(
        f"commledger.ablate (the exposed-comm replay) needs collectives "
        f"over a process group: not ported yet ({_ITEM11})")


def ablating(axis_label: str) -> bool:
    raise NotImplementedError(
        f"commledger.ablating: not ported yet ({_ITEM11})")


def ablation_token():
    raise NotImplementedError(
        f"commledger.ablation_token: not ported yet ({_ITEM11})")


def build_report(*args, **kwargs):
    raise NotImplementedError(
        f"commledger.build_report (exposed-comm attribution): not ported "
        f"yet ({_ITEM11})")


def replay_callable(*args, **kwargs):
    raise NotImplementedError(
        f"commledger.replay_callable (replaying a ledger's collectives): "
        f"not ported yet ({_ITEM11})")

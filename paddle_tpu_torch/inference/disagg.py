"""Disaggregated prefill/decode serving: KV page migration (counterpart
of ``paddle_tpu/inference/disagg.py``).

A ``phase="prefill"`` replica runs the chunked ``[B, Sc]`` unified step
and parks each request at its first sampled token; a
:class:`KVMigrator` then moves the request's committed KV pages to a
``phase="decode"`` replica, which advances it in ``[B, 1]`` decode
rounds. A page is a pool row plus a block-table entry, so a migrated
page is valid in any pool of the same geometry. On one card the two
replicas are two engines on the same device.

Wire format (``pack_migration`` / ``unpack_migration``), the JAX
package's: one ``[2 * layers, kv_heads, page, head_dim]`` payload array
per committed page (K and V interleaved by layer; bf16 as its uint16
image, as the checkpoints store it), each with a crc32 of the
checkpoint codec (``distributed.checkpoint.array_crc32``, computed on a
few threads), plus the row's block table and the host request state
(prompt, committed tokens, trace identity). A mismatch raises
:class:`MigrationCorruptError`; the router retries the request on a
fresh replica, which is exact because a greedy prefill recommits the
same first token.

Bytes are exact at a closed form per request::

    wire_bytes = ceil(L / page) * page_bytes + block_table_row_bytes

and every migration books them on the comm ledger
(observability/commledger.py) as point-to-point ``ppermute`` records
under the ``migrate`` axis (wire == payload), and on
``paddle_tpu_serving_migration_bytes_total``.

The pages go device to host (one gather and one copy into pinned memory
on the prefill replica), through the crc32, and host to device (one
copy from pinned memory and one indexed write a pool on the decode
replica). ``KVMigrator.timings`` keeps each migration's seconds in
those three parts. Export and import write pools in place, so neither
replica captures a graph again.

Backpressure: a decode replica without a free slot or the pages refuses
(``can_import`` False) and the row stays parked on its prefill replica,
holding its pages.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List

import numpy as np

from ..distributed.checkpoint.save_state_dict import crc32_all
from ..observability import commledger as _cl
from ..observability.catalog import serving_metrics as _serving_metrics

__all__ = ["KVMigrator", "MigrationCorruptError", "pack_migration",
           "unpack_migration", "migration_nbytes", "MIGRATE_AXES"]

# the comm-ledger axis migrations are booked under (point-to-point page
# moves between replicas: ppermute semantics, wire == payload)
MIGRATE_AXES = ("migrate",)


class MigrationCorruptError(RuntimeError):
    """A transferred KV page payload failed its crc32: the migration is
    dropped and the request retried on a fresh replica."""


def migration_nbytes(pkg: Dict[str, Any]) -> int:
    """The closed form of one request's migration wire bytes: committed
    pages x page_bytes + the block-table row."""
    return int(sum(int(a.nbytes) for a in pkg["pages"])
               + int(pkg["table_row"].nbytes))


def pack_migration(pkg: Dict[str, Any]) -> Dict[str, Any]:
    """Frame an exported request for the wire: contiguous page payloads
    with one crc32 each (the checkpoint codec) and the closed-form byte
    count."""
    pages = [np.ascontiguousarray(a) for a in pkg["pages"]]
    table = np.ascontiguousarray(pkg["table_row"])
    wire = dict(pkg)
    wire["pages"] = pages
    wire["table_row"] = table
    wire["page_crc32"] = crc32_all(pages)
    wire["wire_bytes"] = int(sum(a.nbytes for a in pages) + table.nbytes)
    return wire


def unpack_migration(wire: Dict[str, Any]) -> Dict[str, Any]:
    """Check every page payload against its recorded crc32, as a
    checkpoint shard is checked on load; raises
    :class:`MigrationCorruptError` at the first mismatch."""
    got = crc32_all(wire["pages"])
    for j, (g, want) in enumerate(zip(got, wire["page_crc32"])):
        if g != want:
            raise MigrationCorruptError(
                f"KV page payload {j} failed its crc32 ({g:#010x} != "
                f"recorded {want:#010x}); dropping the migration so the "
                "request can be retried on a fresh replica")
    return wire


def _retry_info(pkg: Dict[str, Any]) -> Dict[str, Any]:
    """What a router needs to resubmit a failed migration's request from
    scratch (a greedy prefill restart is exact)."""
    return {"prompt": pkg["prompt"],
            "max_new_tokens": pkg["max_new_tokens"],
            "eos_token_id": pkg["eos_token_id"],
            "trace_id": pkg["trace_id"],
            "parent_span_id": pkg["parent_span_id"]}


class KVMigrator:
    """Moves committed KV pages from prefill replicas to decode replicas.
    ``pump(prefill_replicas)`` is one migration tick: every parked row
    moves to an accepting decode replica or stays parked
    (backpressure). Returns one event a migration tried: ``{"status":
    "ok", "src", "src_rid", "dst", "dst_rid"}``, or ``{"status":
    "crc_error" | "refused", "src", "src_rid", "request": <resubmit
    info>}``. ``timings`` holds one dict for each of the last
    ``TIMINGS_KEPT`` migrations that completed: its pages, wire bytes,
    and seconds device to host (``d2h_s``, the export), in crc32
    (``crc_s``, computing and checking) and host to device (``h2d_s``,
    the import)."""

    TIMINGS_KEPT = 4096

    def __init__(self, decode_replicas: List[Any]):
        self.decode = list(decode_replicas)
        self._metrics = _serving_metrics()
        # cumulative wire bytes, pinned to the per-request closed form
        self.wire_bytes = 0
        self.migrated = 0
        self.timings: deque = deque(maxlen=self.TIMINGS_KEPT)

    def _pick(self, prompt_len: int, max_new_tokens: int):
        """The decode replica with the most free pages that can adopt
        this geometry now, or None (backpressure)."""
        cands = [e for e in self.decode
                 if e.can_import(prompt_len, max_new_tokens)]
        if not cands:
            return None
        return max(cands, key=lambda e: e._avail_pages())

    def _transmit(self, wire: Dict[str, Any]) -> Dict[str, Any]:
        """The wire seam: an in-process fleet hands the frame over as it
        is; a transport between hosts (or a fault-injecting test)
        overrides this."""
        return wire

    def pump(self, prefill_replicas: List[Any]) -> List[Dict[str, Any]]:
        """One migration tick over the prefill side of the fleet."""
        events = []
        for peng in prefill_replicas:
            for rid in list(peng.migratable()):
                s = next(s for s in peng.slots
                         if s is not None and s.req.rid == rid)
                dst = self._pick(len(s.req.prompt), s.req.max_new_tokens)
                if dst is None:
                    # the row stays parked holding its pages; the prefill
                    # replica's own stall / preempt machinery throttles
                    self._metrics["migrations"].inc(result="refused")
                    continue
                events.append(self._migrate(peng, rid, dst))
        return events

    def _migrate(self, src, rid: int, dst) -> Dict[str, Any]:
        t0 = time.perf_counter()
        pkg = src.export_request(rid)
        t1 = time.perf_counter()
        wire = self._transmit(pack_migration(pkg))
        t2 = time.perf_counter()
        nbytes = int(wire["wire_bytes"])
        # every byte on the migration wire is a point-to-point page move,
        # booked like a collective: ppermute wire == payload, so the
        # ledger's total is the closed form
        with _cl.capture() as led:
            for arr in wire["pages"]:
                _cl.note("ppermute", MIGRATE_AXES, arr.shape, arr.dtype,
                         p=2)
            _cl.note("ppermute", MIGRATE_AXES, wire["table_row"].shape,
                     wire["table_row"].dtype, p=2)
        led.publish(self._metrics["comm_bytes"], self._metrics["comm_ops"])
        self.wire_bytes += nbytes
        self._metrics["migration_bytes"].inc(nbytes)
        t3 = time.perf_counter()
        try:
            pkg2 = unpack_migration(wire)
        except MigrationCorruptError as e:
            self._metrics["migrations"].inc(result="crc_error")
            return {"status": "crc_error", "src": src, "src_rid": rid,
                    "error": str(e), "request": _retry_info(pkg)}
        t4 = time.perf_counter()
        nrid = dst.import_request(pkg2)
        t5 = time.perf_counter()
        if nrid is None:
            # the capacity check raced an admission on the decode
            # replica; the export already evicted the row, so the
            # request restarts from scratch like a corrupt frame
            self._metrics["migrations"].inc(result="refused")
            return {"status": "refused", "src": src, "src_rid": rid,
                    "request": _retry_info(pkg)}
        self.migrated += 1
        self.timings.append({"pages": len(wire["pages"]),
                             "wire_bytes": nbytes, "d2h_s": t1 - t0,
                             "crc_s": (t2 - t1) + (t4 - t3),
                             "h2d_s": t5 - t4})
        self._metrics["migrations"].inc(result="ok")
        self._metrics["migration_seconds"].observe(time.perf_counter() - t0)
        return {"status": "ok", "src": src, "src_rid": rid,
                "dst": dst, "dst_rid": nrid}

"""Checkpoint save with a crash-consistent commit protocol (counterpart
of ``paddle_tpu/distributed/checkpoint/save_state_dict.py``).

The format is the JAX package's, byte for byte, so a directory written
by either package loads in the other:

- ``<proc>_0.distcp``: an ``np.savez`` archive (no pickle), one member
  per tensor, named ``<flat key>@<global offset>``; the port runs one
  process, so every tensor is one whole shard at offset 0,
- ``0.metadata``: json with each tensor's shape, dtype and the crc32 of
  its member's byte image,
- ``train_meta.json`` (optional): the small json committed with the
  tensors (step counters, LR schedule, scaler),
- ``COMMIT``: the marker written last.

bf16 tensors are written as their ``uint16`` bit image with
``"bfloat16"`` in the metadata (the JAX loader views it back; the port
never needs ``ml_dtypes``). The caller chooses the layout: the engine
hands over ``[in, out]`` views of its ``nn.Linear`` weights, so the
bytes are the JAX package's (``ParallelEngine._checkpoint_state``).

Crash consistency (the commit protocol):

1. every file is written into ``<path>.tmp`` and fsync'd;
2. ``0.metadata`` is written only after the shard file is durable;
3. a ``COMMIT`` marker is written last, the directory fsync'd, and the
   whole tmp directory atomically renamed to ``<path>``.

A crash at ANY point leaves either the previous committed checkpoint
untouched or a tmp/old directory the loader refuses (no COMMIT) or
falls back from (committed ``.tmp``/``.old`` after a mid-rename crash).
The write path carries the ``ckpt.write_shard`` / ``ckpt.write_metadata``
/ ``ckpt.commit`` / ``ckpt.rename`` failpoints (``failpoints.py``).

``collect_shards`` is the only part that touches the device: it copies
every tensor to host memory and returns once the copies are done, so
an optimizer step that updates parameters, masters and moments in
place right after it cannot reach the checkpoint. ``async_save=True``
runs the rest — the crc32s and the file protocol — on a background
writer thread; ``wait_async_saves()`` blocks until pending writes
commit. The rolling-retention form lives in ``manager.CheckpointManager``.
"""
from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...core.enforce import enforce
from .. import failpoints as _fp
from .metadata import LocalTensorIndex, LocalTensorMetadata, Metadata

__all__ = ["save_state_dict", "wait_async_saves", "collect_shards",
           "write_committed", "array_crc32", "crc32_all", "host_array",
           "COMMIT_MARKER",
           "TMP_SUFFIX", "OLD_SUFFIX", "EXTRA_META_FILE"]

COMMIT_MARKER = "COMMIT"
TMP_SUFFIX = ".tmp"
OLD_SUFFIX = ".old"
EXTRA_META_FILE = "train_meta.json"
_FORMAT_VERSION = 1


def _flatten(state: Dict, prefix=""):
    out = {}
    for k, v in state.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def array_crc32(arr) -> int:
    """The shard checksum codec: crc32 over the C-contiguous byte
    image of one array (the JAX package's)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def crc32_all(arrays) -> List[int]:
    """``array_crc32`` of each array, on a few threads (zlib releases
    the GIL over large buffers)."""
    arrays = list(arrays)
    if len(arrays) < 2:
        return [array_crc32(a) for a in arrays]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(array_crc32, arrays))


def host_array(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(C-contiguous host copy, metadata dtype) of a tensor: bf16 as its
    uint16 bit image under ``"bfloat16"``. A non-contiguous CUDA tensor
    (an ``[in, out]`` view) is made contiguous on the device first. The
    copy is complete when this returns, and shares no memory with
    ``t``."""
    t = t.detach()
    if t.device.type == "cpu":
        # a copy of its own: the caller may update ``t`` in place next
        t = t.clone(memory_format=torch.contiguous_format)
    else:
        t = t.contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return (np.ascontiguousarray(t.view(torch.int16).numpy())
                .view(np.uint16), "bfloat16")
    arr = np.ascontiguousarray(t.numpy())
    return arr, str(arr.dtype)


def _check_one_process(what: str) -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        raise NotImplementedError(
            f"{what} across {dist.get_world_size()} processes is not "
            f"ported yet: ROADMAP.md queue 1, item 8 (the communication "
            f"base)")


# ---------------------------------------------------------------------------
# snapshot: tensors -> host arrays + metadata (the blocking part)
# ---------------------------------------------------------------------------


def collect_shards(state_dict: Dict) -> Tuple[Metadata, Dict[str,
                                                             np.ndarray],
                                              str]:
    """Host snapshot of a state dict: metadata + the arrays this
    process will write. Tensors on any device are copied to host memory
    before it returns; the crc32s are left to ``write_committed``."""
    _check_one_process("a checkpoint save")
    md = Metadata()
    shards_out: Dict[str, np.ndarray] = {}
    fname = "0_0.distcp"
    for key, v in _flatten(state_dict).items():
        if isinstance(v, torch.Tensor):
            arr, dtype = host_array(v)
        else:
            arr = np.array(v, order="C")      # a copy of its own
            dtype = str(arr.dtype)
        md.state_dict_metadata[key] = [LocalTensorMetadata(
            (0,) * arr.ndim, tuple(arr.shape), dtype)]
        sk = LocalTensorIndex(key, (0,) * arr.ndim).storage_key()
        md.storage_metadata[sk] = fname
        md.global_shape[key] = list(arr.shape)
        shards_out[sk] = arr
    return md, shards_out, fname


# ---------------------------------------------------------------------------
# durable file helpers
# ---------------------------------------------------------------------------


def _write_durable(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:        # platforms without directory fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _rmtree(path: str) -> None:
    import shutil

    shutil.rmtree(path, ignore_errors=True)


def _replace_dir(tmp: str, final: str) -> None:
    """Atomically promote ``tmp`` to ``final``. A pre-existing committed
    ``final`` is renamed aside first (loaders probe ``<final>.old`` /
    ``<final>.tmp`` as fallbacks, so no crash window is uncovered)."""
    bak = final + OLD_SUFFIX
    if os.path.isdir(final):
        _rmtree(bak)
        os.rename(final, bak)
    os.rename(tmp, final)
    _rmtree(bak)
    _fsync_dir(os.path.dirname(os.path.abspath(final)))


def _write_shards(path: str, shards: Dict[str, np.ndarray]) -> None:
    """The npz archive, durable. Straight to the file, unless the
    ``ckpt.write_shard`` site is armed: then through its bytes, as the
    JAX writer always does."""
    if _fp.active("ckpt.write_shard"):
        import io

        bio = io.BytesIO()
        np.savez(bio, **shards)
        _write_durable(path, _fp.hit("ckpt.write_shard", bio.getvalue()))
        return
    with open(path, "wb") as f:
        np.savez(f, **shards)
        f.flush()
        os.fsync(f.fileno())


# ---------------------------------------------------------------------------
# the commit protocol (pure file I/O over a collected snapshot)
# ---------------------------------------------------------------------------


def write_committed(path: str, md: Metadata,
                    shards: Dict[str, np.ndarray], fname: str,
                    coordinator_rank: int = 0,
                    extra_meta: Optional[Dict[str, Any]] = None) -> None:
    """Run the crc32 → tmp → fsync → metadata → COMMIT → rename
    protocol for a collected snapshot (one process)."""
    todo = [sk for sk in shards if sk not in md.checksums]
    md.checksums.update(zip(todo, crc32_all(shards[sk] for sk in todo)))
    tmp = path.rstrip("/") + TMP_SUFFIX
    os.makedirs(tmp, exist_ok=True)
    _write_shards(os.path.join(tmp, fname), shards)
    meta_bytes = _fp.hit("ckpt.write_metadata",
                         json.dumps(md.to_json()).encode())
    _write_durable(os.path.join(tmp, "0.metadata"), meta_bytes)
    if extra_meta is not None:
        _write_durable(os.path.join(tmp, EXTRA_META_FILE),
                       json.dumps(extra_meta).encode())
    _fp.hit("ckpt.commit")
    commit = {"format": _FORMAT_VERSION,
              "shard_files": sorted({v for v in
                                     md.storage_metadata.values()}),
              "n_tensors": len(md.state_dict_metadata)}
    _write_durable(os.path.join(tmp, COMMIT_MARKER),
                   json.dumps(commit).encode())
    _fsync_dir(tmp)
    _fp.hit("ckpt.rename")
    _replace_dir(tmp, path)


# ---------------------------------------------------------------------------
# public save entry point (+ the module-level async writer)
# ---------------------------------------------------------------------------

_async_lock = threading.Lock()
_async_threads: List[threading.Thread] = []
_async_errors: List[BaseException] = []


def _drain_finished() -> None:
    with _async_lock:
        _async_threads[:] = [t for t in _async_threads if t.is_alive()]


def wait_async_saves(timeout: Optional[float] = None) -> None:
    """Block until every ``save_state_dict(async_save=True)`` issued by
    this process has committed; re-raises the first background error."""
    with _async_lock:
        threads = list(_async_threads)
    for t in threads:
        t.join(timeout)
    _drain_finished()
    with _async_lock:
        if _async_errors:
            raise _async_errors.pop(0)


def save_state_dict(state_dict: Dict, path: str,
                    process_group=None, coordinator_rank: int = 0,
                    unique_id=None, async_save: bool = False,
                    extra_meta: Optional[Dict[str, Any]] = None) -> None:
    """Write a checkpoint under ``path`` (a directory), with the atomic
    commit protocol.

    ``async_save``: snapshot to host now (the only stall), run the file
    protocol on a background thread (``wait_async_saves()`` joins it).
    ``extra_meta``: small json dict committed atomically WITH the shards
    as ``train_meta.json`` (step counters, scaler state — anything that
    must never be newer or older than the tensors next to it).
    """
    enforce(unique_id is None,
            "save_state_dict(unique_id=...) is not implemented: the "
            "atomic commit protocol identifies a save by its directory "
            "(use CheckpointManager for per-step rolling names)")
    md, shards, fname = collect_shards(state_dict)
    if not async_save:
        write_committed(path, md, shards, fname, coordinator_rank,
                        extra_meta)
        return

    def _bg():
        try:
            write_committed(path, md, shards, fname, coordinator_rank,
                            extra_meta)
        except BaseException as e:       # surfaced by wait_async_saves
            with _async_lock:
                _async_errors.append(e)

    t = threading.Thread(target=_bg, daemon=True, name="ckpt-writer")
    with _async_lock:
        _async_threads.append(t)
    t.start()
    _drain_finished()

"""Checkpoint load with commit verification (counterpart of
``paddle_tpu/distributed/checkpoint/load_state_dict.py``).

Reads the JAX package's format (``save_state_dict.py``), whichever
package wrote it. Each target tensor is filled in place, on its device
and in its dtype (``Tensor.copy_``), from the stored shards that cover
it; a target may be a view, so the engine loads the ``[in, out]`` image
of an ``nn.Linear`` weight straight through its transpose. A raw
(non-tensor) leaf is replaced by the stored numpy array. bf16 members —
the port's ``uint16`` images and the JAX writer's ``|V2`` records alike
— are read as ``torch.bfloat16`` without ``ml_dtypes``.

Crash consistency: the loader REFUSES a directory without the ``COMMIT``
marker the writer cuts last (a crash mid-save can never be read back),
probing ``<path>``, then a committed ``<path>.tmp`` / ``<path>.old``
(mid-rename crash windows). Every storage file is checksum-verified
against the metadata's per-shard crc32 on first open; a mismatch (or an
unparseable npz — torn write) raises :class:`CheckpointCorruptError`
instead of silently loading garbage. Newest-committed *fallback across
checkpoints* lives in ``manager.latest_committed``.
"""
from __future__ import annotations

import glob
import io
import json
import mmap
import os
import struct
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from ...core.enforce import enforce
from .metadata import Metadata
from .save_state_dict import (COMMIT_MARKER, OLD_SUFFIX, TMP_SUFFIX,
                              crc32_all)

__all__ = ["load_state_dict", "open_checkpoint", "is_committed",
           "resolve_committed", "CheckpointCorruptError"]


class CheckpointCorruptError(RuntimeError):
    """A committed checkpoint failed verification (checksum mismatch or
    unreadable shard archive) — fall back to an older committed one."""


def is_committed(path: str) -> bool:
    """Whether ``path`` is a fully-committed checkpoint directory (the
    writer's COMMIT marker plus a metadata file exist)."""
    return (os.path.isdir(path)
            and os.path.isfile(os.path.join(path, COMMIT_MARKER))
            and bool(glob.glob(os.path.join(path, "*.metadata"))))


def resolve_committed(path: str) -> Optional[str]:
    """The committed directory to read for ``path``: the path itself,
    else a committed ``.tmp``/``.old`` sibling left by a crash between
    the COMMIT marker and the final rename."""
    for cand in (path, path + TMP_SUFFIX, path + OLD_SUFFIX):
        if is_committed(cand):
            return cand
    return None


def _flatten(state: Dict, prefix=""):
    out = {}
    for k, v in state.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = (state, k, v)
    return out


def _np_dtype(dtype: str) -> np.dtype:
    """The numpy container of a metadata dtype: bf16 lives in uint16."""
    return np.dtype(np.uint16) if dtype == "bfloat16" else np.dtype(dtype)


def _as_dtype(arr: np.ndarray, dtype: str) -> np.ndarray:
    """Reinterpret an npz member with the metadata's dtype (a bf16
    member is a ``|V2`` record from the JAX writer, ``uint16`` from the
    port's: both view as uint16)."""
    want = _np_dtype(dtype)
    if arr.dtype == want:
        return arr
    return arr.view(want) if arr.dtype.itemsize == want.itemsize \
        else arr.astype(want)


def _to_torch(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _npz_members(path: str) -> Dict[str, np.ndarray]:
    """Every member of an ``np.savez`` archive (stored ``.npy`` members,
    format 1.0 or 2.0, as both packages write them) as an array over one
    private (copy-on-write) memory map of the file: no copy and no read
    loop; pages come in as the arrays are touched. Anything else raises
    ``ValueError``."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    with zipfile.ZipFile(path) as zf:
        infos = zf.infolist()
    out = {}
    fmt = np.lib.format
    for info in infos:
        name = info.filename[:-4] if info.filename.endswith(".npy") \
            else info.filename
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"member {name!r} is compressed")
        off = info.header_offset
        if struct.unpack_from("<I", mm, off)[0] != 0x04034b50:
            raise ValueError(f"member {name!r}: no local file header")
        nlen, elen = struct.unpack_from("<HH", mm, off + 26)
        start = off + 30 + nlen + elen
        major, _ = fmt.read_magic(io.BytesIO(mm[start:start + 8]))
        if major not in (1, 2):
            raise ValueError(f"member {name!r}: .npy format {major}")
        hlen = struct.unpack_from("<H" if major == 1 else "<I", mm,
                                  start + 8)[0]
        head = 10 + hlen if major == 1 else 12 + hlen
        fp = io.BytesIO(mm[start:start + head])
        fmt.read_magic(fp)
        shape, fortran, dtype = (fmt.read_array_header_1_0 if major == 1
                                 else fmt.read_array_header_2_0)(fp)
        if dtype.hasobject:
            raise ValueError(f"member {name!r} holds Python objects")
        count = int(np.prod(shape, dtype=np.int64))
        out[name] = np.frombuffer(mm, dtype=dtype, count=count,
                                  offset=start + head).reshape(
            shape, order="F" if fortran else "C")
    return out


class _LazyStorages:
    """Opens .distcp files on first use and verifies every member's
    crc32 against the metadata before any shard is handed out."""

    def __init__(self, path: str, md: Metadata):
        self._path = path
        self._md = md
        self._cache: Dict[str, Dict] = {}

    def get(self, fname: str):
        if fname not in self._cache:
            full = os.path.join(self._path, fname)
            try:
                data = _npz_members(full)
            except Exception as e:
                raise CheckpointCorruptError(
                    f"checkpoint shard file {full!r} is unreadable "
                    f"({e}) — torn write or corruption; fall back to "
                    "an older committed checkpoint") from None
            sums = self._md.checksums
            checked = [sk for sk in data if sk in sums]  # else: no crc
            for sk, got in zip(checked, crc32_all(
                    [data[sk] for sk in checked])):
                want = sums[sk]
                if got != want:
                    raise CheckpointCorruptError(
                        f"checksum mismatch for shard {sk!r} in "
                        f"{full!r} (crc32 {got:#010x} != recorded "
                        f"{want:#010x}) — refusing the corrupt "
                        "checkpoint")
            self._cache[fname] = data
        return self._cache[fname]


def _assemble(md, storages, key, metas, gshape, dtype) -> np.ndarray:
    """The whole tensor ``key`` from the stored shards (one whole shard
    from a one-process writer; a multi-host JAX writer's several)."""
    if len(metas) == 1 and tuple(metas[0].global_offset) == (0,) * len(
            gshape) and tuple(metas[0].local_shape) == gshape:
        m = metas[0]
        sk = f"{key}@" + "_".join(str(o) for o in m.global_offset)
        data = storages.get(md.storage_metadata[sk])[sk]
        return _as_dtype(data, m.dtype).reshape(m.local_shape)
    out = np.zeros(gshape, dtype=_np_dtype(dtype))
    for m in metas:
        sk = f"{key}@" + "_".join(str(o) for o in m.global_offset)
        data = storages.get(md.storage_metadata[sk])[sk]
        data = _as_dtype(data, m.dtype).reshape(m.local_shape)
        dst = tuple(slice(o, o + s) for o, s in
                    zip(m.global_offset, m.local_shape))
        out[dst] = data
    return out


class _Checkpoint:
    """One committed checkpoint, opened once: its metadata and its
    storage files, each read and crc-verified on first use. Several
    ``load`` calls (the engine's parameters, then the optimizer's slots)
    share one read of the files."""

    def __init__(self, path: str):
        resolved = resolve_committed(path)
        enforce(resolved is not None,
                f"no committed checkpoint at {path!r}: the COMMIT marker "
                "the atomic writer cuts last is missing (crash mid-save, "
                "pre-commit-protocol directory, or wrong path). Use "
                "checkpoint.manager.latest_committed(base) to fall back "
                "to the newest committed checkpoint")
        meta_files = glob.glob(os.path.join(resolved, "*.metadata"))
        enforce(meta_files, f"no .metadata file under {resolved!r}")
        with open(meta_files[0]) as f:
            self.md = Metadata.from_json(json.load(f))
        self.path = resolved
        self._storages = _LazyStorages(resolved, self.md)

    def load(self, state_dict: Dict) -> None:
        """Fill ``state_dict``'s tensors in place (``load_state_dict``)."""
        md = self.md
        for key, (owner, k, cur) in _flatten(state_dict).items():
            if key not in md.state_dict_metadata:
                continue
            metas = md.state_dict_metadata[key]
            gshape = tuple(md.global_shape.get(
                key, metas[0].local_shape if metas else ()))
            dtype = metas[0].dtype if metas else "float32"
            full = _assemble(md, self._storages, key, metas, gshape, dtype)
            if isinstance(cur, torch.Tensor):
                enforce(tuple(cur.shape) == gshape,
                        f"checkpoint tensor {key!r} has shape {gshape}, "
                        f"target expects {tuple(cur.shape)}")
                src = _to_torch(full, dtype)
                with torch.no_grad():
                    cur.copy_(src.to(device=cur.device, dtype=cur.dtype))
            else:
                owner[k] = (_to_torch(full, dtype) if dtype == "bfloat16"
                            else np.array(full))


def open_checkpoint(path: str) -> _Checkpoint:
    """The committed checkpoint at ``path`` (or its committed ``.tmp`` /
    ``.old`` sibling), for several ``load`` calls over one read."""
    return _Checkpoint(path)


def load_state_dict(state_dict: Dict, path: str, process_group=None,
                    coordinator_rank: int = 0, unique_id=None,
                    offload: bool = False) -> None:
    """Fill ``state_dict``'s tensors in place from the checkpoint at
    ``path``. Refuses uncommitted directories; verifies shard
    checksums. Keys the checkpoint lacks are left as they are."""
    _Checkpoint(path).load(state_dict)

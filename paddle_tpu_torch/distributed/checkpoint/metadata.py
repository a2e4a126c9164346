"""Checkpoint metadata types (counterpart of
``paddle_tpu/distributed/checkpoint/metadata.py``, the same json)
(reference: python/paddle/distributed/checkpoint/metadata.py —
LocalTensorMetadata{global_offset, local_shape, dtype},
LocalTensorIndex{tensor_key, global_offset}, Metadata{state_dict_metadata,
storage_metadata, flat_mapping}).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

__all__ = ["LocalTensorMetadata", "LocalTensorIndex", "Metadata"]


@dataclass(frozen=True)
class LocalTensorMetadata:
    """One stored shard: where it sits in the global tensor."""
    global_offset: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    dtype: str

    def to_json(self):
        return {"global_offset": list(self.global_offset),
                "local_shape": list(self.local_shape), "dtype": self.dtype}

    @staticmethod
    def from_json(d):
        return LocalTensorMetadata(tuple(d["global_offset"]),
                                   tuple(d["local_shape"]), d["dtype"])


@dataclass(frozen=True)
class LocalTensorIndex:
    tensor_key: str
    global_offset: Tuple[int, ...]

    def storage_key(self) -> str:
        off = "_".join(str(o) for o in self.global_offset)
        return f"{self.tensor_key}@{off}"


@dataclass
class Metadata:
    """state_dict_metadata: key → list of shard metadata;
    storage_metadata: storage_key → data file name;
    global_shape: key → full shape;
    checksums: storage_key → crc32 of the shard's raw bytes (computed at
    snapshot time, verified by the loader before any shard is used)."""
    state_dict_metadata: Dict[str, List[LocalTensorMetadata]] = \
        field(default_factory=dict)
    storage_metadata: Dict[str, str] = field(default_factory=dict)
    global_shape: Dict[str, List[int]] = field(default_factory=dict)
    checksums: Dict[str, int] = field(default_factory=dict)

    def to_json(self):
        return {
            "state_dict_metadata": {
                k: [m.to_json() for m in v]
                for k, v in self.state_dict_metadata.items()},
            "storage_metadata": self.storage_metadata,
            "global_shape": self.global_shape,
            "checksums": self.checksums,
        }

    @staticmethod
    def from_json(d):
        md = Metadata()
        md.state_dict_metadata = {
            k: [LocalTensorMetadata.from_json(m) for m in v]
            for k, v in d["state_dict_metadata"].items()}
        md.storage_metadata = d["storage_metadata"]
        md.global_shape = d.get("global_shape", {})
        md.checksums = {k: int(v)
                        for k, v in d.get("checksums", {}).items()}
        return md

"""Crash-consistent checkpoints (counterpart of
``paddle_tpu/distributed/checkpoint/``, in its format: a directory
written by either package loads in the other).

The atomic commit protocol (tmp + fsync + per-shard crc32 + COMMIT
marker + rename), a loader that refuses uncommitted and corrupt
directories, an async save path, and a rolling :class:`CheckpointManager`
with newest-committed fallback (``latest_committed``) — see
save_state_dict.py / manager.py. One process: resharding across a mesh
waits on ROADMAP.md queue 1, item 8.
"""
from .metadata import LocalTensorIndex, LocalTensorMetadata, Metadata  # noqa: F401
from .save_state_dict import (save_state_dict, wait_async_saves,  # noqa: F401
                              COMMIT_MARKER, array_crc32)
from .load_state_dict import (load_state_dict, is_committed,  # noqa: F401
                              open_checkpoint, resolve_committed,
                              CheckpointCorruptError)
from .manager import (CheckpointManager, latest_committed,  # noqa: F401
                      read_extra_meta)

__all__ = ["save_state_dict", "load_state_dict", "Metadata",
           "LocalTensorMetadata", "LocalTensorIndex", "CheckpointManager",
           "latest_committed", "read_extra_meta", "is_committed",
           "open_checkpoint", "resolve_committed", "CheckpointCorruptError",
           "wait_async_saves", "COMMIT_MARKER", "array_crc32"]

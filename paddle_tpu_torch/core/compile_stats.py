"""Launch-site shape telemetry (counterpart of
``paddle_tpu/core/compile_stats.py``).

Eager PyTorch has no compile step. Here ``compiles`` counts the distinct
``(site, shape key)`` pairs a launch site has seen and ``cache_hits`` the
repeats, so the "fixed shape lattice after warmup" property of the
serving engine stays testable (and is what a CUDA-graph capture per
shape would key on)."""
from __future__ import annotations

from typing import Any, Dict

__all__ = ["CompileStats"]


class CompileStats:
    def __init__(self):
        self.compiles = 0
        self.cache_hits = 0
        self.tokens = 0
        self.bucket_tokens: Dict[Any, int] = {}
        self._seen = set()

    def note(self, kind: str, sig) -> bool:
        """Record one launch at a site; True if its shape key is new."""
        key = (kind, sig)
        if key in self._seen:
            self.cache_hits += 1
            return False
        self._seen.add(key)
        self.compiles += 1
        return True

    def count_tokens(self, bucket, n: int):
        self.tokens += int(n)
        self.bucket_tokens[bucket] = self.bucket_tokens.get(bucket, 0) \
            + int(n)

    def as_dict(self) -> Dict[str, Any]:
        return {"compiles": self.compiles, "cache_hits": self.cache_hits,
                "tokens": self.tokens,
                "bucket_tokens": {str(k): v
                                  for k, v in self.bucket_tokens.items()}}

    def __repr__(self):
        return (f"CompileStats(compiles={self.compiles}, "
                f"cache_hits={self.cache_hits}, tokens={self.tokens})")

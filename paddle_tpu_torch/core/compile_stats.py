"""Launch-site shape telemetry (counterpart of
``paddle_tpu/core/compile_stats.py``).

``compiles`` counts the distinct ``(site, shape key)`` pairs a launch
site has seen and ``cache_hits`` the repeats, as the JAX package counts
its jitted programs, so the "fixed shape lattice after warmup" property
of the serving engine stays testable. The step sites (``decode``,
``serve_decode``, ``unified``) run as CUDA graphs on a card, one per
shape key (``core/cuda_graphs.py``): ``captures`` and ``capture_s``
count the graphs captured and the host seconds their captures took,
``replays`` the replays, and ``capture_bytes`` the device memory the
captures reserved (the graphs' shared pool), each by site. Eager sites
(``prefill``, ``run``) only note their keys."""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict

__all__ = ["CompileStats"]


class CompileStats:
    def __init__(self):
        self.compiles = 0
        self.cache_hits = 0
        self.tokens = 0
        self.bucket_tokens: Dict[Any, int] = {}
        self.captures: Counter = Counter()
        self.capture_s: Counter = Counter()
        self.capture_bytes: Counter = Counter()
        self.replays: Counter = Counter()
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

    def keys(self, kind: str) -> int:
        """The number of distinct shape keys noted at a site."""
        return sum(k == kind for k, _ in self._seen)

    def note_capture(self, site: str, seconds: float, nbytes: int):
        self.captures[site] += 1
        self.capture_s[site] += float(seconds)
        self.capture_bytes[site] += int(nbytes)

    def count_tokens(self, bucket, n: int):
        self.tokens += int(n)
        self.bucket_tokens[bucket] = self.bucket_tokens.get(bucket, 0) \
            + int(n)

    def as_dict(self) -> Dict[str, Any]:
        return {"compiles": self.compiles, "cache_hits": self.cache_hits,
                "tokens": self.tokens,
                "bucket_tokens": {str(k): v
                                  for k, v in self.bucket_tokens.items()},
                "captures": dict(self.captures),
                "capture_s": dict(self.capture_s),
                "capture_bytes": dict(self.capture_bytes),
                "replays": dict(self.replays)}

    def __repr__(self):
        return (f"CompileStats(compiles={self.compiles}, "
                f"cache_hits={self.cache_hits}, tokens={self.tokens}, "
                f"captures={dict(self.captures)}, "
                f"replays={dict(self.replays)})")

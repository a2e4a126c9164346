"""The shared bucketing lattice (counterpart of
``paddle_tpu/core/bucketing.py``).

Serving sequence lengths, chunk sizes and KV page-pool sizes are
quantized onto a power-of-two lattice. The port runs eagerly, so a new
bucket costs no compile here, but the serving scheduler's decisions
(pool size, chunk size, prefill bucket) depend on the lattice exactly,
and they must match the JAX engine's for token streams to compare.
"""
from __future__ import annotations

__all__ = ["bucket"]


def bucket(n: int, lo: int = 64) -> int:
    """Smallest power-of-two multiple of ``lo`` that is >= ``n``."""
    b = lo
    while b < n:
        b *= 2
    return b

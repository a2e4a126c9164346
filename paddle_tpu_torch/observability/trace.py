"""Semantic trace annotations + host-side in-flight regions
(counterpart of ``paddle_tpu/observability/trace.py``).

``annotate(name)`` does two jobs at once:

- it opens a ``torch.profiler.record_function`` range, so a
  ``torch.profiler`` trace (host ranges, and the kernels launched under
  them) carries framework names — ``gpt/layer3/attention`` — where the
  JAX package's ``jax.named_scope`` named XLA's ops,
- on the host it pushes the name on a per-thread region stack, so a
  stall flight-record (flight.py) can report what every thread was
  doing when it was dumped.

The host bookkeeping is plain list push/pop under no lock (each thread
touches only its own stack; the flight dump reads other threads'
stacks racily, which is fine for a post-mortem).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List

from torch.profiler import record_function

__all__ = ["annotate", "current_regions"]

# tid -> region-name stack. Threads insert their own entry on first
# annotate; the dict itself is only ever appended to (no rebalancing),
# so racy reads from the flight dump see a consistent-enough view.
_regions: Dict[int, List[str]] = {}


@contextlib.contextmanager
def annotate(name: str):
    """Named region: a profiler range + an in-flight marker for stall
    flight-records. Cheap enough for per-layer use."""
    tid = threading.get_ident()
    stack = _regions.get(tid)
    if stack is None:
        stack = _regions[tid] = []
    stack.append(name)
    try:
        with record_function(name):
            yield
    finally:
        stack.pop()


def current_regions() -> Dict[str, List[str]]:
    """{thread-name (tid): open-region stack}, innermost last — what
    each thread is inside right now (flight records embed this)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, stack in list(_regions.items()):
        if stack:
            out[f"{names.get(tid, 'dead')} ({tid})"] = list(stack)
    return out

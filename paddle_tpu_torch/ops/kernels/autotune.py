"""K7: measured tile selection for K1 with a persistent algorithm cache
(counterpart of ``paddle_tpu/ops/pallas/autotune.py``).

``AlgoCache``, ``get_cache`` and ``autotune`` keep the JAX contract: a
key that is cached is returned without measuring; otherwise every
candidate is measured (``measure(candidate) -> seconds``; a candidate
whose measurement raises or returns inf is skipped), the argmin is
cached and returned, and no feasible candidate raises ``RuntimeError``.
The cache persists as JSON ``{key: [block_q, block_kv]}`` at
``$PADDLE_TPU_TORCH_AUTOTUNE_CACHE`` (``""``: memory only; default
``~/.cache/paddle_tpu_torch/autotune.json``); an unreadable file is
ignored.

The tunable is K1's tile: ``(block_q, block_kv)`` of the Hopper forward
body (``csrc/flash_attention.cu``), whose instances the build lists
(``flash_attention.fwd_tiles``). ``measure_flash_blocks`` times them on
the card at the real shape; ``flash_attention._select_blocks`` builds the
key and the candidates, as the JAX ``_prep`` does, when
``FLAGS_use_autotune`` is on (``set_flags({"FLAGS_use_autotune":
True})``).

What bounds it: a search is ``len(candidates) * (1 + reps)`` K1 launches
at the real shape, once per new key (shape, card and K1 build); every
later call is a dictionary lookup.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from . import _build, counted

__all__ = ["AlgoCache", "get_cache", "set_cache", "autotune",
           "measure_flash_blocks", "search_log"]


class AlgoCache:
    """In-memory + on-disk map: key string -> chosen config."""

    def __init__(self, path: Optional[str] = None):
        self._mem: Dict[str, list] = {}
        self._path = path
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    self._mem.update(json.load(f))
            except (OSError, ValueError):
                pass  # an unreadable cache is an empty one

    def get(self, key: str):
        v = self._mem.get(key)
        return tuple(v) if isinstance(v, list) else v

    def put(self, key: str, value) -> None:
        self._mem[key] = list(value) if isinstance(value, tuple) else value
        if self._path:
            try:
                os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
                with open(self._path, "w") as f:
                    json.dump(self._mem, f)
            except OSError:
                pass  # the choice still holds for this process

    def size(self) -> int:
        return len(self._mem)


_cache: Optional[AlgoCache] = None

# one record per search this process ran: the key, each candidate's
# measured seconds (None where it was infeasible), the choice and the
# search's wall seconds
search_log: List[dict] = []


def _default_path() -> Optional[str]:
    p = os.environ.get("PADDLE_TPU_TORCH_AUTOTUNE_CACHE")
    if p == "":
        return None  # explicit opt-out of persistence
    return p or os.path.join(os.path.expanduser("~"), ".cache",
                             "paddle_tpu_torch", "autotune.json")


def get_cache() -> AlgoCache:
    global _cache
    if _cache is None:
        _cache = AlgoCache(_default_path())
    return _cache


def set_cache(cache: Optional[AlgoCache]) -> Optional[AlgoCache]:
    """Replace the process cache and return the one it replaces; None
    rebuilds it from the environment at the next ``get_cache``."""
    global _cache
    old, _cache = _cache, cache
    return old


def _card_fault(e: Exception) -> bool:
    """A CUDA error, from a kernel's C entry point or from torch: never
    an infeasible candidate."""
    return (isinstance(e, _build.LaunchError)
            or isinstance(e, getattr(torch, "AcceleratorError", ()))
            or (isinstance(e, RuntimeError) and "CUDA error" in str(e)))


def autotune(key: str, candidates: Sequence, measure: Callable,
             cache: Optional[AlgoCache] = None):
    """Return the cached choice for ``key`` or measure all candidates
    (``measure(candidate) -> seconds``; inf/exception = infeasible) and
    cache the argmin. A CUDA error during a measurement propagates.
    ``autotune.hits`` counts the calls a cached choice served."""
    cache = cache or get_cache()
    hit = cache.get(key)
    if hit is not None:
        autotune.hits += 1
        return hit
    t0 = time.perf_counter()
    times = {}
    best, best_t = None, float("inf")
    for cand in candidates:
        try:
            t = measure(cand)
        except Exception as e:  # noqa: BLE001 -- the JAX contract
            if _card_fault(e):
                raise
            times[cand] = None
            continue
        times[cand] = t
        if t < best_t:
            best, best_t = cand, t
    if best is None:
        raise RuntimeError(f"autotune: no feasible candidate for {key}")
    cache.put(key, best)
    search_log.append(dict(key=key, times=times, choice=best,
                           seconds=time.perf_counter() - t0))
    return best


autotune.hits = 0


def measure_flash_blocks(q_shape, kv_len: int, kv_heads: int, dtype,
                         causal: bool, reps: int = 5) -> Callable:
    """Measurement closure for K1: ``measure((block_q, block_kv))`` runs
    K1 with that tile once to warm up, then ``reps`` times between CUDA
    events, at the real shape, and returns seconds a launch. q, k and v
    are made on the card at the first measurement from a
    ``torch.Generator`` seeded 0 (the JAX closure uses ``RandomState(0)``)
    and live as long as the closure. Runs under ``no_grad``. A CUDA error
    propagates as it is: ``autotune`` then stops, since a fault on the
    card is not an infeasible tile. Each measured candidate adds one to
    ``measure_flash_blocks.launches``."""
    from .flash_attention import _k1

    B, S, H, D = q_shape
    scale = 1.0 / float(D) ** 0.5
    inputs = []

    def measure(cand) -> float:
        with torch.no_grad():
            if not inputs:
                dev = torch.device("cuda", torch.cuda.current_device())
                g = torch.Generator(device=dev).manual_seed(0)
                inputs.extend(torch.randn(shape, generator=g, device=dev,
                                          dtype=torch.float32).to(dtype)
                              for shape in ((B, S, H, D),
                                            (B, kv_len, kv_heads, D),
                                            (B, kv_len, kv_heads, D)))
            q, k, v = inputs
            _k1(q, k, v, causal, scale, None, None, cand)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                _k1(q, k, v, causal, scale, None, None, cand)
            t1.record()
            t1.synchronize()
        measure_flash_blocks.launches += 1
        return t0.elapsed_time(t1) / 1e3 / reps

    return measure


counted(measure_flash_blocks)

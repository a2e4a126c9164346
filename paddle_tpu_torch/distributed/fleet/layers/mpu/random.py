"""The hybrid-parallel RNG tracker (counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/random.py`` and the tracker of
``paddle_tpu/core/rng.py``).

Named, explicit ``torch.Generator`` streams (CPU generators: a stream
hands out seeds and values the same on any device). ``GLOBAL_SEED`` is
the same on every mp rank (dropout on replicated activations);
``LOCAL_SEED`` is distinct per mp rank (dropout on mp-sharded tensors):
``fleet.init`` seeds both once. ``local_dropout_key()`` draws one 64-bit
seed from the local stream for ``ops.attention.flash_attention(seed=)``.

GPT does not draw its attention masks from here: its attention seed is
the model's own (the same on every rank, as at degree 1), and each mp
rank's kernels hash its global head indices (``head_offset``), so the
ranks' masks are distinct and together equal the degree-1 mask.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "local_dropout_key",
           "LOCAL_SEED", "GLOBAL_SEED"]

GLOBAL_SEED = "global_seed"
LOCAL_SEED = "local_seed"


class RNGStatesTracker:
    """Named generator streams: ``add(name, seed)``; ``with
    tracker.rng_state(name) as g: ...`` hands out that stream."""

    def __init__(self):
        self.states_: Dict[str, torch.Generator] = {}
        self.seeds_ = set()

    def add(self, name: str, s: int) -> None:
        if s in self.seeds_:
            raise ValueError(f"seed {s} already exists")
        if name in self.states_:
            raise ValueError(f"rng state '{name}' already exists")
        self.seeds_.add(s)
        self.states_[name] = torch.Generator().manual_seed(int(s))

    def reset(self) -> None:
        self.states_ = {}
        self.seeds_ = set()

    def get_states_tracker(self):
        return {k: g.get_state() for k, g in self.states_.items()}

    def set_states_tracker(self, states):
        for k, st in states.items():
            self.states_.setdefault(k, torch.Generator()).set_state(st)

    @contextlib.contextmanager
    def rng_state(self, name: str = GLOBAL_SEED):
        if name not in self.states_:
            raise ValueError(f"rng state '{name}' not added")
        yield self.states_[name]


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _TRACKER


def model_parallel_random_seed(seed: int = 0) -> None:
    """Reseed both streams: global ``seed``, local ``seed + 2718 + mp
    rank`` (the fleet's mp rank, 0 without one)."""
    from ... import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    rank = hcg.get_model_parallel_rank() if hcg is not None else 0
    tracker = get_rng_state_tracker()
    tracker.reset()
    torch.manual_seed(int(seed))
    tracker.add(GLOBAL_SEED, int(seed))
    tracker.add(LOCAL_SEED, int(seed) + 2718 + rank)


def local_dropout_key() -> int:
    """One 64-bit seed from the local stream (the global one when the
    tracker has no local stream)."""
    tracker = get_rng_state_tracker()
    name = LOCAL_SEED if LOCAL_SEED in tracker.states_ else GLOBAL_SEED
    if name not in tracker.states_:
        model_parallel_random_seed(0)
    g = tracker.states_[name]
    return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=g,
                             dtype=torch.int64))

from . import mp_ops, random  # noqa: F401
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding, mp_active,
                        parallel_cross_entropy)
from .random import (RNGStatesTracker, get_rng_state_tracker,
                     model_parallel_random_seed)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy", "mp_active",
           "parallel_cross_entropy", "RNGStatesTracker",
           "get_rng_state_tracker", "model_parallel_random_seed", "mp_ops",
           "random"]

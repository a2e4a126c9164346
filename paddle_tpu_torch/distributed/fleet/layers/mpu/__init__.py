from .mp_layers import (ColumnParallelLinear, RowParallelLinear,
                        VocabParallelEmbedding, mp_active,
                        parallel_cross_entropy)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "mp_active", "parallel_cross_entropy"]

from .fused_transformer import (FusedFeedForward,  # noqa: F401
                                FusedMultiHeadAttention,
                                FusedMultiTransformer)

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedMultiTransformer"]

"""Incubating NN ops and layers (counterpart of
``paddle_tpu/incubate/nn``): the fused cache-KV attention functions in
``functional``, the training blocks ``FusedMultiHeadAttention`` (causal
attention with attention dropout inside K1/K2) and ``FusedFeedForward``,
and the ``FusedMultiTransformer`` decoder stack."""
from . import functional  # noqa: F401
from .layer import (FusedFeedForward, FusedMultiHeadAttention,  # noqa: F401
                    FusedMultiTransformer)

__all__ = ["functional", "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedMultiTransformer"]

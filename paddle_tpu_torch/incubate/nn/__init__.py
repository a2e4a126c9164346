"""Incubating NN ops and layers (counterpart of
``paddle_tpu/incubate/nn``): the fused cache-KV attention functions in
``functional`` and the ``FusedMultiTransformer`` decoder stack.
``FusedMultiHeadAttention`` and ``FusedFeedForward`` are training layers
with attention dropout and are not ported (ROADMAP.md queue 1, item 1.3)."""
from . import functional  # noqa: F401
from .layer import FusedMultiTransformer  # noqa: F401

__all__ = ["functional", "FusedMultiTransformer"]

from .fused_transformer import FusedMultiTransformer  # noqa: F401

__all__ = ["FusedMultiTransformer"]

"""Fleet utilities (counterpart of
``paddle_tpu/distributed/fleet/utils/__init__.py``):
``sequence_parallel_utils`` (Megatron-style sequence parallelism) and
``recompute`` (activation recomputation). The hook-based helpers of the
reference reduce to markers ``ParallelEngine`` reads."""
from . import sequence_parallel_utils  # noqa: F401
from .recompute import recompute, recompute_sequential  # noqa: F401

__all__ = ["sequence_parallel_utils", "recompute", "recompute_sequential"]

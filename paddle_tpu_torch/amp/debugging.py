"""AMP accuracy debugging (counterpart of ``paddle_tpu/amp/debugging.py``;
reference: python/paddle/amp/debugging.py, and ``FLAGS_check_nan_inf``,
which scans every eager op's outputs).

The JAX package watches its one op chokepoint (``core/dispatch.py``,
``core/registry.py:175-192``). The port has none, so it watches two
places, and only while something asks it to:

- every aten op, through a ``TorchDispatchMode`` installed for the
  duration (allocations, whose outputs are not yet written, are left
  out);
- every hand-written kernel, through its counted wrapper's hook
  (``ops/kernels/__init__.py`` ``after_call``): a ctypes launch is
  invisible to a dispatch mode.

``collect_operator_stats`` counts calls by op name and by the dtype of
the op's first tensor argument, as the JAX observer does. The names are
aten's (``mm``, ``addmm``, ``native_layer_norm``, ...) and the kernel
wrappers' (``flash_attention_fwd``, ``fused_adam``, ...), not the JAX
package's Paddle op names (ROADMAP.md queue 3). ``FLAGS_check_nan_inf``
(set directly, or by ``enable_tensor_checker``) makes a non-finite
floating output raise ``FloatingPointError`` naming the op; nothing is
checked while a CUDA graph is being captured (the check reads the
values back). With both off neither hook is installed.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..core import flags as _flags
from ..ops import kernels as _kernels

__all__ = ["collect_operator_stats", "enable_operator_stats_collection",
           "disable_operator_stats_collection", "check_numerics",
           "TensorCheckerConfig", "enable_tensor_checker",
           "disable_tensor_checker", "DebugMode"]


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 4


_stats: Optional[Dict[str, Dict[str, int]]] = None
_checking = False
_mode: Optional[TorchDispatchMode] = None

# aten ops that allocate without writing: their outputs are not values yet
_ALLOCATING = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided")


def _tensors(tree):
    return [t for t in _pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _observe(name: str, args, out) -> None:
    """Count ``name`` under its first tensor argument's dtype, then check
    ``out``'s floating tensors."""
    if _stats is not None:
        first = _tensors(args)
        dt = str(first[0].dtype).replace("torch.", "") if first else "other"
        _stats[name][dt] += 1
    if not _checking:
        return
    for t in _tensors(out):
        if (not t.is_floating_point() or t.layout != torch.strided
                or t.device.type == "meta"):
            continue
        if t.is_cuda and torch.cuda.is_current_stream_capturing():
            return
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"NaN/Inf detected in output of op '{name}'")


class _Watch(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name not in _ALLOCATING:
            _observe(name, args, out)
        return out


def _reinstall() -> None:
    """Install both hooks while stats or the checker are on; remove them
    once neither is."""
    global _mode
    on = _stats is not None or _checking
    if on and _mode is None:
        _mode = _Watch()
        _mode.__enter__()
        _kernels.after_call = _observe
    elif not on and _mode is not None:
        _mode.__exit__(None, None, None)
        _mode = None
        _kernels.after_call = None


def _install_checker(on: bool) -> None:
    """``FLAGS_check_nan_inf``'s effect (``core/flags.py`` calls it)."""
    global _checking
    _checking = on
    _reinstall()


def enable_operator_stats_collection():
    """Start counting ops by name and dtype (reference debugging.py
    enable_operator_stats_collection)."""
    global _stats
    _stats = defaultdict(lambda: defaultdict(int))
    _reinstall()


def disable_operator_stats_collection():
    """Stop counting; print the table (op, dtype, calls) and return the
    counts, ``{op: {dtype: calls}}``."""
    global _stats
    stats, _stats = _stats, None
    _reinstall()
    if stats:
        print(f"{'op':<32} {'dtype':<12} {'calls':>8}")
        for op, by_dt in sorted(stats.items()):
            for dt, n in sorted(by_dt.items()):
                print(f"{op:<32} {dt:<12} {n:>8}")
    return stats


@contextlib.contextmanager
def collect_operator_stats():
    """(reference debugging.py collect_operator_stats context)."""
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def check_numerics(tensor, op_type: str = "", var_name: str = "",
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT):
    """(NaN count, Inf count, the rest) of a tensor, as the JAX function
    counts them (a non-floating tensor: (0, 0, its size); an empty one
    counts as size 1, as there); the abort mode raises
    ``FloatingPointError`` on any NaN or Inf."""
    t = torch.as_tensor(tensor)
    n = int(np.prod(tuple(t.shape)) or 1)
    if not t.is_floating_point():
        return 0, 0, n
    n_nan = int(torch.isnan(t).sum())
    n_inf = int(torch.isinf(t).sum())
    if debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT and (n_nan or n_inf):
        raise FloatingPointError(
            f"check_numerics: {op_type or '<tensor>'} {var_name} has "
            f"{n_nan} NaN and {n_inf} Inf values")
    return n_nan, n_inf, n - n_nan - n_inf


class TensorCheckerConfig:
    """(reference debugging.py TensorCheckerConfig). As in the JAX
    package, ``enable`` decides and the other fields are kept: every
    non-finite output raises."""

    def __init__(self, enable: bool = True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.checked_op_list = checked_op_list
        self.skipped_op_list = skipped_op_list


def enable_tensor_checker(checker_config: TensorCheckerConfig):
    """Turn on the scan of every op's outputs (``FLAGS_check_nan_inf``)."""
    if checker_config.enable:
        _flags.set_flags({"FLAGS_check_nan_inf": True})


def disable_tensor_checker():
    _flags.set_flags({"FLAGS_check_nan_inf": False})

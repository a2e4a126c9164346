"""Hand-written Hopper kernels of the port (counterpart of
``paddle_tpu/ops/pallas``).

Every kernel module holds three things: the wrapper a model calls, the
plain PyTorch version of the same function, and a launch counter on the
wrapper. The wrapper checks device, dtype, shape and contiguity and
raises on anything the kernel does not take. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises. Nothing
falls back.

This module holds the checks the wrappers share, the ctypes argument
helpers and the registry of launch counters; ``_build.py`` builds and
loads the libraries.

``amp/debugging.py`` watches the kernels through ``counted``'s
wrapper: its ctypes launches are invisible to a torch dispatch mode, so
with operator stats or ``FLAGS_check_nan_inf`` on it sets ``after_call``,
which the wrapper calls with the kernel's name, arguments and result.
Off, ``after_call`` is None and the wrapper only tests it: one Python
frame and one test a kernel call (``chip_smoke.py`` times it).

A ``LaunchCounter`` counts a variant of a kernel (K1's launches that
carry the per-sequence frontiers) that has no entry point of its own:
the kernel's wrapper adds one to it beside its own counter.

A CUDA graph replay does not run the wrappers, so their counters would
miss its launches. ``recording_launches`` records what a capture counted
(and takes it back off the counters: a capture launches nothing), and
``add_launches`` adds the record once for every replay.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, Dict, Iterator, List, Optional

import torch

__all__ = ["DTYPE_CODES", "LaunchCounter", "add_launches", "counted",
           "dtype_code", "hooked", "launch_counts", "ptr",
           "recording_launches", "route", "stream", "want_contiguous"]

# every launch counter (kernel wrappers and LaunchCounters), in
# registration order
_COUNTED: List = []

# amp.debugging's hook: called as after_call(name, args, result) after
# every counted wrapper returns, or None
after_call: Optional[Callable] = None


def hooked(fn: Callable) -> Callable:
    """``fn`` wrapped for ``after_call`` (``counted``'s wrapper, not
    registered)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        if after_call is not None:
            after_call(wrapper.__name__, args, out)
        return out

    return wrapper


def counted(fn: Callable) -> Callable:
    """The kernel wrapper ``fn`` wrapped for ``after_call``, with its
    counter ``.launches`` (which ``fn`` adds one to, through its module's
    name for it, where it launches its kernel and nowhere else), entered
    in the registry. Its module rebinds the name: ``f = counted(f)``."""
    wrapper = hooked(fn)
    wrapper.launches = 0
    _COUNTED.append(wrapper)
    return wrapper


class LaunchCounter:
    """A registered counter ``.launches`` named ``name``, for a variant
    of a kernel that its kernel's wrapper launches."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0
        _COUNTED.append(self)

    def __repr__(self):
        return f"LaunchCounter({self.__name__!r})"


def launch_counts() -> Dict:
    """Every registered counter, by its wrapper or ``LaunchCounter``."""
    return {fn: fn.launches for fn in _COUNTED}


@contextlib.contextmanager
def recording_launches() -> Iterator[Dict]:
    """Record, by wrapper, the launches counted inside the block, and
    restore the counters on exit (a CUDA graph capture records launches
    without running them). The record holds only non-zero deltas."""
    before = launch_counts()
    record: Dict = {}
    try:
        yield record
    finally:
        for fn, n in before.items():
            if fn.launches != n:
                record[fn] = fn.launches - n
                fn.launches = n


def add_launches(record: Dict) -> None:
    """Add a recorded step's launches to the counters: one replay."""
    for fn, n in record.items():
        fn.launches += n

# the dtype codes the C entry points switch on
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def route(*tensors: torch.Tensor) -> str:
    """"cpu" or "cuda": the device type every tensor lies on. Mixed
    devices, or any other device type, raise."""
    dev = {t.device for t in tensors}
    if len(dev) != 1:
        raise ValueError(f"kernel inputs on several devices: {sorted(map(str, dev))}")
    kind = next(iter(dev)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"kernel inputs on unsupported device {kind!r}")
    return kind


def dtype_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        "(float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]


def want_contiguous(t: torch.Tensor, name: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (shape "
                         f"{tuple(t.shape)}, strides {t.stride()})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device: kernels launch there
    and never synchronise."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)

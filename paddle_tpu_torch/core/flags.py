"""Global FLAGS registry with environment override (counterpart of
``paddle_tpu/core/flags.py``, exported as ``paddle_tpu_torch.set_flags``
and ``get_flags`` like ``paddle.set_flags`` / ``paddle.get_flags``).

The same registry and the same nine flags with the same defaults. Flags
are process-global and typed; a ``FLAGS_<name>`` environment variable
overrides the default when the flag is defined; names may carry the
``FLAGS_`` prefix; bools take "1", "true", "yes" and "on" (any case);
an unknown name raises ``ValueError``.

The port reads two flags: ``use_autotune`` (the measured K1 tile
search, ``ops/kernels/autotune.py``) and ``check_nan_inf`` (setting it
installs ``amp/debugging.py``'s scan of every op's floating outputs:
aten ops through a dispatch mode, the kernels through their counted
wrappers; a non-finite value raises ``FloatingPointError`` naming the
op). Every other flag names the ROADMAP.md item
that would make the port read it, and setting it to anything but its
default, by ``set_flags`` or by the environment, raises
``NotImplementedError``: no flag is accepted and then ignored.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterable, Optional, Union

__all__ = ["define_flag", "set_flags", "get_flags", "flag_defined"]

_lock = threading.Lock()


class _Flag:
    __slots__ = ("name", "value", "default", "dtype", "doc", "todo")

    def __init__(self, name: str, default: Any, doc: str,
                 todo: Optional[str] = None):
        self.name = name
        self.default = default
        self.dtype = type(default)
        self.doc = doc
        self.todo = todo
        self.value = self.checked(self._from_env(default))

    def _from_env(self, default: Any) -> Any:
        env = os.environ.get("FLAGS_" + self.name)
        if env is None:
            return default
        return _coerce(env, self.dtype)

    def checked(self, value: Any) -> Any:
        """``value``, or NotImplementedError for a flag the port does not
        read yet set to anything but its default."""
        if self.todo is not None and value != self.default:
            raise NotImplementedError(
                f"FLAGS_{self.name}={value!r}: paddle_tpu_torch does not "
                f"read this flag yet ({self.todo}); only its default "
                f"{self.default!r} is accepted")
        return value


def _coerce(value: Any, dtype: type) -> Any:
    if dtype is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    return dtype(value)


_REGISTRY: Dict[str, _Flag] = {}


def define_flag(name: str, default: Any, doc: str = "",
                todo: Optional[str] = None) -> None:
    """Define a global flag. ``todo`` names where the port's reading of
    the flag is queued; such a flag takes only its default."""
    with _lock:
        if name in _REGISTRY:
            raise ValueError(f"flag '{name}' already defined")
        _REGISTRY[name] = _Flag(name, default, doc, todo)


def flag_defined(name: str) -> bool:
    return name in _REGISTRY


def set_flags(flags: Dict[str, Any]) -> None:
    """Set flag values at runtime. Accepts both bare names and
    ``FLAGS_``-prefixed names."""
    with _lock:
        for key, value in flags.items():
            name = key[6:] if key.startswith("FLAGS_") else key
            flag = _REGISTRY.get(name)
            if flag is None:
                raise ValueError(f"unknown flag '{key}'")
            flag.value = flag.checked(_coerce(value, flag.dtype))
            if name == "check_nan_inf":
                _check_nan_inf_set(flag.value)


def get_flags(flags: Union[str, Iterable[str]]) -> Dict[str, Any]:
    """Read flag values, keyed as asked."""
    if isinstance(flags, str):
        flags = [flags]
    out: Dict[str, Any] = {}
    for key in flags:
        name = key[6:] if key.startswith("FLAGS_") else key
        flag = _REGISTRY.get(name)
        if flag is None:
            raise ValueError(f"unknown flag '{key}'")
        out[key] = flag.value
    return out


def _get(name: str, default: Any = None) -> Any:
    flag = _REGISTRY.get(name)
    return flag.value if flag is not None else default


def _check_nan_inf_set(value: bool) -> None:
    """FLAGS_check_nan_inf's effect: amp.debugging's hooks in or out."""
    from ..amp import debugging
    debugging._install_checker(bool(value))


# ---------------------------------------------------------------------------
# The JAX package's nine flags, same names and defaults.
# ---------------------------------------------------------------------------
_ITEM2_2 = ("ROADMAP.md queue 1, item 2.2: the Paddle Tensor and op-dispatch "
            "scaffold")
_ITEM11 = "ROADMAP.md queue 1, item 11: watchdog.py"

define_flag("check_nan_inf", False, "Scan outputs of every eager op for "
            "NaN/Inf.")
define_flag("benchmark", False, "Block on each eager op for timing "
            "accuracy.", _ITEM2_2)
define_flag("eager_op_jit_cache", True, "Cache per-op jitted executables "
            "keyed by op+attrs.", _ITEM2_2)
define_flag("use_pallas_kernels", True, "Use the hand-written kernels for "
            "fused hot ops. The port has no path around them on the card.",
            _ITEM2_2)
define_flag("use_autotune", False, "Measured K1 tile (block_q, block_kv) "
            "selection with a persistent algorithm cache (one search per "
            "new shape, card and K1 build).")
define_flag("allocator_strategy", "xla", "Memory management owner (the "
            "port leaves it to PyTorch's caching allocator).", _ITEM2_2)
define_flag("collective_timeout_s", 1800.0, "Watchdog timeout for in-flight "
            "collectives.", _ITEM11)
define_flag("enable_async_trace", False, "Enable collective watchdog "
            "tracing.", _ITEM11)
define_flag("tpu_matmul_precision", "default", "Default matmul precision "
            "(default|high|highest).", _ITEM2_2)

if _get("check_nan_inf"):       # set from the environment
    _check_nan_inf_set(True)

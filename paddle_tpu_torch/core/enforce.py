"""``enforce`` and the error it raises (counterpart of
``paddle_tpu/core/enforce.py``, which also carries the full typed-error
taxonomy; the port needs only this pair so far)."""
from __future__ import annotations

__all__ = ["PreconditionNotMetError", "enforce"]


class PreconditionNotMetError(RuntimeError):
    """A precondition of an API call does not hold."""


def enforce(cond: bool, msg, err: type = PreconditionNotMetError) -> None:
    """Raise ``err(msg)`` unless ``cond``; ``msg`` may be a zero-arg
    callable, evaluated only on failure."""
    if not cond:
        raise err(msg() if callable(msg) else msg)

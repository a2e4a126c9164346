"""``save`` / ``load`` (counterpart of ``paddle_tpu/framework/io.py``;
reference: python/paddle/framework/io.py:721, 960).

The file format is the JAX package's: a pickle at protocol 4 of the
object with every tensor replaced by a marker dict ``{"__paddle_tpu_tensor__":
True, "data": <numpy array>, "stop_gradient": bool, "name": str}``; numpy
arrays, dicts, lists and tuples of them and plain values are pickled as
they are. A file either package writes loads in the other.

bfloat16. numpy has no bf16 type; the JAX package's arrays are
``ml_dtypes.bfloat16`` and pickle as a reference to that type.
``save`` writes that stream itself from the tensor's bits (a pickler that
names ``ml_dtypes.bfloat16`` without importing it: byte for byte what the
JAX package writes), so it never needs ``ml_dtypes`` and never upcasts.
``load`` reads such a file with or without ``ml_dtypes``: without it, the
reference resolves to a stand-in and the array comes back as its 2-byte
bit images (numpy ``|V2``), which become a ``torch.bfloat16`` tensor.
``load(..., return_numpy=True)`` gives numpy arrays as the JAX package
does; a bf16 array then needs ``ml_dtypes``, and without it ``load``
raises naming the module.

Tensors load onto the CUDA device unless ``device`` names another, as
every entry point of the port does (with no card, the default raises).

A tensor saved from the mapping ``nn.Module.state_dict()`` returns (torch's
``OrderedDict`` with ``_metadata``) carries ``"layout": "torch"`` in its
marker dict: its ``nn.Linear`` weights are ``[out, in]``, where the JAX
package's are ``[in, out]``. The JAX package ignores the key; the port's
predictor refuses such a file (``inference.Config(params_file=...)``
loads the JAX layout: write it with ``save(export_jax_state_dict(model),
path)``).
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load", "load_state"]

_PROTOCOL = 4
_MARK = "__paddle_tpu_tensor__"
# numpy's own reconstructor of a pickled array (numpy._core.multiarray.
# _reconstruct, or numpy.core.multiarray's under numpy 1.x)
_RECONSTRUCT = np.zeros(0).__reduce__()[0]


class _MlDtypesBfloat16:
    """Stands for the global ``ml_dtypes.bfloat16`` in a pickle (written
    by ``_Pickler.save_global``, read back by ``_Unpickler.find_class``
    where ``ml_dtypes`` is missing)."""


class _Bf16Dtype:
    """Pickles as numpy pickles ``np.dtype(ml_dtypes.bfloat16)``."""

    def __reduce__(self):
        return (np.dtype, (_MlDtypesBfloat16, False, True),
                (3, "<", None, None, None, 2, 2, 64))


_BF16_DTYPE = _Bf16Dtype()


class _Bf16Array:
    """A bf16 tensor's bits, pickled as numpy pickles an
    ``ml_dtypes.bfloat16`` array of that shape."""

    def __init__(self, t: torch.Tensor):
        self.shape = tuple(int(n) for n in t.shape)
        self.raw = t.detach().cpu().contiguous().view(torch.int16).numpy() \
            .tobytes()

    def __reduce__(self):
        return (_RECONSTRUCT, (np.ndarray, (0,), b"b"),
                (1, self.shape, _BF16_DTYPE, False, self.raw))


class _Pickler(pickle._Pickler):
    """The pure-Python pickler (it writes the C pickler's bytes), naming
    ``ml_dtypes.bfloat16`` without importing it."""

    def save_global(self, obj, name=None):
        if obj is _MlDtypesBfloat16:
            self.save("ml_dtypes")
            self.save("bfloat16")
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def _have_ml_dtypes() -> bool:
    try:
        import ml_dtypes  # noqa: F401
    except ImportError:
        return False
    return True


class _Unpickler(pickle.Unpickler):
    """Reads ``ml_dtypes.bfloat16`` arrays without ``ml_dtypes`` as their
    bit images (``|V2``)."""

    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _MlDtypesBfloat16
        if (module, name) == ("numpy", "dtype"):
            return _dtype
        return super().find_class(module, name)


def _dtype(obj, *args):
    return np.dtype("V2") if obj is _MlDtypesBfloat16 else np.dtype(obj, *args)


def _tensor_data(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return _Bf16Array(t)
    return t.detach().cpu().numpy()


def _to_serializable(obj: Any, torch_layout: bool = False) -> Any:
    if isinstance(obj, torch.Tensor):
        out = {_MARK: True, "data": _tensor_data(obj),
               "stop_gradient": not obj.requires_grad,
               "name": getattr(obj, "name", "") or ""}
        if torch_layout:
            out["layout"] = "torch"
        return out
    if isinstance(obj, dict):
        # nn.Module.state_dict() returns torch's OrderedDict with _metadata
        inner = torch_layout or hasattr(obj, "_metadata")
        return {k: _to_serializable(v, inner) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_serializable(v, torch_layout) for v in obj)
    return obj


def _is_bf16(arr) -> bool:
    return isinstance(arr, np.ndarray) and (
        arr.dtype == np.dtype("V2") or str(arr.dtype) == "bfloat16")


def _as_tensor(arr: np.ndarray, device) -> torch.Tensor:
    if _is_bf16(arr):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device)


def _from_serializable(obj: Any, return_numpy: bool, device) -> Any:
    if isinstance(obj, dict):
        if obj.get(_MARK):
            data = obj["data"]
            if return_numpy:
                if data.dtype == np.dtype("V2"):
                    raise ModuleNotFoundError(
                        "load(return_numpy=True): the file holds bfloat16 "
                        "arrays, which numpy holds only through ml_dtypes "
                        "(not installed); load them as tensors "
                        "(return_numpy=False)")
                return data
            t = _as_tensor(data, device)
            t.requires_grad_(not obj.get("stop_gradient", True)
                             and t.is_floating_point())
            return t
        return {k: _from_serializable(v, return_numpy, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_serializable(v, return_numpy, device)
                         for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = _PROTOCOL) -> None:
    """Pickle ``obj`` to ``path`` in the JAX package's format (module
    docstring); tensors are copied to the host."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f, protocol=protocol).dump(_to_serializable(obj))


def _read(path: str) -> Any:
    with open(path, "rb") as f:
        if _have_ml_dtypes():
            return pickle.load(f)
        return _Unpickler(f).load()


def load(path: str, return_numpy: bool = False, device=None) -> Any:
    """The object ``save`` (of either package) wrote to ``path``: marker
    dicts become tensors on ``device`` (CUDA unless named), or numpy
    arrays with ``return_numpy``."""
    from ..models.llama import resolve_device

    obj = _read(path)
    dev = None if return_numpy else resolve_device(device)
    return _from_serializable(obj, return_numpy, dev)


def load_state(path: str):
    """``(state, torch_layout)`` of a saved state dict, for loading into
    a model: ``state`` maps names to numpy arrays, with bf16 ones as
    ``torch.bfloat16`` CPU tensors (numpy cannot hold them without
    ``ml_dtypes``); ``torch_layout`` is True when any tensor of the file
    carries the port's ``"layout": "torch"`` mark."""
    obj = _read(path)
    if not isinstance(obj, dict):
        raise TypeError(f"{path}: a state dict file holds a dict, got "
                        f"{type(obj).__name__}")
    state, torch_layout = {}, False
    for k, v in obj.items():
        if isinstance(v, dict) and v.get(_MARK):
            torch_layout |= v.get("layout") == "torch"
            v = v["data"]
        state[k] = _as_tensor(v, "cpu") if _is_bf16(v) else v
    return state, torch_layout

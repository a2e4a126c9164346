"""Weight-only quantization for serving (counterpart of
``paddle_tpu/nn/quant.py``; reference: python/paddle/nn/quant/
quantized_linear.py).

Decode is bound by the bytes of the weights it reads, so serving stores
the projections' weights int8 (or int4, two a byte) and reads those
bytes, never a dequantized copy: ``weight_only_linear`` runs kernel K9
(``ops/kernels/weight_only_linear.py``) on CUDA tensors and its plain
version on CPU tensors. The per-output-channel scale multiplies the f32
sum of ``x`` times the integer weights, then the bias adds, then one
rounding to ``x``'s dtype, as in the JAX function.

Layouts as in the JAX package: ``weight_quantize`` takes ``[in, out]``
and returns ``q`` int8 ``[out, in]`` (int4: ``[out, in // 2]``, the even
input column in the low nibble) and ``scale`` f32 ``[out]``, bit for bit
the JAX values. ``WeightOnlyLinear`` quantizes ``inner.weight.T``: the
port's linears hold ``[out, in]``.

``llm_int8_linear`` is LLM.int8's outlier decomposition (the JAX
function's steps and roundings): kernel K10
(``ops/kernels/llm_int8_linear.py``) on CUDA tensors, its plain version on
CPU tensors.
"""
from __future__ import annotations

import warnings

import torch
from torch import nn

from ..core.enforce import enforce
from ..ops.kernels.llm_int8_linear import llm_int8_linear as k10_linear
from ..ops.kernels.weight_only_linear import unpack_int4 as _unpack_int4
from ..ops.kernels.weight_only_linear import weight_only_linear as k9_linear

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "llm_int8_linear", "WeightOnlyLinear", "quantize_for_serving"]

_ALGOS = ("weight_only_int8", "weight_only_int4", "llm.int8")
_DTYPES = {"float16": torch.float16, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


@torch.no_grad()
def weight_quantize(x: torch.Tensor, algo: str = "weight_only_int8",
                    arch=None, group_size: int = -1):
    """Per-output-channel symmetric quantization of a ``[in, out]``
    weight: ``scale = max|w| / qmax`` per output column, ``q =
    clip(round(w / max(scale, 1e-10)), -qmax, qmax)`` (round half to
    even), qmax 127 or 7. Returns ``(q [out, in] int8, scale f32
    [out])``; int4 packs two values a byte, ``[out, in // 2]``."""
    enforce(algo in _ALGOS, lambda: f"algo must be one of {_ALGOS}")
    _no_groups(group_size)
    w = x.detach().float().T                   # [out, in]
    bits = 4 if algo == "weight_only_int4" else 8
    qmax = float(2 ** (bits - 1) - 1)
    amax = torch.amax(torch.abs(w), dim=1)
    # a tensor divisor: CUDA divides by a host scalar as a product with
    # its reciprocal, which rounds twice and would miss JAX's bits
    scale = amax / torch.full_like(amax, qmax)
    q = torch.round(w / torch.clamp(scale, min=1e-10)[:, None])
    q = torch.clamp(q, -qmax, qmax).to(torch.int8)
    if bits == 4:
        enforce(q.shape[1] % 2 == 0,
                lambda: "int4 needs an even input dimension")
        lo = q[:, 0::2] & 0x0F                 # low nibble
        hi = (q[:, 1::2] & 0x0F) << 4          # high nibble (wraps in int8)
        q = lo | hi                            # [out, in // 2]
    return q.contiguous(), scale.contiguous()


@torch.no_grad()
def weight_dequantize(x: torch.Tensor, scale: torch.Tensor,
                      algo: str = "weight_only_int8",
                      out_dtype: str = "float16",
                      group_size: int = -1) -> torch.Tensor:
    """Inverse of ``weight_quantize``: back to ``[in, out]`` float."""
    enforce(algo in _ALGOS, lambda: f"algo must be one of {_ALGOS}")
    _no_groups(group_size)
    q = _unpack_int4(x) if algo == "weight_only_int4" else x
    w = q.float() * scale[:, None]
    return w.T.to(_DTYPES[str(out_dtype)])


def _no_groups(group_size: int) -> None:
    # the JAX package accepts group_size and quantizes per channel
    # whatever it says; the port refuses (ROADMAP.md, reference-side
    # divergences)
    if group_size != -1:
        raise NotImplementedError(
            f"group_size={group_size}: grouped weight-only quantization is "
            "not implemented (per-output-channel scales only; the JAX "
            "package ignores the argument, ROADMAP.md reference-side "
            "divergences)")


@torch.no_grad()
def weight_only_linear(x: torch.Tensor, weight: torch.Tensor,
                       bias=None, weight_scale=None,
                       weight_dtype: str = "int8", arch=None,
                       group_size: int = -1) -> torch.Tensor:
    """``y = x @ dequant(weight).T + bias`` over int8 / int4 weights
    ``[out, in]`` (int4 packed), kernel K9 on the card. ``arch`` is
    accepted and ignored, as in the JAX package."""
    _no_groups(group_size)
    enforce(weight_dtype in ("int8", "int4"),
            lambda: f"weight_dtype must be int8 or int4, got "
                    f"{weight_dtype!r}")
    return k9_linear(x, weight, weight_scale, bias, weight_dtype == "int4")


@torch.no_grad()
def llm_int8_linear(x: torch.Tensor, weight: torch.Tensor, bias=None,
                    weight_scale=None,
                    threshold: float = 6.0) -> torch.Tensor:
    """LLM.int8's linear over an int8 ``weight`` [out, in] and its f32
    ``weight_scale`` (``weight_quantize(w, "llm.int8")``): the input
    columns whose absmax over all rows exceeds ``threshold`` multiply the
    dequantized weight in f32, the rest run as int8 x int8 -> int32 with
    per-row scales; kernel K10 on the card. Inference only, as in the JAX
    package."""
    return k10_linear(x, weight, weight_scale, bias, threshold)


class WeightOnlyLinear(nn.Module):
    """Serving linear with int8 / int4 weights (the module form of
    ``weight_only_linear``; what ``quantize_for_serving`` swaps in). The
    quantized weight and the scale are parameters that do not require
    grad, so the structured names (``weight_quant``, ``weight_scale``)
    equal the JAX model's; ``inner.bias`` is kept. The input is not
    cast under ``amp.auto_cast``: the JAX op sits outside the AMP hook."""

    def __init__(self, inner: nn.Module, algo: str = "weight_only_int8"):
        super().__init__()
        enforce(algo in ("weight_only_int8", "weight_only_int4"),
                lambda: f"unsupported algo {algo!r}")
        self.algo = algo
        self.weight_dtype = "int4" if algo.endswith("int4") else "int8"
        q, s = weight_quantize(inner.weight.T, algo)
        self.weight_quant = nn.Parameter(q, requires_grad=False)
        self.weight_scale = nn.Parameter(s, requires_grad=False)
        self.register_parameter("bias", inner.bias)
        self.in_features = inner.weight.shape[1]
        self.out_features = inner.weight.shape[0]

    def forward(self, x):
        return weight_only_linear(x, self.weight_quant, self.bias,
                                  self.weight_scale, self.weight_dtype)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, algo={self.algo}")


def _swappable(sub: nn.Module) -> bool:
    # the port's Column/RowParallelLinear are nn.Linears at degree 1
    return isinstance(sub, nn.Linear)


def quantize_for_serving(model: nn.Module, algo: str = "weight_only_int8",
                         skip=()) -> nn.Module:
    """Swap every linear of ``model`` (in place) for a
    ``WeightOnlyLinear``: ``nn.Linear`` and the port's
    ``ColumnParallelLinear`` / ``RowParallelLinear`` (degree 1). Names
    containing a ``skip`` fragment (e.g. the LM head) keep full
    precision, and so, with a warning, does a linear with an odd
    ``in_features`` under int4. Returns the model."""

    def swap(layer: nn.Module, prefix: str = "") -> None:
        for name, sub in list(layer.named_children()):
            full = f"{prefix}.{name}" if prefix else name
            if _swappable(sub) and not any(s in full for s in skip):
                if algo.endswith("int4") and sub.in_features % 2:
                    warnings.warn(
                        f"quantize_for_serving: {full} kept in full "
                        f"precision (odd in_features {sub.in_features} "
                        f"cannot pack int4 nibbles)", stacklevel=3)
                    continue
                setattr(layer, name, WeightOnlyLinear(sub, algo))
            else:
                swap(sub, full)

    swap(model)
    return model

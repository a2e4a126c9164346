"""Functional ops (counterpart of ``paddle_tpu/nn/functional.py``): the
hard-label cross entropy the Llama training step uses, and the layer
norm, exact GELU and Paddle-layout linear of the fused inference ops."""
from __future__ import annotations

import torch
from torch.nn import functional as _F

from ..amp import cast_inputs

__all__ = ["cross_entropy", "gelu", "layer_norm", "linear"]


def layer_norm(x, weight=None, bias=None, epsilon=1e-5, begin_norm_axis=-1):
    """Normalise over the axes from ``begin_norm_axis`` on, in x's dtype,
    with the JAX ``layer_norm``'s formula (ops/nn_ops.py:383): biased
    variance, ``(x - mean) * rsqrt(var + epsilon) * weight + bias``."""
    dims = tuple(range(begin_norm_axis % x.dim(), x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def gelu(x, approximate=False):
    """GELU, exact (erf) unless ``approximate`` (the tanh form), as
    ``jax.nn.gelu`` behind the JAX ``gelu`` (ops/nn_ops.py:58)."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def linear(x, weight, bias=None):
    """Paddle's linear: ``x @ weight + bias`` with weight ``[in, out]``;
    under ``amp.auto_cast`` its f32 inputs are cast to the AMP dtype
    (op ``linear``)."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    out = x @ weight
    return out if bias is None else out + bias


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  label_smoothing=0.0, use_softmax=True):
    """Softmax cross entropy with hard labels (the hard-label part of the
    JAX ``cross_entropy_loss``, ops/nn_ops.py:561): f32 log-softmax over
    ``axis`` whatever the logits' dtype, labels equal to
    ``ignore_index`` contribute 0, ``reduction`` "mean" divides by the
    count of the other labels (at least 1). Soft labels, class weights,
    label smoothing and ``use_softmax=False`` are not ported yet."""
    if soft_label or weight is not None or label_smoothing or not use_softmax:
        raise NotImplementedError(
            "cross_entropy: soft labels, class weights, label smoothing and "
            "use_softmax=False are not ported yet (ROADMAP.md queue 1, "
            "item 2)")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    ax = axis % input.dim()
    logp = torch.log_softmax(input.float(), dim=ax)
    lbl = label
    if lbl.dim() == input.dim():
        lbl = lbl.squeeze(ax)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl)).long()
    picked = torch.gather(logp, ax, safe.unsqueeze(ax)).squeeze(ax)
    loss = -picked * valid.float()
    if reduction == "mean":
        return loss.sum() / valid.float().sum().clamp_min(1.0)
    if reduction == "sum":
        return loss.sum()
    return loss

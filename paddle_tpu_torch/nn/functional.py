"""Functional losses (counterpart of ``paddle_tpu/nn/functional.py``;
the hard-label cross entropy the Llama training step uses)."""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


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

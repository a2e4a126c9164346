"""Weight-decay regularizers (counterpart of ``paddle_tpu/regularizer.py``).

An optimizer reads ``coeff`` and ``mode``: ``L2Decay`` adds
``coeff * p`` to the gradient (or, in AdamW, to the update), ``L1Decay``
the subgradient ``coeff * sign(p)``."""
from __future__ import annotations

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    mode = "l2"
    _coeff = 0.0

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(WeightDecayRegularizer):
    mode = "l1"


class L2Decay(WeightDecayRegularizer):
    mode = "l2"

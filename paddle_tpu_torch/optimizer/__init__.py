"""Optimizers (counterpart of ``paddle_tpu/optimizer/__init__.py``:
``Optimizer`` on its dense path, ``Adam`` and ``AdamW``).

The update math runs in f32 whatever the parameters' dtype: moments are
kept in ``state_dtype`` (f32 by default) and cast in and out, and with
``multi_precision`` a non-f32 parameter gets an f32 master copy that the
update reads and writes, the parameter receiving its rounded value. Where
the JAX step swapped each parameter's ``_value`` for a new array, the
port updates the parameters, moments and masters in place under
``torch.no_grad()``.

``grad_clip`` (``nn.clip.ClipGradByGlobalNorm``) clips the gradients in
place before the update; the global norm of the last step is kept as
``grad_norm``. Sparse (SelectedRows) gradients and LR schedulers are not
ported yet and raise.

``parameters`` takes parameters, as Paddle's optimizers do, or
``(name, parameter)`` pairs such as ``model.named_parameters()``: named
parameters key ``state_dict`` and reach ``apply_decay_param_fun`` by
their structured name, the others by ``param_{i}``, as the JAX package
keys unnamed parameters.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..nn.clip import ClipGradByGlobalNorm

__all__ = ["Optimizer", "Adam", "AdamW"]

_TODO = "not ported yet (ROADMAP.md queue 1, item 2)"


def _f32(x: float) -> float:
    """A Python float holding the f32 rounding of ``x``: the JAX update
    sees its scalars as f32."""
    return float(np.float32(x))


class Optimizer:
    """Base optimizer: dense per-parameter f32 updates."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None,
                 multi_precision: bool = False, state_dtype=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(f"LR schedulers are {_TODO}")
        self._lr = float(learning_rate)
        if parameters is None:
            raise ValueError("the port's optimizers need parameters=")
        named = []
        for i, item in enumerate(parameters):
            if isinstance(item, tuple):
                named.append(item)
            else:
                named.append((f"param_{i}", item))
        self._parameter_list = [p for _, p in named]
        self._names = {id(p): n for n, p in named}
        if grad_clip is not None and not isinstance(grad_clip,
                                                    ClipGradByGlobalNorm):
            raise NotImplementedError(
                f"grad_clip {type(grad_clip).__name__} is {_TODO}")
        self._grad_clip = grad_clip
        self._weight_decay = float(weight_decay or 0.0)
        self._multi_precision = bool(multi_precision)
        if isinstance(state_dtype, str):
            state_dtype = getattr(torch, state_dtype)
        self._state_dtype = state_dtype or torch.float32
        self._states: Dict[int, Dict[str, torch.Tensor]] = {}
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._step_count = 0
        self.grad_norm: Optional[torch.Tensor] = None

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        return self._lr

    def set_lr(self, value: float):
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler):
        raise NotImplementedError(f"LR schedulers are {_TODO}")

    # -- state -------------------------------------------------------------
    def _state_shapes(self):
        """Per-parameter state slot names."""
        return ()

    def _param_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        st = self._states.get(id(p))
        if st is None:
            st = {k: torch.zeros(p.shape, dtype=self._state_dtype,
                                 device=p.device)
                  for k in self._state_shapes()}
            if self._multi_precision and p.dtype != torch.float32:
                self._master_weights[id(p)] = p.detach().float().clone()
            self._states[id(p)] = st
        return st

    def _update_rule(self, p, pf, g, state, lr, step):
        """Update the f32 ``pf`` (and the f32 ``state``) in place."""
        raise NotImplementedError

    # -- the step ----------------------------------------------------------
    def _collect(self):
        return [p for p in self._parameter_list
                if p.grad is not None and p.requires_grad]

    @torch.no_grad()
    def step(self):
        params = self._collect()
        if not params:
            return
        for p in params:
            if p.grad.is_sparse:
                raise NotImplementedError(
                    f"sparse (SelectedRows) gradients are {_TODO}")
        self._step_count += 1
        grads = [p.grad for p in params]
        if self._grad_clip is not None:
            self.grad_norm = self._grad_clip.apply_(grads)
        lr = _f32(self.get_lr())
        for p, g in zip(params, grads):
            state = self._param_state(p)
            master = self._master_weights.get(id(p))
            pf = master if master is not None else (
                p if p.dtype == torch.float32 else p.float())
            st32 = {k: v.float() for k, v in state.items()}
            self._update_rule(p, pf, g.float(), st32, lr, self._step_count)
            if pf is not p:
                p.copy_(pf)
            for k, v in state.items():
                if v is not st32[k]:
                    v.copy_(st32[k])

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> Dict:
        """``step_count`` plus ``{key}.{slot}`` and ``{key}.master_weight``
        per parameter that has state; ``key`` is the structured name or
        ``param_{i}``."""
        out = {"step_count": self._step_count}
        for p in self._parameter_list:
            st = self._states.get(id(p))
            if st is None:
                continue
            key = self._names[id(p)]
            for k, v in st.items():
                out[f"{key}.{k}"] = v
            if id(p) in self._master_weights:
                out[f"{key}.master_weight"] = self._master_weights[id(p)]
        return out


class Adam(Optimizer):
    """Adam with L2 weight decay added to the gradient."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 state_dtype=None):
        if lazy_mode:
            raise NotImplementedError(
                f"lazy_mode (SelectedRows row updates) is {_TODO}")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, state_dtype)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._decoupled = False

    def _state_shapes(self):
        return ("moment1", "moment2")

    def _decays(self, p) -> bool:
        return bool(self._weight_decay)

    def _update_rule(self, p, pf, g, state, lr, step):
        b1, b2 = _f32(self._beta1), _f32(self._beta2)
        if self._decays(p) and not self._decoupled:
            g = g + self._weight_decay * pf
        m, v = state["moment1"], state["moment2"]
        m.mul_(b1).add_(g * _f32(1 - self._beta1))
        v.mul_(b2).add_(torch.square(g) * _f32(1 - self._beta2))
        t = np.float32(step)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + _f32(self._epsilon))
        if self._decays(p) and self._decoupled:
            upd = upd + self._weight_decay * pf
        pf.sub_(lr * upd)


class AdamW(Adam):
    """Adam with decoupled weight decay: ``p -= lr * (update + wd * p)``.
    ``apply_decay_param_fun(name)`` returning False exempts a parameter
    from the decay."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, state_dtype=None):
        if lr_ratio is not None:
            raise NotImplementedError(f"AdamW(lr_ratio=...) is {_TODO}")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         state_dtype)
        self._decoupled = True
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decays(self, p) -> bool:
        if not self._weight_decay:
            return False
        fun = self._apply_decay_param_fun
        return fun is None or bool(fun(self._names[id(p)]))

"""Optimizers (counterpart of ``paddle_tpu/optimizer/__init__.py``:
``Optimizer`` on its dense path and its twelve optimizers).

``step()`` collects the dense parameters and hands them all to
``_fused_update``, which clips and updates them together, as the JAX
package's one jitted multi-tensor update does. For ``Adam`` and
``AdamW`` that is kernel K8 on CUDA tensors (``ops/kernels/fused_adam.py``,
the global-norm clip and the AMP protocol folded in) and its plain
version on CPU tensors. Every other optimizer runs its ``_update_rule``
per parameter in torch on either device, as the JAX ``update_all`` runs
them under XLA; each rule is the JAX package's, with its dtypes: the
rule sees the f32 master (``multi_precision``) or the parameter in its
own dtype, the moments cast in to f32 from ``state_dtype`` and out
again. Where the JAX step swapped each parameter's ``_value`` for a new
array, the port updates parameters, masters and moments in place under
``torch.no_grad()``.

``learning_rate`` is a float or an ``lr.LRScheduler`` (``get_lr`` calls
it); ``weight_decay`` a float or an ``L1Decay`` / ``L2Decay``;
``grad_clip`` any ``nn.clip`` clip. ``grad_norm`` keeps the global norm
of the last step's gradients where the step computed one (a global-norm
clip, or a loss scaler).

``parameters`` takes parameters, as Paddle's optimizers do, or
``(name, parameter)`` pairs such as ``model.named_parameters()``: named
parameters key ``state_dict`` and reach ``apply_decay_param_fun`` by
their structured name, the others by ``param_{i}``, as the JAX package
keys unnamed parameters.

Sparse gradients (the sparse COO ``.grad`` that ``Embedding(sparse=True)``
leaves) take the JAX step's sparse path (``optimizer/__init__.py:110-175``
there): each is merged into a ``SelectedRows``; a global-norm clip counts
them into the one norm and scales their values by the same coefficient
(per-tensor clips leave them alone, as there); then SGD, and Adam / AdamW
with ``lazy_mode=True``, update only the touched rows (and their f32
masters) by index on the device, and every other optimizer, lazy-less
Adam / AdamW included, densifies the gradient and updates it with the
dense parameters (K8 for Adam / AdamW on CUDA). A loss scaler with sparse
gradients raises (the JAX step has no such path).

Under tensor parallelism ``ParallelEngine`` hands the optimizer a
``nn.clip.GradSync`` (``_grad_sync``): every clip norm and the global
norm are then the norm over the model-parallel group (the shards'
squared sums all-reduced, the replicated gradients once), and a loss
scaler's overflow flag is maxed over every rank; K8 takes the split
reduce of ``ops/kernels/fused_adam.py``. Sparse gradients under it
raise (ROADMAP.md queue 1, item 8.2).

Not ported, and raising: AdamW's ``lr_ratio`` and Lamb's
``exclude_from_weight_decay_fn`` (both stored and never read by the JAX
package).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..framework.selected_rows import SelectedRows, merge_selected_rows
from ..nn.clip import (ClipGradBase, ClipGradByGlobalNorm, GradSync,
                       global_norm)
from ..ops.kernels.fused_adam import bias_correction, fused_adam
from . import lr
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "LarsMomentum", "Adam", "AdamW",
           "Adagrad", "Adadelta", "Adamax", "ASGD", "Rprop", "RMSProp",
           "Lamb", "lr"]


def _f32(x: float) -> float:
    """A Python float holding the f32 rounding of ``x``: the JAX update
    sees its scalars as f32."""
    return float(np.float32(x))


class Optimizer:
    """Base optimizer: dense multi-tensor updates."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision: bool = False, state_dtype=None):
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (int, float, LRScheduler)):
            raise TypeError(
                f"learning_rate must be a float or an "
                f"optimizer.lr.LRScheduler, got {type(learning_rate).__name__}")
        self._lr = (learning_rate if isinstance(learning_rate, LRScheduler)
                    else float(learning_rate))
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
        if grad_clip is not None and not isinstance(grad_clip, ClipGradBase):
            raise TypeError(f"grad_clip must be an nn.clip clip, got "
                            f"{type(grad_clip).__name__}")
        self._grad_clip = grad_clip
        if weight_decay is None or isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay or 0.0)
            self._wd_mode = "l2"
        else:  # L1Decay / L2Decay: a coeff and a mode
            self._weight_decay = float(getattr(
                weight_decay, "_coeff", getattr(weight_decay, "coeff", 0.0)))
            self._wd_mode = getattr(weight_decay, "mode", "l2")
        self._multi_precision = bool(multi_precision)
        if isinstance(state_dtype, str):
            state_dtype = getattr(torch, state_dtype)
        self._state_dtype = state_dtype or torch.float32
        self._states: Dict[int, Dict[str, torch.Tensor]] = {}
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._step_count = 0
        self.grad_norm: Optional[torch.Tensor] = None
        # set by ParallelEngine over a tensor-parallel mesh
        self._grad_sync: Optional[GradSync] = None

    def _decay_term(self, pf):
        """Weight-decay gradient term: wd*p for L2Decay, wd*sign(p) (the
        L1 subgradient) for L1Decay."""
        wd = _f32(self._weight_decay)
        if self._wd_mode == "l1":
            return wd * torch.sign(pf)
        return wd * pf

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return float(self._lr)

    def set_lr(self, value: float):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler: LRScheduler):
        if not isinstance(scheduler, LRScheduler):
            raise TypeError(f"set_lr_scheduler takes an LRScheduler, got "
                            f"{type(scheduler).__name__}")
        self._lr = scheduler

    # -- state -------------------------------------------------------------
    def _state_shapes(self):
        """Per-parameter state slot names."""
        return ()

    def _new_master(self, p):
        if self._multi_precision and p.dtype != torch.float32:
            self._master_weights[id(p)] = p.detach().float().clone()

    def _param_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        st = self._states.get(id(p))
        if st is None:
            st = {k: torch.zeros(p.shape, dtype=self._state_dtype,
                                 device=p.device)
                  for k in self._state_shapes()}
            self._new_master(p)
            self._states[id(p)] = st
        return st

    def _update_rule(self, p, g, state, lr, step):
        """Pure, as in the JAX package: ``p`` is the f32 master or the
        parameter in its dtype, ``g`` the gradient in its dtype, ``state``
        the f32 slots, ``lr`` an f32 value, ``step`` the bias-correction
        step (an int, or an int tensor under a loss scaler). Returns
        (new p, new state)."""
        raise NotImplementedError

    # -- the step ----------------------------------------------------------
    def _collect(self):
        return [p for p in self._parameter_list
                if p.grad is not None and p.requires_grad]

    @torch.no_grad()
    def step(self, amp=None):
        """One update of every parameter that has a gradient. ``amp`` (an
        ``amp.AmpStep``) is the engine's loss-scaler state: gradients are
        then unscaled, an overflow step writes nothing, and the scaler's
        state advances on the device."""
        params = self._collect()
        if not params:
            return
        sparse = [p for p in params if p.grad.is_sparse]
        if sparse and amp is not None:
            raise NotImplementedError(
                "a loss scaler with sparse (SelectedRows) gradients: the JAX "
                "step has no such path")
        if sparse and self._grad_sync is not None:
            raise NotImplementedError(
                "sparse (SelectedRows) gradients under tensor parallelism "
                "are not ported yet: ROADMAP.md queue 1, item 8.2")
        self._step_count += 1
        lr_v = _f32(self.get_lr())
        if sparse:
            self.grad_norm = self._sparse_step(params, lr_v)
            return
        self.grad_norm = self._update(params, [p.grad for p in params], lr_v,
                                      amp)

    def _update(self, params, grads, lr, amp=None, clipped=False):
        """``_fused_update`` of ``params`` with their states and masters."""
        states = [self._param_state(p) for p in params]
        masters = [self._master_weights.get(id(p)) for p in params]
        return self._fused_update(params, grads, states, masters, lr,
                                  self._step_count, amp, clipped)

    def _sparse_step(self, params, lr) -> Optional[torch.Tensor]:
        """The step with sparse gradients (module docstring): the clip in
        torch over dense and merged sparse gradients together, the row
        updates, then the dense update of the rest, clip done."""
        dense = [p for p in params if not p.grad.is_sparse]
        grads = [p.grad for p in dense]
        merged = [(p, merge_selected_rows(SelectedRows.from_coo(p.grad)))
                  for p in params if p.grad.is_sparse]
        clip, norm = self._grad_clip, None
        if isinstance(clip, ClipGradByGlobalNorm):
            sparse_sq = sum(torch.sum(torch.square(sr.values.float()))
                            for _, sr in merged)
            grads, norm = clip.apply_values(grads, extra_sq=sparse_sq)
            coef = clip.coefficient(norm)
            merged = [(p, SelectedRows(sr.rows, (sr.values.float() * coef).to(
                sr.dtype), sr.height)) for p, sr in merged]
        elif clip is not None:
            grads, norm = clip.apply_values(grads)
        for p, sr in merged:
            if self._row_update(p):
                self._sparse_update(p, sr, lr, self._step_count)
            else:
                dense.append(p)
                grads.append(sr.to_dense())
        if dense:
            dnorm = self._update(dense, grads, lr, clipped=True)
            norm = dnorm if norm is None else norm
        return norm

    def _row_update(self, p) -> bool:
        """Whether ``p``'s sparse gradient updates its rows in place
        (``_sparse_update``); the default densifies it."""
        return False

    def _sparse_update(self, p, sr, lr, step):
        """Update the rows ``sr.rows`` of ``p`` (and of its f32 master) from
        the merged SelectedRows ``sr``; the optimizers that update by row
        override it."""
        raise NotImplementedError

    def _rows_written(self, p, pin, rows, new_rows):
        """Write updated rows into ``pin`` (the master or the parameter)
        and, from a master, into the parameter in its dtype."""
        pin.index_copy_(0, rows, new_rows.to(pin.dtype))
        if pin is not p:
            p.index_copy_(0, rows, pin.index_select(0, rows).to(p.dtype))

    def _sync_kw(self, params) -> Dict:
        """The clips' tensor-parallel arguments for ``params``' grads."""
        sync = self._grad_sync
        if sync is None:
            return {}
        return {"sync": sync, "sharded": sync.sharded(params)}

    def _clip_values(self, grads, params):
        clip = self._grad_clip
        if clip is None:
            return grads, None
        return clip.apply_values(grads, **self._sync_kw(params))

    def _fused_update(self, params, grads, states, masters, lr, step,
                      amp=None, clipped=False) -> Optional[torch.Tensor]:
        """Clip and update every parameter (in place); returns the global
        gradient norm where one is computed. The torch version: the AMP
        unscale, the clip (not when ``clipped``: the caller has clipped),
        then ``_update_rule`` per parameter."""
        found = None
        if amp is not None:
            grads, found = amp.unscale(list(grads))
        grads, norm = ((list(grads), None) if clipped
                       else self._clip_values(list(grads), params))
        if amp is not None:
            if norm is None:
                norm = global_norm(grads, **self._sync_kw(params)).reshape(1)
            step = amp.applied_step(found)
        for p, g, st, master in zip(params, grads, states, masters):
            pin = master if master is not None else p
            new_p, new_s = self._update_rule(
                pin, g, {k: v.float() if v.is_floating_point() else v
                         for k, v in st.items()}, lr, step)
            outs = [(st[k], v) for k, v in new_s.items() if k in st]
            outs.append((pin, new_p))
            if master is not None:
                outs.append((p, new_p))
            for dst, val in outs:
                val = val.to(dst.dtype)
                if found is not None:
                    val = torch.where(found > 0, dst, val)
                dst.copy_(val)
        if amp is not None:
            amp.bookkeep(found)
        return norm

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> Dict:
        """``step_count`` plus ``{key}.{slot}`` and ``{key}.master_weight``
        per parameter that has state; ``key`` is the structured name or
        ``param_{i}``; ``LR_Scheduler`` under a scheduler."""
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
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state: Dict):
        self._step_count = int(state.get("step_count", 0))
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])
        for p in self._parameter_list:
            key = self._names[id(p)]
            st = {k[len(key) + 1:]: torch.as_tensor(v, device=p.device)
                  for k, v in state.items()
                  if k.startswith(key + ".") and k != f"{key}.master_weight"}
            if st:
                self._states[id(p)] = st
            mk = f"{key}.master_weight"
            if mk in state:
                self._master_weights[id(p)] = torch.as_tensor(
                    state[mk], device=p.device).float()


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _update_rule(self, p, g, state, lr, step):
        g = g.float()
        if self._weight_decay:
            g = g + self._decay_term(p.float())
        return p - (lr * g).to(p.dtype), state

    def _row_update(self, p):
        return True

    def _sparse_update(self, p, sr, lr, step):
        """Row-wise SGD (the JAX ``SGD._sparse_update``): only the looked-up
        rows move; weight decay, when set, applies to those rows."""
        pin = self._master_weights.get(id(p), p)
        old = pin.index_select(0, sr.rows)
        g = sr.values.float()
        if self._weight_decay:
            g = g + self._decay_term(old.float())
        self._rows_written(p, pin, sr.rows, old - (lr * g).to(old.dtype))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _state_shapes(self):
        return ("velocity",)

    def _update_rule(self, p, g, state, lr, step):
        g = g.float()
        if self._weight_decay:
            g = g + self._decay_term(p.float())
        v = _f32(self._momentum) * state["velocity"] + g
        upd = g + _f32(self._momentum) * v if self._nesterov else v
        return p - (lr * upd).to(p.dtype), {"velocity": v}


class Adam(Optimizer):
    """Adam with L2 (or L1) weight decay added to the gradient. Its
    update is K8 on CUDA tensors and K8's plain version on the CPU.
    ``lazy_mode`` updates a sparse gradient's rows only, moments
    included (``_sparse_update``); without it a sparse gradient is
    densified."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 state_dtype=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, state_dtype)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._decoupled = False
        self._lazy_mode = bool(lazy_mode)

    def _state_shapes(self):
        return ("moment1", "moment2")

    def _decays(self, p) -> bool:
        return bool(self._weight_decay)

    def _row_update(self, p):
        return self._lazy_mode

    def _sparse_update(self, p, sr, lr, step):
        """Lazy Adam (the JAX ``Adam._sparse_update``, the reference's lazy
        path): moments and parameter move at the touched rows only,
        gathered and written back by index; the decay (L2 / L1 into the
        gradient, AdamW's decoupled into the update) reads those rows."""
        st = self._param_state(p)
        pin = self._master_weights.get(id(p), p)
        rows = sr.rows
        pf = pin.index_select(0, rows).float()
        g = sr.values.float()
        decays = self._decays(p)
        if decays and not self._decoupled:
            g = g + self._decay_term(pf)
        m = (_f32(self._beta1) * st["moment1"].index_select(0, rows).float()
             + _f32(1 - self._beta1) * g)
        v = (_f32(self._beta2) * st["moment2"].index_select(0, rows).float()
             + _f32(1 - self._beta2) * torch.square(g))
        upd = (m / bias_correction(self._beta1, step)) / (
            torch.sqrt(v / bias_correction(self._beta2, step))
            + _f32(self._epsilon))
        if decays and self._decoupled:
            upd = upd + self._decay_term(pf)
        old = pin.index_select(0, rows)
        self._rows_written(p, pin, rows, old + (-lr * upd).to(old.dtype))
        st["moment1"].index_copy_(0, rows, m.to(st["moment1"].dtype))
        st["moment2"].index_copy_(0, rows, v.to(st["moment2"].dtype))

    def _fused_update(self, params, grads, states, masters, lr, step,
                      amp=None, clipped=False):
        clip = None if clipped else self._grad_clip
        pre_found = None
        clip_norm = 0.0
        if isinstance(clip, ClipGradByGlobalNorm):
            clip_norm = clip.clip_norm
        elif clip is not None:
            # a per-tensor clip runs in torch before the update, after
            # the unscale (the JAX order); the update then only skips
            if amp is not None:
                grads, pre_found = amp.unscale(list(grads))
            grads, _ = clip.apply_values(list(grads),
                                         **self._sync_kw(params))
        sync = self._grad_sync
        return fused_adam(
            params, grads, masters, [s["moment1"] for s in states],
            [s["moment2"] for s in states], [self._decays(p) for p in params],
            lr=lr, beta1=self._beta1, beta2=self._beta2,
            epsilon=self._epsilon, weight_decay=self._weight_decay,
            l1=self._wd_mode == "l1", decoupled=self._decoupled,
            clip_norm=clip_norm, step=step, amp=amp, pre_found=pre_found,
            split=None if sync is None else (sync, sync.sharded(params)))


class AdamW(Adam):
    """Adam with decoupled weight decay: ``p -= lr * (update + wd * p)``.
    ``apply_decay_param_fun(name)`` returning False exempts a parameter
    from the decay (the JAX package builds that mask and never reads it;
    ROADMAP.md queue 3)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, state_dtype=None,
                 name=None):
        if lr_ratio is not None:
            raise NotImplementedError(
                "AdamW(lr_ratio=...) is not ported: the JAX package stores "
                "it and never reads it (ROADMAP.md queue 1, item 2)")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         state_dtype, name)
        self._decoupled = True
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decays(self, p) -> bool:
        if not self._weight_decay:
            return False
        fun = self._apply_decay_param_fun
        return fun is None or bool(fun(self._names[id(p)]))


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _state_shapes(self):
        return ("moment",)

    def _param_state(self, p):
        st = self._states.get(id(p))
        if st is None:
            st = {"moment": torch.full(p.shape, float(self._init_acc),
                                       dtype=torch.float32, device=p.device)}
            self._states[id(p)] = st
        return st

    def _update_rule(self, p, g, state, lr, step):
        g = g.float()
        if self._weight_decay:
            g = g + self._decay_term(p.float())
        acc = state["moment"] + torch.square(g)
        new_p = p.float() - lr * g / (torch.sqrt(acc) + _f32(self._epsilon))
        return new_p.to(p.dtype), {"moment": acc}


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _state_shapes(self):
        return ("mean_square", "mean_grad", "momentum")

    def _update_rule(self, p, g, state, lr, step):
        g = g.float()
        if self._weight_decay:
            g = g + self._decay_term(p.float())
        rho, c = _f32(self._rho), _f32(1 - self._rho)
        eps = _f32(self._epsilon)
        ms = rho * state["mean_square"] + c * torch.square(g)
        if self._centered:
            mg = rho * state["mean_grad"] + c * g
            denom = torch.sqrt(ms - torch.square(mg) + eps)
        else:
            mg = state["mean_grad"]
            denom = torch.sqrt(ms + eps)
        mom = _f32(self._momentum) * state["momentum"] + lr * g / denom
        new_p = p.float() - mom
        return new_p.to(p.dtype), {"mean_square": ms, "mean_grad": mg,
                                   "momentum": mom}


class Adadelta(Optimizer):
    """Accumulated-gradient / accumulated-update rule."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def _state_shapes(self):
        return ("avg_squared_grad", "avg_squared_update")

    def _update_rule(self, p, g, state, lr, step):
        g = g.float()
        if self._weight_decay:
            g = g + self._decay_term(p.float())
        rho, c = _f32(self._rho), _f32(1 - self._rho)
        eps = _f32(self._epsilon)
        asg = rho * state["avg_squared_grad"] + c * torch.square(g)
        upd = g * torch.sqrt((state["avg_squared_update"] + eps)
                             / (asg + eps))
        asu = rho * state["avg_squared_update"] + c * torch.square(upd)
        new_p = p.float() - lr * upd
        return new_p.to(p.dtype), {"avg_squared_grad": asg,
                                   "avg_squared_update": asu}


class Adamax(Optimizer):
    """Infinity-norm Adam variant."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _state_shapes(self):
        return ("moment", "inf_norm")

    def _update_rule(self, p, g, state, lr, step):
        g = g.float()
        if self._weight_decay:
            g = g + self._decay_term(p.float())
        m = _f32(self._beta1) * state["moment"] + _f32(1 - self._beta1) * g
        u = torch.maximum(_f32(self._beta2) * state["inf_norm"],
                          torch.abs(g))
        bc = bias_correction(self._beta1, step)
        # f32 quotient: a float64 quotient of two f32 values rounds to it
        lr_t = lr / bc if isinstance(bc, torch.Tensor) else _f32(lr / bc)
        new_p = p.float() - lr_t * m / (u + _f32(self._epsilon))
        return new_p.to(p.dtype), {"moment": m, "inf_norm": u}


class ASGD(Optimizer):
    """Averaged SGD: ``d`` holds the sum of the last ``batch_num``
    gradients, kept in a history ring."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._n = max(int(batch_num), 1)

    def _param_state(self, p):
        st = self._states.get(id(p))
        if st is None:
            st = {"d": torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device),
                  "hist": torch.zeros((self._n,) + tuple(p.shape),
                                      dtype=torch.float32, device=p.device)}
            self._new_master(p)
            self._states[id(p)] = st
        return st

    def _update_rule(self, p, g, state, lr, step):
        g = g.float()
        if self._weight_decay:
            g = g + self._decay_term(p.float())
        idx = torch.as_tensor((step - 1) % self._n,
                              device=g.device).long().reshape(1)
        oldest = state["hist"].index_select(0, idx)[0]
        d = state["d"] - oldest + g
        hist = state["hist"].index_copy(0, idx, g[None])
        new_p = p.float() - lr * d / self._n
        return new_p.to(p.dtype), {"d": d, "hist": hist}


class Rprop(Optimizer):
    """Resilient backprop: per-weight step sizes grown or shrunk by the
    agreement of gradient signs; magnitudes are ignored."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def _param_state(self, p):
        st = self._states.get(id(p))
        if st is None:
            st = {"prev_grad": torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device),
                  "lr_w": torch.full(p.shape, _f32(self.get_lr()),
                                     dtype=torch.float32, device=p.device)}
            self._new_master(p)
            self._states[id(p)] = st
        return st

    def _update_rule(self, p, g, state, lr, step):
        g = g.float()
        sign = torch.sign(g * state["prev_grad"])
        lr_w = state["lr_w"]
        lr_w = torch.clamp(
            torch.where(sign > 0, lr_w * _f32(self._eta_pos),
                        torch.where(sign < 0, lr_w * _f32(self._eta_neg),
                                    lr_w)),
            _f32(self._lr_min), _f32(self._lr_max))
        # sign-disagreement steps are skipped (grad treated as 0)
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        new_p = p.float() - lr_w * torch.sign(g_eff)
        return new_p.to(p.dtype), {"prev_grad": g_eff, "lr_w": lr_w}


class Lamb(Optimizer):
    """Layer-wise adaptive large-batch optimizer."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        if exclude_from_weight_decay_fn is not None:
            raise NotImplementedError(
                "Lamb(exclude_from_weight_decay_fn=...) is not ported: the "
                "JAX package stores it and never reads it")
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _state_shapes(self):
        return ("moment1", "moment2")

    def _update_rule(self, p, g, state, lr, step):
        pf = p.float()
        g = g.float()
        m = (_f32(self._beta1) * state["moment1"]
             + _f32(1 - self._beta1) * g)
        v = (_f32(self._beta2) * state["moment2"]
             + _f32(1 - self._beta2) * torch.square(g))
        mhat = m / bias_correction(self._beta1, step)
        vhat = v / bias_correction(self._beta2, step)
        r = mhat / (torch.sqrt(vhat) + _f32(self._epsilon)) \
            + self._decay_term(pf)
        w_norm = torch.linalg.vector_norm(pf)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        new_p = pf - lr * trust * r
        return new_p.to(p.dtype), {"moment1": m, "moment2": v}


class LarsMomentum(Momentum):
    """LARS: layer-wise adaptive rate scaling over momentum,
    ``local_lr = lr * coeff * ||w|| / (||g|| + wd * ||w|| + eps)``;
    parameters whose name holds a token of ``exclude_from_weight_decay``
    take neither the decay nor the local rate."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 lars_coeff=0.001, lars_weight_decay=0.0005, epsilon=1e-8,
                 exclude_from_weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, momentum, parameters,
                         weight_decay=None, grad_clip=grad_clip,
                         multi_precision=multi_precision, name=name)
        self._lars_coeff = float(lars_coeff)
        self._lars_wd = float(lars_weight_decay)
        self._eps = float(epsilon)
        self._exclude = list(exclude_from_weight_decay or [])

    def _param_state(self, p):
        st = super()._param_state(p)
        if "lars_skip" not in st:
            # the exclusion travels in the state, as in the JAX package
            name = self._names.get(id(p), "")
            skip = any(tok in name for tok in self._exclude)
            st["lars_skip"] = torch.tensor(1.0 if skip else 0.0,
                                           dtype=self._state_dtype,
                                           device=p.device)
        return st

    def _update_rule(self, p, g, state, lr, step):
        g = g.float()
        pf = p.float()
        skip = state["lars_skip"] > 0
        w_norm = torch.sqrt(torch.sum(pf * pf))
        g_norm = torch.sqrt(torch.sum(g * g))
        local = torch.where(
            (~skip) & (w_norm > 0) & (g_norm > 0),
            _f32(self._lars_coeff) * w_norm
            / (g_norm + _f32(self._lars_wd) * w_norm + _f32(self._eps)),
            torch.ones_like(w_norm))
        g = g + torch.where(skip, torch.zeros_like(w_norm),
                            torch.full_like(w_norm, self._lars_wd)) * pf
        v = _f32(self._momentum) * state["velocity"] + lr * local * g
        return p - v.to(p.dtype), {"velocity": v,
                                   "lars_skip": state["lars_skip"]}

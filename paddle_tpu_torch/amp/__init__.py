"""Automatic mixed precision (counterpart of ``paddle_tpu/amp/__init__.py``).

**O1, ``auto_cast``.** The JAX package casts the f32 array arguments of
white-listed ops to the AMP dtype at its dispatch chokepoint
(``_amp_hook``). The port has no dispatch layer, so the port's own entry
points for those ops ask ``cast_inputs(op_name, ...)``: ``linear`` (the
Linear layers and ``nn.functional.linear``), ``matmul`` (the tied-embedding
logits), ``flash_attention`` and ``flash_attn_varlen``. It casts f32
tensors to the AMP dtype when the op is in the white set
(``WHITE_LIST`` plus ``custom_white_list``, less ``custom_black_list``)
and leaves everything else, as the JAX hook does: black-listed ops are
not cast up. ``torch.autocast`` is not used; its lists are not these.

**O2, ``decorate``.** Casts the models' floating parameters to the low
dtype and turns on the optimizers' ``multi_precision`` (f32 masters).

**``GradScaler``.** The eager protocol (``scale``, ``unscale_``, ``step``,
``update``, ``minimize``) runs on the host as in the JAX package. Under
``ParallelEngine.train_step(scaler=...)`` the state lives on the device
as ``(scale f32, [good, bad, applied-step] int32)`` and the whole step
runs there with no host read (``AmpStep``); ``last_found_inf`` and
``get_loss_scaling`` read it back. On CUDA, Adam and AdamW run that
protocol inside kernel K8; every other optimizer runs ``AmpStep``'s
torch version.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

import torch

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "white_list", "black_list", "cast_inputs",
           "is_bfloat16_supported", "is_float16_supported"]

# ops that benefit from low precision (tensor-core bound)
WHITE_LIST: Set[str] = {
    "matmul", "linear", "conv2d", "conv1d", "conv2d_transpose", "bmm",
    "fused_gemm_epilogue", "einsum_op", "flash_attention",
    "scaled_dot_product_attention", "addmm",
}
# ops that must stay fp32 (numerically sensitive)
BLACK_LIST: Set[str] = {
    "softmax_with_cross_entropy", "cross_entropy_loss", "log_softmax",
    "exp", "log", "logsumexp", "pow", "square", "sum", "mean",
    "layer_norm", "rms_norm", "batch_norm", "group_norm", "instance_norm",
    "norm", "cumsum",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)


def _dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"AMP dtype {dtype!r}: expected one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[dtype]


class _AmpState:
    enabled = False
    dtype = torch.bfloat16
    level = "O1"
    custom_white: Set[str] = set()
    custom_black: Set[str] = set()


_state = _AmpState()


def enabled() -> bool:
    """Whether an ``auto_cast`` block is active."""
    return _state.enabled


def cast_inputs(op_name: str, *tensors):
    """``tensors`` with each f32 tensor cast to the AMP dtype when
    ``auto_cast`` is on and ``op_name`` is in the white set; otherwise
    unchanged."""
    if not _state.enabled:
        return tensors
    white = (WHITE_LIST | _state.custom_white) - _state.custom_black
    if op_name not in white:
        return tensors
    return tuple(t.to(_state.dtype)
                 if isinstance(t, torch.Tensor) and t.dtype == torch.float32
                 else t for t in tensors)


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1", dtype="bfloat16",
              use_promote: bool = True):
    prev = (_state.enabled, _state.dtype, _state.level,
            _state.custom_white, _state.custom_black)
    _state.enabled = bool(enable)
    _state.dtype = _dtype(dtype)
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level,
         _state.custom_white, _state.custom_black) = prev


amp_guard = auto_cast


@torch.no_grad()
def decorate(models, optimizers=None, level: str = "O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the models' floating parameters to ``dtype`` and turn on
    the optimizers' ``multi_precision`` (f32 masters). Buffers keep their
    dtype, as the JAX layers' plain attributes (the rope tables) do."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        dt = _dtype(dtype)
        for m in model_list:
            for p in m.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(dt)
        if optimizers is not None:
            opts = [optimizers] if not isinstance(optimizers, (list, tuple)) \
                else list(optimizers)
            for o in opts:
                o._multi_precision = True
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


# -- the device-resident protocol of ParallelEngine.train_step -------------
@dataclass
class AmpStep:
    """One engine step's scaler state on the device and the scaler's
    hyperparameters. ``scale`` is an f32 tensor [1], capped before the
    backward; ``counts`` an int32 tensor [3]: good steps, bad steps and
    the applied-step count that drives bias correction. The optimizer's
    update reads and updates both in place and sets ``found`` (f32 [1],
    1 on overflow)."""
    scale: torch.Tensor
    counts: torch.Tensor
    dynamic: bool
    incr_every: int
    decr_every: int
    incr_ratio: float
    decr_ratio: float
    cap: float
    found: Optional[torch.Tensor] = None

    def unscale(self, grads: List[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """(unscaled gradients, found): found over every raw gradient;
        each unscaled in f32, rounded to its dtype, with an inverse scale
        of 0 on overflow (the JAX engine's ``inv``)."""
        finite = torch.ones((), dtype=torch.bool, device=self.scale.device)
        for g in grads:
            finite = finite & torch.isfinite(g).all()
        found = (~finite).float().reshape(1)
        inv = torch.where(found > 0, torch.zeros_like(self.scale),
                          1.0 / self.scale)
        return [(g.float() * inv).to(g.dtype) for g in grads], found

    def applied_step(self, found: torch.Tensor) -> torch.Tensor:
        """The bias-correction step: the applied count plus one unless
        this step overflowed (int32 [1])."""
        return self.counts[2:3] + (1 - (found > 0).int())

    def bookkeep(self, found: torch.Tensor) -> None:
        """The JAX engine's scale bookkeeping, dynamic or static, on the
        device tensors in place; stores ``found``."""
        f = found > 0
        scale = self.scale
        good, bad = self.counts[0:1], self.counts[1:2]
        step = self.applied_step(found)
        zero = torch.zeros_like(good)
        if self.dynamic:
            bad1 = torch.where(f, bad + 1, zero)
            good1 = torch.where(f, zero, good + 1)
            dec = f & (bad1 >= self.decr_every)
            scale1 = torch.where(
                dec, torch.clamp(scale * self.decr_ratio, min=1.0), scale)
            bad2 = torch.where(dec, zero, bad1)
            inc = (~f) & (good1 >= self.incr_every)
            scale2 = torch.clamp(torch.where(inc, scale1 * self.incr_ratio,
                                             scale1), max=self.cap)
            good2 = torch.where(inc, zero, good1)
        else:
            scale2 = scale
            good2 = torch.where(f, zero, good + 1)
            bad2 = torch.where(f, bad + 1, zero)
        self.scale.copy_(scale2)
        self.counts.copy_(torch.cat([good2, bad2, step]).int())
        self.found = found


class GradScaler:
    """Dynamic (or static) loss scaling: the eager protocol on the host,
    and the device state ``ParallelEngine.train_step(scaler=...)``
    carries."""

    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        # device-resident state when driven by ParallelEngine:
        # (scale f32 [1], [good, bad, applied-step] int32 [3])
        self._dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._found_inf_dev: Optional[torch.Tensor] = None
        self._applied_steps = 0

    def _to_eager(self):
        """Hand the device state back to the eager protocol: sync the
        host values, then drop the device copy so the next engine step
        reseeds from them."""
        self._sync_from_dev()
        self._dev = None
        self._found_inf_dev = None

    def scale(self, var: torch.Tensor) -> torch.Tensor:
        if not self._enable:
            return var
        self._to_eager()
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        self._to_eager()
        inv = 1.0 / self._scale
        for p in optimizer._parameter_list:
            if p.grad is not None:
                p.grad.mul_(inv)
        self._found_inf = self._check_found_inf(optimizer)

    def _check_found_inf(self, optimizer) -> bool:
        # all-finite test, read back to the host (eager protocol only)
        finite = True
        for p in optimizer._parameter_list:
            if p.grad is not None:
                finite = finite and bool(torch.isfinite(p.grad).all())
        return not finite

    # -- the engine's device protocol ----------------------------------
    def _amp_step(self, device, cap: float, fallback_step: int = 0
                  ) -> AmpStep:
        """This step's ``AmpStep`` on ``device``; the device state is
        seeded from the host values on first use (the applied-step count
        from ``fallback_step``, the optimizer's step count, unless a
        checkpoint restored one)."""
        if self._dev is None:
            self._dev = (
                torch.tensor([self._scale], dtype=torch.float32,
                             device=device),
                torch.tensor([self._good_steps, self._bad_steps,
                              self._applied_steps or fallback_step],
                             dtype=torch.int32, device=device))
        return AmpStep(self._dev[0], self._dev[1], bool(self._dynamic),
                       int(self._incr_every), int(self._decr_every),
                       float(self._incr_ratio), float(self._decr_ratio),
                       float(cap))

    @property
    def last_found_inf(self) -> bool:
        """Whether the most recent step hit inf/nan (a host read)."""
        if self._found_inf_dev is not None:
            return bool(self._found_inf_dev.item() > 0)
        return self._found_inf

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        optimizer.clear_grad()

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def _sync_from_dev(self):
        if self._dev is not None:
            scale, counts = self._dev
            self._scale = float(scale.item())
            self._good_steps, self._bad_steps, self._applied_steps = (
                int(c) for c in counts.tolist())

    def get_loss_scaling(self) -> float:
        self._sync_from_dev()
        return self._scale

    def set_init_loss_scaling(self, v: float):
        self._sync_from_dev()  # keep the counters; only the scale resets
        self._scale = float(v)
        self._dev = None

    def state_dict(self):
        self._sync_from_dev()
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps,
                "applied_steps": self._applied_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)
        self._applied_steps = state.get("applied_steps", 0)
        self._dev = None


def is_bfloat16_supported(device=None) -> bool:
    """Whether ``device`` (the CUDA device unless named) computes in
    bf16: asks the card; the CPU always does."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return torch.cuda.is_available() and torch.cuda.is_bf16_supported()
    return True


def is_float16_supported(device=None) -> bool:
    """Whether ``device`` (the CUDA device unless named) computes in
    f16: any CUDA card of compute capability 5.3 or later; the CPU
    always does."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return (torch.cuda.is_available()
                and torch.cuda.get_device_capability(dev) >= (5, 3))
    return True

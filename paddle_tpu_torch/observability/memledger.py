"""Device memory ledger: per-site memory attribution, model-state
accounting, and roofline verdicts (counterpart of
``paddle_tpu/observability/memledger.py`` at degree 1).

**What stands in for XLA's ``Compiled.memory_analysis()``.** The JAX
package reads the buffer assignment of each compiled program. The port
compiles nothing: a serving round is a CUDA graph of eager PyTorch
calls, a train step runs eagerly. So a site's ledger is built from what
the site is known to touch, at its first execution:

- ``argument_bytes``: the tensors the site reads — parameters, the KV
  page pools, its static input buffers (optimizer state and masters for
  a train step);
- ``output_bytes``: the tensors it writes — the pools it updates and
  its result buffers (a train step: parameters, optimizer state,
  masters, the loss);
- ``alias_bytes``: the tensors it updates in place (the pools; a train
  step's parameters, state and masters) — the counterpart of donation,
  counted in both classes above and subtracted once from the peak;
- ``temp_bytes``: on a card, the CUDA caching allocator's peak over the
  site's first execution less the bytes allocated before it, or after
  it where that is more: what the execution keeps (a first train
  step's optimizer state) is no temporary. For a graphed site that
  first execution is its eager warmup and its capture, whose
  temporaries the graph's private pool then holds (``StepGraphs``
  books that pool as ``stats.capture_bytes``). Reading the allocator's
  counters is host-side: no device sync;
- ``generated_code_bytes``: not measured (no generated code is sized).

Off the card (the CPU) no allocator statistics exist: ``temp_bytes`` is
0 and the ledger's ``note`` says it was not measured. No number is
invented for a class the device cannot measure.

``account_engine`` / ``closed_form_state_bytes`` are the JAX package's
model-state accounting at degree 1 (every tensor whole on the one
device; no ZeRO, offload or quantized-comm state until items 9-10),
with the auto_tuner's analytic model (``estimate_memory_gb``, a copy of
``paddle_tpu/distributed/auto_tuner/cost_model.py``'s) for the drift
gauge. ``roofline`` reads the H100 peak table of ``flops.py``; off the
card every peak is unknown and the verdict is ``"unknown"``.
``live_bytes`` is ``torch.cuda.memory_allocated`` on a card (0 off it);
``suggest_pool_pages`` sizes a serving page pool from the card's free
memory (``torch.cuda.mem_get_info``), so a second engine on the card
sees what the first one holds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional

import numpy as np

__all__ = [
    "MemLedger", "analyze", "TempProbe", "shard_bytes",
    "StateAccounting", "account_engine", "closed_form_state_bytes",
    "RooflineReport", "roofline", "live_bytes", "suggest_pool_pages",
    "estimate_memory_gb", "RESOURCES",
]

# the three roofline resources, in verdict tie-break order
RESOURCES = ("compute", "hbm", "ici")


# ---------------------------------------------------------------------------
# 1. per-site memory ledger
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MemLedger:
    """Memory attribution of ONE launch site (module docstring for how
    each class is measured in the port)."""

    program: str = ""
    temp_bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    generated_code_bytes: int = 0
    available: bool = True
    note: str = ""

    @property
    def peak_bytes(self) -> int:
        """Estimated high-water mark of one execution: arguments +
        outputs + temps + code, less the in-place bytes both count."""
        return (self.argument_bytes + self.output_bytes
                + self.temp_bytes + self.generated_code_bytes
                - self.alias_bytes)

    @property
    def traffic_bytes(self) -> int:
        """Roofline traffic estimate: arguments read once, outputs
        written once, temps written and read. An upper bound for a site
        that updates a tensor in place: a serving round's whole KV pool
        counts as read and as written, where a round touches its rows'
        pages only (``ServingEngine.roofline_report`` counts those)."""
        return (self.argument_bytes + self.output_bytes
                + 2 * self.temp_bytes)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "program": self.program,
            "temp_bytes": self.temp_bytes,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "alias_bytes": self.alias_bytes,
            "generated_code_bytes": self.generated_code_bytes,
            "peak_bytes": self.peak_bytes,
            "available": self.available,
            **({"note": self.note} if self.note else {}),
        }

    def publish(self, metrics: Dict[str, Any],
                program: Optional[str] = None) -> None:
        """Set the ``paddle_tpu_mem_*_bytes{program}`` catalog gauges."""
        if not self.available:
            return
        prog = program if program is not None else self.program
        metrics["mem_temp"].set(self.temp_bytes, program=prog)
        metrics["mem_argument"].set(self.argument_bytes, program=prog)
        metrics["mem_output"].set(self.output_bytes, program=prog)
        metrics["mem_alias"].set(self.alias_bytes, program=prog)
        metrics["mem_code"].set(self.generated_code_bytes, program=prog)

    def same_totals(self, other: "MemLedger") -> bool:
        return (self.temp_bytes == other.temp_bytes
                and self.argument_bytes == other.argument_bytes
                and self.output_bytes == other.output_bytes
                and self.alias_bytes == other.alias_bytes)


def shard_bytes(t) -> int:
    """Bytes one device holds of ``t``: at degree 1 the whole tensor (a
    torch tensor or a numpy array); 0 for anything without a shape."""
    if t is None:
        return 0
    if hasattr(t, "element_size"):
        return int(t.numel()) * int(t.element_size())
    nbytes = getattr(t, "nbytes", None)
    return int(nbytes) if nbytes is not None else 0


def _unique_bytes(tensors: Iterable) -> int:
    """Bytes of distinct tensors (one storage counted once: the table
    every layer's cache tuple shares, a view of a pool)."""
    seen, total = set(), 0
    for t in tensors:
        if t is None:
            continue
        key = (t.data_ptr(), t.numel(), str(t.dtype)) \
            if hasattr(t, "data_ptr") else id(t)
        if key in seen:
            continue
        seen.add(key)
        total += shard_bytes(t)
    return total


class TempProbe:
    """The caching allocator's peak over a region, less what was
    allocated before it or, where more, after it: the bytes live only
    inside the region, not what it allocated to keep (a first step's
    optimizer state). CUDA only; ``temp_bytes()`` is None elsewhere.
    It resets the allocator's peak counter at entry: host-side, no
    device sync."""

    def __init__(self, device):
        import torch

        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.before = 0
        if self.cuda:
            self.before = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def temp_bytes(self) -> Optional[int]:
        if not self.cuda:
            return None
        import torch

        kept = max(self.before,
                   int(torch.cuda.memory_allocated(self.device)))
        return max(int(torch.cuda.max_memory_allocated(self.device))
                   - kept, 0)


def analyze(program: str, reads: Iterable, writes: Iterable,
            in_place: Iterable = (), temp_bytes: Optional[int] = None,
            note: str = "") -> MemLedger:
    """The ledger of one site from the tensors it reads, writes and
    updates in place, and its measured temporaries (None: not measured,
    said so in the note). Where the JAX ``analyze`` lowers a jitted
    program, the port has no program to lower; its sites name their
    tensors instead."""
    notes = [note] if note else []
    if temp_bytes is None:
        notes.append("temp_bytes not measured (no allocator statistics "
                     "off the card)")
    notes.append("generated_code_bytes not measured")
    return MemLedger(
        program=program,
        temp_bytes=int(temp_bytes or 0),
        argument_bytes=_unique_bytes(reads),
        output_bytes=_unique_bytes(writes),
        alias_bytes=_unique_bytes(in_place),
        generated_code_bytes=0,
        available=True,
        note="; ".join(notes))


# ---------------------------------------------------------------------------
# 2. model-state accounting (degree 1)
# ---------------------------------------------------------------------------
def _group_name(name: str) -> str:
    """Layer-group key: the first two dotted path components."""
    parts = name.split(".")
    return ".".join(parts[:2]) if len(parts) > 1 else name


@dataclass
class StateAccounting:
    """Measured model-state footprint on the one device + the analytic
    drift (the JAX class, degree 1)."""

    components: Dict[str, int] = field(default_factory=dict)
    groups: Dict[str, Dict[str, int]] = field(default_factory=dict)
    analytic_bytes: float = 0.0
    drift: float = 0.0

    @property
    def measured_bytes(self) -> int:
        return int(sum(self.components.values()))

    @property
    def device_bytes(self) -> int:
        return self.measured_bytes - int(
            self.components.get("host_state", 0))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "components": dict(self.components),
            "groups": {g: dict(v) for g, v in sorted(self.groups.items())},
            "measured_bytes": self.measured_bytes,
            "device_bytes": self.device_bytes,
            "analytic_bytes": round(self.analytic_bytes, 1),
            "analytic_drift": round(self.drift, 4),
        }

    def publish(self, metrics: Dict[str, Any]) -> None:
        for comp, v in self.components.items():
            metrics["mem_state"].set(v, component=comp)
        metrics["mem_drift"].set(self.drift)


def _num_params(model: Dict) -> float:
    h = model["hidden_size"]
    L = model["num_layers"]
    V = model.get("vocab_size", 50304)
    i = model.get("intermediate_size", 4 * h)
    return V * h + L * (4 * h * h + 2 * h * i) + 2 * h


def estimate_memory_gb(model: Dict, cfg: Dict, global_batch: int,
                       seq_len: int, dtype_bytes: int = 2,
                       optimizer_mult: float = 6.0,
                       recompute: bool = False) -> float:
    """Per-chip memory estimate (params + grads + optimizer +
    activations): the auto_tuner's analytic model, a copy of
    ``paddle_tpu/distributed/auto_tuner/cost_model.py``'s."""
    dp = cfg.get("dp_degree", 1)
    mp = cfg.get("mp_degree", 1)
    pp = cfg.get("pp_degree", 1)
    sh = cfg.get("sharding_degree", 1)
    micro = cfg.get("micro_batch_size",
                    max(1, global_batch // max(1, dp * sh)))
    P = _num_params(model) / (mp * pp)
    param_bytes = P * dtype_bytes
    grad_bytes = P * dtype_bytes
    opt_bytes = P * dtype_bytes * optimizer_mult / sh
    if cfg.get("sharding_stage", 1) >= 3:
        param_bytes /= sh
        grad_bytes /= sh
    h = model["hidden_size"]
    L = model["num_layers"] / pp
    act_per_layer = micro * seq_len * h * dtype_bytes
    act_mult = 4 if recompute else 34  # flash-attn era per-layer factor
    act_bytes = L * act_per_layer * act_mult / mp
    quant = cfg.get("quant_comm") or {}
    quant_bytes = 0.0
    if quant.get("dtype", "none") in ("int8", "fp8") and \
            quant.get("error_feedback", True):
        quant_bytes = _num_params(model) / (mp * pp) * 4
    off = cfg.get("offload") or {}
    if off.get("optimizer", False):
        opt_bytes = 0.0
        quant_bytes = 0.0
    if off.get("params", False):
        param_bytes = 0.0
    return (param_bytes + grad_bytes + opt_bytes + act_bytes
            + quant_bytes) / 1e9


def _params(engine):
    return list(getattr(engine, "params", None)
                or engine.model.parameters())


def account_engine(engine, batch_tokens: int = 0,
                   accumulate_steps: int = 1) -> StateAccounting:
    """Measured model-state accounting of a degree-1 ``ParallelEngine``:
    bytes of every parameter, its transient gradient (at the
    parameter's size and dtype), optimizer state and f32 master, the
    analytic activation-checkpoint term (one saved residual a layer:
    layers x tokens x hidden x dtype bytes) and the auto_tuner
    cross-check — the JAX ``account_engine`` with every mesh degree 1."""
    opt = engine.optimizer
    comp = {"params": 0, "grads": 0, "optimizer_state": 0,
            "master_weights": 0, "activation_ckpt": 0}
    groups: Dict[str, Dict[str, int]] = {}
    named = {}
    try:
        named = {id(p): n for n, p in engine.model.named_parameters()}
    except Exception:
        pass
    states = getattr(opt, "_states", {}) if opt is not None else {}
    masters = getattr(opt, "_master_weights", {}) if opt is not None \
        else {}
    params = _params(engine)
    for p in params:
        pb = shard_bytes(p)
        comp["params"] += pb
        g = groups.setdefault(_group_name(named.get(id(p), "param")),
                              {"params": 0, "optimizer_state": 0,
                               "master_weights": 0})
        g["params"] += pb
        if p.requires_grad:
            comp["grads"] += pb
        st = states.get(id(p))
        if st:
            sb = sum(shard_bytes(v) for v in st.values()
                     if hasattr(v, "shape"))
            comp["optimizer_state"] += sb
            g["optimizer_state"] += sb
        mw = masters.get(id(p))
        if mw is not None:
            mb = shard_bytes(mw)
            comp["master_weights"] += mb
            g["master_weights"] += mb

    cfg = getattr(engine.model, "config", None)
    hidden = getattr(cfg, "hidden_size", None)
    layers = getattr(cfg, "num_layers", None)
    analytic = 0.0
    if hidden and layers:
        dtype_bytes = int(params[0].element_size()) if params else 4
        micro_tokens = batch_tokens / max(accumulate_steps, 1)
        comp["activation_ckpt"] = int(
            layers * micro_tokens * hidden * dtype_bytes)
        model_d = {"hidden_size": hidden, "num_layers": layers,
                   "vocab_size": getattr(cfg, "vocab_size", 50304)}
        cfg_d = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                 "sharding_degree": 1, "sharding_stage": 2,
                 "micro_batch_size": 1}
        try:
            analytic = estimate_memory_gb(
                model_d, cfg_d, global_batch=max(accumulate_steps, 1),
                seq_len=max(int(micro_tokens), 1),
                dtype_bytes=dtype_bytes) * 1e9
        except Exception:
            analytic = 0.0
    measured = sum(comp.values())
    drift = ((analytic - measured) / measured) if measured and analytic \
        else 0.0
    return StateAccounting(components=comp, groups=groups,
                           analytic_bytes=analytic, drift=drift)


def closed_form_state_bytes(engine) -> Dict[str, int]:
    """Closed-form param / optimizer / master bytes from shapes and
    dtypes alone (each tensor's element count times its element size; at
    degree 1 no divisor): the independent derivation
    ``account_engine`` must equal byte for byte."""
    opt = engine.optimizer
    out = {"params": 0, "optimizer_state": 0, "master_weights": 0}

    def nbytes(t):
        return int(np.prod(tuple(t.shape)) if t.dim() else 1) \
            * int(t.element_size())

    for p in _params(engine):
        out["params"] += nbytes(p)
        if not p.requires_grad or opt is None:
            continue
        for v in getattr(opt, "_states", {}).get(id(p), {}).values():
            if hasattr(v, "shape"):
                out["optimizer_state"] += nbytes(v)
        mw = getattr(opt, "_master_weights", {}).get(id(p))
        if mw is not None:
            out["master_weights"] += nbytes(mw)
    return out


# ---------------------------------------------------------------------------
# 3. roofline verdict
# ---------------------------------------------------------------------------
@dataclass
class RooflineReport:
    """The per-step bottleneck verdict (the JAX class): ``seconds[r]``
    each resource's floor for one step, ``bound`` the largest
    ("compute-bound" / "hbm-bound" / "ici-bound", or "unknown" when no
    peak is known), ``headroom_pct`` and ``util_pct`` per resource."""

    program: str = ""
    step_seconds: float = 0.0
    seconds: Dict[str, float] = field(default_factory=dict)
    bound: str = "unknown"
    headroom_pct: Dict[str, float] = field(default_factory=dict)
    util_pct: Dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "program": self.program,
            "bound": self.bound,
            "step_seconds": round(self.step_seconds, 6),
            "seconds": {k: round(v, 6) for k, v in self.seconds.items()},
            "headroom_pct": {k: round(v, 2)
                             for k, v in self.headroom_pct.items()},
            "util_pct": {k: round(v, 2)
                         for k, v in self.util_pct.items()},
        }


def roofline(*, step_seconds: float, flops_per_step: float,
             hbm_traffic_bytes: float, wire_bytes: float = 0.0,
             device=None, exposed_ici_seconds: Optional[float] = None,
             program: str = "") -> RooflineReport:
    """The roofline verdict from one device's per-step quantities.
    ``device`` is a torch device or a card name; the peaks come from
    ``flops.peak_flops_per_chip`` (the H100's; (0, 0) elsewhere). The
    interconnect's rate is not in the port's table (NVLink waits on a host
    with more than one card: item 8.1), so the ici term is the
    measured ``exposed_ici_seconds`` or 0."""
    from . import flops as _flops

    peak, hbm_bw = _flops.peak_flops_per_chip(device) \
        if device is not None else (0.0, 0.0)
    t = {
        "compute": (flops_per_step / peak) if peak > 0 else 0.0,
        "hbm": (hbm_traffic_bytes / hbm_bw) if hbm_bw > 0 else 0.0,
        "ici": float(exposed_ici_seconds)
        if exposed_ici_seconds is not None else 0.0,
    }
    t = {k: max(v, 0.0) for k, v in t.items()}
    rep = RooflineReport(program=program,
                         step_seconds=max(float(step_seconds), 0.0),
                         seconds=t)
    peaks_known = peak > 0 or hbm_bw > 0
    t_bound = max(t.values())
    if peaks_known and t_bound > 0:
        rep.bound = next(r for r in RESOURCES if t[r] == t_bound) \
            + "-bound"
        rep.headroom_pct = {r: 100.0 * (1.0 - t[r] / t_bound)
                            for r in RESOURCES}
    else:
        rep.headroom_pct = {r: 0.0 for r in RESOURCES}
    if rep.step_seconds > 0:
        rep.util_pct = {r: 100.0 * t[r] / rep.step_seconds
                        for r in RESOURCES}
    return rep


# ---------------------------------------------------------------------------
# live bytes + page-pool sizing
# ---------------------------------------------------------------------------
def live_bytes(device=None) -> int:
    """Bytes the CUDA caching allocator has handed out on ``device``
    (default: the current card), ``torch.cuda.memory_allocated``'s
    number read from the allocator's nested counters (it skips the
    flattening of every counter that call does) — host-side, no sync; 0
    with no card (not measured off it)."""
    try:
        import torch

        if not torch.cuda.is_available():
            return 0
        if device is not None and torch.device(device).type != "cuda":
            return 0
        st = torch.cuda.memory_stats_as_nested_dict(device)
        return int(st["allocated_bytes"]["all"]["current"])
    except Exception:
        return 0


def _free_and_total(device):
    """(free, total) bytes of a CUDA device, the allocator's cached but
    unused blocks counted as free; None for anything else."""
    import torch

    try:
        dev = torch.device(device)
    except (TypeError, RuntimeError):
        return None
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    free, total = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - \
        torch.cuda.memory_allocated(dev)
    return int(free) + max(int(cached), 0), int(total)


def suggest_pool_pages(device, page_bytes: int, reserved_bytes: int,
                       margin: float = 0.1) -> Optional[int]:
    """Pages of ``page_bytes`` a serving KV pool can take.

    On a CUDA device: ``(free - margin x total - reserved_bytes) //
    page_bytes``, where ``free`` is the card's free memory now
    (``torch.cuda.mem_get_info``, plus the allocator's cached unused
    blocks) — so what this process and others already hold (weights,
    another engine's pool) is taken off — and ``reserved_bytes`` is what
    the caller will still allocate. On an object with ``memory_stats()``
    (the JAX package's interface): ``(bytes_limit x (1 - margin) -
    reserved_bytes) // page_bytes``. ``None`` on the CPU, without
    statistics, or when not one page fits: the caller falls back to its
    geometric default."""
    if page_bytes <= 0:
        return None
    info = None
    if not hasattr(device, "memory_stats"):
        info = _free_and_total(device)
        if info is None:
            return None
        free, total = info
        usable = int(free - margin * total) - int(reserved_bytes)
    else:
        try:
            stats = device.memory_stats() or {}
        except Exception:
            return None
        limit = int(stats.get("bytes_limit", 0))
        if limit <= 0:
            return None
        usable = int(limit * (1.0 - margin)) - int(reserved_bytes)
    if usable < page_bytes:
        return None
    return int(usable // page_bytes)

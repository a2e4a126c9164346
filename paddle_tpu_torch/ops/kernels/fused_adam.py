"""K8: the multi-tensor Adam / AdamW update with global-norm clipping and
the AMP loss-scale protocol (a port-only kernel: the counterpart of the
fusion XLA makes of ``paddle_tpu/optimizer/__init__.py``
``Optimizer._fused_update`` :211, "multi-tensor fused path", and of the
AMP part of the JAX engine's step, ``distributed/engine.py:843-932``).

``fused_adam`` updates a list of parameters in place: each tensor has a
gradient (its parameter's dtype), an optional f32 master, two moments
(f32 or bf16) and a decay flag. Per launch it takes the Adam scalars,
the clip norm, the bias-correction step and, under a loss scaler, the
device state of ``amp.AmpStep``. On CUDA tensors it launches the kernels
of ``csrc/fused_adam.cu`` (its header gives the design and the bound);
on CPU tensors it runs ``fused_adam_dense``, the plain version, which
is the optimizer's per-parameter loop. Both round as the JAX package
rounds:

- unscale ``(g.f32 * inv).astype(g.dtype)``, with ``inv`` 0 on overflow;
- clip ``(g * coef).astype(g.dtype)``, ``coef = min(clip / max(norm,
  1e-6), 1)``, ``norm`` the f32 global norm of the unscaled gradients;
- f32 math with the scalars rounded to f32; Adam's decay (L2 ``wd*p`` or
  L1 ``wd*sign(p)``) added to the gradient, AdamW's to the update;
- bias correction ``1 - beta^t`` in f32 (``bias_correction``);
- moments cast out to their dtype, the master written in f32 and the
  parameter receiving ``new_p.astype(p.dtype)``.

Under a scaler an overflow step writes nothing (parameters, masters and
moments stay bit-equal) and does not advance the applied-step count.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import _build, counted, route, stream, want_contiguous

__all__ = ["bias_correction", "fused_adam", "fused_adam_dense"]

CHUNK = 65536                 # elements a block updates (csrc kChunk)
_PDTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SDTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _f32(x: float) -> float:
    return float(np.float32(x))


def bias_correction(beta: float, t):
    """f32 ``1 - beta^t``: beta rounded to f32, the power taken in
    float64 and rounded to f32, the subtraction in f32 (the kernel does
    the same). ``t`` is an int or an int tensor on the device."""
    b = _f32(beta)
    if isinstance(t, torch.Tensor):
        p = torch.pow(torch.tensor(b, dtype=torch.float64, device=t.device),
                      t.double()).float()
        return 1 - p
    return float(np.float32(1) - np.float32(b ** int(t)))


def _decay(pf, wd, l1):
    return wd * torch.sign(pf) if l1 else wd * pf


@torch.no_grad()
def fused_adam_dense(params, grads, masters, moments1, moments2, decays, *,
                     lr, beta1, beta2, epsilon, weight_decay, l1=False,
                     decoupled=False, clip_norm=0.0, step=1, amp=None,
                     pre_found=None) -> Optional[torch.Tensor]:
    """Plain version of ``fused_adam``: the same in-place update, in
    torch, one parameter at a time. Returns the global norm (f32 [1]) of
    the unscaled gradients when it clips or runs under a scaler, else
    None."""
    gs = list(grads)
    found = None
    if amp is not None:
        if pre_found is None:
            gs, found = amp.unscale(gs)
        else:
            found = pre_found
    norm = None
    if clip_norm > 0 or amp is not None:
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in gs)).reshape(1)
    if clip_norm > 0:
        coef = torch.clamp(clip_norm / torch.clamp(norm, min=1e-6), max=1.0)
        gs = [(g.float() * coef).to(g.dtype) for g in gs]
    t = amp.applied_step(found) if amp is not None else step
    # as tensors on the parameters' device: CUDA divides by a host scalar
    # as a product with its reciprocal, which rounds twice
    bc1, bc2 = (torch.as_tensor(bias_correction(b, t), dtype=torch.float32,
                                device=params[0].device)
                for b in (beta1, beta2))
    b1, b2, eps = _f32(beta1), _f32(beta2), _f32(epsilon)
    c1, c2 = _f32(1 - beta1), _f32(1 - beta2)
    lr, wd = _f32(lr), _f32(weight_decay)
    for p, g, master, m, v, decay in zip(params, gs, masters, moments1,
                                         moments2, decays):
        pf = master if master is not None else p.float()
        gf = g.float()
        if decay and not decoupled:
            gf = gf + _decay(pf, wd, l1)
        m1 = m.float() * b1 + gf * c1
        v1 = v.float() * b2 + torch.square(gf) * c2
        upd = (m1 / bc1) / (torch.sqrt(v1 / bc2) + eps)
        if decay and decoupled:
            upd = upd + _decay(pf, wd, l1)
        new = pf - lr * upd
        outs = [(m, m1), (v, v1), (p, new)]
        if master is not None:
            outs.append((master, new))
        for dst, val in outs:
            val = val.to(dst.dtype)
            if found is not None:
                val = torch.where(found > 0, dst, val)
            dst.copy_(val)
    if amp is not None:
        amp.bookkeep(found)
    return norm


class _Args(ctypes.Structure):
    """``struct Args`` of csrc/fused_adam.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "descs", "chunks", "partial", "flags", "scalars", "out",
        "amp_scale", "amp_counts", "pre_found")] + [
        (n, ctypes.c_float) for n in (
            "lr", "beta1", "beta2", "c1", "c2", "eps", "wd", "clip",
            "incr_ratio", "decr_ratio", "scale_cap")] + [
        (n, ctypes.c_int) for n in (
            "n_chunks", "l1", "decoupled", "step", "reduce", "unscale",
            "dynamic", "incr_every", "decr_every", "state_dtype")]


@functools.cache
def _lib():
    fn = _build.library("fused_adam").fused_adam_launch
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# per (device, shapes, dtypes, masters, decay flags) key: the chunk table
# and the per-chunk workspace, built once, as JAX's jit caches its
# executable per pytree structure and shapes
_PLANS: Dict[tuple, tuple] = {}


def _plan(dev, params, masters, decays):
    key = (str(dev),) + tuple(
        (tuple(p.shape), p.dtype, m is not None, bool(d))
        for p, m, d in zip(params, masters, decays))
    plan = _PLANS.get(key)
    if plan is None:
        table = [(i, c) for i, p in enumerate(params)
                 for c in range(-(-p.numel() // CHUNK))]
        chunks = torch.tensor(np.asarray(table, np.int32).reshape(-1, 2),
                              device=dev)
        n = max(len(table), 1)
        plan = (chunks, torch.empty(n, dtype=torch.float32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(8, dtype=torch.float32, device=dev))
        if len(_PLANS) >= 16:
            _PLANS.pop(next(iter(_PLANS)))
        _PLANS[key] = plan
    return plan


def _check(params, grads, masters, moments1, moments2, decays):
    n = len(params)
    if not (len(grads) == len(masters) == len(moments1) == len(moments2)
            == len(decays) == n):
        raise ValueError("fused_adam: params, grads, masters, moments and "
                         "decay flags must be lists of one length")
    sdt = {m.dtype for m in list(moments1) + list(moments2)}
    if len(sdt) > 1 or not sdt <= set(_SDTYPES):
        raise TypeError(f"fused_adam: moments must all be float32 or all "
                        f"bfloat16, got {sorted(map(str, sdt))}")
    for i, (p, g, mw, m, v) in enumerate(zip(params, grads, masters,
                                             moments1, moments2)):
        if p.dtype not in _PDTYPES:
            raise TypeError(f"fused_adam: parameter {i} dtype {p.dtype} "
                            "(float32, bfloat16 or float16)")
        if g.dtype != p.dtype or g.shape != p.shape:
            raise TypeError(f"fused_adam: gradient {i} is {g.dtype} "
                            f"{tuple(g.shape)}, its parameter {p.dtype} "
                            f"{tuple(p.shape)}")
        if mw is not None and (mw.dtype != torch.float32
                               or mw.shape != p.shape):
            raise TypeError(f"fused_adam: master {i} must be float32 of "
                            f"the parameter's shape")
        if m.shape != p.shape or v.shape != p.shape:
            raise ValueError(f"fused_adam: moments {i} must have the "
                             "parameter's shape")


def fused_adam(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               masters: Sequence[Optional[torch.Tensor]],
               moments1: Sequence[torch.Tensor],
               moments2: Sequence[torch.Tensor], decays: Sequence[bool], *,
               lr, beta1, beta2, epsilon, weight_decay, l1=False,
               decoupled=False, clip_norm=0.0, step=1, amp=None,
               pre_found=None) -> Optional[torch.Tensor]:
    """Update ``params`` (and their masters and moments) in place; see
    the module docstring. ``step`` is the bias-correction step unless
    ``amp`` (an ``amp.AmpStep``) carries it. ``pre_found`` (f32 [1]) is
    an overflow flag the caller computed when it unscaled and clipped
    the gradients itself (a ``ClipGradByNorm`` / ``ClipGradByValue``
    clip): the update then only ORs it with its own check and does not
    unscale again. Returns the global norm of the unscaled gradients (f32
    [1]) when clipping or under a scaler, else None."""
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, epsilon=epsilon,
              weight_decay=weight_decay, l1=l1, decoupled=decoupled,
              clip_norm=clip_norm, step=step, amp=amp, pre_found=pre_found)
    _check(params, grads, masters, moments1, moments2, decays)
    tensors = [t for ts in (params, grads, moments1, moments2) for t in ts]
    tensors += [m for m in masters if m is not None]
    if amp is not None:
        tensors += [amp.scale, amp.counts]
    if pre_found is not None:
        tensors.append(pre_found)
    if not params:
        return None
    if route(*tensors) == "cpu":
        return fused_adam_dense(params, grads, masters, moments1, moments2,
                                decays, **kw)
    for i, t in enumerate(tensors):
        want_contiguous(t, f"fused_adam tensor {i}")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_adam: tensor {i} is not 16-byte "
                             "aligned")
    dev = params[0].device
    chunks, partial, flags, scalars = _plan(dev, params, masters, decays)
    desc = np.zeros((len(params), 7), np.int64)
    for i, (p, g, mw, m, v, d) in enumerate(zip(params, grads, masters,
                                                moments1, moments2, decays)):
        desc[i] = (p.data_ptr(), g.data_ptr(),
                   0 if mw is None else mw.data_ptr(), m.data_ptr(),
                   v.data_ptr(), p.numel(),
                   _PDTYPES[p.dtype] | (mw is not None) << 8 | bool(d) << 9)
    # one small H2D copy a step: gradients are freed by clear_grad, so
    # their addresses change between steps. The pinned staging buffer
    # stays alive in the caching host allocator until the copy is done.
    descs = torch.from_numpy(desc).pin_memory().to(dev, non_blocking=True)
    out = torch.zeros(2, dtype=torch.float32, device=dev)
    reduce = clip_norm > 0 or amp is not None
    a = _Args(
        descs=descs.data_ptr(), chunks=chunks.data_ptr(),
        partial=partial.data_ptr(), flags=flags.data_ptr(),
        scalars=scalars.data_ptr(), out=out.data_ptr(),
        amp_scale=amp.scale.data_ptr() if amp is not None else None,
        amp_counts=amp.counts.data_ptr() if amp is not None else None,
        pre_found=pre_found.data_ptr() if pre_found is not None else None,
        lr=lr, beta1=_f32(beta1), beta2=_f32(beta2), c1=_f32(1 - beta1),
        c2=_f32(1 - beta2), eps=epsilon, wd=weight_decay,
        clip=clip_norm if clip_norm > 0 else 0.0,
        incr_ratio=amp.incr_ratio if amp is not None else 1.0,
        decr_ratio=amp.decr_ratio if amp is not None else 1.0,
        scale_cap=amp.cap if amp is not None else 1.0,
        n_chunks=chunks.shape[0], l1=int(bool(l1)),
        decoupled=int(bool(decoupled)), step=int(step) if amp is None else 0,
        reduce=int(reduce), unscale=int(pre_found is None),
        dynamic=int(amp.dynamic) if amp is not None else 0,
        incr_every=amp.incr_every if amp is not None else 0,
        decr_every=amp.decr_every if amp is not None else 0,
        state_dtype=_SDTYPES[moments1[0].dtype])
    _build.check(_lib()(ctypes.byref(a), stream(params[0])), "fused_adam")
    fused_adam.launches += 1
    if amp is not None:
        amp.found = out[1:2]
    return out[0:1] if reduce else None


counted(fused_adam)

"""Tensor-parallel communication primitives (counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/mp_ops.py``).

Each primitive is a ``torch.autograd.Function`` whose backward is the
JAX ``custom_vjp`` rule (the Megatron pairings):

- ``identity_psum_bwd``   identity forward, all-reduce of the gradient
  (f in Megatron; ``_c_identity``, the column-parallel input);
- ``psum_identity_bwd``   all-reduce forward, identity backward (g;
  ``_mp_allreduce``, the row-parallel output);
- ``allgather_slice_bwd`` all-gather along an axis, this rank's slice
  back (``_c_concat``);
- ``slice_allgather_bwd`` this rank's slice, all-gather back
  (``_c_split``);
- ``allgather_reducescatter_bwd`` / ``reducescatter_allgather_bwd``
  the sequence-parallel pair.

``mp_active(group)`` is True for an mp group of more than one rank; with
no argument it reads the fleet's HCG, as the JAX one reads the SPMD
region. Off an active group every primitive is the identity.
"""
from __future__ import annotations

from typing import Optional

import torch

from .... import collective as C
from .....observability import commledger as cl

__all__ = ["_c_identity", "_c_concat", "_c_split", "_mp_allreduce",
           "mp_group", "mp_active", "identity_psum_bwd",
           "psum_identity_bwd", "allgather_slice_bwd",
           "slice_allgather_bwd", "allgather_reducescatter_bwd",
           "reducescatter_allgather_bwd"]


def mp_group(group: Optional[C.Group] = None) -> Optional[C.Group]:
    """``group``, or the fleet HCG's model-parallel group; None when
    there is neither or it spans one rank."""
    g = group
    if g is None:
        from .... import fleet as _fleet

        hcg = _fleet.get_hybrid_communicate_group()
        if hcg is not None:
            g = hcg.get_model_parallel_group()
    if g is None:
        return None
    if not isinstance(g, C.Group):
        raise TypeError(f"mp_group must be a distributed Group (new_group, "
                        f"or the fleet HCG's), got {type(g).__name__}")
    return g if g.nranks > 1 else None


def mp_active(group: Optional[C.Group] = None) -> bool:
    return mp_group(group) is not None


def _carry(ctx):
    """Note the forward thread's open comm captures on ``ctx``: a CUDA
    backward runs on autograd's device thread, and its collectives are
    booked into them there (``commledger.carried``)."""
    ctx.captures = cl.open_captures()


def _slice(x, g, axis):
    n = x.shape[axis] // g.nranks
    return x.narrow(axis, g.rank * n, n).contiguous()


class _IdentityPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        _carry(ctx)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        with cl.carried(ctx.captures):
            return C.t_psum(dy.contiguous(), ctx.g), None


class _PsumIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return C.t_psum(x.contiguous(), g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _AllgatherSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, axis):
        ctx.g, ctx.axis = g, axis
        return C.t_all_gather(x.contiguous(), g, axis=axis)

    @staticmethod
    def backward(ctx, dy):
        return _slice(dy, ctx.g, ctx.axis), None, None


class _SliceAllgather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, axis):
        ctx.g, ctx.axis = g, axis
        _carry(ctx)
        return _slice(x, g, axis)

    @staticmethod
    def backward(ctx, dy):
        with cl.carried(ctx.captures):
            return C.t_all_gather(dy.contiguous(), ctx.g,
                                  axis=ctx.axis), None, None


class _AllgatherReducescatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, axis):
        ctx.g, ctx.axis = g, axis
        _carry(ctx)
        return C.t_all_gather(x.contiguous(), g, axis=axis)

    @staticmethod
    def backward(ctx, dy):
        with cl.carried(ctx.captures):
            return C.t_psum_scatter(dy.contiguous(), ctx.g,
                                    scatter_dimension=ctx.axis), None, None


class _ReducescatterAllgather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, axis):
        ctx.g, ctx.axis = g, axis
        _carry(ctx)
        return C.t_psum_scatter(x.contiguous(), g, scatter_dimension=axis)

    @staticmethod
    def backward(ctx, dy):
        with cl.carried(ctx.captures):
            return C.t_all_gather(dy.contiguous(), ctx.g,
                                  axis=ctx.axis), None, None


def identity_psum_bwd(x, group):
    return _IdentityPsum.apply(x, group)


def psum_identity_bwd(x, group):
    return _PsumIdentity.apply(x, group)


def allgather_slice_bwd(x, group, axis=-1):
    return _AllgatherSlice.apply(x, group, axis % x.dim())


def slice_allgather_bwd(x, group, axis=-1):
    return _SliceAllgather.apply(x, group, axis % x.dim())


def allgather_reducescatter_bwd(x, group, axis=0):
    return _AllgatherReducescatter.apply(x, group, axis % x.dim())


def reducescatter_allgather_bwd(x, group, axis=0):
    return _ReducescatterAllgather.apply(x, group, axis % x.dim())


def _c_identity(x, group: Optional[C.Group] = None):
    """Forward identity; backward all-reduces the gradient over mp (the
    column-parallel input)."""
    g = mp_group(group)
    return x if g is None else identity_psum_bwd(x, g)


def _mp_allreduce(x, group: Optional[C.Group] = None, op=None):
    """Forward all-reduce over mp; backward identity (the row-parallel
    output)."""
    g = mp_group(group)
    return x if g is None else psum_identity_bwd(x, g)


def _c_concat(x, group: Optional[C.Group] = None):
    """Forward all-gather along the last dim; backward this rank's
    slice (the column-parallel output with ``gather_output``)."""
    g = mp_group(group)
    return x if g is None else allgather_slice_bwd(x, g, -1)


def _c_split(x, group: Optional[C.Group] = None):
    """Forward this rank's slice of the last dim; backward all-gather
    (the row-parallel input without ``input_is_parallel``)."""
    g = mp_group(group)
    return x if g is None else slice_allgather_bwd(x, g, -1)

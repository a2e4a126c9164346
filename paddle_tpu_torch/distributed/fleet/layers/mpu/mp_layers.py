"""Model-parallel layers (counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py``).

Megatron-style tensor parallelism over the model-parallel group (the
``mp_group`` argument, else the fleet HCG's; one process a rank). Each
layer holds its rank's shard and marks it with the dim it is split on
(``split_axis``, in the port's layout) and the group (``mp_group``),
which ``convert.py``, the engine and the clip read (``mp_sharded``):

- ``VocabParallelEmbedding``: weight rows ``[V / mp, H]``; the masked
  local lookup (ids outside this rank's rows give zeros, the JAX
  ``_c_embedding``) and an all-reduce;
- ``ColumnParallelLinear``: ``nn.Linear`` weight ``[out / mp, in]`` and
  bias ``[out / mp]``; ``_c_identity`` on its input (the gradient is
  all-reduced), the output gathered along the last dim with
  ``gather_output``;
- ``RowParallelLinear``: weight ``[out, in / mp]``; the input split
  unless ``input_is_parallel``, the product all-reduced, then the
  (replicated) bias added once;
- ``parallel_cross_entropy``: softmax cross entropy over vocab-sharded
  logits in f32: a max all-reduce, the sum of exponentials and the
  target logit all-reduced, the backward (softmax - onehot) computed
  locally.

At degree 1 the three layers are a plain embedding and plain linears
(bias-free unless ``has_bias``, which GPT's projections set; the port's
Llama takes none) and ``parallel_cross_entropy`` is the plain cross
entropy. Weights are ``nn.Linear``s, ``[out, in]``, where the JAX
package stores ``[in, out]``: ``paddle_tpu_torch.convert`` transposes.
Under ``amp.auto_cast`` the linears cast their f32 input and weight to
the AMP dtype (op ``linear``), as the JAX dispatch hook does.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as TF

from .....amp import cast_inputs
from .....core.enforce import enforce
from .....nn import functional as F
from .mp_ops import (_c_concat, _c_identity, _c_split, _mp_allreduce,
                     mp_active)
from .mp_ops import mp_group as _group_of
from .... import collective as C

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "mp_active",
           "parallel_cross_entropy", "mark_distributed", "mp_sharded"]


def mark_distributed(p: torch.Tensor, axis: int, group: C.Group) -> None:
    """Mark ``p`` as this rank's shard of a tensor split on dim ``axis``
    over ``group`` (Paddle's ``is_distributed``; torch's tensors already
    have a method of that name)."""
    p.split_axis = axis
    p.mp_group = group


def mp_sharded(p: torch.Tensor) -> bool:
    """Is ``p`` a tensor-parallel shard (``mark_distributed``)?"""
    return getattr(p, "mp_group", None) is not None


def _world(group):
    g = _group_of(group)
    return g, (1 if g is None else g.nranks)


class VocabParallelEmbedding(nn.Embedding):
    """Token embedding, weight ``[vocab, hidden]`` as in the JAX package;
    its rows split over mp."""

    def __init__(self, num_embeddings: int, embedding_dim: int, device=None,
                 dtype=None, mp_group=None):
        g, n = _world(mp_group)
        enforce(num_embeddings % n == 0,
                f"vocab size {num_embeddings} must divide mp degree {n}")
        super().__init__(num_embeddings // n, embedding_dim, device=device,
                         dtype=dtype)
        self.full_num_embeddings = num_embeddings
        self.world_size = n
        self.is_mp = g is not None
        self._mp_group = g
        if self.is_mp:
            self.vocab_start = g.rank * (num_embeddings // n)
            mark_distributed(self.weight, 0, g)

    def forward(self, ids):
        if not self.is_mp:
            return super().forward(ids)
        vloc = self.num_embeddings
        local = ids - self.vocab_start
        inside = (local >= 0) & (local < vloc)
        out = TF.embedding(local.clamp(0, vloc - 1), self.weight)
        out = out.masked_fill(~inside.unsqueeze(-1), 0)
        return _mp_allreduce(out, self._mp_group)


class _Linear(nn.Linear):
    def forward(self, x):
        return TF.linear(*cast_inputs("linear", x, self.weight, self.bias))


class ColumnParallelLinear(_Linear):
    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=None, has_bias: bool = False,
                 gather_output: bool = True, mp_group=None):
        g, n = _world(mp_group)
        enforce(out_features % n == 0,
                f"out_features {out_features} must divide mp degree {n}")
        super().__init__(in_features, out_features // n, bias=has_bias,
                         device=device, dtype=dtype)
        self.full_out_features = out_features
        self.gather_output = gather_output
        self.world_size = n
        self.is_mp = g is not None
        self._mp_group = g
        if self.is_mp:
            mark_distributed(self.weight, 0, g)
            if self.bias is not None:
                mark_distributed(self.bias, 0, g)

    def forward(self, x):
        if not self.is_mp:
            return super().forward(x)
        out = super().forward(_c_identity(x, self._mp_group))
        return _c_concat(out, self._mp_group) if self.gather_output else out


class RowParallelLinear(_Linear):
    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=None, has_bias: bool = False,
                 input_is_parallel: bool = False, mp_group=None):
        g, n = _world(mp_group)
        enforce(in_features % n == 0,
                f"in_features {in_features} must divide mp degree {n}")
        super().__init__(in_features // n, out_features, bias=has_bias,
                         device=device, dtype=dtype)
        self.full_in_features = in_features
        self.input_is_parallel = input_is_parallel
        self.world_size = n
        self.is_mp = g is not None
        self._mp_group = g
        if self.is_mp:
            # the bias stays replicated: added once, after the all-reduce
            mark_distributed(self.weight, 1, g)

    def forward(self, x):
        if not self.is_mp:
            return super().forward(x)
        if not self.input_is_parallel:
            x = _c_split(x, self._mp_group)
        x, w, b = cast_inputs("linear", x, self.weight, self.bias)
        out = _mp_allreduce(TF.linear(x, w), self._mp_group)
        return out if b is None else out + b


class _ParallelCE(torch.autograd.Function):
    """The JAX ``_pce_fwd_impl`` / ``_pce_bwd_impl``."""

    @staticmethod
    def forward(ctx, logits, label, g, ignore_index):
        lv = logits.float()
        vloc = lv.shape[-1]
        off = g.rank * vloc
        maxl = C.t_pmax(lv.amax(dim=-1, keepdim=True), g)
        shifted = lv - maxl
        expx = torch.exp(shifted)
        sumexp = C.t_psum(expx.sum(dim=-1, keepdim=True), g)
        local = label - off
        inside = (local >= 0) & (local < vloc)
        local = local.clamp(0, vloc - 1)
        tgt = shifted.gather(-1, local.unsqueeze(-1)).squeeze(-1)
        tgt = C.t_psum(torch.where(inside, tgt, torch.zeros_like(tgt)), g)
        valid = label != ignore_index
        loss = torch.where(valid, torch.log(sumexp.squeeze(-1)) - tgt,
                           torch.zeros_like(tgt)).unsqueeze(-1)
        ctx.save_for_backward(expx.div_(sumexp), local, inside, valid)
        ctx.in_dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, dloss):
        softmax, local, inside, valid = ctx.saved_tensors
        onehot = torch.zeros_like(softmax).scatter_(
            -1, local.unsqueeze(-1),
            inside.unsqueeze(-1).to(softmax.dtype))
        gl = (softmax - onehot) * dloss
        gl = torch.where(valid.unsqueeze(-1), gl, torch.zeros_like(gl))
        return gl.to(ctx.in_dtype), None, None, None


def parallel_cross_entropy(logits, label, mp_group=None,
                           ignore_index: int = -100):
    """Softmax cross entropy over (vocab-sharded, at mp > 1) logits: f32
    log-softmax, ``ignore_index`` labels give 0, loss shape
    ``label.shape + [1]`` as the reference returns it."""
    g = _group_of(mp_group)
    if g is None:
        loss = F.cross_entropy(logits, label, reduction="none",
                               ignore_index=ignore_index)
        return loss.unsqueeze(-1)
    if label.dim() == logits.dim():      # [..., 1] labels, as Paddle takes
        label = label.squeeze(-1)
    return _ParallelCE.apply(logits, label, g, int(ignore_index))


class ParallelCrossEntropy(nn.Module):
    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        self._mp_group = mp_group
        self._ignore_index = ignore_index

    def forward(self, logits, label):
        return parallel_cross_entropy(logits, label, self._mp_group,
                                      self._ignore_index)

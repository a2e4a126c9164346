"""Functional ops (counterpart of ``paddle_tpu/nn/functional.py``):
cross entropy with every option of the JAX ``cross_entropy_loss``,
dropout, embedding, Paddle's attention entry points
(``scaled_dot_product_attention``, ``flash_attention``,
``flash_attn_unpadded``) and the layer norm, GELU and Paddle-layout
linear of the fused ops.

The attention entry points return what the JAX ones return (``(out,
None)`` for the flash pair, ``return_softmax`` or not) and run K1/K2
through ``ops/attention.py``. Their dropout is the kernels' Philox mask:
it takes a ``generator=`` (a CPU ``torch.Generator``) or a ``seed=``
where the JAX functions draw a key from the global RNG.
``fixed_seed_offset`` and ``rng_name`` (which the JAX functions accept
and ignore) raise when given."""
from __future__ import annotations

import math

import torch
from torch.nn import functional as _F

from ..amp import cast_inputs
from ..ops import attention as _attn
from ..ops.kernels import dropout_mask as _dm
from ..ops.kernels.flash_attention import flash_attention_fwd

__all__ = ["cross_entropy", "dropout", "embedding", "flash_attention",
           "flash_attn_unpadded", "gelu", "layer_norm", "linear",
           "scaled_dot_product_attention"]

_MODES = ("upscale_in_train", "downscale_in_infer")


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


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Dropout as the JAX ``dropout`` (ops/nn_ops.py:510-517): identity
    when not ``training`` or p = 0, in either mode (the JAX package does
    not scale in inference); otherwise each element is kept with
    probability 1 - p, the mask drawn with ``torch.rand(..., generator=
    generator)`` on x's device (the default generator when None). Kept
    elements are x / (1 - p) under "upscale_in_train" and x under
    "downscale_in_infer"; dropped ones 0, in x's dtype. ``axis`` (which
    the JAX package accepts and ignores) raises when given: ROADMAP.md
    queue 1, item 2.11."""
    if axis is not None:
        raise NotImplementedError(
            "dropout(axis=...): the JAX package accepts and ignores axis; "
            "the port raises on it (ROADMAP.md queue 1, item 2.11)")
    if mode not in _MODES:
        raise ValueError(f"dropout: mode must be one of {_MODES}, got "
                         f"{mode!r}")
    p = float(p)
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout: p must lie in [0, 1], got {p}")
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    if mode == "downscale_in_infer":
        return torch.where(mask, x, torch.zeros_like(x))
    if keep == 0.0:             # everything dropped: x / 0 never enters
        return x * mask
    # 1 - p rounded to x's dtype first, as JAX's weakly typed scalar is
    keep = float(torch.tensor(keep, dtype=x.dtype))
    return torch.where(mask, x / keep, torch.zeros_like(x))


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` [V, D] at the ids ``x``; with ``padding_idx``,
    positions holding that id give zeros (their gradient too), as the
    JAX ``embedding`` (ops/nn_ops.py:521) multiplies by the mask (the id
    is compared as given: the layer normalises a negative one). With
    ``sparse`` the weight's gradient is a sparse COO tensor of the
    looked-up rows (``nn/sparse_embedding.py``), where the JAX functional
    ignores the flag and only its layer takes it."""
    if sparse:
        from .sparse_embedding import sparse_embedding
        return sparse_embedding(x, weight, padding_idx)
    out = _F.embedding(x, weight)
    if padding_idx is not None:
        out = out * (x != padding_idx)[..., None].to(out.dtype)
    return out


def _no_rng_knobs(what, fixed_seed_offset, rng_name):
    if fixed_seed_offset is not None or rng_name:
        raise NotImplementedError(
            f"{what}: fixed_seed_offset / rng_name (which the JAX package "
            "accepts and ignores) are not taken; give generator= or seed= "
            "for the dropout mask (ROADMAP.md queue 3, reference-side "
            "divergences)")


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, generator=None,
                                 seed=None):
    """Attention over [batch, seqlen, num_heads, head_dim] (the JAX
    ``scaled_dot_product_attention``, ops/nn_ops.py:672). Without a mask
    it runs K1/K2 (``is_causal``: the bottom-right rule, as the JAX op's
    ``tril(k=Sk - S)``), k and v may carry fewer heads, and a row that
    sees no key gives 0. With a bool (True = attend) or additive
    ``attn_mask`` it runs the JAX formula in torch ops, as the JAX
    package runs it in XLA: f32 scores, -inf where masked, a softmax
    (a row with no key is NaN there too), then the dropout of the JAX op
    (ops/nn_ops.py:693-702) if any, the output in q's dtype.
    ``dropout_p`` (in training) needs ``generator=`` or ``seed=``. Both
    paths drop by the kernels' Philox mask (``ops/kernels/dropout_mask.py``)
    from one seed: the masked path keeps ``dropout_keep(seed, p, B, H, Sq,
    Skv)``'s elements scaled by ``keep_scale(p)`` and zeroes the rest, so
    an all-True mask drops what K1 drops with that seed. Gradients flow
    by autograd through the constant mask."""
    p = float(dropout_p) if training else 0.0
    seed = _attn._dropout_seed(p, generator, seed)
    if attn_mask is None:
        q, k, v = cast_inputs("scaled_dot_product_attention", query, key,
                              value)
        return flash_attention_fwd(q, k, v, bool(is_causal), dropout=p,
                                   seed=seed)
    q, k, v = cast_inputs("scaled_dot_product_attention", query, key, value)
    B, S, H, D = q.shape
    qf, kf, vf = (t.transpose(1, 2).float() for t in (q, k, v))
    scores = qf @ kf.transpose(-1, -2) * (1.0 / math.sqrt(D))
    if is_causal:
        keep = torch.ones(S, kf.shape[2], dtype=torch.bool,
                          device=q.device).tril(kf.shape[2] - S)
        scores = scores.masked_fill(~keep, float("-inf"))
    if attn_mask.dtype == torch.bool:
        scores = scores.masked_fill(~attn_mask, float("-inf"))
    else:
        scores = scores + attn_mask
    probs = torch.softmax(scores, -1)
    if p:
        keep = _dm.dropout_keep(seed, p, B, H, S, kf.shape[2], q.device)
        probs = torch.where(keep, probs * _dm.keep_scale(p),
                            torch.zeros((), device=q.device))
    out = probs @ vf
    return out.transpose(1, 2).to(q.dtype)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None, generator=None,
                    seed=None):
    """Paddle's ``flash_attention`` over [batch, seqlen, num_heads,
    head_dim]: K1/K2 (``ops/attention.flash_attention``); ``(out, None)``
    with or without ``return_softmax``, as the JAX function returns."""
    _no_rng_knobs("flash_attention", fixed_seed_offset, rng_name)
    p = float(dropout) if training else 0.0
    return _attn.flash_attention(query, key, value, causal=bool(causal),
                                 dropout=p, generator=generator,
                                 seed=seed), None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None, generator=None, seed=None):
    """Paddle's packed varlen flash attention: q/k/v [total_tokens, H, D],
    boundaries ``cu_seqlens_*``; K1/K2 with each sequence's own frontier
    (``ops/attention.flash_attn_varlen``). ``max_seqlen_*`` are hints
    the pack does not need. Returns ``(out, None)``."""
    _no_rng_knobs("flash_attn_unpadded", fixed_seed_offset, rng_name)
    p = float(dropout) if training else 0.0
    return _attn.flash_attn_varlen(query, key, value, cu_seqlens_q,
                                   cu_seqlens_k, causal=bool(causal),
                                   scale=scale, dropout=p,
                                   generator=generator, seed=seed), None


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  label_smoothing=0.0, use_softmax=True, name=None):
    """Softmax cross entropy, the JAX ``cross_entropy_loss``'s formula
    (ops/nn_ops.py:561-592), written out rather than ``F.cross_entropy``,
    which differs in three places:

    - f32 log-softmax over ``axis`` whatever the logits' dtype;
    - hard labels: a label equal to ``ignore_index`` contributes 0 and is
      not valid; ``label_smoothing`` eps targets (1 - eps) one-hot + eps /
      n_class before any weight; ``weight`` [n_class] multiplies each
      loss by ``weight[label]`` and makes the mean's denominator
      ``sum(weight[label] * valid)`` (at least 1);
    - soft labels (``label`` a distribution over ``axis``): every row is
      valid, ``weight`` is not read (as there).

    ``reduction`` "mean" divides the sum by the valid count (at least 1).
    ``use_softmax=False`` raises: the JAX functional accepts it and
    applies the softmax anyway (ROADMAP.md queue 3)."""
    if not use_softmax:
        raise NotImplementedError(
            "cross_entropy(use_softmax=False): the JAX package accepts and "
            "ignores it (its loss always takes the softmax); the port "
            "raises (ROADMAP.md queue 3, reference-side divergences)")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    ax = axis % input.dim()
    logp = torch.log_softmax(input.float(), dim=ax)
    n_class = input.shape[ax]
    if soft_label:
        loss = -(label * logp).sum(ax)
        valid = torch.ones_like(loss)
    else:
        lbl = label.squeeze(ax) if label.dim() == input.dim() else label
        valid = (lbl != ignore_index).float()
        safe = torch.where(lbl == ignore_index, torch.zeros_like(lbl),
                           lbl).long()
        if label_smoothing > 0.0:
            onehot = _F.one_hot(safe, n_class).to(logp.dtype).movedim(-1, ax)
            target = onehot * (1 - label_smoothing) + label_smoothing / n_class
            loss = -(target * logp).sum(ax) * valid
        else:
            picked = torch.gather(logp, ax, safe.unsqueeze(ax)).squeeze(ax)
            loss = -picked * valid
        if weight is not None:
            w = weight[safe]
            loss = loss * w
            valid = w * valid
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1.0)
    if reduction == "sum":
        return loss.sum()
    return loss

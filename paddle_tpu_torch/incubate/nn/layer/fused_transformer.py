"""``FusedMultiHeadAttention``, ``FusedFeedForward`` and
``FusedMultiTransformer`` (counterpart of
``paddle_tpu/incubate/nn/layer/fused_transformer.py``).

``FusedMultiHeadAttention`` and ``FusedFeedForward`` are the training
blocks: (pre- or post-) LN, fused qkv projection, causal flash attention
(K1/K2) with attention dropout in train mode, out projection, dropout,
residual; and LN, linear, activation, dropout, linear, dropout,
residual. Their parameters keep Paddle's ``[in, out]`` layout and the
JAX names (``qkv_weight``, ``linear1_weight``, ...). Each layer owns its
dropout generators, seeded from ``seed`` as ``models.gpt`` seeds a
model's: hidden dropout on the layer's device (``seed + 1``), attention
dropout's seeds from the CPU (``seed + 2718``). Knobs the JAX layers
accept and then ignore raise here when set: ``attn_mask`` (which the JAX
layer turns into non-causal attention without applying it), ``cache``,
``key``/``value`` other than the query, ``kdim``/``vdim``,
``need_weights``, the ``*_attr`` ParamAttrs (ROADMAP.md queue 1, item
2.2) and tensor parallelism (``nranks``, ``ring_id``: item 8's remainder).

``FusedMultiTransformer`` is the reference's inference decoder stack over
fused_multi_transformer_op.cu.h.

Each layer is LN -> fused qkv projection -> attention -> out projection
-> residual -> LN -> FFN -> residual. With caches the new K/V rows are
written in place into the caller's head-major ``[B, H, M, D]`` caches at
``time_step`` and the attention is kernel K6; without caches it is
causal flash attention (K1). Parameters keep Paddle's ``[in, out]``
layout and the JAX layer's names (``ln_scales_0``, ``qkv_weights_0``,
...), so ``convert.load_jax_state_dict`` carries them untransposed.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from ....core.enforce import enforce
from ....models.gpt import _generators
from ....models.llama import resolve_device
from ....nn import functional as F
from ....ops.attention import flash_attention
from ..functional import _ACT, _attention

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedMultiTransformer"]


def _params(module, shapes, device, dtype, seed):
    """Register ``shapes`` {name: shape} on ``module``: ``*_weight``
    Xavier-uniform from a generator seeded with ``seed``, ``*scale`` 1,
    the rest (biases) 0, as the JAX layers initialise them."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    for name, shape in shapes.items():
        p = nn.Parameter(torch.zeros(shape, device=device, dtype=dtype))
        if name.endswith("scale"):
            nn.init.ones_(p)
        elif name.endswith("weight"):
            nn.init.xavier_uniform_(p, generator=g)
        module.register_parameter(name, p)


def _unported(what, **knobs):
    on = sorted(k for k, v in knobs.items() if v is not None)
    enforce(not on, lambda: f"{what}: {', '.join(on)} not ported (the JAX "
            "layer accepts and ignores them; ParamAttr is ROADMAP.md queue "
            "1, item 2.2)")


class FusedMultiHeadAttention(nn.Module):
    """Pre/post-LN self-attention block with a fused qkv projection (the
    JAX layer, fused_transformer.py:44): causal attention, attention
    dropout ``attn_dropout_rate`` and output dropout ``dropout_rate`` in
    train mode. ``device=None`` means the CUDA device."""

    def __init__(self, embed_dim: int, num_heads: int,
                 dropout_rate: float = 0.5, attn_dropout_rate: float = 0.5,
                 kdim=None, vdim=None, normalize_before: bool = False,
                 need_weights: bool = False, qkv_weight_attr=None,
                 qkv_bias_attr=None, linear_weight_attr=None,
                 linear_bias_attr=None, pre_ln_scale_attr=None,
                 pre_ln_bias_attr=None, ln_scale_attr=None,
                 ln_bias_attr=None, epsilon: float = 1e-5,
                 nranks: int = 1, ring_id: int = -1, name=None, device=None,
                 dtype=None, seed: int = 0):
        super().__init__()
        _unported("FusedMultiHeadAttention", kdim=kdim, vdim=vdim,
                  qkv_weight_attr=qkv_weight_attr,
                  qkv_bias_attr=qkv_bias_attr,
                  linear_weight_attr=linear_weight_attr,
                  linear_bias_attr=linear_bias_attr,
                  pre_ln_scale_attr=pre_ln_scale_attr,
                  pre_ln_bias_attr=pre_ln_bias_attr,
                  ln_scale_attr=ln_scale_attr, ln_bias_attr=ln_bias_attr,
                  need_weights=need_weights or None)
        enforce(nranks == 1 and ring_id == -1,
                "FusedMultiHeadAttention: tensor parallelism is not ported "
                "(ROADMAP.md queue 1, item 8's remainder)")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self._epsilon = epsilon
        dev = resolve_device(device)
        E = embed_dim
        _params(self, {"qkv_weight": (E, 3 * E), "qkv_bias": (3 * E,),
                       "linear_weight": (E, E), "linear_bias": (E,),
                       "pre_ln_scale": (E,), "pre_ln_bias": (E,),
                       "ln_scale": (E,), "ln_bias": (E,)}, dev, dtype, seed)
        self._hidden_gen, self._attn_gen = _generators(dev, seed)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        enforce(attn_mask is None and cache is None
                and (key is None or key is query)
                and (value is None or value is query),
                "FusedMultiHeadAttention: attn_mask, cache and a key/value "
                "other than the query are not served (the JAX layer ignores "
                "them: causal self-attention)")
        x = residual = query
        if self.normalize_before:
            x = F.layer_norm(x, self.pre_ln_scale, self.pre_ln_bias,
                             self._epsilon)
        B, S = x.shape[0], x.shape[1]
        qkv = F.linear(x, self.qkv_weight, self.qkv_bias)
        q, k, v = (t.contiguous() for t in qkv.reshape(
            B, S, self.num_heads, 3 * self.head_dim).split(self.head_dim, -1))
        p = self.attn_dropout_rate if self.training else 0.0
        out = flash_attention(q, k, v, causal=True, dropout=p,
                              generator=self._attn_gen)
        out = F.linear(out.reshape(B, S, self.embed_dim), self.linear_weight,
                       self.linear_bias)
        out = residual + F.dropout(out, self.dropout_rate,
                                   training=self.training,
                                   generator=self._hidden_gen)
        if not self.normalize_before:
            out = F.layer_norm(out, self.ln_scale, self.ln_bias,
                               self._epsilon)
        return out


class FusedFeedForward(nn.Module):
    """LN, linear, activation, dropout, linear, dropout, residual (the
    JAX layer, fused_transformer.py:114); ``act_dropout_rate`` defaults
    to ``dropout_rate``. ``device=None`` means the CUDA device."""

    def __init__(self, d_model: int, dim_feedforward: int,
                 dropout_rate: float = 0.1, epsilon: float = 1e-5,
                 activation: str = "relu", act_dropout_rate=None,
                 normalize_before: bool = False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks: int = 1, ring_id: int = -1,
                 name=None, device=None, dtype=None, seed: int = 0):
        super().__init__()
        _unported("FusedFeedForward", linear1_weight_attr=linear1_weight_attr,
                  linear1_bias_attr=linear1_bias_attr,
                  linear2_weight_attr=linear2_weight_attr,
                  linear2_bias_attr=linear2_bias_attr,
                  ln1_scale_attr=ln1_scale_attr, ln1_bias_attr=ln1_bias_attr,
                  ln2_scale_attr=ln2_scale_attr, ln2_bias_attr=ln2_bias_attr)
        enforce(nranks == 1 and ring_id == -1,
                "FusedFeedForward: tensor parallelism is not ported "
                "(ROADMAP.md queue 1, item 8's remainder)")
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (act_dropout_rate
                                 if act_dropout_rate is not None
                                 else dropout_rate)
        self._epsilon = epsilon
        self._act = _ACT[activation]
        dev = resolve_device(device)
        d, f = d_model, dim_feedforward
        _params(self, {"linear1_weight": (d, f), "linear1_bias": (f,),
                       "linear2_weight": (f, d), "linear2_bias": (d,),
                       "ln1_scale": (d,), "ln1_bias": (d,),
                       "ln2_scale": (d,), "ln2_bias": (d,)}, dev, dtype, seed)
        self._hidden_gen = _generators(dev, seed)[0]

    def forward(self, src):
        residual = x = src
        if self.normalize_before:
            x = F.layer_norm(x, self.ln1_scale, self.ln1_bias, self._epsilon)
        x = self._act(F.linear(x, self.linear1_weight, self.linear1_bias))
        x = F.dropout(x, self.act_dropout_rate, training=self.training,
                      generator=self._hidden_gen)
        x = F.linear(x, self.linear2_weight, self.linear2_bias)
        x = residual + F.dropout(x, self.dropout_rate, training=self.training,
                                 generator=self._hidden_gen)
        if not self.normalize_before:
            x = F.layer_norm(x, self.ln2_scale, self.ln2_bias, self._epsilon)
        return x

_GROUPS = ("ln_scales", "ln_biases", "qkv_weights", "qkv_biases",
           "linear_weights", "linear_biases", "ffn_ln_scales",
           "ffn_ln_biases", "ffn1_weights", "ffn1_biases", "ffn2_weights",
           "ffn2_biases")


class FusedMultiTransformer(nn.Module):
    """Decoder stack with cache-KV generation.

    ``forward(src, caches=None, time_step=None)``: without caches, causal
    attention over the whole sequence; with caches (one (k_cache,
    v_cache) [B, H, M, D] pair per layer, from ``empty_caches``), the new
    K/V rows are written at ``time_step`` (an int or a [B] tensor) and
    every row attends to the cache up to its own position — prefill
    (S > 1 at 0) and decode (S = 1) share the path.

    ``device=None`` means the CUDA device. Weights are Xavier-uniform
    from a generator seeded with ``seed``; LN scales one, biases zero, as
    the JAX layer initialises them. The ``*_attrs`` (ParamAttr), tensor
    parallelism (``nranks``, ``ring_id``) and dropout in training are not
    ported and raise. (The JAX layer ignores ``dropout_rate``; here it
    raises in training mode, where the JAX layer would silently drop
    nothing, and is the identity in eval mode.)"""

    def __init__(self, embed_dim: int, num_heads: int,
                 dim_feedforward: int, dropout_rate: float = 0.0,
                 activation: str = "gelu", normalize_before: bool = True,
                 ln_scale_attrs=None, ln_bias_attrs=None,
                 qkv_weight_attrs=None, qkv_bias_attrs=None,
                 linear_weight_attrs=None, linear_bias_attrs=None,
                 ffn_ln_scale_attrs=None, ffn_ln_bias_attrs=None,
                 ffn1_weight_attrs=None, ffn1_bias_attrs=None,
                 ffn2_weight_attrs=None, ffn2_bias_attrs=None,
                 epsilon: float = 1e-5, num_layers: int = -1,
                 nranks: int = 1, trans_qkvw: bool = True,
                 ring_id: int = -1, name=None, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        attrs = (ln_scale_attrs, ln_bias_attrs, qkv_weight_attrs,
                 qkv_bias_attrs, linear_weight_attrs, linear_bias_attrs,
                 ffn_ln_scale_attrs, ffn_ln_bias_attrs, ffn1_weight_attrs,
                 ffn1_bias_attrs, ffn2_weight_attrs, ffn2_bias_attrs)
        enforce(all(a is None for a in attrs),
                "FusedMultiTransformer: ParamAttr is not ported (ROADMAP.md "
                "queue 1, item 2.2); load weights with "
                "convert.load_jax_state_dict")
        enforce(nranks == 1 and ring_id == -1,
                "FusedMultiTransformer: tensor parallelism is not ported "
                "(ROADMAP.md queue 1, item 8's remainder)")
        enforce(trans_qkvw, "FusedMultiTransformer: the layer's qkv weight "
                "is [embed_dim, 3 * embed_dim]; trans_qkvw applies to the "
                "functional form")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.num_layers = num_layers = num_layers if num_layers >= 0 else 1
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self._epsilon = epsilon
        self._act = _ACT[activation]
        h, f = embed_dim, dim_feedforward
        shapes = {"ln_scales": (h,), "ln_biases": (h,),
                  "qkv_weights": (h, 3 * h), "qkv_biases": (3 * h,),
                  "linear_weights": (h, h), "linear_biases": (h,),
                  "ffn_ln_scales": (h,), "ffn_ln_biases": (h,),
                  "ffn1_weights": (h, f), "ffn1_biases": (f,),
                  "ffn2_weights": (f, h), "ffn2_biases": (h,)}
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(int(seed))
        for group in _GROUPS:
            plist = []
            for i in range(num_layers):
                p = nn.Parameter(torch.zeros(shapes[group], device=dev,
                                             dtype=dtype))
                if group.endswith("scales"):
                    nn.init.ones_(p)
                elif group.endswith("weights"):
                    nn.init.xavier_uniform_(p, generator=g)
                self.register_parameter(f"{group}_{i}", p)
                plist.append(p)
            # plain lists beside the registered names, as the JAX layer
            # keeps them: self.qkv_weights[i] is qkv_weights_{i} (module
            # conversions such as .to() update parameters in place)
            setattr(self, group, plist)

    def empty_caches(self, batch_size: int, max_len: int,
                     dtype=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Zeroed (k, v) caches [B, H, M, D] per layer on the layer's
        device, in its parameters' dtype unless ``dtype`` says otherwise."""
        p = self.qkv_weights[0]
        shape = (batch_size, self.num_heads, max_len, self.head_dim)
        kw = {"device": p.device, "dtype": dtype or p.dtype}
        return [(torch.zeros(shape, **kw), torch.zeros(shape, **kw))
                for _ in range(self.num_layers)]

    def _layer(self, i, x, cache, offset):
        B, S = x.shape[0], x.shape[1]
        residual = x
        if self.normalize_before:
            x = F.layer_norm(x, self.ln_scales[i], self.ln_biases[i],
                             self._epsilon)
        qkv = F.linear(x, self.qkv_weights[i], self.qkv_biases[i])
        q, k, v = qkv.reshape(B, S, self.num_heads, 3 * self.head_dim).split(
            self.head_dim, dim=-1)
        out = _attention(q, k, v, cache, offset).reshape(B, S,
                                                         self.embed_dim)
        x = residual + F.linear(out, self.linear_weights[i],
                                self.linear_biases[i])
        residual = x
        h = F.layer_norm(x, self.ffn_ln_scales[i], self.ffn_ln_biases[i],
                         self._epsilon) if self.normalize_before else x
        h = self._act(F.linear(h, self.ffn1_weights[i], self.ffn1_biases[i]))
        x = residual + F.linear(h, self.ffn2_weights[i], self.ffn2_biases[i])
        if not self.normalize_before:
            x = F.layer_norm(x, self.ffn_ln_scales[i], self.ffn_ln_biases[i],
                             self._epsilon)
        return x

    def forward(self, src, attn_mask=None, caches=None, pre_caches=None,
                time_step=None):
        """Returns the output, or (output, caches) when caches are passed
        (the same tensors, written in place)."""
        enforce(attn_mask is None and pre_caches is None,
                "FusedMultiTransformer: attn_mask and pre_caches are not "
                "served (masking is causal + the cache frontier)")
        enforce(not (self.dropout_rate and self.training),
                "FusedMultiTransformer: dropout_rate in training raises: the "
                "JAX layer accepts and ignores it (ROADMAP.md queue 3); call "
                ".eval()")
        offset = 0 if time_step is None else time_step
        x = src
        for i in range(self.num_layers):
            x = self._layer(i, x, None if caches is None else caches[i],
                            offset)
        return x if caches is None else (x, caches)

"""Fused cache-KV attention functions (counterpart of
``paddle_tpu/incubate/nn/functional/__init__.py``; the reference's
``incubate/nn/functional`` surface over its CUDA decoder kernels).

- ``masked_multihead_attention``: one decode step of a fused qkv row
  against a contiguous ``[2, B, H, M, D]`` cache at per-row offsets. It
  is kernel K6 with Sq = 1 and KV = H.
- ``fused_multi_transformer``: the stateless decoder stack with
  caller-owned weight lists; with caches it attends through K6, without
  them through causal flash attention (K1).
- ``block_multihead_attention``: the decode phase over the paged
  (block-table) cache, GQA layout; it attends through K5.

Caches are written in place and also returned, where the JAX functions
return updated copies. The knobs neither package serves (in-kernel
rotary, quantisation, packing metadata, tensor-parallel rings, masks)
raise, as in the JAX package. ``fused_multi_transformer``'s dropout in
training is the JAX function's: ``nn.functional.dropout`` after each
block's output projection (masks from ``generator``, on x's device).
"""
from __future__ import annotations

import torch

from ....core.enforce import enforce
from ....models.llama import write_cache
from ....nn import functional as F
from ....ops.attention import flash_attention
from ....ops.kernels.decode_attention import (decode_attention,
                                              paged_decode_attention)

__all__ = ["masked_multihead_attention", "fused_multi_transformer",
           "block_multihead_attention"]

_ACT = {"relu": torch.relu, "gelu": F.gelu,
        "silu": torch.nn.functional.silu}


def _attention(q, k, v, cache, offset):
    """q [B, S, H, D] and the new k, v [B, S, KV, D]: with a cache
    (k_cache, v_cache) [B, KV, M, D], write the rows at ``offset`` in
    place and attend through K6; without one, causal flash attention
    (K1)."""
    q = q.contiguous()
    if cache is None:
        return flash_attention(q, k.contiguous(), v.contiguous(), causal=True)
    write_cache(cache[0], k, offset)
    write_cache(cache[1], v, offset)
    return decode_attention(q, cache[0], cache[1], offset)


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               cum_offsets=None, sequence_lengths=None,
                               rotary_tensor=None, beam_cache_offset=None,
                               qkv_out_scale=None, out_shift=None,
                               out_smooth=None, seq_len=1,
                               rotary_emb_dims=0,
                               use_neox_rotary_style=False,
                               compute_dtype="default", out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0):
    """One fused decode step of cache-KV attention.

    x: [B, 3*H*D] fused qkv of the new token; cache_kv: [2, B, H, M, D];
    sequence_lengths: [B, 1] per-row write and attend offsets (0 when
    None). Returns (out [B, H*D], cache_kv) with cache_kv written in
    place."""
    for knob, name in ((src_mask, "src_mask"),
                       (cum_offsets, "cum_offsets"),
                       (beam_cache_offset, "beam_cache_offset"),
                       (rotary_tensor, "rotary_tensor"),
                       (qkv_out_scale, "qkv_out_scale"),
                       (out_shift, "out_shift"),
                       (out_smooth, "out_smooth")):
        enforce(knob is None,
                f"masked_multihead_attention: {name} is not served (masking "
                "is the per-row frontier, packing is the Predictor path) — "
                "pass None")
    enforce(out_scale in (-1, None) and compute_dtype == "default"
            and quant_round_type == 1 and quant_max_bound == 127.0
            and quant_min_bound == -127.0,
            "masked_multihead_attention: output/cache quantization is not "
            "served — leave the quant knobs at their defaults")
    enforce(seq_len == 1, "masked_multihead_attention decodes one token "
                          "per row (seq_len must be 1)")
    enforce(rotary_emb_dims == 0 and not use_neox_rotary_style,
            "masked_multihead_attention: apply rotary embeddings at the "
            "model level; the in-kernel rotary path is not provided")
    enforce(cache_kv is not None and cache_kv.dim() == 5
            and cache_kv.shape[0] == 2,
            "cache_kv must be [2, B, H, max_seq, D]")
    B = x.shape[0]
    _, _, H, M, D = cache_kv.shape
    qkv = x.reshape(B, 3, H, D)
    if bias is not None:
        qkv = qkv + bias.reshape(1, 3, H, D)
    off = (sequence_lengths.reshape(B).to(torch.int32)
           if sequence_lengths is not None
           else torch.zeros(B, dtype=torch.int32, device=x.device))
    out = _attention(qkv[:, 0, None], qkv[:, 1, None], qkv[:, 2, None],
                     (cache_kv[0], cache_kv[1]), off)
    return out.reshape(B, H * D), cache_kv


def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights,
                            qkv_biases, linear_weights, linear_biases,
                            ffn_ln_scales, ffn_ln_biases, ffn1_weights,
                            ffn1_biases, ffn2_weights, ffn2_biases,
                            pre_layer_norm=True, epsilon=1e-5,
                            cache_kvs=None, pre_caches=None, seq_lens=None,
                            rotary_embs=None, time_step=None,
                            attn_mask=None, dropout_rate=0.0,
                            rotary_emb_dims=0, activation="gelu",
                            training=False, mode="upscale_in_train",
                            trans_qkvw=True, ring_id=-1, name=None,
                            num_heads=None, generator=None):
    """Stateless form of the FusedMultiTransformer stack. qkv_weights per
    layer: the reference 4-D layout [3, H, D, h] (qkv-major; [h, 3, H, D]
    when not ``trans_qkvw``), or 2-D [3h, h] ([h, 3h] when not
    ``trans_qkvw``, head-major with q, k, v inside each head; pass
    ``num_heads`` or caches). Caches: per layer (k, v) [B, H, M, D] or
    one [2, B, H, M, D] tensor, written at ``time_step`` (an int or a
    [B] tensor). With ``training`` and ``dropout_rate``, each block's
    output is dropped (``mode``) before its residual, as in the JAX
    function, the masks drawn from ``generator``. Returns out, or (out,
    caches) when caches are passed."""
    for knob, kname in ((pre_caches, "pre_caches"), (seq_lens, "seq_lens"),
                        (rotary_embs, "rotary_embs"),
                        (attn_mask, "attn_mask")):
        enforce(knob is None,
                f"fused_multi_transformer: {kname} is not served by this "
                "functional form (ragged prefill is the Predictor path, "
                "rotary embeddings apply at the model level, masking is "
                "causal + frontier) — pass None")
    enforce(rotary_emb_dims == 0, "fused_multi_transformer: in-kernel "
            "rotary (rotary_emb_dims != 0) is not served")
    enforce(ring_id == -1, "fused_multi_transformer: ring_id tensor "
            "parallelism is not served, as the JAX functional refuses it "
            "(ROADMAP.md queue 3, divergences)")
    offset = 0 if time_step is None else time_step
    act = _ACT[activation]
    B, S, h = x.shape
    new_caches = []
    for i, qw in enumerate(qkv_weights):
        residual = x
        if pre_layer_norm:
            x = F.layer_norm(x, ln_scales[i], ln_biases[i], epsilon)
        if qw.dim() == 4:
            Hn = qw.shape[1] if trans_qkvw else qw.shape[2]
        elif num_heads is not None:
            Hn = int(num_heads)
        elif cache_kvs is not None:
            Hn = cache_kvs[i][0].shape[1]   # (k, v) pair or [2, B, H, M, D]
        else:
            raise ValueError("fused_multi_transformer: with 2-D qkv weights "
                             "pass num_heads= (the 4-D [3, num_head, "
                             "head_dim, h] layout carries it)")
        Dh = h // Hn
        w = qw.reshape(-1, qw.shape[-1]).t() if trans_qkvw \
            else qw.reshape(qw.shape[0], -1)
        qkv = F.linear(x, w.to(x.dtype),
                       None if qkv_biases is None else qkv_biases[i])
        if qw.dim() == 4:       # reference layout: q of all heads, k, v
            q, k, v = qkv.reshape(B, S, 3, Hn, Dh).unbind(2)
        else:                   # head-major, q, k, v within each head
            q, k, v = qkv.reshape(B, S, Hn, 3 * Dh).split(Dh, dim=-1)
        cache = None
        if cache_kvs is not None:
            cache = (cache_kvs[i][0], cache_kvs[i][1])
            new_caches.append(cache)
        out = _attention(q, k, v, cache, offset).reshape(B, S, h)
        out = F.linear(out, linear_weights[i], linear_biases[i])
        x = residual + F.dropout(out, dropout_rate, training=training,
                                 mode=mode, generator=generator)
        if not pre_layer_norm:
            x = F.layer_norm(x, ln_scales[i], ln_biases[i], epsilon)
        residual = x
        f = F.layer_norm(x, ffn_ln_scales[i], ffn_ln_biases[i], epsilon) \
            if pre_layer_norm else x
        f = act(F.linear(f, ffn1_weights[i], ffn1_biases[i]))
        f = F.linear(f, ffn2_weights[i], ffn2_biases[i])
        x = residual + F.dropout(f, dropout_rate, training=training,
                                 mode=mode, generator=generator)
        if not pre_layer_norm:
            x = F.layer_norm(x, ffn_ln_scales[i], ffn_ln_biases[i], epsilon)
    return (x, new_caches) if cache_kvs is not None else x


def block_multihead_attention(qkv, key_cache, value_cache,
                              seq_lens_encoder, seq_lens_decoder,
                              seq_lens_this_time, padding_offsets,
                              cum_offsets, cu_seqlens_q, cu_seqlens_k,
                              block_tables, pre_key_cache=None,
                              pre_value_cache=None,
                              cache_k_quant_scales=None,
                              cache_v_quant_scales=None,
                              cache_k_dequant_scales=None,
                              cache_v_dequant_scales=None,
                              qkv_out_scale=None, qkv_bias=None,
                              out_shift=None, out_smooth=None,
                              rope_emb=None, mask=None, tgt_mask=None,
                              max_seq_len=-1, block_size=64,
                              use_neox_style=False,
                              use_dynamic_cachekv_quant=False,
                              quant_round_type=1, quant_max_bound=127.0,
                              quant_min_bound=-127.0, out_scale=-1,
                              compute_dtype="default"):
    """Paged (block-table) KV-cache attention, decode phase: one new token
    per row, written at page ``block_tables[b, pos // page]``, slot
    ``pos % page`` with pos = ``seq_lens_decoder[b]``, then attention
    over the row's pages up to it (K5). qkv: [B, (H + 2*KV) * D], the GQA
    layout; caches [P, KV, page, D]. Returns (out [B, H*D], qkv,
    key_cache, value_cache), the caches written in place. The prefill
    phase, cache quantization, in-kernel rope and pre-caches raise."""
    for knob, name in ((pre_key_cache, "pre_key_cache"),
                       (pre_value_cache, "pre_value_cache"),
                       (cache_k_quant_scales, "cache_k_quant_scales"),
                       (cache_v_quant_scales, "cache_v_quant_scales"),
                       (cache_k_dequant_scales, "cache_k_dequant_scales"),
                       (cache_v_dequant_scales, "cache_v_dequant_scales"),
                       (qkv_out_scale, "qkv_out_scale"),
                       (out_shift, "out_shift"), (out_smooth, "out_smooth"),
                       (rope_emb, "rope_emb"), (mask, "mask"),
                       (tgt_mask, "tgt_mask"), (padding_offsets,
                                                "padding_offsets"),
                       (cum_offsets, "cum_offsets"),
                       (cu_seqlens_q, "cu_seqlens_q"),
                       (cu_seqlens_k, "cu_seqlens_k")):
        enforce(knob is None,
                f"block_multihead_attention: {name} is not served in the "
                "decode phase (prefill and packing are the Predictor paged "
                "path; quantization and rope are not in-kernel) — pass None")
    enforce(not use_dynamic_cachekv_quant and out_scale in (-1, None)
            and compute_dtype == "default" and quant_round_type == 1
            and quant_max_bound == 127.0 and quant_min_bound == -127.0,
            "block_multihead_attention: cache-kv / output quantization is "
            "not served — leave the quant knobs at their defaults")
    enforce(not use_neox_style, "block_multihead_attention: in-kernel neox "
            "rope is not served (rope applies at the model level)")
    B = block_tables.shape[0]
    P, KV, page, D = key_cache.shape
    cap = block_tables.shape[1] * page
    enforce(block_size == page,
            lambda: f"block_multihead_attention: block_size ({block_size}) "
                    f"does not match the cache page size ({page}), which "
                    "the layout [P, KV, page, D] fixes")
    enforce(max_seq_len in (-1, cap),
            lambda: f"block_multihead_attention: max_seq_len ({max_seq_len})"
                    f" disagrees with the block-table capacity ({cap}); "
                    "pass -1")
    if seq_lens_encoder is not None:
        enforce(bool((torch.as_tensor(seq_lens_encoder) == 0).all()),
                "block_multihead_attention: this serves the DECODE phase "
                "only (seq_lens_encoder must be all zero)")
    if seq_lens_this_time is not None:
        enforce(bool((torch.as_tensor(seq_lens_this_time) == 1).all()),
                "block_multihead_attention: the decode phase writes ONE new "
                "token per row (seq_lens_this_time must be all one)")
    enforce(qkv.dim() == 2 and qkv.shape[0] == B,
            "decode phase: qkv is [batchsize, (num_q_heads + 2 * kv_heads) "
            "* head_dim]")
    heads = qkv.shape[1] // D
    enforce(qkv.shape[1] % D == 0 and heads > 2 * KV,
            lambda: f"block_multihead_attention: qkv width {qkv.shape[1]} "
                    f"is not (num_q_heads + 2*{KV})*{D}")
    H = heads - 2 * KV
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.reshape(1, -1)
    hv = qkv.reshape(B, heads, D)
    off = seq_lens_decoder.reshape(B).to(torch.int32)
    enforce(bool((off < cap).all()),
            lambda: "block_multihead_attention: a row's seq_lens_decoder "
                    f"exceeds its block table ({cap} positions); allocate "
                    "more pages")
    tbl = block_tables.to(torch.int32)
    pos = off.long()
    pid = tbl.gather(1, (pos // page)[:, None])[:, 0].long()
    # advanced indices split by a slice go first: the view is [B, KV, D]
    key_cache[pid, :, pos % page] = hv[:, H:H + KV].to(key_cache.dtype)
    value_cache[pid, :, pos % page] = hv[:, H + KV:].to(value_cache.dtype)
    out = paged_decode_attention(hv[:, None, :H].contiguous(), key_cache,
                                 value_cache, tbl.contiguous(), off)
    return out.reshape(B, H * D), qkv, key_cache, value_cache

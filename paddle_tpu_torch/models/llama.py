"""Llama (counterpart of ``paddle_tpu/models/llama.py``).

Ported: the configuration and its presets, the rotary tables, the
training forward without a cache (flash attention, kernels K1/K2, and
``LlamaPretrainingCriterion``), the forward with a paged KV cache (the
path ``ServingEngine``, the legacy per-arrival prefill and paged
``Predictor.generate`` drive; kernels K4/K5), the forward with the
contiguous head-major cache ``[B, KV, M, D]`` (static-cache generation;
kernel K6), and ``generate``. Architecture as in the JAX package:
RMSNorm (kernel K3, with its gradient), rotary embeddings, GQA
(num_kv_heads < num_heads), SwiGLU MLP, untied LM head by default.

The training forward keeps activations in the parameters' dtype: its
rope casts the f32 tables to q/k's dtype, as the serving rope does
(the JAX training rope promotes bf16 q/k to f32; in f32 the two agree).

The KV caches are updated IN PLACE: where the JAX step donated the pool
or cache buffers and returned new ones, the port writes the new K/V rows
straight into the caller's tensors (and returns the same tensors, so the
call shape matches). ``generate`` is an eager loop where JAX reused one
jitted step per shape; ``stats`` notes each shape, as the serving path
does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..amp import cast_inputs
from ..distributed.fleet.layers.mpu import (ColumnParallelLinear,
                                            RowParallelLinear,
                                            VocabParallelEmbedding,
                                            parallel_cross_entropy)
from ..core.compile_stats import CompileStats
from ..core.enforce import enforce
from ..ops.attention import flash_attention
from ..ops.kernels.decode_attention import (decode_attention,
                                            paged_decode_attention,
                                            row_offsets)
from ..ops.kernels.ragged_paged_attention import ragged_paged_attention
from ..ops.kernels.rms_norm import rms_norm
from ..ops.nn_ops import fused_rope
from ..ops.nn_ops import rotate_half as _rot_half

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "LlamaRMSNorm",
           "LlamaPretrainingCriterion", "llama_tiny", "llama_tiny_draft",
           "llama_7b", "llama_13b", "resolve_device"]

_DTYPES = {"float32": torch.float32, None: torch.float32,
           "bfloat16": torch.bfloat16}


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 0               # 0 -> num_heads (MHA)
    intermediate_size: int = 11008
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    use_flash_attention: bool = True
    dtype: str = "float32"

    def __post_init__(self):
        if not self.num_kv_heads:
            self.num_kv_heads = self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def num_params(self) -> int:
        h, L, V = self.hidden_size, self.num_layers, self.vocab_size
        kv = self.num_kv_heads * self.head_dim
        per_layer = (h * h + 2 * h * kv + h * h
                     + 3 * h * self.intermediate_size + 2 * h)
        head = 0 if self.tie_word_embeddings else V * h
        return V * h + L * per_layer + h + head


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. With no card present a CUDA request raises; it never
    quietly becomes the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on the CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU")
    return dev


def _rope_tables(cfg: LlamaConfig, device) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """cos/sin [max_position_embeddings, D]: float64 numpy, then float32."""
    D = cfg.head_dim
    inv = 1.0 / cfg.rope_theta ** (np.arange(0, D, 2, dtype=np.float64) / D)
    t = np.arange(cfg.max_position_embeddings, dtype=np.float64)
    freqs = np.outer(t, inv)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.tensor(np.cos(emb), dtype=torch.float32, device=device),
            torch.tensor(np.sin(emb), dtype=torch.float32, device=device))


def _apply_rope(x, cos, sin, offset):
    """x: [B, S, H, D]; cos/sin: [max, D]; offset: an int, or a per-row
    tensor [B] (each row rotates at its own absolute positions). Rows
    past the table (dead slots of a ragged batch) clamp to its last
    position, as JAX's gather does; their outputs are never used."""
    S = x.shape[1]
    if isinstance(offset, torch.Tensor) and offset.dim():
        pos = offset.long()[:, None] + torch.arange(S, device=x.device)[None]
        pos = pos.clamp(0, cos.shape[0] - 1)
        c = cos[pos][:, :, None, :]                          # [B,S,1,D]
        s = sin[pos][:, :, None, :]
    else:
        o = min(max(int(offset), 0), cos.shape[0] - S)
        c = cos[o:o + S][None, :, None, :]
        s = sin[o:o + S][None, :, None, :]
    return x * c.to(x.dtype) + _rot_half(x) * s.to(x.dtype)


def write_cache(cache, new, offset):
    """Write the new rows ``new`` [B, S, KV, D] into the head-major cache
    [B, KV, M, D] in place: every row at ``offset`` (an int), or row b at
    ``offset[b]`` (a tensor [B]). As ``lax.dynamic_update_slice`` does,
    the start is clamped into [0, M - S]."""
    B, S = new.shape[0], new.shape[1]
    M = cache.shape[2]
    new = new.to(cache.dtype)
    if isinstance(offset, torch.Tensor) and offset.dim():
        start = offset.long().reshape(-1).expand(B).clamp(0, M - S)
        pos = start[:, None] + torch.arange(S, device=cache.device)[None]
        # advanced indices split by a slice go first: the indexed view is
        # [B, S, KV, D], the layout of the new rows
        cache[torch.arange(B, device=cache.device)[:, None], :, pos] = new
    else:
        o = min(max(int(offset), 0), M - S)
        cache[:, :, o:o + S] = new.transpose(1, 2)


class LlamaRMSNorm(nn.Module):
    """RMSNorm straight through the K3 wrapper (no shape gate, no
    fallback: on a CUDA tensor the kernel runs or the call raises)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6,
                 device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))
        self._epsilon = float(epsilon)

    def forward(self, x):
        return rms_norm(x, self.weight, self._epsilon)


class LlamaAttention(nn.Module):
    """GQA attention with rotary embeddings: causal flash attention
    without a cache, else attention over a paged or a contiguous KV
    cache."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        h, D = config.hidden_size, config.head_dim
        kv = config.num_kv_heads * D
        kw = {"device": device, "dtype": dtype}
        self.q_proj = ColumnParallelLinear(h, h, **kw)
        self.k_proj = ColumnParallelLinear(h, kv, **kw)
        self.v_proj = ColumnParallelLinear(h, kv, **kw)
        self.o_proj = RowParallelLinear(h, h, **kw)
        # non-persistent buffers: they follow the module across .to()
        # (a dtype cast rounds them as the multiply's cast would) and stay
        # out of state_dict
        cos, sin = _rope_tables(config, device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, x, cache=None, offset=0, valid=None):
        cfg = self.config
        B, S = x.shape[0], x.shape[1]
        D = cfg.head_dim
        q = self.q_proj(x).view(B, S, cfg.num_heads, D)
        k = self.k_proj(x).view(B, S, cfg.num_kv_heads, D)
        v = self.v_proj(x).view(B, S, cfg.num_kv_heads, D)
        if cache is None:
            # training: rope over positions 0..S-1, causal flash
            # attention (K1/K2); GQA heads pass through as they are
            q, k = fused_rope(q, k, self.rope_cos[:S], self.rope_sin[:S])
            o = flash_attention(q, k, v, causal=True)
            return self.o_proj(o.reshape(B, S, cfg.num_heads * D))
        q = _apply_rope(q, self.rope_cos, self.rope_sin, offset)
        k = _apply_rope(k, self.rope_cos, self.rope_sin, offset)
        if len(cache) == 2:
            # static cache: head-major [B, KV, M, D], written in place at
            # the offset, then attention through K6
            enforce(valid is None, "valid (unified ragged metadata) is "
                    "only served over the paged KV cache")
            k_cache, v_cache = cache
            write_cache(k_cache, k, offset)
            write_cache(v_cache, v, offset)
            o = decode_attention(q, k_cache, v_cache, offset)
            return self.o_proj(o.reshape(B, S, cfg.num_heads * D)), cache
        k_pool, v_pool, tables = cache     # tables int32 [B, ncols]
        page = k_pool.shape[2]
        ncols = tables.shape[1]
        off = row_offsets(offset, x)       # an int fills on the device
        pos = off.long()[:, None] + torch.arange(S, device=x.device)[None]
        nv = None
        if valid is not None:
            # unified mixed prefill-chunk/decode step: only the first
            # valid[b] slots of row b are real tokens. CONTRACT: the
            # caller's table carries ONE EXTRA trailing column that maps
            # to the trash page (inference/serving.py builds it); dead
            # slots' kv writes land there instead of in the row's own
            # future cache slots
            nv = torch.as_tensor(valid, device=x.device).to(
                torch.int32).reshape(B)
            alive = torch.arange(S, device=x.device)[None] \
                < nv.long()[:, None]
            pos = torch.where(alive, pos, torch.full_like(pos,
                                                          (ncols - 1) * page))
        col = (pos // page).clamp(max=ncols - 1)
        pid = torch.gather(tables, 1, col).long()
        slot = pos % page                   # [B, S]
        # advanced indices split by a slice go first: the indexed view is
        # [B, S, KV, D], the layout of the new k/v rows. In place: the
        # pools are the engine's, updated where JAX donated them
        k_pool[pid, :, slot, :] = k.to(k_pool.dtype)
        v_pool[pid, :, slot, :] = v.to(v_pool.dtype)
        if nv is not None:
            # the trailing trash column is write-side only: attention
            # sees the canonical [B, npages] table
            o = ragged_paged_attention(q, k_pool, v_pool, tables[:, :-1],
                                       off, nv)
        else:
            o = paged_decode_attention(q, k_pool, v_pool, tables, off)
        return self.o_proj(o.reshape(B, S, cfg.num_heads * D)), cache


class LlamaMLP(nn.Module):
    """SwiGLU MLP."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        kw = {"device": device, "dtype": dtype}
        self.gate_proj = ColumnParallelLinear(h, m, **kw)
        self.up_proj = ColumnParallelLinear(h, m, **kw)
        self.down_proj = RowParallelLinear(m, h, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.input_layernorm = LlamaRMSNorm(config.hidden_size,
                                            config.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = LlamaRMSNorm(
            config.hidden_size, config.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, x, cache=None, offset=0, valid=None):
        if cache is None:
            x = x + self.self_attn(self.input_layernorm(x))
            return x + self.mlp(self.post_attention_layernorm(x))
        a, cache = self.self_attn(self.input_layernorm(x), cache=cache,
                                  offset=offset, valid=valid)
        x = x + a
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, cache


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = {"device": device, "dtype": dtype}
        self.embed_tokens = VocabParallelEmbedding(config.vocab_size,
                                                   config.hidden_size, **kw)
        self.layers = nn.ModuleList([LlamaDecoderLayer(config, **kw)
                                     for _ in range(config.num_layers)])
        self.norm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps,
                                 **kw)

    def forward(self, input_ids, caches=None, offset=0, valid=None):
        x = self.embed_tokens(input_ids)
        if caches is None:
            for layer in self.layers:
                x = layer(x)
            return self.norm(x)
        new_caches: List = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer(x, cache, offset=offset, valid=valid)
            new_caches.append(cache)
        return self.norm(x), new_caches


class LlamaForCausalLM(nn.Module):
    """Llama with an (untied by default) LM head: the training forward,
    the forward over a paged or contiguous KV cache, and ``generate``
    with static caches. ``device=None`` means the CUDA
    device; weights are drawn from a generator seeded with ``seed`` on
    that device (normal, std ``initializer_range``; the residual-output
    projections use std / sqrt(2 * num_layers), as the JAX package
    does)."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dtype = _DTYPES[config.dtype]
        self.llama = LlamaModel(config, device=dev, dtype=dtype)
        if not config.tie_word_embeddings:
            self.lm_head = ColumnParallelLinear(config.hidden_size,
                                                config.vocab_size,
                                                device=dev, dtype=dtype)
        self._init_weights(seed)
        self.stats = CompileStats()

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    @torch.no_grad()
    def _init_weights(self, seed: int):
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        std = self.config.initializer_range
        out_std = std / math.sqrt(2 * self.config.num_layers)
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith(("o_proj.weight", "down_proj.weight")):
                p.normal_(0.0, out_std, generator=g)
            else:
                p.normal_(0.0, std, generator=g)

    def _logits(self, x):
        if self.config.tie_word_embeddings:
            x, w = cast_inputs("matmul", x, self.llama.embed_tokens.weight)
            return x @ w.t()
        return self.lm_head(x)

    def forward(self, input_ids, caches=None, offset=0, valid=None):
        """Without caches: logits [B, S, vocab] of the training forward.
        With caches, one per layer — (k_pool, v_pool, tables) paged or
        (k_cache, v_cache) contiguous — (logits, caches), the caches
        written in place."""
        if caches is None:
            return self._logits(self.llama(input_ids))
        x, caches = self.llama(input_ids, caches, offset=offset, valid=valid)
        return self._logits(x), caches

    # -- generation (static caches) ---------------------------------------
    def _empty_caches(self, B: int, max_len: int, dtype=None):
        """One (k, v) pair of zeroed head-major caches [B, KV, M, D] per
        layer, on the model's device, in the parameters' dtype unless
        ``dtype`` says otherwise."""
        cfg = self.config
        shape = (B, cfg.num_kv_heads, max_len, cfg.head_dim)
        kw = {"device": self.device,
              "dtype": dtype or self.llama.embed_tokens.weight.dtype}
        return [(torch.zeros(shape, **kw), torch.zeros(shape, **kw))
                for _ in range(cfg.num_layers)]

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 max_length=None) -> torch.Tensor:
        """Greedy (or temperature/top-k) generation with static caches.

        Returns [B, S_prompt + max_new_tokens] token ids on the model's
        device: one prefill at [B, S_prompt], then one [B, 1] decode step
        per further token, attention through K6. Sampling draws from a
        ``torch.Generator`` seeded with ``seed`` on the model's device
        (its numbers differ from JAX's for the same seed; greedy is
        identical)."""
        from ..inference import GenerationConfig, _sample

        ids = torch.as_tensor(input_ids, device=self.device).long()
        B, S0 = ids.shape
        M = max_length or min(self.config.max_position_embeddings,
                              S0 + max_new_tokens)
        enforce(S0 + max_new_tokens <= M,
                f"prompt ({S0}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the cache length {M} (max_position_embeddings="
                f"{self.config.max_position_embeddings}); writes past the "
                "cache would silently clamp")
        caches = self._empty_caches(B, M)
        gen = GenerationConfig(max_new_tokens, temperature, top_k)
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        self.stats.note("step", (B, S0, M))
        logits, caches = self(ids, caches, offset=0)
        nxt = _sample(logits[:, -1], gen, g)
        if max_new_tokens > 1:
            self.stats.note("step", (B, 1, M))
        toks = [ids]
        for pos in range(S0, S0 + max_new_tokens - 1):
            toks.append(nxt[:, None])
            logits, caches = self(nxt[:, None], caches, offset=pos)
            nxt = _sample(logits[:, -1], gen, g)
        toks.append(nxt[:, None])
        return torch.cat(toks, dim=1)


class LlamaPretrainingCriterion(nn.Module):
    """LM loss: the mean over tokens of ``parallel_cross_entropy``, or
    with ``loss_mask`` the masked mean sum(loss * m) / max(sum(m), 1)."""

    def __init__(self, config=None, mp_group=None):
        super().__init__()
        self._mp_group = mp_group

    def forward(self, logits, labels, loss_mask=None):
        loss = parallel_cross_entropy(logits, labels,
                                      self._mp_group).squeeze(-1)
        if loss_mask is not None:
            m = loss_mask.to(loss.dtype)
            return (loss * m).sum() / m.sum().clamp_min(1.0)
        return loss.mean()


def llama_tiny(**kw) -> LlamaConfig:
    return LlamaConfig(vocab_size=256, hidden_size=64, num_layers=2,
                       num_heads=4, num_kv_heads=2, intermediate_size=128,
                       max_position_embeddings=128, **kw)


def llama_tiny_draft(**kw) -> LlamaConfig:
    """Draft-sized companion to ``llama_tiny`` for speculative
    decoding: same vocabulary and position range, one layer, half the
    width."""
    kw.setdefault("vocab_size", 256)
    kw.setdefault("max_position_embeddings", 128)
    return LlamaConfig(hidden_size=32, num_layers=1, num_heads=2,
                       num_kv_heads=1, intermediate_size=64, **kw)


def llama_7b(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)


def llama_13b(**kw) -> LlamaConfig:
    kw.setdefault("hidden_size", 5120)
    kw.setdefault("num_layers", 40)
    kw.setdefault("num_heads", 40)
    kw.setdefault("intermediate_size", 13824)
    return LlamaConfig(**kw)

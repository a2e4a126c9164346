"""GPT (counterpart of ``paddle_tpu/models/gpt.py``), at degree 1 and
under tensor parallelism.

Ported: the configuration and its presets, the training forward (pre-LN
decoder blocks, causal flash attention through kernels K1/K2, attention
and hidden dropout, a learned position embedding, a tied or untied LM
head), the forward with a concatenated KV cache, and
``GPTPretrainingCriterion``. The projections keep the JAX names
(``qkv_proj``, ``out_proj``, ``fc1``, ``fc2``) as ``nn.Linear``s with
biases, so ``convert.load_jax_state_dict`` carries the weights across
(transposed from ``[in, out]``); LayerNorm is ``nn.LayerNorm`` with
``eps = layer_norm_eps``; the tied head is ``F.linear(x,
word_embeddings.weight)``, one parameter whose gradient sums the lookup's
and the logits'.

Randomness is explicit. Each model owns two generators, both seeded
from ``seed``: one on its device for hidden dropout (``seed + 1``; the
masks come from ``torch.rand`` there) and one on the CPU for attention
dropout (``seed + 2718``, the offset of the JAX tracker's local stream),
from which every attention-dropout call draws one 64-bit Philox seed, so
a CPU and a CUDA model built with one seed draw the same attention
masks (``ops/kernels/dropout_mask.py``). The JAX model draws both from
``jax.random`` keys, so masks differ between the packages: only the
distributions match.

Tensor parallelism (an mp group of more than one rank: ``mp_group``, or
the fleet HCG's when the model is built after ``fleet.init``), as the
JAX model under its mesh: ``qkv_proj`` and ``fc1`` column-parallel,
``out_proj`` and ``fc2`` row-parallel, the vocab-parallel embedding and
the tied head's local logits (``_c_identity`` before the product, so its
partial input gradients are summed) into the vocab-parallel cross
entropy (the criterion takes the same group). qkv's columns are
head-major (``[n_local, 3 D]``), so each rank holds whole heads. Built
from a seed, every rank draws each full tensor from the seeded generator
and keeps its slice, so an mp model starts from the degree-1 model's
weights. Hidden dropout acts on replicated activations and draws from
the model's generator, the same on every rank (every rank drops the same
elements); attention dropout acts on head-sharded probabilities: one
seed a call from the model's attention generator, the same on every
rank, and each rank's kernels hash their heads' global indices
(``head_offset``), so each rank drops its own heads and mp 2 with
dropout computes degree 1's masks.

``GPTForCausalLMPipe(config, device=, seed=)`` is the pipeline form (the
JAX ``GPTForCausalLMPipe``): a ``PipelineLayer`` of the embedding (a
``SharedLayerDesc`` tied to the head), the decoder blocks and the final
LayerNorm, with ``GPTPretrainingCriterion`` as its loss, built after
``fleet.init``: each pp rank builds its own chunks only, under mp with
the same sharded layers. Its weights are drawn in the degree-1 model's
order from the seed (the draws of a part another rank builds are made
and dropped), so every rank holds its part of ``GPTForCausalLM(config,
seed=seed)``'s weights.

Not ported: the MoE blocks (``GPTMoEMLP``, ``num_experts > 0``: ROADMAP.md
queue 1, item 10) and context parallelism (a ``sep_group`` of more than
one rank: item 10). The JAX ``_annotate`` scopes are
``torch.profiler.record_function`` ranges here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as TF
from torch.profiler import record_function

from ..amp import cast_inputs
from ..core.enforce import enforce
from ..distributed.fleet.layers.mpu import (ColumnParallelLinear,
                                            RowParallelLinear,
                                            VocabParallelEmbedding,
                                            parallel_cross_entropy)
from ..distributed.fleet.layers.mpu.mp_ops import _c_identity
from ..distributed.fleet.layers.mpu.mp_ops import mp_group as mp_group_of
from ..nn import functional as F
from ..nn.common import Dropout
from ..ops.attention import flash_attention
from .llama import (_DTYPES, _draw, _masked_mean_over_splits,
                    resolve_device)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "GPTForCausalLMPipe",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt_125m", "gpt_350m",
           "gpt_1p3b", "gpt_13b"]

_ATTN_SEED_OFFSET = 2718    # the JAX model_parallel_random_seed local stream


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 0          # 0 -> 4*hidden
    max_position_embeddings: int = 1024
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-5
    use_flash_attention: bool = True
    tie_word_embeddings: bool = True
    dtype: str = "float32"
    # MoE fields, kept for parity; num_experts > 0 raises (item 10)
    num_experts: int = 0
    moe_every: int = 2
    moe_gate: str = "gshard"
    moe_aux_coef: float = 0.01

    def __post_init__(self):
        if not self.intermediate_size:
            self.intermediate_size = 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def num_params(self) -> int:
        """Parameter count (embeddings included once when tied)."""
        h, L, V = self.hidden_size, self.num_layers, self.vocab_size
        per_layer = 4 * h * h + 4 * h + 2 * h * self.intermediate_size \
            + self.intermediate_size + h + 4 * h
        return V * h + self.max_position_embeddings * h + L * per_layer + 2 * h


def _group_size(group) -> int:
    return 1 if group is None else getattr(group, "nranks", 1)


class GPTAttention(nn.Module):
    """Causal self-attention over a fused qkv projection; attention
    dropout (train mode) inside K1/K2, hidden dropout after ``out_proj``."""

    def __init__(self, config: GPTConfig, generators, device=None,
                 dtype=None, mp_group=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kw = {"device": device, "dtype": dtype, "has_bias": True,
              "mp_group": mp_group}
        self.qkv_proj = ColumnParallelLinear(h, 3 * h, gather_output=False,
                                             **kw)
        self.out_proj = RowParallelLinear(h, h, input_is_parallel=True, **kw)
        n = self.qkv_proj.world_size
        enforce(config.num_heads % n == 0,
                f"num_heads {config.num_heads} must divide mp degree {n}")
        self.num_local_heads = config.num_heads // n
        # this rank's first head in the model (the dropout mask's offset)
        g = self.qkv_proj._mp_group
        self.head_offset = 0 if g is None else g.rank * self.num_local_heads
        hidden_gen, self._attn_gen = generators
        self.dropout = Dropout(config.hidden_dropout, generator=hidden_gen)

    def forward(self, x, cache: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None):
        cfg = self.config
        B, S = x.shape[0], x.shape[1]
        D = cfg.head_dim
        n = self.num_local_heads
        # [B, S, n, 3D] split into q, k, v as the JAX layer does
        qkv = self.qkv_proj(x).reshape(B, S, n, 3 * D)
        q, k, v = (t.contiguous() for t in qkv.split(D, dim=-1))
        new_cache = None
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
            new_cache = (k, v)
            out = flash_attention(q, k, v, causal=S > 1)
        else:
            p = cfg.attention_dropout if self.training else 0.0
            out = flash_attention(q, k, v, causal=True, dropout=p,
                                  generator=self._attn_gen,
                                  head_offset=self.head_offset)
        out = self.dropout(self.out_proj(out.reshape(B, S, n * D)))
        return (out, new_cache) if cache is not None else out


class GPTMLP(nn.Module):
    """fc1 -> tanh GELU -> fc2 -> hidden dropout."""

    def __init__(self, config: GPTConfig, generator, device=None,
                 dtype=None, mp_group=None):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        kw = {"device": device, "dtype": dtype, "has_bias": True,
              "mp_group": mp_group}
        self.fc1 = ColumnParallelLinear(h, m, gather_output=False, **kw)
        self.fc2 = RowParallelLinear(m, h, input_is_parallel=True, **kw)
        self.dropout = Dropout(config.hidden_dropout, generator=generator)

    def forward(self, x):
        return self.dropout(self.fc2(F.gelu(self.fc1(x), approximate=True)))


class GPTDecoderLayer(nn.Module):
    """Pre-LN decoder block."""

    def __init__(self, config: GPTConfig, generators, device=None,
                 dtype=None, mp_group=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        h, eps = config.hidden_size, config.layer_norm_eps
        self.ln1 = nn.LayerNorm(h, eps=eps, **kw)
        self.attn = GPTAttention(config, generators, mp_group=mp_group, **kw)
        self.ln2 = nn.LayerNorm(h, eps=eps, **kw)
        self.mlp = GPTMLP(config, generators[0], mp_group=mp_group, **kw)

    def forward(self, x, cache=None):
        if cache is not None:
            with record_function("attention"):
                a, new_cache = self.attn(self.ln1(x), cache=cache)
            x = x + a
            with record_function("mlp"):
                x = x + self.mlp(self.ln2(x))
            return x, new_cache
        with record_function("attention"):
            x = x + self.attn(self.ln1(x))
        with record_function("mlp"):
            return x + self.mlp(self.ln2(x))


class GPTEmbeddings(nn.Module):
    """Token embedding plus a learned position embedding over
    ``arange(S) + position_offset``, then hidden dropout."""

    def __init__(self, config: GPTConfig, generator, device=None,
                 dtype=None, mp_group=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        h = config.hidden_size
        self.word_embeddings = VocabParallelEmbedding(config.vocab_size, h,
                                                      mp_group=mp_group,
                                                      **kw)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h, **kw)
        self.dropout = Dropout(config.hidden_dropout, generator=generator)

    def forward(self, input_ids, position_offset=0):
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device) + position_offset
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        return self.dropout(x)


class GPTModel(nn.Module):
    """Embeddings, the decoder stack and the final LayerNorm.
    ``generators`` = (hidden dropout's, on the device; attention
    dropout's, on the CPU), as ``GPTForCausalLM`` makes them from its
    seed; None makes them from seed 0. ``mp_group``: the tensor-parallel
    group (None: the fleet HCG's; degree 1 without one)."""

    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 generators=None, sep_group=None, mp_group=None):
        super().__init__()
        enforce(config.num_experts == 0,
                "GPT's MoE blocks (GPTMoEMLP, num_experts > 0) are not "
                "ported yet: ROADMAP.md queue 1, item 10")
        enforce(_group_size(sep_group) <= 1,
                "GPT context parallelism (a sep group of more than one "
                "rank, ring attention) is not ported yet: ROADMAP.md queue "
                "1, item 10")
        self.config = config
        dev = resolve_device(device)
        if generators is None:
            generators = _generators(dev, 0)
        kw = {"device": dev, "dtype": dtype,
              "mp_group": mp_group_of(mp_group)}
        self.embeddings = GPTEmbeddings(config, generators[0], **kw)
        self.layers = nn.ModuleList([GPTDecoderLayer(config, generators,
                                                     **kw)
                                     for _ in range(config.num_layers)])
        kw.pop("mp_group")
        self.final_ln = nn.LayerNorm(config.hidden_size,
                                     eps=config.layer_norm_eps, **kw)

    def forward(self, input_ids, caches=None, position_offset=0):
        with record_function("gpt"):
            with record_function("embed"):
                x = self.embeddings(input_ids, position_offset)
            if caches is not None:
                new_caches: List = []
                for i, (layer, cache) in enumerate(zip(self.layers,
                                                       caches)):
                    with record_function(f"layer{i}"):
                        x, nc = layer(x, cache=cache)
                    new_caches.append(nc)
                return self.final_ln(x), new_caches
            for i, layer in enumerate(self.layers):
                with record_function(f"layer{i}"):
                    x = layer(x)
            return self.final_ln(x)


def _generators(device: torch.device, seed: int):
    """(hidden dropout's generator on ``device``, attention dropout's on
    the CPU), seeded from ``seed``."""
    hidden = torch.Generator(device=device).manual_seed(int(seed) + 1)
    attn = torch.Generator().manual_seed(int(seed) + _ATTN_SEED_OFFSET)
    return hidden, attn


class GPTForCausalLM(nn.Module):
    """GPT with a tied (by default) or untied LM head. ``device=None``
    means the CUDA device; weights are drawn from a generator seeded with
    ``seed`` on that device (normal, std ``initializer_range``; ``out_proj``
    and ``fc2`` use std / sqrt(2 * num_layers); biases 0, LayerNorm 1 and
    0), as the JAX initialisers draw them; under tensor parallelism each
    rank draws the full tensors and keeps its slices (module docstring).
    ``mp_group`` (None: the fleet HCG's) shards the model; a ``sep_group``
    of more than one rank raises (item 10). The logits are this rank's
    vocab shard at mp > 1 (pair them with ``GPTPretrainingCriterion``)."""

    def __init__(self, config: GPTConfig, device=None, seed: int = 0,
                 mp_group=None, sep_group=None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dtype = _DTYPES[config.dtype]
        self._mp_group = mp_group_of(mp_group)
        self.gpt = GPTModel(config, device=dev, dtype=dtype,
                            generators=_generators(dev, seed),
                            sep_group=sep_group, mp_group=self._mp_group)
        if not config.tie_word_embeddings:
            self.lm_head = ColumnParallelLinear(config.hidden_size,
                                                config.vocab_size,
                                                device=dev, dtype=dtype,
                                                gather_output=False,
                                                mp_group=self._mp_group)
        self._init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.gpt.embeddings.word_embeddings.weight.device

    @torch.no_grad()
    def _init_weights(self, seed: int):
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        std = self.config.initializer_range
        out_std = std / math.sqrt(2 * self.config.num_layers)
        for name, mod in self.named_modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Embedding)):
                out = name.endswith(("out_proj", "fc2"))
                _draw(mod.weight, out_std if out else std, g)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()

    def _logits(self, x):
        if self.config.tie_word_embeddings:
            if self._mp_group is not None:
                # each rank's head gives a partial input gradient (its
                # vocab shard's): summed before the decoder (Megatron)
                x = _c_identity(x, self._mp_group)
            x, w = cast_inputs("matmul", x,
                               self.gpt.embeddings.word_embeddings.weight)
            return TF.linear(x, w)
        return self.lm_head(x)

    def forward(self, input_ids, caches=None, position_offset=0):
        """Without caches: logits [B, S, vocab]. With caches, one (k, v)
        pair [B, T, num_heads, head_dim] per layer (T = 0 before the
        prefill): (logits, caches), each cache the old keys with this
        call's appended (concatenated: new tensors, as the JAX layer
        returns them)."""
        if caches is not None:
            x, new_caches = self.gpt(input_ids, caches=caches,
                                     position_offset=position_offset)
            return self._logits(x), new_caches
        return self._logits(self.gpt(input_ids))

    @property
    def aux_loss(self) -> torch.Tensor:
        """The MoE blocks' load-balance losses of the last forward (the
        JAX property, models/gpt.py:378-391): a dense model has none, so
        an f32 0 on the model's device, and ``loss + model.aux_loss``
        trains as ``loss`` does. The MoE sum waits on ROADMAP.md queue 1,
        item 10 (``num_experts > 0`` raises at construction)."""
        return torch.zeros((), device=self.device)


class GPTPretrainingCriterion(nn.Module):
    """Shift-by-one LM loss: the mean over tokens of
    ``parallel_cross_entropy``, or with ``loss_mask`` sum(loss * m) /
    max(sum(m), 1) over the whole batch, across the dp ranks inside a
    ``ParallelEngine`` step (the JAX ``_masked_mean_over_splits``)."""

    def __init__(self, config: Optional[GPTConfig] = None, mp_group=None):
        super().__init__()
        self._mp_group = mp_group_of(mp_group)

    def forward(self, logits, labels, loss_mask=None):
        loss = parallel_cross_entropy(logits, labels,
                                      self._mp_group).squeeze(-1)
        if loss_mask is not None:
            m = loss_mask.to(loss.dtype)
            return _masked_mean_over_splits((loss * m).sum(), m.sum())
        return loss.mean()


def gpt_tiny(**kw) -> GPTConfig:
    return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                     num_heads=4, max_position_embeddings=128, **kw)


def gpt_125m(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt_350m(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)


def gpt_1p3b(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                     max_position_embeddings=2048, **kw)


def gpt_13b(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=5120, num_layers=40, num_heads=40,
                     max_position_embeddings=2048, **kw)


# -- the pipeline form ------------------------------------------------------

def _tied_head_forward(shared_emb, x):
    """The LM head on the shared embedding's weight (the JAX
    ``_tied_head_forward``); under mp ``_c_identity`` first, so the
    ranks' partial input gradients are summed."""
    w = shared_emb.word_embeddings.weight
    g = getattr(w, "mp_group", None)
    if g is not None:
        x = _c_identity(x, g)
    x, w = cast_inputs("matmul", x, w)
    return TF.linear(x, w)


class GPTForCausalLMPipe:
    """``GPTForCausalLMPipe(config, ...)`` returns the ``PipelineLayer``
    of ``GPTForCausalLM`` (module docstring); ``num_stages``,
    ``recompute_interval`` and the other ``PipelineLayer`` arguments
    pass through."""

    def __new__(cls, config: GPTConfig, num_stages=None,
                recompute_interval: int = 0, device=None, seed: int = 0,
                mp_group=None, **pp_kwargs):
        from ..distributed.fleet.meta_parallel import (LayerDesc,
                                                       PipelineLayer,
                                                       SharedLayerDesc)

        enforce(config.num_experts == 0,
                "GPT's MoE blocks (GPTMoEMLP, num_experts > 0) are not "
                "ported yet: ROADMAP.md queue 1, item 10")
        dev = resolve_device(device)
        dtype = _DTYPES[config.dtype]
        mp = mp_group_of(mp_group)
        gens = _generators(dev, seed)
        kw = {"device": dev, "dtype": dtype, "mp_group": mp}
        descs = [
            SharedLayerDesc("embed", GPTEmbeddings, None, "weight", config,
                            gens[0], **kw),
            *[LayerDesc(GPTDecoderLayer, config, gens, **kw)
              for _ in range(config.num_layers)],
            LayerDesc(nn.LayerNorm, config.hidden_size,
                      eps=config.layer_norm_eps, device=dev, dtype=dtype),
        ]
        if config.tie_word_embeddings:
            descs.append(SharedLayerDesc("embed", GPTEmbeddings,
                                         _tied_head_forward, "weight",
                                         config, gens[0], **kw))
        else:
            descs.append(LayerDesc(ColumnParallelLinear, config.hidden_size,
                                   config.vocab_size, has_bias=False,
                                   gather_output=False, **kw))
        model = PipelineLayer(
            layers=descs, num_stages=num_stages,
            loss_fn=GPTPretrainingCriterion(config, mp_group=mp),
            seg_method="layer:GPTDecoderLayer",
            recompute_interval=recompute_interval, generators=gens,
            seed=seed, **pp_kwargs)
        model.config = config
        _init_pipe_weights(model, config, seed, dev, dtype)
        return model


@torch.no_grad()
def _init_pipe_weights(model, config: GPTConfig, seed: int, dev, dtype):
    """``GPTForCausalLM._init_weights``'s draws, in its order, into the
    parts this rank holds; the others' draws are made and dropped."""
    g = torch.Generator(device=dev).manual_seed(int(seed))
    std = config.initializer_range
    out_std = std / math.sqrt(2 * config.num_layers)
    h, m = config.hidden_size, config.intermediate_size

    def draw(mod, shape, s):
        if mod is not None:
            _draw(mod.weight, s, g)
        else:
            torch.empty(shape, dtype=dtype, device=dev).normal_(
                0.0, s, generator=g)

    emb = next((lyr for lyr in model.modules()
                if isinstance(lyr, GPTEmbeddings)), None)
    draw(emb.word_embeddings if emb else None,
         (config.vocab_size, h), std)
    draw(emb.position_embeddings if emb else None,
         (config.max_position_embeddings, h), std)
    for i in range(config.num_layers):
        blk = model.blocks[str(i)] if str(i) in model.blocks else None
        if blk is None:
            for shape, s in (((3 * h, h), std), ((h, h), out_std),
                             ((m, h), std), ((h, m), out_std)):
                draw(None, shape, s)
            continue
        for name, mod in blk.named_modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                draw(mod, None, out_std if name.endswith(("out_proj", "fc2"))
                     else std)
                if mod.bias is not None:
                    mod.bias.zero_()
    for lyr in model.epilogue:
        if isinstance(lyr, nn.LayerNorm):
            lyr.weight.fill_(1.0)
            lyr.bias.zero_()
    if not config.tie_word_embeddings:
        head = next((lyr for lyr in model.epilogue
                     if isinstance(lyr, nn.Linear)), None)
        draw(head, (config.vocab_size, h), std)

"""Inference API (counterpart of ``paddle_tpu/inference/__init__.py``).

Ported: ``GenerationConfig``, ``Config`` (model, paged KV, max length,
dtype, generation defaults), ``create_predictor``, the ``Predictor``
constructor and its prefill step (the legacy per-arrival prefill of the
serving engine), and ``_sample``. ``Predictor.run`` and
``Predictor.generate`` are not ported yet (ROADMAP.md queue 1).

The predictor serves on its model's device: the engine puts its page
pools, tables and sampling generator there too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core.compile_stats import CompileStats

__all__ = ["Config", "Predictor", "create_predictor", "GenerationConfig",
           "CompileStats", "ServingEngine", "ServingRequest"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sample(logits: torch.Tensor, gen: "GenerationConfig",
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy / temperature / top-k / top-p sampling of [B, V] logits.
    Greedy is the float32 argmax (first index on ties, as jnp.argmax);
    the stochastic modes draw from ``generator``, which must live on the
    logits' device."""
    lg = logits.float()
    if gen.temperature and gen.temperature > 0:
        lg = lg / gen.temperature
        if gen.top_k:
            kth = torch.topk(lg, gen.top_k, dim=-1).values[:, -1:]
            lg = torch.where(lg < kth, torch.full_like(lg, -1e30), lg)
        if gen.top_p < 1.0:
            srt = torch.sort(lg, dim=-1, descending=True).values
            cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
            # smallest set with cumulative prob >= top_p
            cutoff_idx = (cum < gen.top_p).sum(dim=-1, keepdim=True)
            cutoff = torch.gather(srt, -1, cutoff_idx)
            lg = torch.where(lg < cutoff, torch.full_like(lg, -1e30), lg)
        probs = torch.softmax(lg, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(lg, dim=-1)


@dataclass
class GenerationConfig:
    max_new_tokens: int = 128
    temperature: float = 0.0       # 0 = greedy
    top_k: int = 0                 # 0 = off
    top_p: float = 1.0             # 1 = off
    seed: int = 0
    eos_token_id: Optional[int] = None


class Config:
    """Predictor configuration (the ported subset of
    ``paddle_tpu.inference.Config``)."""

    def __init__(self):
        self._model = None
        self.dtype: Optional[str] = None
        self.max_batch_size = 8
        self.max_length: Optional[int] = None
        self.generation = GenerationConfig()
        self._kv_page_size: Optional[int] = None

    def set_model(self, model) -> "Config":
        """Serve a live ``nn.Module``."""
        self._model = model
        return self

    def enable_paged_kv(self, page_size: int = 64) -> "Config":
        """Serve with a paged (block-table) KV cache. The attention
        kernels step through a page 8 keys at a time."""
        if page_size < 8 or page_size % 8:
            raise ValueError("page_size must be a multiple of 8, got "
                             f"{page_size}")
        self._kv_page_size = int(page_size)
        return self


def create_predictor(config: Config) -> "Predictor":
    return Predictor(config)


class Predictor:
    def __init__(self, config: Config):
        if config._model is None:
            raise ValueError("Config needs set_model(module) before "
                             "create_predictor")
        self.config = config
        self._model = config._model
        if config.dtype:
            self._model.to(_DTYPES[config.dtype])
        self._model.eval()
        self._params = list(self._model.parameters())
        self.stats = CompileStats()

    @property
    def device(self) -> torch.device:
        return self._params[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self._params[0].dtype

    @torch.no_grad()
    def _prefill_step(self, ids, caches, lengths):
        """The prefill step (the JAX package's ``_prefill_fn``; eager
        here, so nothing is cached per shape): the forward at offset 0
        writing the prompt's KV into its pages, and each row's logits at
        its true last prompt token."""
        logits, caches = self._model(ids, caches=caches, offset=0)
        last = logits[torch.arange(ids.shape[0], device=ids.device),
                      lengths.long() - 1]
        return last, caches


from .serving import ServingEngine, ServingRequest  # noqa: E402

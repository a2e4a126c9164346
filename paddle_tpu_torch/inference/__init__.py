"""Inference API (counterpart of ``paddle_tpu/inference/__init__.py``).

Ported: ``GenerationConfig``, ``Config`` (model, paged KV, max length,
dtype, generation defaults), ``create_predictor``, ``_sample``, and the
``Predictor``:

- ``Predictor.run`` — the model's forward on a list of inputs, outputs
  as numpy arrays (the reference's ``AnalysisPredictor::Run`` surface);
- ``Predictor.generate`` — batched generation over any model with the
  KV-cache protocol (``_empty_caches`` / ``forward(ids, caches,
  offset)``). The right-padded prompt prefills at a power-of-two bucket
  (never past the cache), each row's first token is sampled at its true
  last prompt token, and ragged rows decode at per-row offsets with
  optional per-row EOS stopping. The static cache ``[B, KV, M, D]``
  attends through K6; ``Config.enable_paged_kv`` allocates per-row pages
  from a pool bucketed to a power of two with one trash page, and
  attends through K5.

Where JAX ran the token loop as one compiled ``lax.scan``, the port runs
an eager Python loop; like the scan it makes no host round-trip per
token (the EOS ``done`` mask and per-row positions stay on the device),
and ``stats`` notes each launch site's shape. The predictor serves on
its model's device: caches, pools, tables and the sampling generator
live there too.

Not ported (they raise ``NotImplementedError`` naming their ROADMAP.md
item): weight loading from ``params_file`` / ``model_dir`` with a model
factory, and int8/int4 weight-only serving.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from ..core.bucketing import bucket as _bucket
from ..core.compile_stats import CompileStats
from ..core.enforce import enforce

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


_PARAMS_TODO = ("loading weights from a params file or model directory "
                "needs Paddle's save format, which is not ported: "
                "ROADMAP.md queue 1, item 1.4; build the model and call "
                "Config.set_model")


class Config:
    """Predictor configuration (the ported subset of
    ``paddle_tpu.inference.Config``)."""

    def __init__(self, model_dir: Optional[str] = None,
                 params_file: Optional[str] = None):
        if model_dir is not None or params_file is not None:
            raise NotImplementedError(_PARAMS_TODO)
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

    def set_model_factory(self, factory) -> "Config":
        raise NotImplementedError(_PARAMS_TODO)

    def set_params_file(self, path: str) -> "Config":
        raise NotImplementedError(_PARAMS_TODO)

    def enable_weight_only(self, algo: str = "weight_only_int8",
                           skip=("lm_head",)) -> "Config":
        raise NotImplementedError(
            "int8/int4 weight-only serving is not ported: it needs a "
            "kernel that reads the quantized weights (dequantising per "
            "call in torch ops would give up the byte saving); "
            "ROADMAP.md queue 1, item 1.1")

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

    # -- generic forward (AnalysisPredictor::Run) ---------------------------
    @torch.no_grad()
    def run(self, inputs: List[Any]) -> List[np.ndarray]:
        """The model's forward on ``inputs`` (arrays or tensors, moved to
        the model's device); returns its outputs as numpy arrays."""
        xs = [torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x, device=self.device) for x in inputs]
        self.stats.note("run", tuple((tuple(x.shape), str(x.dtype))
                                     for x in xs))
        out = self._model(*xs)
        outs = out if isinstance(out, (list, tuple)) else (out,)
        # numpy holds no bfloat16: such outputs come back as float32
        return [(o.float() if o.dtype == torch.bfloat16 else o).cpu().numpy()
                for o in outs]

    # -- LLM generation ----------------------------------------------------
    def _max_len(self, S0: int, n_new: int) -> int:
        if self.config.max_length:
            return self.config.max_length
        cap = getattr(getattr(self._model, "config", None),
                      "max_position_embeddings", None)
        need = _bucket(S0) + n_new
        return min(cap, _bucket(need)) if cap else _bucket(need)

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

    @torch.no_grad()
    def _decode_loop(self, tok0, caches, pos0, n: int,
                     gen: GenerationConfig, generator) -> torch.Tensor:
        """``n`` [B, 1] decode steps from tok0 at positions pos0 (an int,
        or a [B] tensor for ragged rows); returns the new tokens [B, n].
        With ``eos_token_id`` each row freezes at its eos: every later
        token of the row is eos. Nothing here waits for the device."""
        eos = gen.eos_token_id
        done = tok0 == eos if eos is not None else None
        tok, pos, out = tok0, pos0, []
        for _ in range(n):
            logits, caches = self._model(tok[:, None], caches=caches,
                                         offset=pos)
            tok = _sample(logits[:, -1], gen, generator)
            if eos is not None:
                tok = torch.where(done, torch.full_like(tok, eos), tok)
                done = done | (tok == eos)
            out.append(tok)
            pos = pos + 1
        return torch.stack(out, dim=1)

    def _paged_caches(self, lengths, n_new, M, page, dtype):
        """Per-row physical pages for len + n_new tokens from a pool of P
        pages, P = bucket(sum(need) + 1) on the power-of-two lattice (as
        the JAX predictor sizes it, so both pick the same tables). Logical
        pages a row does not own map to the trash page P - 1, where
        prefill's right-pad writes land unattended. One table serves
        every layer (the port has no donation to keep apart)."""
        cfg = self._model.config
        B = len(lengths)
        npages = -(-M // page)
        need = [-(-(int(n) + n_new) // page) for n in lengths]
        P = _bucket(sum(need) + 1, lo=8)
        table = np.full((B, npages), P - 1, np.int32)
        nxt = 0
        for b, nb in enumerate(need):
            table[b, :nb] = np.arange(nxt, nxt + nb)
            nxt += nb
        shape = (P, cfg.num_kv_heads, page, cfg.head_dim)
        kw = {"device": self.device, "dtype": dtype}
        tbl = torch.from_numpy(table).to(self.device)
        return [(torch.zeros(shape, **kw), torch.zeros(shape, **kw), tbl)
                for _ in range(cfg.num_layers)], P

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: Optional[int] = None,
                 lengths=None, **overrides) -> torch.Tensor:
        """Batched generation: [B, S0 + n_new] token ids on the model's
        device. ``lengths`` gives the true per-row prompt lengths of a
        right-padded ragged batch; ragged rows decode at per-row offsets
        (their own rope positions, cache slots and attention frontiers),
        stopping per row at ``eos_token_id`` when set (later slots are
        eos). ``overrides`` replace fields of the config's
        ``GenerationConfig``."""
        gen = GenerationConfig(**{
            **self.config.generation.__dict__,
            **({"max_new_tokens": max_new_tokens}
               if max_new_tokens is not None else {}),
            **overrides})
        ids = np.asarray(input_ids.cpu() if isinstance(input_ids, torch.Tensor)
                         else input_ids)
        B, S0 = ids.shape
        lengths = np.asarray(np.full((B,), S0) if lengths is None
                             else lengths, np.int32)
        n_new = gen.max_new_tokens
        M = self._max_len(S0, n_new)
        # bucket never past the cache: a 90-token prompt with
        # max_length=100 prefills at Sb=100, not at bucket 128
        Sb = min(_bucket(S0), M)
        ragged = int(lengths.min()) != int(lengths.max())
        enforce(int(lengths.max()) + n_new <= M,
                f"prompt ({int(lengths.max())}) + max_new_tokens ({n_new}) "
                f"exceeds cache length {M}; raise config.max_length")
        page = self.config._kv_page_size
        if page:
            caches, P = self._paged_caches(lengths, n_new, M, page,
                                           self.dtype)
        else:
            caches, P = self._model._empty_caches(B, M, self.dtype), 0
        ids_p = np.zeros((B, Sb), np.int64)
        ids_p[:, :S0] = ids
        dev = self.device
        self.stats.note("prefill", (B, Sb, M, page, P, str(self.dtype)))
        last, caches = self._prefill_step(
            torch.from_numpy(ids_p).to(dev), caches,
            torch.from_numpy(lengths).to(dev))
        generator = torch.Generator(device=dev).manual_seed(int(gen.seed))
        self.stats.count_tokens(("generate", B, Sb, P), B * n_new)
        new = [_sample(last, gen, generator)[:, None]]
        if n_new > 1:
            self.stats.note("decode", (B, M, n_new - 1, gen.temperature,
                                       gen.top_k, gen.top_p,
                                       gen.eos_token_id, ragged, page, P,
                                       str(self.dtype)))
            # ragged rows advance from their own true lengths
            pos0 = torch.from_numpy(lengths).to(dev) if ragged \
                else int(lengths.max())
            new.append(self._decode_loop(new[0][:, 0], caches, pos0,
                                         n_new - 1, gen, generator))
        return torch.cat([torch.from_numpy(ids).long().to(dev), *new], dim=1)


from .serving import ServingEngine, ServingRequest  # noqa: E402

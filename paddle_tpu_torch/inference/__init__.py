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

Where JAX ran the token loop as one ``lax.scan`` jitted per decode key
with the caches donated, the port runs one ``[B, 1]`` step body over
static buffers (token, positions, EOS ``done`` mask, output), captured
as a CUDA graph once per decode key and replayed once per token
(``core/cuda_graphs.py``; the body runs eagerly on the CPU). Nothing in
the loop waits for the device. The prefill stays eager. The caches and
the page table belong to their ``(B, M, page, P, dtype)`` key: the first
call allocates them zeroed, later calls with the key reuse them as they
are, which is exact because every position a row attends is written
first in the same call (see ``generate``). ``stats`` notes each launch
site's shape and counts captures and replays. The predictor serves on
its model's device: caches, pools, tables and the sampling generator
live there too.

``ServingEngine`` (serving.py) serves continuous batches over the page
pool; ``Router`` / ``RouterServer`` (router.py) front several engines,
unified or split by phase, with ``KVMigrator`` (disagg.py) moving KV
pages from prefill to decode replicas.

``Config.enable_weight_only`` serves int8 / int4 weights: the predictor
swaps the model's linears for ``nn.quant.WeightOnlyLinear`` (in place,
after the dtype cast, the LM head kept by default), whose projections
run kernel K9 on the card.

``Config(params_file=...)`` / ``Config(model_dir=...)`` with
``set_model_factory`` serve a saved model, as the JAX predictor does: the
factory builds the model, the file's weights load into it, then
``dtype`` casts and ``enable_weight_only`` quantizes. The file is the JAX
package's ``save`` format (``framework/io.py``) holding the JAX layout
(Linear weights ``[in, out]``): ``paddle_tpu.save(model.state_dict(),
path)`` writes one, and so does the port's ``save(export_jax_state_dict(
model, tensors=True), path)``. It loads through
``convert.load_jax_state_dict``, which raises on a name or a shape that
differs; a file of the port's own ``state_dict()`` (torch layout) is
refused, never transposed silently.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..core.bucketing import bucket as _bucket
from ..core.compile_stats import CompileStats
from ..core.cuda_graphs import StepGraphs
from ..core.enforce import enforce

__all__ = ["Config", "Predictor", "create_predictor", "GenerationConfig",
           "CompileStats", "ServingEngine", "ServingRequest", "KVMigrator",
           "MigrationCorruptError", "Replica", "Router", "RouterServer"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sample(logits: torch.Tensor, gen: "GenerationConfig",
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy / temperature / top-k / top-p sampling of [B, V] logits.
    Greedy is the float32 argmax (first index on ties, as jnp.argmax);
    the stochastic modes draw from ``generator``, which must live on the
    logits' device. The draw is ``torch.multinomial``'s own one-sample
    form, argmax(p / q) with q ~ Exp(1), written out: the same numbers
    from the same generator, without multinomial's checks of its input,
    which read values back to the host and so cannot be captured in a
    CUDA graph."""
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
        q = torch.empty_like(probs).exponential_(1, generator=generator)
        return torch.argmax(probs / q, dim=-1)
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
    ``paddle_tpu.inference.Config``): a live model (``set_model``) or a
    model factory with a params file or model directory."""

    def __init__(self, model_dir: Optional[str] = None,
                 params_file: Optional[str] = None):
        self.model_dir = model_dir
        self.params_file = params_file
        self._model = None
        self._model_factory: Optional[Callable[[], Any]] = None
        self.dtype: Optional[str] = None
        self.max_batch_size = 8
        self.max_length: Optional[int] = None
        self.generation = GenerationConfig()
        self._kv_page_size: Optional[int] = None
        self._weight_only_algo: Optional[str] = None
        self._weight_only_skip = ("lm_head",)

    def set_model(self, model) -> "Config":
        """Serve a live ``nn.Module``."""
        self._model = model
        return self

    def set_model_factory(self, factory: Callable[[], Any]) -> "Config":
        """A callable building the model (its weights need not be set);
        with ``params_file`` / ``model_dir`` the file's weights load
        into it."""
        self._model_factory = factory
        return self

    def set_params_file(self, path: str) -> "Config":
        self.params_file = path
        return self

    def enable_weight_only(self, algo: str = "weight_only_int8",
                           skip=("lm_head",)) -> "Config":
        """Serve with int8 / int4 weights (``nn.quant.quantize_for_serving``):
        decode reads the weights' bytes, so it gains with the byte
        shrink. ``skip`` keeps layers whose names hold one of its
        fragments (default: the LM head) in full precision."""
        if algo not in ("weight_only_int8", "weight_only_int4"):
            raise ValueError(
                f"enable_weight_only supports weight_only_int8/int4, got "
                f"{algo!r} (llm.int8 is the functional nn.quant."
                f"llm_int8_linear, not a serving swap)")
        self._weight_only_algo = algo
        self._weight_only_skip = tuple(skip)
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


def _params_path(config: Config) -> Optional[str]:
    """``params_file``, else the first of ``model.pdparams`` and
    ``params`` in ``model_dir`` (the JAX predictor's search)."""
    if config.params_file is not None or not config.model_dir:
        return config.params_file
    for cand in ("model.pdparams", "params"):
        p = os.path.join(config.model_dir, cand)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"model_dir {config.model_dir!r} holds neither "
                            "model.pdparams nor params")


def _load_params(model, path: str) -> None:
    """The JAX-layout state dict at ``path`` into ``model``
    (``convert.load_jax_state_dict``); a torch-layout file raises."""
    from ..convert import _linear_weights, load_jax_state_dict
    from ..framework.io import load_state

    state, torch_layout = load_state(path)
    params = dict(model.named_parameters())
    # a square [out, in] weight has the JAX shape too: the file's mark
    # (or, without one, a shape that only the transpose fits) tells
    flipped = [n for n in _linear_weights(model) & set(state)
               if torch_layout or (
                   tuple(state[n].shape) == tuple(params[n].shape)
                   != tuple(params[n].shape[::-1]))]
    if flipped:
        raise ValueError(
            f"{path} holds the port's torch layout (nn.Linear weights [out, "
            f"in], e.g. {flipped[0]}); a params file holds the JAX layout "
            "([in, out]): write it with framework.io.save("
            "convert.export_jax_state_dict(model, tensors=True), path)")
    load_jax_state_dict(model, state)


class Predictor:
    def __init__(self, config: Config):
        self.config = config
        self._model = self._build_model(config)
        self._model.eval()
        # the embedding comes first: device and dtype read it, never an
        # int8 weight
        self._params = list(self._model.parameters())
        self.stats = CompileStats()
        self._graphs = StepGraphs(self.device, self.stats)
        # (B, M, page, P, dtype) -> the key's caches, reused across calls
        self._caches = {}
        # re-seeded per generate call; the decode graphs read its state
        self._generator = torch.Generator(device=self.device)

    @staticmethod
    def _build_model(config: Config):
        """The JAX predictor's order: the live model or the factory's, the
        params file's weights, the ``dtype`` cast, then
        ``enable_weight_only``'s swap (after the cast: a later cast would
        round the f32 scales)."""
        model = config._model
        if model is None:
            if config._model_factory is None:
                raise ValueError(
                    "Config needs set_model(module) or set_model_factory "
                    "(+ params_file / model_dir) before create_predictor")
            model = config._model_factory()
        path = _params_path(config)
        if path:
            _load_params(model, path)
        if config.dtype:
            model.to(_DTYPES[config.dtype])
        if config._weight_only_algo:
            from ..nn.quant import quantize_for_serving

            quantize_for_serving(model, config._weight_only_algo,
                                 config._weight_only_skip)
        return model

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
    def _decode_loop(self, key, tok0, caches, pos0, n: int,
                     gen: GenerationConfig) -> torch.Tensor:
        """``n`` [B, 1] decode steps from tok0 at positions pos0 (int32
        [B]); returns the new tokens [B, n] (the key's output buffer,
        which the next call with ``key`` overwrites). With
        ``eos_token_id`` each row freezes at its eos: every later token
        of the row is eos. One step body over the key's static buffers,
        a CUDA graph per decode ``key`` on a card, drawing from the
        predictor's generator; nothing here waits for the device."""
        B = tok0.shape[0]
        eos = gen.eos_token_id
        model, generator = self._model, self._generator

        def make():
            kw = {"device": tok0.device}
            return SimpleNamespace(
                tok=torch.zeros(B, dtype=torch.int64, **kw),
                pos=torch.zeros(B, dtype=torch.int32, **kw),
                done=torch.zeros(B, dtype=torch.bool, **kw),
                col=torch.zeros(1, dtype=torch.int64, **kw),
                out=torch.zeros(B, n, dtype=torch.int64, **kw))

        def body(s):
            logits, _ = model(s.tok[:, None], caches=caches, offset=s.pos)
            tok = _sample(logits[:, -1], gen, generator)
            if eos is not None:
                tok = torch.where(s.done, torch.full_like(tok, eos), tok)
                s.done |= tok == eos
            s.tok.copy_(tok)
            s.out.index_copy_(1, s.col, tok[:, None])
            s.pos.add_(1)
            s.col.add_(1)

        st = self._graphs.buffers("decode", key, make)
        st.tok.copy_(tok0)
        st.pos.copy_(pos0)
        st.col.zero_()
        if eos is not None:
            torch.eq(tok0, eos, out=st.done)
        for _ in range(n):
            self._graphs.step("decode", key, body, generator)
        return st.out

    def _key_caches(self, B, M, page, P, dtype):
        """The caches of one (B, M, page, P, dtype) key: allocated zeroed
        on the key's first use, then the same tensors, NOT zeroed, for
        every later call with the key (a decode graph reads the
        addresses it was captured on). Paged: one pool pair per layer
        and one [B, npages] table that every layer shares (the port has
        no donation to keep apart)."""
        key = (B, M, page, P, str(dtype))
        caches = self._caches.get(key)
        if caches is None:
            cfg = self._model.config
            if not page:
                caches = self._model._empty_caches(B, M, dtype)
            else:
                shape = (P, cfg.num_kv_heads, page, cfg.head_dim)
                kw = {"device": self.device, "dtype": dtype}
                tbl = torch.zeros((B, -(-M // page)), dtype=torch.int32,
                                  device=self.device)
                caches = [(torch.zeros(shape, **kw),
                           torch.zeros(shape, **kw), tbl)
                          for _ in range(cfg.num_layers)]
            self._caches[key] = caches
        return caches

    def _paged_caches(self, lengths, n_new, M, page, dtype):
        """Per-row physical pages for len + n_new tokens from a pool of P
        pages, P = bucket(sum(need) + 1) on the power-of-two lattice (as
        the JAX predictor sizes it, so both pick the same tables). Logical
        pages a row does not own map to the trash page P - 1, where
        prefill's right-pad writes land unattended. Returns the key's
        caches (``_key_caches``) with this table written into them, and
        P."""
        B = len(lengths)
        npages = -(-M // page)
        need = [-(-(int(n) + n_new) // page) for n in lengths]
        P = _bucket(sum(need) + 1, lo=8)
        table = np.full((B, npages), P - 1, np.int32)
        nxt = 0
        for b, nb in enumerate(need):
            table[b, :nb] = np.arange(nxt, nxt + nb)
            nxt += nb
        caches = self._key_caches(B, M, page, P, dtype)
        caches[0][2].copy_(torch.from_numpy(table))
        return caches, P

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: Optional[int] = None,
                 lengths=None, **overrides) -> torch.Tensor:
        """Batched generation: [B, S0 + n_new] token ids on the model's
        device. ``lengths`` gives the true per-row prompt lengths of a
        right-padded ragged batch; ragged rows decode at per-row offsets
        (their own rope positions, cache slots and attention frontiers),
        stopping per row at ``eos_token_id`` when set (later slots are
        eos). ``overrides`` replace fields of the config's
        ``GenerationConfig``.

        The key's caches are reused without zeroing. That is exact: the
        prefill writes every slot 0..Sb-1 of its rows (or, paged, of the
        pages it maps; unowned ones map to the trash page), and each
        decode step writes its row's slot before attending to it, so no
        slot a row attends holds an earlier call's values; slots past a
        row's frontier are masked to an exact zero weight."""
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
            caches, P = self._key_caches(B, M, None, 0, self.dtype), 0
        ids_p = np.zeros((B, Sb), np.int64)
        ids_p[:, :S0] = ids
        dev = self.device
        lengths_t = torch.from_numpy(lengths).to(dev)
        self.stats.note("prefill", (B, Sb, M, page, P, str(self.dtype)))
        last, caches = self._prefill_step(
            torch.from_numpy(ids_p).to(dev), caches, lengths_t)
        self._generator.manual_seed(int(gen.seed))
        self.stats.count_tokens(("generate", B, Sb, P), B * n_new)
        new = [_sample(last, gen, self._generator)[:, None]]
        if n_new > 1:
            key = (B, M, n_new - 1, gen.temperature, gen.top_k, gen.top_p,
                   gen.eos_token_id, ragged, page, P, str(self.dtype))
            self.stats.note("decode", key)
            # every row advances from its own true length (all equal
            # when the batch is not ragged)
            new.append(self._decode_loop(key, new[0][:, 0], caches,
                                         lengths_t, n_new - 1, gen))
        return torch.cat([torch.from_numpy(ids).long().to(dev), *new], dim=1)


from .serving import ServingEngine, ServingRequest  # noqa: E402
from .disagg import KVMigrator, MigrationCorruptError  # noqa: E402
from .router import Replica, Router, RouterServer  # noqa: E402

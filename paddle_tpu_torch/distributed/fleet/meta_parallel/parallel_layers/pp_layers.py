"""Pipeline-parallel model partitioning (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/pp_layers.py``).

``LayerDesc`` / ``SharedLayerDesc`` describe layers to build later;
``SegmentLayers`` cuts a list of them into ``num_stages x vpp`` parts,
part ``j`` going to stage ``j % num_stages`` as its chunk ``j //
num_stages`` (the round-robin map of the interleaved schedule);
``PipelineLayer`` is the partitioned model.

The JAX package runs one SPMD program: every rank holds the stacked
``[L, ...]`` (or ``[vpp, L / vpp, ...]``) block parameters with the
layer axis sharded over 'pp', and a ``lax.scan`` + ``ppermute`` rotates
activations. Here one process is one rank, as in the reference Paddle:
each pp rank builds ONLY its own parts. The longest run of plain
``LayerDesc``s with one ``layer_func`` is the pipelined middle (the
decoder blocks); what comes before it is the prologue, built on stage 0,
and what comes after, the epilogue, built on stage S - 1 (the loss runs
there too). Under ``num_virtual_pipeline_stages = vpp`` with ``K = L /
(S vpp)``, stage ``s`` owns chunk ``v`` = global blocks ``[v L / vpp + s
K, v L / vpp + (s + 1) K)``, the rows the JAX layout gives rank ``s``;
the blocks are ``self.blocks[str(global index)]``, so the JAX stacked
names map row by row (``jax_names``, which ``convert.py`` reads).
``PipelineParallel`` (``pipeline_parallel.py``) drives them under the
1F1B schedule over p2p on the pp group.

A ``SharedLayerDesc`` whose key occurs in the prologue and in the
epilogue (the tied embedding) is built on stage 0 and again on stage
S - 1 when S > 1; its parameters carry ``pp_shared = key``. The copies
are broadcast from stage 0 when ``PipelineParallel`` wraps the model and
their gradients are summed over the HCG's pipe shared group ({stage 0,
stage S - 1} at each other coordinate) before the clip and the update,
as the reference's SharedLayerDesc all-reduce does; the JAX engine gets
the same sum by psumming replicated gradients over 'pp'. At S = 1 a
later occurrence applies its ``forward_func`` to the first instance.

``recompute_interval=1`` runs each block under ``fleet.recompute``
(0: none; the JAX package allows only these two). Hidden and attention
dropout draw from the model's generators, which the layer reseeds before
each block and each prologue call from ``(seed, global block,
microbatch)`` (``dropout_seed``): masks repeat under a seed and differ
across blocks and microbatches. The JAX package seeds each (tick,
stage, chunk) of its scan instead, which a schedule of one process a
rank cannot reproduce (ROADMAP.md queue 3).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from .....core.enforce import enforce

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
           "dropout_seed"]


class LayerDesc:
    """Deferred layer construction: ``layer_func(*inputs, **kwargs)``."""

    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not (issubclass(layer_func, nn.Module)
                if isinstance(layer_func, type) else callable(layer_func)):
            raise TypeError("layer_func must be an nn.Module subclass or "
                            "callable")

    def build_layer(self) -> nn.Module:
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return (f"LayerDesc("
                f"{getattr(self.layer_func, '__name__', self.layer_func)})")


class SharedLayerDesc(LayerDesc):
    """A layer whose parameters its occurrences share (the embedding
    tied to the LM head); ``forward_func(layer, x)`` overrides how a
    later occurrence applies it."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """Cut ``len(layers_desc)`` layers into ``num_parts x vpp`` parts:
    ``uniform`` or ``layer:<ClassName>`` (each part starts at an
    instance of the class); part ``j`` goes to stage ``j % num_parts``
    as its chunk ``j // num_parts``."""

    def __init__(self, layers_desc, num_parts, method="uniform",
                 num_virtual_pipeline_stage=None):
        self._layers_desc = layers_desc
        self.method = method
        self.num_stages = num_parts
        self.num_virtual = num_virtual_pipeline_stage or 1
        self.num_parts = num_parts * self.num_virtual
        self.num_items = len(layers_desc)
        enforce(self.num_items >= self.num_parts,
                f"layer number ({self.num_items}) should be no less than "
                f"the number of segments = pp degree ({self.num_stages}) "
                f"x num_virtual_pipeline_stages ({self.num_virtual}) = "
                f"{self.num_parts}")

    def part_stage(self, part_idx: int) -> int:
        enforce(0 <= part_idx < self.num_parts,
                f"part {part_idx} out of range [0, {self.num_parts})")
        return part_idx % self.num_stages

    def part_chunk(self, part_idx: int) -> int:
        enforce(0 <= part_idx < self.num_parts,
                f"part {part_idx} out of range [0, {self.num_parts})")
        return part_idx // self.num_stages

    def do_segment(self) -> List[int]:
        if self.method == "uniform":
            return self.uniform(self.num_items, self.num_parts)
        if self.method.startswith("layer:"):
            cls_name = self.method.split(":", 1)[1]
            idxs = []
            for i, d in enumerate(self._layers_desc):
                fn = d.layer_func if isinstance(d, LayerDesc) else type(d)
                if getattr(fn, "__name__", str(fn)) == cls_name:
                    idxs.append(i)
            total = len(idxs)
            enforce(total % self.num_parts == 0,
                    f"the number of {cls_name} ({total}) must be divisible "
                    f"by pp degree ({self.num_stages}) x "
                    f"num_virtual_pipeline_stages ({self.num_virtual}) "
                    f"= {self.num_parts}")
            per = total // self.num_parts
            return ([0] + [idxs[k * per] for k in range(1, self.num_parts)]
                    + [self.num_items])
        raise ValueError(f"unknown seg_method {self.method}")

    @staticmethod
    def uniform(num_items, num_parts) -> List[int]:
        result = [0]
        part, extra = num_items // num_parts, num_items % num_parts
        for i in range(num_parts):
            result.append(result[-1] + part + (1 if i < extra else 0))
        return result


def dropout_seed(seed: int, block: int, microbatch: int) -> int:
    """The stream of global block ``block`` (-1: the prologue, -2: the
    epilogue) on ``microbatch``: an odd-constant mix of the model's seed
    with the two indices, below 2^62."""
    return (int(seed) * 1000003 + (block + 3) * 2654435761
            + int(microbatch) * 40503) % (1 << 62)


class _FuncLayer(nn.Module):
    """A bare callable of the layer list, as a parameterless module."""

    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *a, **k):
        return self._fn(*a, **k)


class _SharedApply(nn.Module):
    """An occurrence of a SharedLayerDesc: ``forward_func(layer, x)`` (or
    the layer itself) on the shared instance. ``own``: this occurrence
    holds the instance (its parameters are its own); otherwise it refers
    to the instance another part of this rank holds."""

    def __init__(self, shared: nn.Module, forward_func, own: bool):
        super().__init__()
        if own:
            self.layer = shared
        else:
            object.__setattr__(self, "_shared_ref", shared)
        self._forward_func = forward_func

    def _target(self):
        return self.layer if "layer" in self._modules else self._shared_ref

    def forward(self, *a, **k):
        if self._forward_func is not None:
            return self._forward_func(self._target(), *a, **k)
        return self._target()(*a, **k)


def _apply_seq(layers, x):
    for lyr in layers:
        x = lyr(*x) if isinstance(x, tuple) else lyr(x)
    return x


class PipelineLayer(nn.Module):
    """This pp rank's parts of a pipeline-partitioned model (module
    docstring). ``num_stages`` / ``num_virtual_pipeline_stages`` / the
    stage default to the fleet HCG's; ``generators`` (optional) are the
    generators the built layers draw dropout from, reseeded per block
    and microbatch from ``seed``."""

    def __init__(self, layers, num_stages: Optional[int] = None,
                 topology=None, loss_fn=None, seg_method: str = "uniform",
                 recompute_interval: int = 0, recompute_ctx=None,
                 num_virtual_pipeline_stages: Optional[int] = None,
                 stage_id: Optional[int] = None, generators=(),
                 seed: int = 0):
        super().__init__()
        hcg = self._hcg()
        if num_stages is None:
            num_stages = hcg.get_pipe_parallel_world_size() \
                if hcg is not None else 1
        self._num_stages = S = int(num_stages)
        if num_virtual_pipeline_stages is None:
            num_virtual_pipeline_stages = \
                hcg.get_virtual_pipeline_parallel_world_size() \
                if hcg is not None else 1
        vpp = int(num_virtual_pipeline_stages or 1)
        enforce(vpp >= 1,
                f"num_virtual_pipeline_stages must be >= 1; got {vpp}")
        if vpp > 1:
            enforce(S > 1,
                    f"num_virtual_pipeline_stages={vpp} (the interleaved "
                    f"schedule) needs a pipelined mesh, but pp_degree is "
                    f"{S} — set hybrid_configs['pp_degree'] > 1 or drop "
                    "hybrid_configs['pp_configs']"
                    "['num_virtual_pipeline_stages']")
        self._vpp = V = vpp
        enforce(recompute_interval in (0, 1),
                "recompute_interval must be 0 (off) or 1 (recompute every "
                f"block); got {recompute_interval}")
        self._recompute_interval = recompute_interval
        self._loss_fn = loss_fn
        self._seg_method = seg_method
        if stage_id is None:
            stage_id = hcg.get_stage_id() if hcg is not None and S > 1 \
                else 0
        self._stage = s = int(stage_id)
        enforce(0 <= s < S, f"stage {s} outside {S} pipeline stages")
        self._generators = tuple(generators)
        self._seed = int(seed)
        descs = list(layers)
        lo, hi = self._homogeneous_run(descs)
        L = hi - lo
        enforce(L % (S * V) == 0 if S * V > 1 else True,
                f"pipelined middle has {L} layers (L), not divisible by "
                f"pp_degree ({S}) x num_virtual_pipeline_stages ({V}) = "
                f"{S * V}; each stage must own num_virtual_pipeline_stages "
                f"chunks of L/{S * V} layers — adjust num_layers or the "
                "pp_degree / num_virtual_pipeline_stages knobs")
        self._n_blocks = L
        if L:
            seg = SegmentLayers(descs[lo:hi], S, seg_method,
                                V if V > 1 else None)
            self.segment_parts = seg.do_segment()
            self.segment_part_stages = [seg.part_stage(j)
                                        for j in range(seg.num_parts)]
            self.segment_part_chunks = [seg.part_chunk(j)
                                        for j in range(seg.num_parts)]
        else:
            self.segment_parts = [0]
            self.segment_part_stages = []
            self.segment_part_chunks = []
        # this rank's chunks: the global block indices of each
        self.chunk_blocks: List[List[int]] = [[] for _ in range(V)]
        for j in range(len(self.segment_part_stages)):
            if self.segment_part_stages[j] == s:
                self.chunk_blocks[self.segment_part_chunks[j]] = list(range(
                    self.segment_parts[j], self.segment_parts[j + 1]))
        # keys shared between the two ends (tied across stages)
        pro_keys = {d.layer_name for d in descs[:lo]
                    if isinstance(d, SharedLayerDesc)}
        epi_keys = {d.layer_name for d in descs[hi:]
                    if isinstance(d, SharedLayerDesc)}
        self._cross_keys = pro_keys & epi_keys if S > 1 else set()
        self._pro_index = {d.layer_name: i for i, d in enumerate(descs[:lo])
                           if isinstance(d, SharedLayerDesc)}
        self._shared: Dict[str, nn.Module] = {}
        self.prologue = nn.ModuleList(
            [self._build(d) for d in descs[:lo]] if s == 0 else [])
        self.blocks = nn.ModuleDict()
        for v in range(V):
            for i in self.chunk_blocks[v]:
                self.blocks[str(i)] = descs[lo + i].build_layer()
        self.epilogue = nn.ModuleList(
            [self._build(d) for d in descs[hi:]] if s == S - 1 else [])
        for key in self._cross_keys:
            inst = self._shared.get(key)
            if inst is not None:
                for p in inst.parameters():
                    p.pp_shared = key
        self._microbatch = 0

    # -- construction ------------------------------------------------------
    @staticmethod
    def _hcg():
        from ... import get_hybrid_communicate_group

        return get_hybrid_communicate_group()

    def _build(self, d) -> nn.Module:
        if isinstance(d, SharedLayerDesc):
            if d.layer_name in self._shared:
                return _SharedApply(self._shared[d.layer_name],
                                    d.forward_func, own=False)
            inst = d.build_layer()
            self._shared[d.layer_name] = inst
            if d.forward_func is None:
                return inst
            return _SharedApply(inst, d.forward_func, own=True)
        if isinstance(d, LayerDesc):
            return d.build_layer()
        if isinstance(d, nn.Module):
            return d
        if callable(d):
            return _FuncLayer(d)
        raise TypeError(f"cannot build pipeline entry {d!r}")

    @staticmethod
    def _homogeneous_run(descs) -> tuple:
        """[lo, hi) of the longest run of plain LayerDescs with the same
        layer_func: the pipelined middle."""
        best, i, n = (0, 0), 0, len(descs)
        while i < n:
            d = descs[i]
            if type(d) is LayerDesc:
                j = i
                while j < n and type(descs[j]) is LayerDesc and \
                        descs[j].layer_func is d.layer_func:
                    j += 1
                if j - i > best[1] - best[0]:
                    best = (i, j)
                i = j
            else:
                i += 1
        return best

    # -- the stage's work --------------------------------------------------
    def is_first_stage(self) -> bool:
        return self._stage == 0

    def is_last_stage(self) -> bool:
        return self._stage == self._num_stages - 1

    def _reseed(self, block: int):
        if not self._generators:
            return
        base = dropout_seed(self._seed, block, self._microbatch)
        for k, g in enumerate(self._generators):
            g.manual_seed((base + 7919 * k) % (1 << 62))

    def _block(self, i: int, x):
        self._reseed(i)
        blk = self.blocks[str(i)]
        if self._recompute_interval:
            from ...utils.recompute import recompute

            return recompute(blk, x)
        return blk(x)

    def run_chunk(self, v: int, x, microbatch: int = 0):
        """Chunk ``v`` of this stage on ``x`` for ``microbatch``: the
        prologue first on stage 0's chunk 0 (``x`` = its inputs), the
        epilogue last on stage S - 1's chunk vpp - 1."""
        self._microbatch = int(microbatch)
        if v == 0 and self.is_first_stage() and len(self.prologue):
            self._reseed(-1)
            x = _apply_seq(self.prologue, x)
        for i in self.chunk_blocks[v]:
            x = self._block(i, x)
        if v == self._vpp - 1 and self.is_last_stage() and len(self.epilogue):
            self._reseed(-2)
            x = _apply_seq(self.epilogue, x)
        return x

    def forward(self, *args):
        """The whole model on one rank (a pipeline of one stage)."""
        enforce(self._num_stages == 1,
                "PipelineLayer.forward runs a one-stage pipeline; with "
                "pp_degree > 1 drive it through fleet.distributed_model "
                "(PipelineParallel.train_batch / eval_batch)")
        x = args if len(args) > 1 else args[0]
        for v in range(self._vpp):
            x = self.run_chunk(v, x, self._microbatch)
        return x

    def compute_loss(self, inputs, labels):
        enforce(self._loss_fn is not None,
                "PipelineLayer needs loss_fn for train_batch")
        lbs = list(labels) if isinstance(labels, (tuple, list)) else [labels]
        ins = tuple(inputs) if isinstance(inputs, (tuple, list)) \
            else (inputs,)
        return self._loss_fn(self.forward(*ins), *lbs)

    # -- reference API -----------------------------------------------------
    def get_num_stages(self) -> int:
        return self._num_stages

    def get_num_virtual_stages(self) -> int:
        return self._vpp

    def chunk_parameters(self, v: int) -> List[torch.Tensor]:
        """The parameters chunk ``v`` of this stage trains: its blocks',
        with the prologue's on stage 0's chunk 0 and the epilogue's on
        stage S - 1's last chunk."""
        mods = [self.blocks[str(i)] for i in self.chunk_blocks[v]]
        if v == 0 and self.is_first_stage():
            mods += list(self.prologue)
        if v == self._vpp - 1 and self.is_last_stage():
            mods += list(self.epilogue)
        seen: Dict[int, torch.Tensor] = {}
        for m in mods:
            for p in m.parameters():
                seen.setdefault(id(p), p)
        return list(seen.values())

    def jax_names(self) -> Dict[str, tuple]:
        """{port name: (JAX name, stacked row or None)}: the JAX
        ``PipelineLayer``'s name of each parameter here, and for a block
        parameter its row of the stacked array (``(g,)`` over ``[L,
        ...]``, ``(v, r)`` over ``[vpp, L / vpp, ...]``). A tied copy on
        the last stage maps to its stage-0 name."""
        out: Dict[str, tuple] = {}
        per = self._n_blocks // self._vpp if self._n_blocks else 0
        for name, p in self.named_parameters():
            if name.startswith("blocks."):
                _, g, rest = name.split(".", 2)
                g = int(g)
                row = (g,) if self._vpp == 1 else (g // per, g % per)
                out[name] = ("blocks__" + rest.replace(".", "__"), row)
            else:
                out[name] = (name, None)
        if not self.is_first_stage():
            # a tied copy takes the stage-0 instance's (prologue) name
            for idx, lyr in enumerate(self.epilogue):
                if not (isinstance(lyr, _SharedApply)
                        and "layer" in lyr._modules):
                    continue
                key = next(k for k, m in self._shared.items()
                           if m is lyr.layer)
                for n, _ in lyr.layer.named_parameters():
                    out[f"epilogue.{idx}.layer.{n}"] = (
                        f"prologue.{self._pro_index[key]}.{n}", None)
        return out

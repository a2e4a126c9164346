"""Optimizer wrappers for hybrid-parallel training (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/``).

``HybridParallelOptimizer`` wraps the user's optimizer: its clip and
global norm become the norm over the model-parallel group (a
``nn.clip.GradSync``, as ``ParallelEngine`` installs), and its ``step()``
first runs the engine's gradient sync (``parallel.sync_hybrid_gradients``:
the mean over the data-parallel group, then the sum over the
model-parallel group of the parameters marked ``sequence_parallel``), so
an eager ``loss.backward(); opt.step()`` loop trains as the engine does.
``ParallelEngine`` unwraps it (``_inner_opt``).

Over a sharding axis both wrappers mark the inner optimizer
``state_partition_axis = "sharding"`` (ZeRO stage 1, as the JAX wrappers
do), which ``ParallelEngine`` reads to shard the optimizer state. The
JAX ``DygraphShardingOptimizer``'s ``reduce_gradients`` and
``_sharding_sync_parameters`` are no-ops (its compiled step moves the
data); here an eager loop runs them: ``reduce_gradients`` averages the
gradients over dp and reduce-scatters each ZeRO plan entry's onto this
rank's shard over the sharding group (the rest averaged over dp x
sharding), ``step`` updates the shards with shard-shaped moments (one K8
launch for Adam / AdamW on CUDA) and ``_sharding_sync_parameters``
all-gathers them back into the whole parameters: the engine's ZeRO path
(``engine.zero_sync`` / ``zero_apply``, ``grad_buckets.ZeroStep``) on
the HCG's groups, built by the engine's ``build_zero`` (the stage from
``sharding_configs``; at stage 3 the parameters are stored as shards
between steps and a forward pre-hook on the model gathers them).
``HybridParallelOptimizer.step()`` over a sharding axis runs those
three.
"""
from __future__ import annotations

from ....core.enforce import enforce
from ...parallel import sync_hybrid_gradients
from ....nn.clip import GradSync

__all__ = ["HybridParallelOptimizer", "DygraphShardingOptimizer"]


class _OptimizerWrapper:
    def __init__(self, optimizer, hcg=None, strategy=None):
        inner = getattr(optimizer, "_inner_opt", optimizer)
        self._inner_opt = inner
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)

    @property
    def _step_count(self):
        return self._inner_opt._step_count

    @_step_count.setter
    def _step_count(self, v):
        self._inner_opt._step_count = v

    def step(self):
        return self._inner_opt.step()

    def clear_grad(self, set_to_zero: bool = True):
        return self._inner_opt.clear_grad()

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, state_dict):
        return self._inner_opt.set_state_dict(state_dict)

    def get_lr(self):
        return self._inner_opt.get_lr()

    def set_lr(self, lr):
        return self._inner_opt.set_lr(lr)


class HybridParallelOptimizer(_OptimizerWrapper):
    def __init__(self, optimizer, hcg=None, strategy=None):
        super().__init__(optimizer, hcg, strategy)
        self._sharding = None
        if hcg is None:
            return
        if hcg.get_sharding_parallel_world_size() > 1:
            # fleet applies stage 1 when the axis exists
            self._sharding = DygraphShardingOptimizer(self._inner_opt, hcg)
            return
        mp = hcg.get_model_parallel_group()
        if mp.nranks > 1:
            self._inner_opt._grad_sync = GradSync(
                mp_group=mp, found_group=hcg.get_check_parallel_group())

    def step(self):
        if self._sharding is not None:
            return self._sharding.step()
        if self._hcg is not None:
            sync_hybrid_gradients(self._inner_opt._parameter_list,
                                  self._hcg.get_data_parallel_group(),
                                  self._hcg.get_model_parallel_group())
        return self._inner_opt.step()


class DygraphShardingOptimizer(_OptimizerWrapper):
    """ZeRO over the HCG's sharding group (module docstring)."""

    def __init__(self, optimizer, hcg=None):
        super().__init__(optimizer, hcg)
        self._inner_opt.state_partition_axis = "sharding"
        self._zs = None
        self._synced = None
        self._shards = None

    def _eager(self):
        """The ZeRO step over the HCG's groups, built at the first use by
        the engine's ``build_zero`` (the stage from ``sharding_configs``,
        or 3 where ``group_sharded_parallel`` marked ``p_g_os``; no
        buckets). A stage-3 model gathers its parameters in a forward
        pre-hook."""
        if self._zs is None:
            from ... import fleet
            from ...engine import build_zero, zero_counted
            from ...grad_buckets import stage_config

            hcg = self._hcg or fleet.get_hybrid_communicate_group()
            enforce(hcg is not None,
                    "DygraphShardingOptimizer's eager step needs fleet.init "
                    "(the sharding group comes from the HCG)")
            enforce(hcg.get_pipe_parallel_world_size() <= 1,
                    "a pipeline trains through PipelineParallel.train_batch, "
                    "not an eager DygraphShardingOptimizer step")
            # the parameters' model (the plan reads its linears):
            # group_sharded_parallel's, else fleet.distributed_model's
            model = getattr(self._inner_opt, "_sharded_model", None)
            if model is None:
                model = fleet._fleet_state.model
            enforce(model is not None,
                    "DygraphShardingOptimizer's eager step needs the model: "
                    "wrap it by group_sharded_parallel(model, optimizer, "
                    "level) or fleet.distributed_model(model) first")
            self._hcg = hcg

            def big(g):
                return g if g.nranks > 1 else None
            sh = big(hcg.get_sharding_parallel_group())
            self._mp = big(hcg.get_model_parallel_group())
            _, _, self._zs = build_zero(
                model, self._inner_opt, sh,
                big(hcg.get_data_parallel_group()),
                big(hcg.get_dp_sharding_parallel_group()), self._mp,
                hcg.get_check_parallel_group(), hcg.mesh.coords,
                stage_config()[0])
            if self._zs.stored():
                zs = self._zs
                model.register_forward_pre_hook(lambda m, a: zs.gather())
            coords = hcg.mesh.coords
            self._counted = lambda p, shard: zero_counted(
                p, coords, self._mp, sh, shard)
        return self._zs

    def reduce_gradients(self, parameter_list=None, hcg=None):
        """The gradient sync (module docstring); the gradients are
        consumed (``p.grad`` None after it)."""
        from ...engine import zero_sync

        zs = self._eager()
        self._synced = zero_sync(self._inner_opt, zs, None, self._mp)

    def step(self):
        """Sync (unless ``reduce_gradients`` ran), update this rank's
        shards, all-gather them."""
        from ...engine import zero_apply

        if self._synced is None:
            self.reduce_gradients()
        zs = self._eager()
        _, self._shards = zero_apply(self._inner_opt, zs, self._synced,
                                     self._counted)
        self._synced = None
        self._sharding_sync_parameters()

    def _sharding_sync_parameters(self):
        """The updated shards all-gathered into the whole parameters."""
        if self._shards is not None:
            self._eager().after_update(self._shards)
            self._shards = None

"""Optimizer wrappers for hybrid-parallel training (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/``).

``HybridParallelOptimizer`` wraps the user's optimizer: its clip and
global norm become the norm over the model-parallel group (a
``nn.clip.GradSync``, as ``ParallelEngine`` installs), and its ``step()``
first runs the engine's gradient sync (``parallel.sync_hybrid_gradients``:
the mean over the data-parallel group, then the sum over the
model-parallel group of the parameters marked ``sequence_parallel``), so
an eager ``loss.backward(); opt.step()`` loop trains as the engine does.
``ParallelEngine`` unwraps it (``_inner_opt``). ``DygraphShardingOptimizer``
(ZeRO) raises: ROADMAP.md queue 1, item 9.
"""
from __future__ import annotations

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
        if hcg is None:
            return
        if hcg.get_sharding_parallel_world_size() > 1:
            raise NotImplementedError(
                "HybridParallelOptimizer with a sharding axis (ZeRO stage "
                "1): not ported yet (ROADMAP.md queue 1, item 9)")
        mp = hcg.get_model_parallel_group()
        if mp.nranks > 1:
            self._inner_opt._grad_sync = GradSync(
                mp_group=mp, found_group=hcg.get_check_parallel_group())

    def step(self):
        if self._hcg is not None:
            sync_hybrid_gradients(self._inner_opt._parameter_list,
                                  self._hcg.get_data_parallel_group(),
                                  self._hcg.get_model_parallel_group())
        return self._inner_opt.step()


class DygraphShardingOptimizer(_OptimizerWrapper):
    def __init__(self, optimizer, hcg=None):
        raise NotImplementedError(
            "DygraphShardingOptimizer (ZeRO stage 1): not ported yet "
            "(ROADMAP.md queue 1, item 9)")

"""Fleet: the hybrid-parallel user API (counterpart of
``paddle_tpu/distributed/fleet/__init__.py``).

``fleet.init(strategy=...)`` builds the ``HybridCommunicateGroup`` from
``strategy.hybrid_configs`` (starting the process group first when it is
not) and seeds the hybrid RNG tracker once: the global stream from
``mp_seed`` (2024 by default), the same on every rank, and the local
stream from ``mp_seed + 2718 + mp rank``, distinct per mp rank.
``distributed_model`` / ``distributed_optimizer`` wrap by strategy.
``fleet.utils`` holds sequence parallelism (``sequence_parallel_utils``)
and ``recompute``, which ``fleet.recompute`` names too.
"""
from __future__ import annotations

from typing import Optional

from .base.distributed_strategy import DistributedStrategy
from .base.role_maker import (PaddleCloudRoleMaker, Role,  # noqa: F401
                              RoleMakerBase, UserDefinedRoleMaker, UtilBase)
from .base.topology import CommunicateTopology, HybridCommunicateGroup
from . import utils  # noqa: F401
from .utils.recompute import recompute  # noqa: F401

__all__ = ["init", "DistributedStrategy", "HybridCommunicateGroup",
           "CommunicateTopology", "get_hybrid_communicate_group",
           "get_strategy", "is_initialized", "distributed_model",
           "distributed_optimizer", "fleet", "util", "utils", "recompute"]


class _FleetState:
    """The process's fleet: its HCG and strategy (one process a rank)."""

    def __init__(self):
        self.initialized = False
        self.hcg: Optional[HybridCommunicateGroup] = None
        self.strategy: Optional[DistributedStrategy] = None
        self.model = None        # the last model distributed_model wrapped


_fleet_state = _FleetState()
util = UtilBase()


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, log_level="INFO"):
    """Build the HCG from ``strategy.hybrid_configs`` and seed the RNG
    tracker (module docstring); returns the HCG."""
    strategy = strategy or DistributedStrategy()
    hc = strategy.hybrid_configs
    pp_conf = hc.get("pp_configs", {}) or {}
    hcg = HybridCommunicateGroup(
        dp_degree=hc.get("dp_degree", 1), mp_degree=hc.get("mp_degree", 1),
        pp_degree=hc.get("pp_degree", 1),
        sharding_degree=hc.get("sharding_degree", 1),
        sep_degree=hc.get("sep_degree", 1),
        ep_degree=hc.get("ep_degree", 1),
        order=list(hc.get("order",
                          ["dp", "pp", "sharding", "sep", "ep", "mp"])),
        vpp_degree=pp_conf.get("num_virtual_pipeline_stages", 1))
    _fleet_state.initialized = True
    _fleet_state.hcg = hcg
    _fleet_state.strategy = strategy
    from .layers.mpu.random import (GLOBAL_SEED, LOCAL_SEED,
                                    get_rng_state_tracker)

    tracker = get_rng_state_tracker()
    if LOCAL_SEED not in tracker.states_:
        seed = int(hc.get("mp_seed", 2024))
        if GLOBAL_SEED not in tracker.states_:
            tracker.add(GLOBAL_SEED, seed)
        tracker.add(LOCAL_SEED,
                    seed + 2718 + hcg.get_model_parallel_rank())
    return hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _fleet_state.hcg


def get_strategy() -> Optional[DistributedStrategy]:
    return _fleet_state.strategy


def is_initialized() -> bool:
    return _fleet_state.initialized


def distributed_model(model):
    """Wrap ``model`` by the active strategy (``meta_parallel``)."""
    from .meta_parallel import wrap_distributed_model

    _fleet_state.model = model
    return wrap_distributed_model(model, _fleet_state.hcg,
                                  _fleet_state.strategy)


def distributed_optimizer(optimizer, strategy=None):
    from .meta_optimizers import HybridParallelOptimizer

    return HybridParallelOptimizer(optimizer, _fleet_state.hcg,
                                   strategy or _fleet_state.strategy)


class _FleetNamespace:
    """``from paddle_tpu_torch.distributed.fleet import fleet;
    fleet.init(...)``, as Paddle code writes it."""

    init = staticmethod(init)
    distributed_model = staticmethod(distributed_model)
    distributed_optimizer = staticmethod(distributed_optimizer)
    get_hybrid_communicate_group = staticmethod(get_hybrid_communicate_group)

    @property
    def worker_num(self):
        from .. import collective as C

        return C.get_world_size()


fleet = _FleetNamespace()

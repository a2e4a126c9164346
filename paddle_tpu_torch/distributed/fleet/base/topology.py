"""The hybrid-parallel topology over processes (counterpart of
``paddle_tpu/distributed/fleet/base/topology.py``).

The JAX ``HybridCommunicateGroup`` is a ``jax.sharding.Mesh`` whose axes
are the parallel dimensions, each "group" an axis name. Here each
process is one rank of the job and owns one ``Group`` per axis: the
ranks that share every other coordinate. The axis order is the JAX
one, ``dp / pp / sharding / sep / ep / mp`` with mp innermost (the
fastest-varying coordinate of a global rank, as the JAX mesh reshapes
its devices), so one rank's groups are exactly the JAX mesh's axis
slices through that rank. Besides the axes there is the ``dp+sharding``
group (gradient sync in sharding mode), the world group and, with a pp
axis of more than one stage, the pipeline's shared-layer group: the
first and the last stage at this rank's other coordinates (a tied
embedding lives on both; its gradients are summed over the two).

``hcg.mesh`` is a small descriptor, ``HybridMesh``: ``axis_names``,
``shape`` (axis -> size), ``size``, this rank's ``coords`` and its
``groups`` (axis -> Group, plus ``dp_sharding`` and ``pp_shared``);
``ParallelEngine`` reads it as the JAX engine reads its ``Mesh``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ... import collective as C

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "HybridMesh"]

_DEFAULT_ORDER = ["dp", "pp", "sharding", "sep", "ep", "mp"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names: List[str] = None,
                 dims: List[int] = None, order: List[str] = None):
        self._parallel_names = hybrid_group_names or _DEFAULT_ORDER
        self._dims = dims or [1] * len(self._parallel_names)
        self._order = order or self._parallel_names

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return int(np.prod(self._dims))

    def get_coord(self, rank: int) -> Dict[str, int]:
        """The coordinates of global ``rank`` (the last axis fastest)."""
        idx = np.unravel_index(int(rank), tuple(self._dims))
        return {n: int(i) for n, i in zip(self._parallel_names, idx)}

    def get_rank(self, **coords) -> int:
        return int(np.ravel_multi_index(
            tuple(coords.get(n, 0) for n in self._parallel_names),
            tuple(self._dims)))

    def get_comm_list(self, axis_names) -> List[List[int]]:
        """Every group along ``axis_names`` (one or several axes): the
        ranks that share all the other coordinates, each list in rank
        order."""
        axis_names = [axis_names] if isinstance(axis_names, str) \
            else list(axis_names)
        groups: Dict[Tuple, List[int]] = {}
        for r in range(self.world_size()):
            c = self.get_coord(r)
            key = tuple(c[n] for n in self._parallel_names
                        if n not in axis_names)
            groups.setdefault(key, []).append(r)
        return [groups[k] for k in sorted(groups)]


@dataclass
class HybridMesh:
    """What ``ParallelEngine`` reads of the topology (the JAX engine's
    ``Mesh``): axis names and sizes, this rank's coordinates and its
    group along each axis."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, C.Group]
    rank: int

    @property
    def size(self) -> int:
        return int(np.prod([self.shape[a] for a in self.axis_names]))


class HybridCommunicateGroup:
    def __init__(self, topology: Optional[CommunicateTopology] = None,
                 dp_degree: int = 1, mp_degree: int = 1, pp_degree: int = 1,
                 sharding_degree: int = 1, sep_degree: int = 1,
                 order: Optional[List[str]] = None,
                 vpp_degree: int = 1, ep_degree: int = 1):
        if topology is not None:
            degrees = {n: topology.get_dim(n)
                       for n in topology.get_hybrid_group_names()}
            dp_degree = degrees.get("dp", 1)
            mp_degree = degrees.get("mp", 1)
            pp_degree = degrees.get("pp", 1)
            sharding_degree = degrees.get("sharding", 1)
            sep_degree = degrees.get("sep", 1)
            ep_degree = degrees.get("ep", 1)
        self._dp_degree = dp_degree
        self._mp_degree = mp_degree
        self._pp_degree = pp_degree
        self._sharding_degree = sharding_degree
        self._sep_degree = sep_degree
        self._ep_degree = ep_degree
        self._vpp_degree = int(vpp_degree or 1)
        self._order = list(order) if order else list(_DEFAULT_ORDER)
        if ep_degree > 1 and "ep" not in self._order:
            raise ValueError(
                f"ep_degree={ep_degree} needs an 'ep' axis in the hybrid "
                f"order, got {self._order}; add 'ep' (default order is "
                f"{_DEFAULT_ORDER}) or drop the custom order")
        self._topo = topology or CommunicateTopology(
            self._order, [self._degree_of(n) for n in self._order])
        total = (dp_degree * mp_degree * pp_degree * sharding_degree *
                 sep_degree * ep_degree)
        if total > 1 and not C.is_initialized():
            C.init_parallel_env()
        world = C.get_world_size()
        if total != world:
            raise ValueError(
                f"hybrid degrees product {total} != world size {world} "
                f"(one process a rank)")
        me = C.get_rank()
        self._coords = self._topo.get_coord(me)
        # every process makes every group, in one order (new_group's rule)
        self._groups: Dict[str, C.Group] = {}
        for name in self._order:
            self._groups[name] = self._make(name, [name])
        self._groups["dp_sharding"] = self._make("dp+sharding",
                                                 ["dp", "sharding"])
        self._groups["world"] = C.get_group(0)
        self._groups["pp_shared"] = self._make_pp_shared()
        self.mesh = HybridMesh(
            axis_names=tuple(self._order),
            shape={n: self._degree_of(n) for n in self._order},
            coords=dict(self._coords),
            groups=dict({n: self._groups[n] for n in self._order},
                        dp_sharding=self._groups["dp_sharding"],
                        pp_shared=self._groups["pp_shared"]), rank=me)

    def _make(self, name: str, axes: List[str]) -> C.Group:
        axes = [a for a in axes if a in self._order]
        mine = None
        for ranks in self._topo.get_comm_list(axes) if axes else []:
            if len(ranks) == 1:
                if C.get_rank() in ranks:
                    mine = C.Group(ranks, name=name,
                                   backend=C.get_backend())
                continue
            g = C.new_group(ranks, name=name)
            if C.get_rank() in ranks:
                mine = g
        return mine or C.Group([C.get_rank()], name=name,
                               backend=C.get_backend())

    def _make_pp_shared(self) -> C.Group:
        """{stage 0, stage S - 1} at every other coordinate (every
        process makes every one, in one order); one rank without pp."""
        me = C.get_rank()
        if self._pp_degree <= 1:
            return C.Group([me], name="pp_shared", backend=C.get_backend())
        mine = None
        for ranks in self._topo.get_comm_list(["pp"]):
            g = C.new_group([ranks[0], ranks[-1]], name="pp_shared")
            if me in g.ranks:
                mine = g
        return mine or C.Group([me], name="pp_shared",
                               backend=C.get_backend())

    def _degree_of(self, name: str) -> int:
        return {"dp": self._dp_degree, "mp": self._mp_degree,
                "pp": self._pp_degree, "sharding": self._sharding_degree,
                "sep": self._sep_degree, "ep": self._ep_degree}[name]

    # -- degrees ---------------------------------------------------------
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_virtual_pipeline_parallel_world_size(self):
        return self._vpp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_expert_parallel_world_size(self):
        return self._ep_degree

    # -- ranks (Python ints: one process a rank) -------------------------
    def get_global_rank(self):
        return C.get_rank()

    def get_data_parallel_rank(self):
        return self._coords["dp"]

    def get_model_parallel_rank(self):
        return self._coords["mp"]

    def get_stage_id(self):
        return self._coords["pp"]

    def get_sharding_parallel_rank(self):
        return self._coords["sharding"]

    def get_sep_parallel_rank(self):
        return self._coords["sep"]

    def get_expert_parallel_rank(self):
        return self._coords.get("ep", 0)

    # -- groups ----------------------------------------------------------
    def get_data_parallel_group(self):
        return self._groups["dp"]

    def get_model_parallel_group(self):
        return self._groups["mp"]

    def get_pipe_parallel_group(self):
        return self._groups["pp"]

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_sep_parallel_group(self):
        return self._groups["sep"]

    def get_expert_parallel_group(self):
        return self._groups.get("ep")

    def get_dp_sharding_parallel_group(self):
        return self._groups["dp_sharding"]

    def get_pipe_shared_group(self):
        """The first and the last pipeline stage at this rank's other
        coordinates (module docstring)."""
        return self._groups["pp_shared"]

    def get_check_parallel_group(self, *a):
        return self._groups["world"]

    def get_data_parallel_group_src_rank(self):
        return self._groups["dp"].ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self._groups["mp"].ranks[0]

    # -- pipeline helpers --------------------------------------------------
    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    @property
    def topology(self):
        return self._topo

    def get_p2p_next_rank(self):
        return self.get_rank_from_stage((self.get_stage_id() + 1)
                                        % self._pp_degree)

    def get_p2p_prev_rank(self):
        return self.get_rank_from_stage((self.get_stage_id() - 1)
                                        % self._pp_degree)

    def get_rank_from_stage(self, stage_id, **kwargs):
        c = dict(self._coords)
        c.update(kwargs)
        c["pp"] = int(stage_id)
        return self._topo.get_rank(**c)

    def __repr__(self):
        return (f"HCG(dp={self._dp_degree}, pp={self._pp_degree}, "
                f"sharding={self._sharding_degree}, sep={self._sep_degree}, "
                f"ep={self._ep_degree}, mp={self._mp_degree}, "
                f"order={self._order})")

"""Rank topology (port of ``paddle_tpu/distributed/fleet/topology.py``;
reference: fleet/base/topology.py — CommunicateTopology:65,
HybridCommunicateGroup:178, axis order at :290).

``CommunicateTopology`` lays global ranks out over the named axes;
``HybridCommunicateGroup`` answers model code's questions about this
rank's place and groups.  Its groups are the mesh's process groups
(``distributed.env.Mesh.group``, the ``DeviceMesh``'s own for one
axis), so a collective on them runs on the ranks of that axis.
"""

from __future__ import annotations

import numpy as np

from ..communication import Group
from ..env import AXIS_ORDER, get_mesh, get_rank


class CommunicateTopology:
    def __init__(self, hybrid_group_names=AXIS_ORDER, dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self._world = int(np.prod(self._dims))
        self._ranks = np.arange(self._world).reshape(self._dims)
        self._coords = {int(r): tuple(int(i) for i in np.unravel_index(
            r, self._dims)) for r in range(self._world)}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        return int(self._ranks[tuple(kwargs[n]
                                     for n in self._parallel_names)])

    def get_coord(self, rank):
        return self._coords[rank]

    def get_axis_list(self, axis_name, index):
        ax = self._parallel_names.index(axis_name)
        sl = [slice(None)] * len(self._dims)
        sl[ax] = index
        return [int(r) for r in self._ranks[tuple(sl)].reshape(-1)]

    def get_comm_list(self, axis_name):
        """Every group along ``axis_name``: a list of rank lists."""
        ax = self._parallel_names.index(axis_name)
        moved = np.moveaxis(self._ranks, ax, -1)
        return [list(map(int, row))
                for row in moved.reshape(-1, self._dims[ax])]


class HybridCommunicateGroup:
    """This rank's degrees, ranks and groups over the hybrid axes
    (reference: topology.py:178).  The groups need the global mesh
    (``fleet.init`` builds it)."""

    def __init__(self, topology=None):
        mesh = get_mesh()
        if topology is None:
            dims = [mesh.shape[a] if mesh is not None else 1
                    for a in AXIS_ORDER]
            topology = CommunicateTopology(AXIS_ORDER, dims)
        self._topo = topology
        self.global_rank = get_rank() % max(topology.world_size(), 1)
        self._coord = topology.get_coord(self.global_rank)

    # -- degrees -----------------------------------------------------------
    def get_data_parallel_world_size(self):
        return self._topo.get_dim("dp")

    def get_model_parallel_world_size(self):
        return self._topo.get_dim("mp")

    def get_pipe_parallel_world_size(self):
        return self._topo.get_dim("pp")

    def get_sharding_parallel_world_size(self):
        return self._topo.get_dim("sharding")

    def get_sep_parallel_world_size(self):
        return self._topo.get_dim("sep")

    # -- this rank ---------------------------------------------------------
    def _axis_rank(self, name):
        return self._coord[self._topo.get_hybrid_group_names().index(name)]

    def get_data_parallel_rank(self):
        return self._axis_rank("dp")

    def get_model_parallel_rank(self):
        return self._axis_rank("mp")

    def get_stage_id(self):
        return self._axis_rank("pp")

    def get_sharding_parallel_rank(self):
        return self._axis_rank("sharding")

    def get_sep_parallel_rank(self):
        return self._axis_rank("sep")

    # -- groups ------------------------------------------------------------
    def _axis_group(self, name):
        names = self._topo.get_hybrid_group_names()
        sl = list(self._coord)
        sl[names.index(name)] = slice(None)
        ranks = [int(r) for r in self._topo._ranks[tuple(sl)].reshape(-1)]
        mesh = get_mesh()
        return Group(rank=self._axis_rank(name), ranks=ranks,
                     axis_names=(name,),
                     pg=None if mesh is None else mesh.group(name))

    def get_data_parallel_group(self):
        return self._axis_group("dp")

    def get_model_parallel_group(self):
        return self._axis_group("mp")

    def get_pipe_parallel_group(self):
        return self._axis_group("pp")

    def get_sharding_parallel_group(self):
        return self._axis_group("sharding")

    def get_sep_parallel_group(self):
        return self._axis_group("sep")

    def get_data_parallel_group_src_rank(self):
        return self.get_data_parallel_group().ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self.get_model_parallel_group().ranks[0]

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self.get_pipe_parallel_world_size() - 1

    def topology(self):
        return self._topo


__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]

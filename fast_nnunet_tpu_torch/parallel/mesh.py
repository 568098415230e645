"""The (data, space) layout of fast_nnunet_tpu/parallel/mesh.py as rank
lists and process groups.

JAX reshapes its device list into a (data, space) mesh: batches shard
along ``data``, the sliding-window volume slabs along ``space``. Here the
same reshape of the world's ranks, rank ``d * n_space + s`` at (d, s); the
groups along an axis are what the trainer (``data``) and the slab-parallel
sweep (``space``, inference/sharded.py) reduce over.
"""
from typing import Dict, List, Optional

import numpy as np
import torch.distributed as dist

from .distributed import rank, world_size


class Mesh:
    """``shape`` {"data": n_data, "space": n_space}; ``ranks`` the
    (n_data, n_space) array of ranks."""

    def __init__(self, n_data: Optional[int] = None, n_space: int = 1):
        world = world_size()
        if n_data is None:
            n_data = world // n_space
        if n_data * n_space > world:
            raise ValueError(f"mesh {n_data}x{n_space} needs "
                             f"{n_data * n_space} ranks, have {world}")
        self.shape = {"data": int(n_data), "space": int(n_space)}
        self.ranks = np.arange(n_data * n_space).reshape(n_data, n_space)
        self._groups: Dict[str, object] = {}

    def axis_ranks(self, axis: str) -> List[List[int]]:
        """The rank lists along ``axis``: one group per index of the other
        axis."""
        a = self.ranks if axis == "space" else self.ranks.T
        return [[int(r) for r in row] for row in a]

    def group(self, axis: str):
        """This rank's process group along ``axis`` (None for a rank
        outside the mesh, or without a process group). The first call
        creates every group of the axis and must be made on every rank
        of the world (``new_group`` is collective)."""
        if axis not in self._groups:
            mine = None
            for ranks in self.axis_ranks(axis):
                if not dist.is_initialized():
                    break
                g = dist.new_group(ranks)
                if rank() in ranks:
                    mine = g
            self._groups[axis] = mine
        return self._groups[axis]


def make_mesh(n_data: Optional[int] = None, n_space: int = 1) -> Mesh:
    """(data, space) mesh. Default: all ranks on the data axis."""
    return Mesh(n_data, n_space)

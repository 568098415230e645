"""Multi-GPU support of the port: ranks and the launcher
(``distributed``), the (data, space) layout (``mesh``) and the explicit
collectives (``collectives``)."""
from .distributed import (barrier, initialize_distributed, is_main_process,
                          local_batch_and_oversample, rank, spawn,
                          world_size)
from .mesh import Mesh, make_mesh

__all__ = ["barrier", "initialize_distributed", "is_main_process",
           "local_batch_and_oversample", "rank", "spawn", "world_size",
           "Mesh", "make_mesh"]

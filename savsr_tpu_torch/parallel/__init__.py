from .mesh import (Mesh, all_reduce_sum, get_mesh_from_opt, mesh_axes, rank_rows,
                   reduce_gradients, replicate, shard_or_replicate_batch)
from .spatial import BandGroup

__all__ = ["BandGroup", "Mesh", "all_reduce_sum", "get_mesh_from_opt", "mesh_axes",
           "rank_rows",
           "reduce_gradients", "replicate", "shard_or_replicate_batch"]

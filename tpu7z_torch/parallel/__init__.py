"""Blocks sharded over the ranks of a `torch.distributed` process group,
the port's counterpart of tpu7z.parallel (a jax Mesh there):

  mesh.py         process groups; None is this process alone
  sharded.py      each rank encodes its span of blocks, ordered
                  all-gathers, one frame assembled in order on every rank
  progress.py     sizes and errors reduced across the ranks
  distributed.py  joining a process group; ranks spawned on one host
"""

from .mesh import data_axis, make_mesh
from .sharded import (shard_compress_lz4, shard_compress_lz4_device,
                      sharded_find_matches)

__all__ = ["make_mesh", "data_axis", "shard_compress_lz4",
           "shard_compress_lz4_device", "sharded_find_matches"]

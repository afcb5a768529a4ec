"""Process groups: the port's counterpart of tpu7z/parallel/mesh.py.

Where tpu7z lays its devices out on a jax Mesh whose "data" axis shards
independent blocks, the port runs one process per device (one rank a
card with NCCL; ranks on the CPU with gloo) and shards the blocks over
the ranks of a `torch.distributed` process group. `None` stands for the
calling process alone: no collective runs.
"""

from __future__ import annotations

import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"

# the backend each device's tensors go through; no other pairing runs
BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def data_axis() -> str:
    return DATA_AXIS


def make_mesh(n: int | None = None):
    """The process group of the first `n` ranks (default: every rank).
    Every rank must call it, as `dist.new_group` requires; a rank outside
    the first `n` gets a group it is not a member of. Without an
    initialised process group it gives `None` (this process alone) for
    `n` of None or 1."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    if n is None:
        n = size
    if n < 1 or n > size:
        raise ValueError(f"requested {n} ranks, have {size}")
    if size % n:
        raise ValueError(f"{n} ranks do not divide the world of {size}")
    if not dist.is_initialized():
        return None
    if n == size:
        return dist.group.WORLD
    return dist.new_group(ranks=list(range(n)))


def world(group, device=None) -> tuple[int, int]:
    """(size, rank) of this process in `group`, (1, 0) for None. Raises
    where `group` is no process group (before it looks at the device), this
    process is not a member of it, or its backend does not carry tensors on
    `device` (the card unless named)."""
    if group is None:
        return 1, 0
    if group is dist.GroupMember.NON_GROUP_MEMBER:
        raise ValueError("this process is not a member of the group")
    if not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"group: expected a torch.distributed ProcessGroup "
                        f"or None, got {type(group).__name__}")
    rank = dist.get_rank(group)
    dev = resolve_device(device)
    backend = dist.get_backend(group)
    if BACKEND.get(dev.type) != backend:
        raise ValueError(f"a {backend} process group does not carry tensors "
                         f"on {dev}")
    return dist.get_world_size(group), rank

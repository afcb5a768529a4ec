"""Adapter: the LZ4 device block encoder, as `a -tlz4 -mdev` and the
library's group API call it: `shard_compress_lz4_device(data, group,
W=...)`. The group is None on one chip, the program's `global_mesh()` on
several; every rank returns the whole frame."""

from __future__ import annotations


class Entry:
    def __init__(self, config: dict, device: str, group):
        from tpu7z_torch.parallel import sharded

        self._compress = sharded.shard_compress_lz4_device
        self.params = dict(config["params"])
        self.group = group
        self.device = device

    def __call__(self, data, **overrides) -> bytes:
        return self._compress(data, self.group, **{**self.params, **overrides},
                              device=self.device)

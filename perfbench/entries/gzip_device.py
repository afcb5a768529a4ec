"""Adapter: the port's gzip writer, as `a -tgzip` calls it:
`gzip_compress(data, level=..., device=...)`, its parse, histograms and
packing on the card."""

from __future__ import annotations


class Entry:
    def __init__(self, config: dict, device: str, group):
        from tpu7z_torch.models.deflate import codec

        self._compress = codec.gzip_compress
        self.params = dict(config["params"])
        self.device = device

    def __call__(self, data, **overrides) -> bytes:
        return self._compress(data, **{**self.params, **overrides}, device=self.device)

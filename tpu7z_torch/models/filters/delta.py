"""Delta filter (byte-distance differencing), a port of
tpu7z/models/filters/delta.py.

Behavioral reference: C/Delta.c (Delta_Encode/Delta_Decode, distance
1..256). Encode is one subtraction of the input shifted by the distance;
decode's prefix dependency is a cumulative sum down each residue class
mod the distance. Both are tensor code on the device the caller names
(the CUDA card unless `device` names the CPU).
"""

from __future__ import annotations

import torch

from .bcj import _on_device


def _check(dist: int):
    if not 1 <= dist <= 256:
        raise ValueError("delta distance must be 1..256")


def delta_encode(data: bytes, dist: int = 1, *, device=None) -> bytes:
    _check(dist)
    s = _on_device(data, device)
    out = s.clone()
    out[dist:] = s[dist:] - s[:-dist]
    return out.cpu().numpy().tobytes()


def delta_decode(data: bytes, dist: int = 1, *, device=None) -> bytes:
    _check(dist)
    s = _on_device(data, device)
    n = s.numel()
    padded = torch.cat([s, s.new_zeros((-n) % dist)]).view(-1, dist)
    # cumulative sum down each residue class, mod 256
    dec = (torch.cumsum(padded.to(torch.int64), dim=0) & 0xFF).to(torch.uint8)
    return dec.reshape(-1)[:n].cpu().numpy().tobytes()

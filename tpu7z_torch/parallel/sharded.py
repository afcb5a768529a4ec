"""Device-tier LZ4 frame compression on one device.

The counterpart of tpu7z/parallel/sharded.py `shard_compress_lz4_device`
at one device: the input is cut into 64 KiB blocks, every block is encoded
by the device block encoder, and one standard .lz4 frame is assembled on
the device from the encoded blocks in order. The bytes equal the JAX
package's at any mesh size.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.lz4.frame import HEADER
from ..ops import lz4_cuda
from ..ops import lz4_plane as P


def split_blocks(data: bytes, device):
    """(blocks (B, BLOCK) uint8 zero padded, ns (B,) int32) on `device`;
    empty input still gives one block, of length 0."""
    N = P.BLOCK
    nb = max(1, -(-len(data) // N))
    buf = np.zeros(nb * N, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    ns = np.clip(len(data) - np.arange(nb, dtype=np.int64) * N, 0, N)
    return (torch.from_numpy(buf).view(nb, N).to(device),
            torch.from_numpy(ns.astype(np.int32)).to(device))


def assemble(out, used, blocks, ns):
    """The .lz4 frame (uint8, on the device) of the encoded blocks: the
    header, then per non-empty block its size word and either its LZ4
    bytes or, where those are not shorter, its raw bytes (bit 31 of the
    size word set), then a zero EndMark."""
    dev = out.device
    B = out.shape[0]
    n = ns.to(torch.int64)
    u = used.to(torch.int64)
    store = u >= n
    sizes = torch.where(store, n, u)
    szword = torch.where(store, 1 << 31, 0) | sizes
    seg = torch.where(n > 0, sizes + 4, 0)
    offs = len(HEADER) + torch.cumsum(seg, 0) - seg
    total = len(HEADER) + int(seg.sum())
    j = torch.arange(len(HEADER), total, dtype=torch.int64, device=dev)
    # which block each byte falls in, and where in that block's segment
    b = (torch.searchsorted(offs, j, right=True) - 1).clamp(0, B - 1)
    rel = j - offs[b]
    size_byte = (szword[b] >> (8 * rel.clamp(0, 3))) & 0xFF
    src = (rel - 4).clamp(min=0)
    comp = out.view(-1)[b * out.shape[1] + src.clamp(max=out.shape[1] - 1)]
    raw = blocks.view(-1)[b * blocks.shape[1] + src.clamp(max=blocks.shape[1] - 1)]
    body = torch.where(rel < 4, size_byte,
                       torch.where(store[b], raw, comp).to(torch.int64))
    head = torch.tensor(list(HEADER), dtype=torch.uint8, device=dev)
    end = torch.zeros(4, dtype=torch.uint8, device=dev)
    return torch.cat([head, body.to(torch.uint8), end])


def shard_compress_lz4_device(data: bytes, W: int = P.W_DEFAULT,
                              device=None) -> bytes:
    """Compress `data` into one .lz4 frame with the device block encoder.
    Runs on the CUDA card unless `device` names another."""
    dev = resolve_device(device)
    blocks, ns = split_blocks(data, dev)
    out, used = lz4_cuda.encode_blocks(blocks, ns, W)
    frame = assemble(out, used, blocks, ns)
    return frame.cpu().numpy().tobytes()

"""LZ4 frame compression on one device.

The counterpart of tpu7z/parallel/sharded.py at one device:
  - `shard_compress_lz4_device`: the input is cut into 64 KiB blocks,
    every block is encoded by the device block encoder, and one standard
    .lz4 frame is assembled on the device from the encoded blocks in
    order;
  - `sharded_find_matches` and `shard_compress_lz4`: the device match
    finder over a batch of blocks (any block size, `hashlog` 0-31), each
    block emitted on the host as a frame of its own, the frames in the
    skippable-frame container. Every parameter after the data is
    keyword-only: `tpu7z` takes a mesh in the place of `hashlog` and of
    `block_size`, so a positional call could never bind alike in both.
The bytes equal the JAX package's at any mesh size.
"""

from __future__ import annotations

import numpy as np
import torch

from ..containers import skippable
from ..device import resolve_device
from ..models.lz4 import torch_backend
from ..models.lz4.frame import HEADER, block_record, frame_header
from ..ops import lz4_cuda
from ..ops import lz4_plane as P
from ..ops.hashing import xxh32


def split_blocks(data: bytes, device):
    """(blocks (B, BLOCK) uint8 zero padded, ns (B,) int32) on `device`;
    empty input still gives one block, of length 0."""
    blocks, ns = torch_backend.pad_blocks(data, P.BLOCK)
    return torch.from_numpy(blocks).to(device), torch.from_numpy(ns).to(device)


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
                              tier_b: bool = True, device=None) -> bytes:
    """Compress `data` into one .lz4 frame with the device block encoder.
    tier_b=False drops the sorted-neighbour candidate tiers. Runs on the
    CUDA card unless `device` names another."""
    dev = resolve_device(device)
    blocks, ns = split_blocks(data, dev)
    out, used = lz4_cuda.encode_blocks(blocks, ns, W, tier_b)
    frame = assemble(out, used, blocks, ns)
    return frame.cpu().numpy().tobytes()


def sharded_find_matches(blocks, lengths, *, hashlog: int = 16, device=None):
    """The device match finder over a batch of blocks (B, N) uint8 with
    lengths (B,). Returns numpy (selected, mlen, moff) and the count of
    bytes the selected matches cover."""
    sel, mlen, moff = torch_backend.find_matches_host(blocks, lengths, hashlog,
                                                      device)
    return sel, mlen, moff, int(np.where(sel, mlen, 0).sum())


def shard_compress_lz4(data: bytes, *, block_size: int = 1 << 16,
                       device=None) -> bytes:
    """Every block of `block_size` bytes as an independent .lz4 frame of
    its own, the frames in the skippable-frame container, so a decoder can
    split the work without parsing. Runs on the CUDA card unless `device`
    names another."""
    dev = resolve_device(device)
    blocks, lengths = torch_backend.pad_blocks(data, block_size)
    sel, mlen, moff, _ = sharded_find_matches(blocks, lengths, device=dev)
    frames = []
    for b in range(blocks.shape[0]):
        s = blocks[b, :int(lengths[b])]
        body = torch_backend.emit_block(s, sel[b], mlen[b], moff[b])
        frames.append(_wrap_single_block_frame(s, body, block_size))
    return skippable.write_container(frames)


def _wrap_single_block_frame(chunk: np.ndarray, comp: bytes,
                             block_size: int) -> bytes:
    """One independent .lz4 frame holding one block: stored raw where the
    LZ4 bytes are not shorter."""
    raw = chunk.tobytes()
    return (frame_header(len(raw), block_size) + block_record(raw, comp)
            + (0).to_bytes(4, "little") + xxh32(raw).to_bytes(4, "little"))

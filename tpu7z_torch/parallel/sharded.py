"""LZ4 frame compression over the ranks of a process group.

The counterpart of tpu7z/parallel/sharded.py, with a `torch.distributed`
process group (parallel/mesh.py) where tpu7z has a mesh; `None` is the
calling process alone, and no collective runs:
  - `shard_compress_lz4_device`: the input is cut into 64 KiB blocks, the
    block count padded to a multiple of the world size, and each rank
    encodes its contiguous span of blocks with the device block encoder;
    ordered all-gathers of the encoded blocks, their sizes, the raw
    blocks and their lengths then let every rank assemble the same
    standard .lz4 frame on its device;
  - `sharded_find_matches` and `shard_compress_lz4`: the device match
    finder over a batch of blocks (any block size, `hashlog` 0-31), each
    rank over its rows, the rows gathered in order; each block is emitted
    on the host as a frame of its own, the frames in the skippable-frame
    container.
The group is the second positional parameter of `shard_compress_lz4` and
`shard_compress_lz4_device` and the third of `sharded_find_matches`, as
the mesh is in tpu7z; every parameter after it is keyword-only, so a
positional call binds alike in both packages or raises. The bytes equal
the JAX package's at any world and mesh size.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..containers import skippable
from ..device import resolve_device
from ..models.lz4 import torch_backend
from ..models.lz4.frame import HEADER, block_record, frame_header
from ..ops import lz4_cuda
from ..ops import lz4_plane as P
from ..ops import match
from ..ops.hashing import xxh32_native
from ..utils import trace
from . import mesh


def split_blocks(data: bytes, device, first: int = 0, count: int | None = None):
    """(blocks (count, BLOCK) uint8 zero padded, ns (count,) int32) on
    `device`: blocks `first` .. `first + count - 1` of `data`, those past
    its end of length 0. By default every block of `data`; empty input
    still gives one block, of length 0."""
    N = P.BLOCK
    if count is None:
        count = max(1, -(-len(data) // N))
    with trace.span("entry.split"):
        src = np.frombuffer(data, dtype=np.uint8)[first * N:(first + count) * N]
        blocks = np.zeros(count * N, dtype=np.uint8)
        blocks[:src.size] = src
        ns = np.clip(len(data) - (first + np.arange(count)) * N, 0, N).astype(np.int32)
    with trace.span("entry.h2d"):
        return (torch.from_numpy(blocks.reshape(count, N)).to(device),
                torch.from_numpy(ns).to(device))


def _all_gather(t, group):
    """`t` of every rank of `group`, in rank order, joined along dim 0 (bool
    travels as uint8)."""
    carrier = t.contiguous().view(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(carrier) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, carrier, group=group)
    out = torch.cat(parts)
    return out.view(torch.bool) if t.dtype == torch.bool else out


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
    with trace.span("read.lz4_assemble_total"):
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


def shard_compress_lz4_device(data: bytes, group=None, *, W: int = P.W_DEFAULT,
                              tier_b: bool = True, device=None) -> bytes:
    """Compress `data` into one .lz4 frame with the device block encoder,
    each rank of `group` encoding an equal contiguous span of blocks; every
    rank returns the same bytes. tier_b=False drops the sorted-neighbour
    candidate tiers. Runs on the CUDA card unless `device` names another.
    The call is a root span, `entry.lz4_device`, over the spans of its
    parts: `entry.split`, `entry.h2d`, the encoder's, `collective.all_gather`
    (a group only), `entry.assemble`, `entry.d2h` and `entry.tobytes`."""
    with trace.span("entry.lz4_device", size=len(data)):
        size, rank = mesh.world(group, device)
        dev = resolve_device(device)
        nb = max(1, -(-len(data) // P.BLOCK))
        k = -(-nb // size)
        blocks, ns = split_blocks(data, dev, rank * k, k)
        out, used = lz4_cuda.encode_blocks(blocks, ns, W, tier_b)
        if group is not None:
            with trace.span("collective.all_gather"):
                out, used, blocks, ns = (_all_gather(t, group) for t in (out, used, blocks, ns))
        with trace.span("entry.assemble"):
            frame = assemble(out, used, blocks, ns)
        with trace.span("entry.d2h"):
            frame = frame.cpu()
        with trace.span("entry.tobytes"):
            return frame.numpy().tobytes()


def sharded_find_matches(blocks, lengths, group=None, *, hashlog: int = 16,
                         device=None):
    """The device match finder over a batch of blocks (B, N) uint8 with
    lengths (B,), B divisible by the world size of `group`: each rank
    finds the matches of its B / size rows, and the rows are gathered in
    order. Returns numpy (selected, mlen, moff) and the count of bytes the
    selected matches cover."""
    size, rank = mesh.world(group, device)
    dev = resolve_device(device)
    B = blocks.shape[0]
    if B % size:
        raise ValueError(f"{B} blocks do not divide over {size} ranks")
    rows = slice(rank * (B // size), (rank + 1) * (B // size))
    sel, mlen, moff = match.find_matches(
        torch.from_numpy(np.ascontiguousarray(blocks[rows])).to(dev),
        torch.from_numpy(np.asarray(lengths, np.int32)[rows].copy()).to(dev),
        hashlog=hashlog)
    covered = torch.where(sel, mlen, 0).sum()
    if group is not None:
        sel, mlen, moff = (_all_gather(t, group) for t in (sel, mlen, moff))
        dist.all_reduce(covered, group=group)
    return (sel.cpu().numpy(), mlen.cpu().numpy(), moff.cpu().numpy(),
            int(covered))


def shard_compress_lz4(data: bytes, group=None, *, block_size: int = 1 << 16,
                       device=None) -> bytes:
    """Every block of `block_size` bytes as an independent .lz4 frame of
    its own, the frames in the skippable-frame container, so a decoder can
    split the work without parsing. The blocks' matches are found over the
    ranks of `group`, the block count padded to a multiple of its size;
    every rank returns the same bytes. Runs on the CUDA card unless
    `device` names another."""
    size, _ = mesh.world(group, device)
    blocks, lengths = torch_backend.pad_blocks(data, block_size)
    nb = blocks.shape[0]
    pad = -nb % size
    if pad:
        blocks = np.concatenate([blocks, np.zeros((pad, block_size), np.uint8)])
        lengths = np.concatenate([lengths, np.zeros(pad, np.int32)])
    sel, mlen, moff, _ = sharded_find_matches(blocks, lengths, group,
                                              device=device)
    frames = []
    for b in range(nb):
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
            + (0).to_bytes(4, "little") + xxh32_native(raw).to_bytes(4, "little"))

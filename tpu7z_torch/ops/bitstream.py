"""Bitstream primitives.

Zstd (RFC 8878) and LZMA use two very different bit conventions:

- zstd/FSE/Huffman: bits are written LSB-first into a little-endian stream
  and *read backwards* from the end (reference: C/zstd/bitstream.h).
- LZMA: a binary range coder, byte-oriented (handled in models/lzma).

This module provides:
- scalar forward/backward readers (host, bit-exact, used by decoders)
- `pack_bits_lsb`: fully vectorized numpy packer used by the FSE/Huffman
  encoders (host code, as tpu7z/ops/bitstream.py) — per-symbol (value, nbits) arrays are laid out via prefix sum
  and scatter-OR, replacing the reference's sequential BIT_addBits/
  BIT_flushBits loop (C/zstd/bitstream.h) with a data-parallel kernel;
- `pack_bits_lsb_tensor`: the same packing as tensor code on the device
  of its inputs (deflate's stream, on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace
from ..utils.errors import CorruptError


class ForwardBitReader:
    """LSB-first forward bit reader (FSE table descriptions, Huffman weights
    headers read this way; reference: C/zstd/fse_decompress.c FSE_readNCount).
    """

    __slots__ = ("data", "bitpos")

    def __init__(self, data: bytes):
        self.data = data
        self.bitpos = 0

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        byte0 = self.bitpos >> 3
        shift = self.bitpos & 7
        # gather up to 4 bytes (nbits <= 16 in practice, + 7 shift)
        acc = 0
        for i in range((shift + nbits + 7) // 8):
            if byte0 + i < len(self.data):
                acc |= self.data[byte0 + i] << (8 * i)
        self.bitpos += nbits
        return (acc >> shift) & ((1 << nbits) - 1)

    def bytes_consumed(self) -> int:
        return (self.bitpos + 7) >> 3


class BackwardBitReader:
    """Backward bit reader for zstd entropy streams.

    The stream is written LSB-first; the final byte contains a 1-bit
    end marker above the last data bit. Reading proceeds from the most
    significant data bit downwards (reference: C/zstd/bitstream.h
    BIT_initDStream / BIT_readBits).
    """

    __slots__ = ("data", "bitpos")

    def __init__(self, data: bytes):
        if len(data) == 0:
            raise CorruptError("empty bitstream")
        last = data[-1]
        if last == 0:
            raise CorruptError("bitstream end marker missing")
        # position just below the end marker bit
        self.data = data
        self.bitpos = 8 * len(data) - (8 - (last.bit_length() - 1))
        # bitpos = total bits available (below the marker)

    def read(self, nbits: int) -> int:
        """Read nbits from the top of the remaining stream.

        Reading may go below zero conceptually (zstd allows overread of
        up to the init padding during the final states); out-of-range
        bits read as 0.
        """
        if nbits == 0:
            return 0
        self.bitpos -= nbits
        pos = self.bitpos
        if pos >= 0:
            byte0 = pos >> 3
            shift = pos & 7
            acc = 0
            nbytes = (shift + nbits + 7) >> 3
            for i in range(nbytes):
                b = byte0 + i
                if b < len(self.data):
                    acc |= self.data[b] << (8 * i)
            return (acc >> shift) & ((1 << nbits) - 1)
        # partial underflow: upper bits valid, lower bits zero-filled
        valid = nbits + pos  # number of valid top bits
        if valid <= 0:
            return 0
        acc = 0
        nbytes = (valid + 7) >> 3
        for i in range(nbytes):
            if i < len(self.data):
                acc |= self.data[i] << (8 * i)
        return (acc & ((1 << valid) - 1)) << (-pos)

    @property
    def exhausted(self) -> bool:
        return self.bitpos == 0

    @property
    def overread(self) -> bool:
        return self.bitpos < 0


class BitWriterLSB:
    """Scalar LSB-first bit writer (host serialization of table headers)."""

    __slots__ = ("acc", "nbits", "out")

    def __init__(self):
        self.acc = 0
        self.nbits = 0
        self.out = bytearray()

    def write(self, value: int, nbits: int) -> None:
        self.acc |= (value & ((1 << nbits) - 1)) << self.nbits
        self.nbits += nbits
        while self.nbits >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.nbits -= 8

    def close(self) -> bytes:
        """Flush, padding the final partial byte with zeros."""
        if self.nbits > 0:
            self.out.append(self.acc & 0xFF)
            self.acc = 0
            self.nbits = 0
        return bytes(self.out)

    def close_with_end_marker(self) -> bytes:
        """Append the 1-bit end marker then flush (zstd entropy streams)."""
        self.write(1, 1)
        return self.close()


def pack_bits_lsb(values: np.ndarray, nbits: np.ndarray,
                  end_marker: bool = True) -> bytes:
    """Vectorized LSB-first bit packing.

    values[i] (uint32/uint64) is appended using nbits[i] bits, LSB-first,
    matching what a sequential BitWriterLSB would produce. With
    `end_marker`, a final 1 bit is appended (zstd entropy stream framing).

    Data-parallel construction: bit offsets via cumsum, each value is
    shifted into a 64-bit window covering its byte span and scattered with
    bitwise-OR. Values are at most 56 bits wide + 7 bit shift = 63 bits,
    so one uint64 window per symbol suffices for nbits <= 56.

    `pack_bits_lsb_tensor` is the same algorithm as tensor code, for a
    stream made on the card. This numpy form stays for the host entropy
    coders (zstd's FSE and Huffman streams): on CPU tensors index_add_
    spreads its scatter over torch's intra-op threads, which at those
    streams' sizes (10**4-10**5 fields) can make it slower than numpy's
    `bitwise_or.at`.
    """
    values = np.asarray(values, dtype=np.uint64)
    nbits = np.asarray(nbits, dtype=np.int64)
    if np.any(nbits > 56):
        raise ValueError("pack_bits_lsb supports at most 56 bits per item")
    if end_marker:
        values = np.concatenate([values, np.asarray([1], dtype=np.uint64)])
        nbits = np.concatenate([nbits, np.asarray([1], dtype=np.int64)])
    if values.size == 0:
        return b""
    # mask values to their width
    mask = (np.uint64(1) << nbits.astype(np.uint64)) - np.uint64(1)
    values = values & mask
    starts = np.concatenate([[0], np.cumsum(nbits)[:-1]])
    total_bits = int(starts[-1] + nbits[-1])
    total_bytes = (total_bits + 7) >> 3

    byte_idx = (starts >> 3).astype(np.int64)
    shift = (starts & 7).astype(np.uint64)
    window = values << shift  # <= 63 bits used

    # scatter-OR each 8-byte window into the output
    out = np.zeros(total_bytes + 8, dtype=np.uint8)
    for b in range(8):
        byte_vals = ((window >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint8)
        np.bitwise_or.at(out, byte_idx + b, byte_vals)
    return out[:total_bytes].tobytes()


def pack_bits_lsb_tensor(values, nbits):
    """uint8 tensor on the device of `values`: the fields values[i], each
    nbits[i] <= 56 bits wide (int64 tensors), written LSB-first one after
    another with the last byte padded with zeros, as a BitWriterLSB gives
    them for the same writes and `close()`. Bit offsets are an exclusive
    cumsum; a field shifted by its offset's low 3 bits fits a window below
    2**63; fields share no bit, so a scatter-add of the windows' bytes
    equals their OR. One host read: the total length and the widest
    field (a span `read.bitstream_total`)."""
    nbits = nbits.to(torch.int64)
    if nbits.numel() == 0:
        return torch.zeros(0, dtype=torch.uint8, device=values.device)
    ends = torch.cumsum(nbits, 0)
    starts = ends - nbits
    with trace.span("read.bitstream_total"):
        total, widest = torch.stack([ends[-1], nbits.max()]).tolist()
    if widest > 56:
        raise ValueError("pack_bits_lsb_tensor supports at most 56 bits per field")
    window = (values & ((1 << nbits) - 1)) << (starts & 7)
    byte = starts >> 3
    size = (total + 7) >> 3
    out = torch.zeros(size + 8, dtype=torch.int32, device=values.device)
    for k in range(8):
        out.index_add_(0, byte + k, ((window >> (8 * k)) & 0xFF).to(torch.int32))
    return out[:size].to(torch.uint8)


def reverse_pack_bits_lsb(values: np.ndarray, nbits: np.ndarray) -> bytes:
    """Pack symbols so that a BackwardBitReader yields them in the original
    order: equivalent to writing values in reverse order with an end marker.
    """
    return pack_bits_lsb(values[::-1], nbits[::-1], end_marker=True)

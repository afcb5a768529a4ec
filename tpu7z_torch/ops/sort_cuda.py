"""Row sort of unique uint32 keys with 32-bit payloads, on Hopper.

The counterpart of tpu7z/ops/sort_pallas.py `bitonic_sort`, with the same
contract: `sort_rows(key, *payloads)` sorts each row of a (B, N) key
tensor ascending and returns `(key_sorted, *payloads_sorted)`, every dtype
kept. The kernel is a stable LSD radix sort in csrc/sort.cu; its plain
version is `sort_rows_ref` (`torch.sort(stable=True)` and `gather`).

Keys are uint32 values, carried in any of three dtypes:
  - torch.uint32, the values themselves;
  - torch.int32, their raw bits (a key >= 2**31 reads as negative);
  - torch.int64 holding values in [0, 2**32), as lz4_plane's masked
    unsigned arithmetic does.
Payloads are 32-bit tensors of any dtype (int32, uint32, float32), moved
as raw bits.

On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernel, adds one to LAUNCHES["sort_rows"], or raises. There
is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_N = 65536
MAX_PAYLOADS = 3
KEY_DTYPES = (torch.int32, torch.uint32, torch.int64)
BEGIN_BITS = (0, 8, 16, 24)

# kernel launches made by the wrapper in this process
LAUNCHES = {"sort_rows": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def reset_launches():
    LAUNCHES["sort_rows"] = 0


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("sort")
        lib.sort_rows_launch.argtypes = [_P] * 12 + [_I] * 4 + [_P]
        lib.sort_rows_launch.restype = ctypes.c_int
        lib.sort_error_string.argtypes = [ctypes.c_int]
        lib.sort_error_string.restype = ctypes.c_char_p
        lib.sort_max_n.argtypes = []
        lib.sort_max_n.restype = ctypes.c_int
        if lib.sort_max_n() != MAX_N:
            raise RuntimeError("csrc/sort.cu and MAX_N disagree")
        _lib = lib
    return _lib


def raw_bits(t):
    """The tensor as 32-bit raw bits (int32 view); int64 keys are cut to
    their low 32 bits."""
    if t.dtype == torch.int64:
        return ((t ^ 0x80000000) - 0x80000000).to(torch.int32)
    return t.view(torch.int32)


def _from_bits(bits, dtype):
    if dtype == torch.int64:
        return bits.to(torch.int64) & 0xFFFFFFFF
    return bits.view(dtype)


def _check(key, payloads, begin_bit):
    if not isinstance(key, torch.Tensor) or key.dim() != 2:
        raise ValueError("key: expected a (B, N) tensor")
    if key.dtype not in KEY_DTYPES:
        raise TypeError(f"key: dtype {key.dtype}, expected one of {KEY_DTYPES}")
    if key.shape[1] > MAX_N:
        raise ValueError(f"key: rows of {key.shape[1]} keys, at most {MAX_N}")
    if not key.is_contiguous():
        raise ValueError("key: must be contiguous")
    if len(payloads) > MAX_PAYLOADS:
        raise ValueError(f"at most {MAX_PAYLOADS} payloads, got {len(payloads)}")
    for i, p in enumerate(payloads):
        if not isinstance(p, torch.Tensor) or p.element_size() != 4:
            raise TypeError(f"payload {i}: expected a tensor of a 32-bit dtype")
        if p.shape != key.shape:
            raise ValueError(f"payload {i}: shape {tuple(p.shape)}, expected {tuple(key.shape)}")
        if p.device != key.device:
            raise ValueError(f"payload {i}: on {p.device}, key on {key.device}")
        if not p.is_contiguous():
            raise ValueError(f"payload {i}: must be contiguous")
    if begin_bit not in BEGIN_BITS:
        raise ValueError(f"begin_bit={begin_bit}, expected one of {BEGIN_BITS}")


def sort_rows_ref(key, *payloads, begin_bit: int = 0):
    """Plain version: a stable sort of each row by the key's bits
    [begin_bit, 32), on any device."""
    k = raw_bits(key).to(torch.int64) & 0xFFFFFFFF
    _, order = torch.sort(k >> begin_bit, dim=1, stable=True)
    return tuple(_from_bits(raw_bits(t).gather(1, order), t.dtype)
                 for t in (key,) + payloads)


def sort_rows(key, *payloads, begin_bit: int = 0):
    """Sort each row of `key` (B, N), N <= 65536, ascending; keys must be
    unique within a row. Returns (key_sorted, *payloads_sorted).

    begin_bit (0, 8, 16 or 24) orders by the key's bits [begin_bit, 32)
    only, keeping the input order among keys equal there. That is the
    full order when each row arrives sorted by its low begin_bit bits:
    the LZ4 matcher's keys `hash << 16 | pos`, in position order, sort in
    two 8-bit passes with begin_bit=16 instead of four."""
    _check(key, payloads, begin_bit)
    dev = key.device
    if dev.type == "cpu":
        return sort_rows_ref(key, *payloads, begin_bit=begin_bit)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, N = key.shape
    ops = [raw_bits(key)] + [p.view(torch.int32) for p in payloads]
    outs = [torch.empty_like(o) for o in ops]
    npass = (32 - begin_bit) // 8
    tmps = [torch.empty_like(o) if npass > 1 else None for o in ops]
    args = []
    for i in range(1 + MAX_PAYLOADS):
        if i < len(ops):
            args += [ops[i].data_ptr(), outs[i].data_ptr(),
                     tmps[i].data_ptr() if tmps[i] is not None else None]
        else:
            args += [None, None, None]
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.sort_rows_launch(*args, len(payloads), B, N, begin_bit, stream)
    if err != 0:
        raise RuntimeError(f"sort_rows: {lib.sort_error_string(err).decode()}")
    LAUNCHES["sort_rows"] += 1
    return tuple(_from_bits(o, t.dtype) for o, t in zip(outs, (key,) + payloads))

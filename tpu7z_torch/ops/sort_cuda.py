"""Stable row sort of uint32 keys with 32-bit payloads, on Hopper.

The counterpart of tpu7z/ops/sort_pallas.py `bitonic_sort`:
`sort_rows(key, *payloads)` sorts each row of a (B, N) key tensor
ascending and returns `(key_sorted, *payloads_sorted)`, every dtype kept.
Rows may be of any length and keys need not be unique: the sort is
stable, so equal keys keep their input order (the bitonic sort takes
rows of 65536 keys and is not stable). The kernel is a stable LSD radix
sort in csrc/sort.cu; its plain version is `sort_rows_ref`
(`torch.sort(stable=True)` and `gather`).

Keys are uint32 values, carried in any of three dtypes:
  - torch.uint32, the values themselves;
  - torch.int32, their raw bits (a key >= 2**31 reads as negative);
  - torch.int64 holding values in [0, 2**32), as lz4_plane's masked
    unsigned arithmetic does.
Payloads are 32-bit tensors of any dtype (int32, uint32, float32), moved
as raw bits.

On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernels or raises. There is no fallback between the two.
The kernel reads and writes the key's own carrier: an int64 key is read
as its low 32 bits and written back zero-extended, so no conversion runs
around it. Each pass is three launches (count and scatter over the
tiles of every row, a scan of each row's count table between them);
LAUNCHES["sort_rows"] counts one per `sort_rows` call that launches
them, whatever the number of passes.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import trace
from . import _build

MAX_PAYLOADS = 3
KEY_DTYPES = (torch.int32, torch.uint32, torch.int64)
BEGIN_BITS = (0, 8, 16, 24)
RADIX = 256
# the kernels of the main path's sort, in the order of sort_kernel_info
INFO_KERNELS = ("count_i64", "scan", "scatter_i64_u32", "count_u32", "scatter_u32_i64")

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
        lib.sort_rows_launch.argtypes = [_P] * 13 + [_I] * 5 + [_P]
        lib.sort_rows_launch.restype = ctypes.c_int
        lib.sort_error_string.argtypes = [ctypes.c_int]
        lib.sort_error_string.restype = ctypes.c_char_p
        lib.sort_tile.argtypes = []
        lib.sort_tile.restype = ctypes.c_int
        lib.sort_kernel_info.argtypes = [_I] + 5 * [ctypes.POINTER(_I)]
        lib.sort_kernel_info.restype = ctypes.c_int
        _lib = lib
    return _lib


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: {_library().sort_error_string(err).decode()}")


def kernel_info():
    """What the compiler and the current card make of the kernels of the
    main path's sort (int64 keys, begin_bit 16, no payloads), in launch
    order: name -> registers and local (spill) bytes a thread, static
    shared bytes and threads a CTA, resident CTAs per SM."""
    lib = _library()
    info = {}
    for which, name in enumerate(INFO_KERNELS):
        vals = [ctypes.c_int() for _ in range(5)]
        _raise_on(lib.sort_kernel_info(which, *[ctypes.byref(v) for v in vals]),
                  f"sort_kernel_info({name})")
        info[name] = dict(zip(("regs", "local_bytes", "shared_bytes", "threads",
                               "ctas_per_sm"), (v.value for v in vals)))
    return info


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


def launch_bytes(key, payloads, begin_bit: int = 0):
    """Bytes one `sort_rows` call reads and writes by its contract: in
    each pass every operand is read once and written once, the key in its
    own carrier where the first pass reads it and the last writes it, as
    u32 in between, and each payload as its 32 bits. The count table (1 B
    a key a pass) is left out. The span `sort.rows` carries it as
    `bytes`, on the CPU path too; 0 for anything that is not a 2-D
    tensor, which the checks then refuse."""
    if not isinstance(key, torch.Tensor) or key.dim() != 2 or begin_bit not in BEGIN_BITS:
        return 0
    npass = (32 - begin_bit) // 8
    key_bytes = 2 * key.element_size() + 8 * (npass - 1)
    return key.numel() * (key_bytes + 8 * npass * len(payloads))


def sort_rows(key, *payloads, begin_bit: int = 0):
    """Sort each row of `key` (B, N) ascending, stably: keys equal in the
    bits sorted keep their input order. Returns (key_sorted,
    *payloads_sorted).

    begin_bit (0, 8, 16 or 24) orders by the key's bits [begin_bit, 32)
    only, keeping the input order among keys equal there. That is the
    full order when each row arrives sorted by its low begin_bit bits:
    the LZ4 matcher's keys `hash << 16 | pos`, in position order, sort in
    two 8-bit passes with begin_bit=16 instead of four. A span
    `sort.rows`."""
    with trace.span("sort.rows", bytes=launch_bytes(key, payloads, begin_bit)):
        _check(key, payloads, begin_bit)
        dev = key.device
        if dev.type == "cpu":
            return sort_rows_ref(key, *payloads, begin_bit=begin_bit)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        outs, scratch = buffers(key, payloads, begin_bit)
        if key.numel():
            _launch(key, payloads, outs, scratch, begin_bit)
        return tuple(outs)


def buffers(key, payloads, begin_bit):
    """What the kernels write: the outputs (the inputs' dtypes) and the
    scratch (a u32 row set per operand when more than one pass runs, and
    the count table of B * tiles * 256 u32)."""
    B, N = key.shape
    ops = (key,) + tuple(payloads)
    outs = [torch.empty_like(o) for o in ops]
    npass = (32 - begin_bit) // 8
    tmps = [torch.empty((B, N), dtype=torch.int32, device=key.device) if npass > 1 else None
            for _ in ops]
    tiles = -(-N // _library().sort_tile())
    counts = torch.empty(B * tiles * RADIX, dtype=torch.int32, device=key.device)
    return outs, (tmps, counts)


def _launch(key, payloads, outs, scratch, begin_bit):
    """The kernels' launches on the current stream, into buffers from
    `buffers`; adds one to LAUNCHES["sort_rows"]."""
    tmps, counts = scratch
    B, N = key.shape
    args = []
    for o, out, tmp in zip((key,) + tuple(payloads), outs, tmps):
        args += [o.data_ptr(), out.data_ptr(), tmp.data_ptr() if tmp is not None else None]
    args += [None] * (3 * (1 + MAX_PAYLOADS) - len(args))
    stream = torch.cuda.current_stream(key.device).cuda_stream
    _raise_on(_library().sort_rows_launch(*args, counts.data_ptr(), len(payloads),
                                          key.element_size(), B, N, begin_bit, stream),
              "sort_rows")
    LAUNCHES["sort_rows"] += 1

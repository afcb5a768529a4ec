"""LZ4 device block encoder through hand-written Hopper kernels.

The counterpart of tpu7z/ops/lz4_pallas.py, with the same contract:
`encode_blocks(blocks, ns, W)` returns `(out (B, OUT_CAP) uint8,
used (B,) int32)`, and block b's LZ4 bytes are `out[b, :used[b]]`.

The path is the sorted-neighbour candidates, two kernels around one row
sort of both tiers' keys (the kernel of sort_cuda.py, csrc/sort.cu, the
counterpart of the TPU's bitonic_sort), followed by four kernels; all six
are in csrc/lz4_stages.cu:

  lz4_keys       both tiers' sort keys               (XLA's lax.sort tiers)
  lz4_probe      the sorted neighbours, verified     (the same)
  lz4_match      words, tier-A window, run lengths   (TPU kernel a1)
  lz4_parse      lazy greedy parse                   (a2)
  lz4_geometry   sequence geometry and prefix sums   (a3)
  lz4_emit       the LZ4 bytes, 255-runs included    (b1 + b2 + c)

Each stage has a wrapper here. On CPU tensors it runs the plain PyTorch
version from lz4_plane.py; on CUDA tensors it launches its kernel, adds
one to LAUNCHES[name], or raises. There is no fallback between the two.
Every kernel moves its planes as 16-byte lanes (lz4_parse stores its
uint8 plane as 4-byte lanes), so their inputs and outputs must start on
a 16-byte boundary. lz4_match, lz4_geometry and lz4_emit give each warp
one 128-position row; lz4_parse gives each group of 4 lanes one, eight
rows a warp; lz4_keys gives each thread 4 positions; lz4_probe gives one
CTA a block and a plane.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import trace
from . import _build
from . import lz4_plane as P
from . import sort_cuda

BLOCK = P.BLOCK
OUT_CAP = P.OUT_CAP
KERNELS = ("lz4_match", "lz4_parse", "lz4_geometry", "lz4_emit", "lz4_keys",
           "lz4_probe")

# kernel launches made by the wrappers in this process, by kernel name
LAUNCHES = {k: 0 for k in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "lz4_match": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "lz4_parse": [_P, _P, _I, _P],
    "lz4_geometry": [_P, _P, _P, _P, _P, _P, _P, _I, _P],
    "lz4_emit": [_P, _P, _P, _P, _P, _I, _P],
    "lz4_keys": [_P, _P, _I, _P],
    "lz4_probe": [_P, _P, _P, _P, _I, _P],
}
_lib = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("lz4_stages")
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name + "_launch")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.lz4_geo_planes.argtypes = []
        lib.lz4_geo_planes.restype = ctypes.c_int
        lib.lz4_error_string.argtypes = [ctypes.c_int]
        lib.lz4_error_string.restype = ctypes.c_char_p
        lib.lz4_kernel_info.argtypes = [_I] + 5 * [ctypes.POINTER(_I)]
        lib.lz4_kernel_info.restype = ctypes.c_int
        if lib.lz4_geo_planes() != len(P.GEO_NAMES):
            raise RuntimeError("csrc/lz4_stages.cu and GEO_NAMES disagree")
        _lib = lib
    return _lib


def _launch(name, *args):
    """Launch kernel `name` on the current stream; tensors go as device
    pointers, ints as ints."""
    lib = _library()
    stream = torch.cuda.current_stream().cuda_stream
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = getattr(lib, name + "_launch")(*cargs, stream)
    if err != 0:
        raise RuntimeError(f"{name}: {lib.lz4_error_string(err).decode()}")
    LAUNCHES[name] += 1


def kernel_info(name):
    """What the compiler and the current card make of an encoder kernel:
    registers and local (spill) bytes a thread, shared bytes (static, and
    lz4_probe's dynamic) and threads a CTA, and resident CTAs per SM
    (lz4_match as the main path launches it, W = 0)."""
    lib = _library()
    vals = [_I() for _ in range(5)]
    err = lib.lz4_kernel_info(KERNELS.index(name),
                              *[ctypes.byref(v) for v in vals])
    if err != 0:
        raise RuntimeError(f"{name}: {lib.lz4_error_string(err).decode()}")
    return dict(zip(("regs", "local_bytes", "shared_bytes", "threads",
                     "ctas_per_sm"), (v.value for v in vals)))


def _check(t, name, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_aligned(*named):
    """The row kernels load and store 16 bytes a lane (lz4_parse: mlen;
    lz4_emit: its planes, moff and out)."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must start on a 16-byte boundary")


def _on_card(device):
    """True for CUDA (launch the kernel), False for the CPU (plain version);
    anything else raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")


def _check_ns(ns, B, device):
    """Valid lengths only: the kernels size their writes from them. One
    host read (a span `read.lz4_check_ns`)."""
    _check(ns, "ns", torch.int32, (B,), device)
    with trace.span("read.lz4_check_ns"):
        bad = bool(((ns < 0) | (ns > BLOCK)).any())
    if bad:
        raise ValueError(f"ns: every length must lie in [0, {BLOCK}]")


def _check_blocks(blocks):
    if not isinstance(blocks, torch.Tensor) or blocks.dim() != 2:
        raise ValueError("blocks: expected a (B, BLOCK) uint8 tensor")
    B = blocks.shape[0]
    _check(blocks, "blocks", torch.uint8, (B, BLOCK), blocks.device)
    return B, blocks.device


def _check_batch(blocks, ns):
    B, dev = _check_blocks(blocks)
    _check_ns(ns, B, dev)
    return B, dev


def launch_bytes(name, B, W: int = P.W_DEFAULT):
    """Bytes the launch of encoder kernel `name` over B blocks reads and
    writes by its contract: each plane it reads whole once, each plane it
    writes once. Planes a kernel reads only where the data asks are left
    out: lz4_match's blocks at W = 0, lz4_geometry's moff, lz4_emit's
    blocks, moff and every geometry plane but glen and kept. The spans
    `lz4.keys`, `lz4.probe`, `lz4.match`, `lz4.parse`, `lz4.geometry` and
    `lz4.emit` carry it as `bytes`, on the CPU path too."""
    N = BLOCK
    per_block = {
        "lz4_keys": N + 2 * 4 * N,
        "lz4_probe": N + 2 * 4 * N + 4 + 3 * 4 * N,
        "lz4_match": 4 + 3 * 4 * N + (N if W else 0) + 2 * 4 * N,
        "lz4_parse": 4 * N + N,
        "lz4_geometry": 4 * N + N + 4 + 4 * len(P.GEO_NAMES) * N + 2 * 4,
        "lz4_emit": 4 + 2 * 4 * N + OUT_CAP,
    }[name]
    return B * per_block


def _rows(t):
    """The row count of a 2-D tensor, else 0: the spans' bytes are counted
    before the wrappers' checks, which must raise as they do."""
    return t.shape[0] if isinstance(t, torch.Tensor) and t.dim() == 2 else 0


def candidate_keys(blocks):
    """keys (2, B, BLOCK) int32, the raw bits of both tiers' uint32 sort
    keys hash16 << 16 | pos (tier B, then tier B4). A span `lz4.keys`."""
    with trace.span("lz4.keys", bytes=launch_bytes("lz4_keys", _rows(blocks))):
        B, dev = _check_blocks(blocks)
        if not _on_card(dev):
            return P.candidate_keys(blocks)
        _check_aligned(("blocks", blocks))
        keys = torch.empty((2, B, BLOCK), dtype=torch.int32, device=dev)
        _launch("lz4_keys", blocks, keys, B)
        return keys


def candidate_probe(blocks, skeys, ns):
    """(so8, so4a, so4b) (B, BLOCK) int32 from the keys of candidate_keys,
    each row sorted as uint32. ns is checked for its type and shape only:
    the kernel writes each block's plane whole whatever its length. A span
    `lz4.probe`."""
    with trace.span("lz4.probe", bytes=launch_bytes("lz4_probe", _rows(blocks))):
        B, dev = _check_blocks(blocks)
        _check(skeys, "skeys", torch.int32, (2, B, BLOCK), dev)
        _check(ns, "ns", torch.int32, (B,), dev)
        if not _on_card(dev):
            return P.candidate_probe(blocks, skeys, ns)
        _check_aligned(("blocks", blocks), ("skeys", skeys))
        so = torch.empty((3, B, BLOCK), dtype=torch.int32, device=dev)
        _launch("lz4_probe", blocks, skeys, ns, so, B)
        return so[0], so[1], so[2]


def candidates(blocks, ns):
    """Sorted-neighbour candidate planes (so8, so4a, so4b) on any device:
    both tiers' keys, one row sort of their 2B rows (begin_bit 16: the
    keys arrive in position order, so two passes over the hash give their
    full order), the probes. On the card three launches. A span
    `lz4.candidates`."""
    with trace.span("lz4.candidates"):
        _check_batch(blocks, ns)
        keys = candidate_keys(blocks)
        skeys = sort_cuda.sort_rows(keys.view(-1, BLOCK), begin_bit=16)[0]
        return candidate_probe(blocks, skeys.view(keys.shape), ns)


def match_lengths(blocks, ns, so8, so4a, so4b, W: int = P.W_DEFAULT):
    """(mlen, moff) (B, BLOCK) int32 from the candidate planes and the
    tier-A window of width W. A span `lz4.match`."""
    with trace.span("lz4.match", bytes=launch_bytes("lz4_match", _rows(blocks), W)):
        B, dev = _check_batch(blocks, ns)
        for name, t in (("so8", so8), ("so4a", so4a), ("so4b", so4b)):
            _check(t, name, torch.int32, (B, BLOCK), dev)
        if not 0 <= W < BLOCK:
            raise ValueError(f"W={W} out of range")
        if not _on_card(dev):
            return P.match_lengths_ref(blocks, ns, so8, so4a, so4b, W)
        _check_aligned(("blocks", blocks), ("so8", so8), ("so4a", so4a),
                       ("so4b", so4b))
        mlen = torch.empty((B, BLOCK), dtype=torch.int32, device=dev)
        moff = torch.empty((B, BLOCK), dtype=torch.int32, device=dev)
        _launch("lz4_match", blocks, ns, so8, so4a, so4b, mlen, moff, B, W)
        return mlen, moff


def parse(mlen):
    """is_start (B, BLOCK) bool from any int32 mlen plane. A span
    `lz4.parse`."""
    with trace.span("lz4.parse", bytes=launch_bytes("lz4_parse", _rows(mlen))):
        if not isinstance(mlen, torch.Tensor) or mlen.dim() != 2:
            raise ValueError("mlen: expected a (B, BLOCK) int32 tensor")
        B, dev = mlen.shape[0], mlen.device
        _check(mlen, "mlen", torch.int32, (B, BLOCK), dev)
        if not _on_card(dev):
            return P.phase3_parse(mlen)
        _check_aligned(("mlen", mlen))
        st = torch.empty((B, BLOCK), dtype=torch.uint8, device=dev)
        _launch("lz4_parse", mlen, st, B)
        return st.view(torch.bool)


def geometry(mlen, moff, is_start, ns):
    """Geometry dict: (B, BLOCK) int32 planes named by GEO_NAMES, and
    `core_used`, `used` (B,) int32. A span `lz4.geometry`."""
    with trace.span("lz4.geometry", bytes=launch_bytes("lz4_geometry", _rows(mlen))):
        B, dev = mlen.shape[0], mlen.device
        _check(mlen, "mlen", torch.int32, (B, BLOCK), dev)
        _check(moff, "moff", torch.int32, (B, BLOCK), dev)
        _check(is_start, "is_start", torch.bool, (B, BLOCK), dev)
        _check_ns(ns, B, dev)
        if not _on_card(dev):
            return P.phase4_geometry(mlen, moff, is_start, ns)
        _check_aligned(("mlen", mlen), ("moff", moff), ("is_start", is_start))
        planes = torch.empty((B, len(P.GEO_NAMES), BLOCK), dtype=torch.int32,
                             device=dev)
        core_used = torch.empty((B,), dtype=torch.int32, device=dev)
        used = torch.empty((B,), dtype=torch.int32, device=dev)
        _launch("lz4_geometry", mlen, moff, is_start.view(torch.uint8), ns,
                planes, core_used, used, B)
        geo = {k: planes[:, i] for i, k in enumerate(P.GEO_NAMES)}
        geo["planes"] = planes
        geo["core_used"] = core_used
        geo["used"] = used
        return geo


def _planes(geo, B, dev):
    """The stacked geometry planes lz4_emit reads."""
    planes = geo.get("planes")
    if planes is None:
        planes = torch.stack([geo[k] for k in P.GEO_NAMES], dim=1)
    _check(planes, "geo planes", torch.int32, (B, len(P.GEO_NAMES), BLOCK), dev)
    _check(geo["used"], "used", torch.int32, (B,), dev)
    return planes


def emit(blocks, moff, geo):
    """(out (B, OUT_CAP) uint8, used (B,) int32): block b's LZ4 bytes are
    out[b, :used[b]], zero from used[b] on. One launch writes the bytes,
    255-runs included; no core buffer is made on the card. A span
    `lz4.emit`."""
    with trace.span("lz4.emit", bytes=launch_bytes("lz4_emit", _rows(blocks))):
        B, dev = blocks.shape[0], blocks.device
        _check(blocks, "blocks", torch.uint8, (B, BLOCK), dev)
        _check(moff, "moff", torch.int32, (B, BLOCK), dev)
        if not _on_card(dev):
            return P.emit_ref(blocks, moff, geo)
        planes = _planes(geo, B, dev)
        out = torch.empty((B, OUT_CAP), dtype=torch.uint8, device=dev)
        _check_aligned(("blocks", blocks), ("moff", moff), ("geo planes", planes),
                       ("out", out))
        _launch("lz4_emit", blocks, moff, planes, geo["used"], out, B)
        return out, geo["used"]


def encode_blocks(blocks, ns, W: int = P.W_DEFAULT, tier_b: bool = True):
    """blocks (B, BLOCK) uint8 zero padded past ns, ns (B,) int32.
    tier_b=False drops the sorted-neighbour tiers: their planes are zero
    and no sort runs; the tier-A window W still applies.

    Returns (out (B, OUT_CAP) uint8, used (B,) int32)."""
    if tier_b:
        so8, so4a, so4b = candidates(blocks, ns)
    else:
        so8 = so4a = so4b = torch.zeros_like(blocks, dtype=torch.int32)
    mlen, moff = match_lengths(blocks, ns, so8, so4a, so4b, W)
    geo = geometry(mlen, moff, parse(mlen), ns)
    return emit(blocks, moff, geo)

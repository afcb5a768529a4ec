""".7z archive reader, a port of tpu7z/containers/sevenzip/reader.py.

Behavioral reference: CPP/7zip/Archive/7z/7zIn.cpp (ReadHeader:1232,
streams info :695-1085, ReadAndDecodePackedStreams:1160) and
DOC/7zFormat.txt. Written from the format spec.

Folders are coder DAGs (CoderMixer2 analog): coders are evaluated by
resolving bind pairs recursively from the folder's final output stream.
Folders are independent -> the parallel decode unit (MtDec analog).

The reader runs on the device the caller names (the CUDA card unless
`device` names the CPU): AES decryption, the whole-array branch
filters and bzip2's inverse BWT are tensor code there; the other codecs,
x86, IA-64, RISC-V, BCJ2 and PPMd run on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ...device import resolve_device
from ...models import deflate, ppmd
from ...models.filters import bcj, delta
from ...models.lz4 import frame as lz4_frame
from ...models.lzma import decoder as lzma1
from ...models.lzma import lzma2
from ...models.lzma.rangecoder import RangeDecoder
from ...models.zstd import frame as zstd_frame
from ...ops.hashing import crc32_native as _crc32
from ...utils.errors import CorruptError, UnsupportedError
from . import format as F
from .aes7z import aes_decrypt
from .format import ByteReader


@dataclass
class Coder:
    method_id: int
    num_in: int
    num_out: int
    props: bytes


@dataclass
class Folder:
    coders: list = field(default_factory=list)
    bind_pairs: list = field(default_factory=list)   # (in_index, out_index)
    packed_indices: list = field(default_factory=list)
    unpack_sizes: list = field(default_factory=list)  # per out-stream
    crc: int | None = None

    def total_in(self):
        return sum(c.num_in for c in self.coders)

    def total_out(self):
        return sum(c.num_out for c in self.coders)

    def final_out_index(self) -> int:
        bound = {out for _in, out in self.bind_pairs}
        for i in range(self.total_out()):
            if i not in bound:
                return i
        raise CorruptError("7z: folder has no final output")

    def output_size(self) -> int:
        return self.unpack_sizes[self.final_out_index()]


@dataclass
class StreamsInfo:
    pack_pos: int = 0
    pack_sizes: list = field(default_factory=list)
    folders: list = field(default_factory=list)
    # substreams
    num_unpack_streams: list = field(default_factory=list)
    sub_sizes: list = field(default_factory=list)
    sub_crcs: list = field(default_factory=list)


@dataclass
class FileEntry:
    name: str
    has_stream: bool = True
    is_dir: bool = False
    is_empty_file: bool = False
    size: int = 0
    crc: int | None = None
    attrib: int | None = None
    mtime: int | None = None


def _read_folder(r: ByteReader) -> Folder:
    f = Folder()
    num_coders = r.number()
    if num_coders == 0 or num_coders > 64:
        raise CorruptError("7z: bad coder count")
    for _ in range(num_coders):
        flags = r.byte()
        id_size = flags & 0x0F
        mid = int.from_bytes(r.bytes(id_size), "big")
        num_in = num_out = 1
        if flags & 0x10:
            num_in = r.number()
            num_out = r.number()
        props = b""
        if flags & 0x20:
            props = r.bytes(r.number())
        if flags & 0xC0:
            raise CorruptError("7z: reserved coder flags")
        f.coders.append(Coder(mid, num_in, num_out, props))
    total_in = f.total_in()
    total_out = f.total_out()
    num_bind = total_out - 1
    for _ in range(num_bind):
        in_i = r.number()
        out_i = r.number()
        f.bind_pairs.append((in_i, out_i))
    num_pack = total_in - num_bind
    if num_pack == 1:
        bound_ins = {i for i, _o in f.bind_pairs}
        for i in range(total_in):
            if i not in bound_ins:
                f.packed_indices = [i]
                break
    else:
        f.packed_indices = [r.number() for _ in range(num_pack)]
    return f


def _read_streams_info(r: ByteReader) -> StreamsInfo:
    si = StreamsInfo()
    while True:
        nid = r.number()
        if nid == F.K_END:
            break
        if nid == F.K_PACK_INFO:
            si.pack_pos = r.number()
            num = r.number()
            while True:
                nid2 = r.number()
                if nid2 == F.K_END:
                    break
                if nid2 == F.K_SIZE:
                    si.pack_sizes = [r.number() for _ in range(num)]
                elif nid2 == F.K_CRC:
                    defined = r.bool_vector_opt(num)
                    for d in defined:
                        if d:
                            r.u32()
                else:
                    raise CorruptError("7z: bad packinfo nid")
        elif nid == F.K_UNPACK_INFO:
            if r.number() != F.K_FOLDER:
                raise CorruptError("7z: expected kFolder")
            num_folders = r.number()
            external = r.byte()
            if external:
                raise UnsupportedError("7z: external folders")
            si.folders = [_read_folder(r) for _ in range(num_folders)]
            if r.number() != F.K_CODERS_UNPACK_SIZE:
                raise CorruptError("7z: expected kCodersUnpackSize")
            for f in si.folders:
                f.unpack_sizes = [r.number() for _ in range(f.total_out())]
            while True:
                nid2 = r.number()
                if nid2 == F.K_END:
                    break
                if nid2 == F.K_CRC:
                    defined = r.bool_vector_opt(num_folders)
                    for f, d in zip(si.folders, defined):
                        f.crc = r.u32() if d else None
                else:
                    raise CorruptError("7z: bad unpackinfo nid")
        elif nid == F.K_SUBSTREAMS_INFO:
            si.num_unpack_streams = [1] * len(si.folders)
            nid2 = r.number()
            if nid2 == F.K_NUM_UNPACK_STREAM:
                si.num_unpack_streams = [r.number()
                                         for _ in range(len(si.folders))]
                nid2 = r.number()
            sizes = []
            if nid2 == F.K_SIZE:
                for fi, f in enumerate(si.folders):
                    cnt = si.num_unpack_streams[fi]
                    if cnt == 0:
                        continue
                    total = 0
                    for _ in range(cnt - 1):
                        s = r.number()
                        sizes.append(s)
                        total += s
                    sizes.append(f.output_size() - total)
                nid2 = r.number()
            else:
                for fi, f in enumerate(si.folders):
                    cnt = si.num_unpack_streams[fi]
                    if cnt == 1:
                        sizes.append(f.output_size())
                    elif cnt != 0:
                        raise CorruptError("7z: missing substream sizes")
            si.sub_sizes = sizes
            num_unknown = 0
            known = []
            for fi, f in enumerate(si.folders):
                cnt = si.num_unpack_streams[fi]
                if cnt == 1 and f.crc is not None:
                    known.append(f.crc)
                else:
                    known.extend([None] * cnt)
                    num_unknown += cnt
            if nid2 == F.K_CRC:
                defined = r.bool_vector_opt(num_unknown)
                vals = iter([r.u32() if d else None for d in defined])
                out = []
                for c in known:
                    out.append(c if c is not None else next(vals))
                si.sub_crcs = out
                nid2 = r.number()
            else:
                si.sub_crcs = known
            if nid2 != F.K_END:
                raise CorruptError("7z: bad substreams end")
        else:
            raise CorruptError(f"7z: unexpected streams nid {nid}")
    if not si.num_unpack_streams:
        si.num_unpack_streams = [1] * len(si.folders)
        si.sub_sizes = [f.output_size() for f in si.folders]
        si.sub_crcs = [f.crc for f in si.folders]
    return si


class SevenZipReader:
    def __init__(self, data: bytes, password: str | None = None, *, device=None):
        self.device = resolve_device(device)
        # SFX support: archives embedded after an executable stub are
        # found by scanning for the signature (7zIn kSearchLimit analog).
        if len(data) >= 32 and data[:6] != F.SIGNATURE and data[:2] == b"MZ":
            pos = data.find(F.SIGNATURE, 0, 1 << 22)
            if pos > 0:
                data = data[pos:]
        self.data = data
        self.password = password
        if len(data) < 32 or data[:6] != F.SIGNATURE:
            raise CorruptError("7z: bad signature")
        start_crc = int.from_bytes(data[8:12], "little")
        if _crc32(data[12:32]) != start_crc:
            raise CorruptError("7z: start header crc mismatch")
        nh_off = int.from_bytes(data[12:20], "little")
        nh_size = int.from_bytes(data[20:28], "little")
        nh_crc = int.from_bytes(data[28:32], "little")
        hdr = data[32 + nh_off:32 + nh_off + nh_size]
        if len(hdr) != nh_size:
            raise CorruptError("7z: truncated next header")
        if nh_size and _crc32(hdr) != nh_crc:
            raise CorruptError("7z: next header crc mismatch")
        self.files: list[FileEntry] = []
        self.streams: StreamsInfo | None = None
        if nh_size == 0:
            return
        r = ByteReader(hdr)
        nid = r.number()
        if nid == F.K_ENCODED_HEADER:
            si = _read_streams_info(r)
            hdr = self._decode_streams(si)
            r = ByteReader(hdr)
            nid = r.number()
        if nid != F.K_HEADER:
            raise CorruptError("7z: expected kHeader")
        self._read_header(r)

    # --- folder decoding ---------------------------------------------------

    def _pack_stream_data(self, si: StreamsInfo):
        """Slice packed stream spans for each folder."""
        base = 32 + si.pack_pos
        offs = []
        pos = base
        for s in si.pack_sizes:
            offs.append((pos, s))
            pos += s
        return offs

    def _decode_streams(self, si: StreamsInfo) -> bytes:
        spans = self._pack_stream_data(si)
        out = []
        pack_index = 0
        for f in si.folders:
            npack = len(f.packed_indices)
            packs = [self.data[o:o + s]
                     for (o, s) in spans[pack_index:pack_index + npack]]
            pack_index += npack
            data = decode_folder(f, packs, self.password, device=self.device)
            if f.crc is not None and _crc32(data) != f.crc:
                raise CorruptError("7z: folder crc mismatch")
            out.append(data)
        return b"".join(out)

    def _read_header(self, r: ByteReader):
        while True:
            nid = r.number()
            if nid == F.K_END:
                break
            if nid == F.K_MAIN_STREAMS:
                self.streams = _read_streams_info(r)
            elif nid == F.K_FILES_INFO:
                self._read_files_info(r)
            elif nid == F.K_ARCHIVE_PROPERTIES:
                while True:
                    pid = r.number()
                    if pid == F.K_END:
                        break
                    r.bytes(r.number())
            else:
                raise CorruptError(f"7z: unexpected header nid {nid}")

    def _read_files_info(self, r: ByteReader):
        num_files = r.number()
        files = [FileEntry(name="") for _ in range(num_files)]
        empty_streams: list[bool] = [False] * num_files
        empty_files: list[bool] = []
        while True:
            pid = r.number()
            if pid == F.K_END:
                break
            size = r.number()
            end = r.pos + size
            if pid == F.K_EMPTY_STREAM:
                empty_streams = r.bitfield(num_files)
            elif pid == F.K_EMPTY_FILE:
                n_empty = sum(empty_streams)
                empty_files = r.bitfield(n_empty)
            elif pid == F.K_NAME:
                external = r.byte()
                if external:
                    raise UnsupportedError("7z: external names")
                raw = r.bytes(end - r.pos)
                names = raw.decode("utf-16-le").split("\x00")[:-1]
                if len(names) != num_files:
                    raise CorruptError("7z: name count mismatch")
                for fe, nm in zip(files, names):
                    fe.name = nm
            elif pid == F.K_MTIME:
                defined = r.bool_vector_opt(num_files)
                external = r.byte()
                for fe, d in zip(files, defined):
                    if d:
                        fe.mtime = r.u64()
            elif pid == F.K_WIN_ATTRIB:
                defined = r.bool_vector_opt(num_files)
                external = r.byte()
                for fe, d in zip(files, defined):
                    if d:
                        fe.attrib = r.u32()
            r.pos = end
        ei = 0
        for i, fe in enumerate(files):
            if empty_streams[i]:
                fe.has_stream = False
                is_empty_file = empty_files[ei] if ei < len(empty_files) \
                    else False
                fe.is_dir = not is_empty_file
                fe.is_empty_file = is_empty_file
                ei += 1
        self.files = files
        # attach sizes/crcs from substreams
        if self.streams:
            sizes = iter(self.streams.sub_sizes)
            crcs = iter(self.streams.sub_crcs)
            for fe in files:
                if fe.has_stream:
                    fe.size = next(sizes)
                    fe.crc = next(crcs)

    # --- extraction --------------------------------------------------------

    def extract_all(self, verify_crc: bool = True) -> dict[str, bytes]:
        out: dict[str, bytes] = {}
        si = self.streams
        file_iter = [fe for fe in self.files if fe.has_stream]
        fi = 0
        if si:
            spans = self._pack_stream_data(si)
            pack_index = 0
            sub_idx = 0
            for folder_i, f in enumerate(si.folders):
                npack = len(f.packed_indices)
                packs = [self.data[o:o + s]
                         for (o, s) in spans[pack_index:pack_index + npack]]
                pack_index += npack
                data = decode_folder(f, packs, self.password, device=self.device)
                cnt = si.num_unpack_streams[folder_i]
                pos = 0
                for _ in range(cnt):
                    sz = si.sub_sizes[sub_idx]
                    chunk = data[pos:pos + sz]
                    pos += sz
                    crc = si.sub_crcs[sub_idx]
                    if verify_crc and crc is not None and _crc32(chunk) != crc:
                        raise CorruptError("7z: file crc mismatch")
                    if fi < len(file_iter):
                        out[file_iter[fi].name] = chunk
                        fi += 1
                    sub_idx += 1
        for fe in self.files:
            if not fe.has_stream and fe.is_empty_file:
                out[fe.name] = b""
        return out


# ---------------------------------------------------------------------------
# Folder coder-graph decoding (CoderMixer2 analog)
# ---------------------------------------------------------------------------

def decode_folder(folder: Folder, packs: list[bytes],
                  password: str | None = None, *, device=None) -> bytes:
    """Evaluate the coder DAG and return the folder's final output."""
    # map global in-stream index -> source
    in_sources: dict[int, tuple] = {}
    for local, gin in enumerate(folder.packed_indices):
        in_sources[gin] = ("pack", local)
    for in_i, out_i in folder.bind_pairs:
        in_sources[in_i] = ("coder_out", out_i)

    # global stream index bases per coder
    in_base = []
    out_base = []
    ti = to = 0
    for c in folder.coders:
        in_base.append(ti)
        out_base.append(to)
        ti += c.num_in
        to += c.num_out

    out_cache: dict[int, bytes] = {}

    def coder_of_out(out_i: int) -> int:
        for ci, c in enumerate(folder.coders):
            if out_base[ci] <= out_i < out_base[ci] + c.num_out:
                return ci
        raise CorruptError("7z: bad out index")

    def get_out(out_i: int) -> bytes:
        if out_i in out_cache:
            return out_cache[out_i]
        ci = coder_of_out(out_i)
        c = folder.coders[ci]
        ins = []
        for k in range(c.num_in):
            src = in_sources.get(in_base[ci] + k)
            if src is None:
                raise CorruptError("7z: unbound coder input")
            if src[0] == "pack":
                ins.append(packs[src[1]])
            else:
                ins.append(get_out(src[1]))
        out_size = folder.unpack_sizes[out_i]
        result = _run_decoder(c, ins, out_size, password, device)
        out_cache[out_i] = result
        return result

    return get_out(folder.final_out_index())


# branch filters: tensor code on the reader's device, or serial on the host
_TENSOR_FILTERS = {F.M_ARM64: bcj.bcj_arm64_decode, F.M_ARM: bcj.bcj_arm_decode,
                   F.M_PPC: bcj.bcj_ppc_decode, F.M_SPARC: bcj.bcj_sparc_decode,
                   F.M_ARMT: bcj.bcj_armt_decode, F.M_SWAP2: bcj.swap2,
                   F.M_SWAP4: bcj.swap4}
_HOST_FILTERS = {F.M_BCJ: bcj.bcj_x86_decode, F.M_BCJ_X86: bcj.bcj_x86_decode,
                 F.M_RISCV: bcj.bcj_riscv_decode, F.M_IA64: bcj.bcj_ia64_decode}


def _run_decoder(coder: Coder, ins: list[bytes], out_size: int,
                 password: str | None, device) -> bytes:
    mid = coder.method_id
    data = ins[0] if ins else b""
    if mid == F.M_COPY:
        return data[:out_size]
    if mid == F.M_LZMA2:
        return lzma2.decompress(data, out_size)
    if mid == F.M_LZMA:
        return lzma1.decompress_raw(data, coder.props, out_size)
    if mid == F.M_ZSTD:
        return zstd_frame.decompress(data)
    if mid in (F.M_BZIP2, F.M_DEFLATE):
        from ...models.registry import get_codec  # the registry imports this package
        name = "bzip2" if mid == F.M_BZIP2 else "deflate"
        return get_codec(name).decompress(data, out_size=out_size, device=device)
    if mid == F.M_DEFLATE64:
        return deflate.decompress(data, max_out=out_size, deflate64=True)
    if mid == F.M_LZ4:
        return lz4_frame.decompress(data)
    if mid == F.M_BROTLI:
        from ...models import brotli
        return brotli.decompress_mt_container(data)
    if mid == F.M_DELTA:
        dist = coder.props[0] + 1 if coder.props else 1
        return delta.delta_decode(data, dist, device=device)[:out_size]
    if mid in _HOST_FILTERS:
        return _HOST_FILTERS[mid](data)[:out_size]
    if mid in _TENSOR_FILTERS:
        return _TENSOR_FILTERS[mid](data, device=device)[:out_size]
    if mid == F.M_BCJ2:
        return _bcj2_decode(ins, out_size)
    if mid == F.M_AES256:
        if password is None:
            raise UnsupportedError("7z: archive is encrypted (no password)")
        return aes_decrypt(data, coder.props, password, device=device)[:out_size]
    if mid == F.M_PPMD:
        return ppmd.decompress(data, coder.props, out_size)
    raise UnsupportedError(f"7z: unsupported method {mid:#x}")


def _bcj2_decode(ins: list[bytes], out_size: int) -> bytes:
    """BCJ2 4-stream decoder (C/Bcj2.c semantics)."""
    main, call, jump, rc = ins[0], ins[1], ins[2], ins[3]
    out = bytearray()
    # range decoder over rc stream (11-bit probs, like LZMA)
    probs = [1024] * (2 + 256)
    rdec = RangeDecoder(rc)
    mp = 0
    cp = 0
    jp = 0
    prev = 0
    while len(out) < out_size:
        b = main[mp]
        mp += 1
        out.append(b)
        if (b & 0xFE) == 0xE8 or (prev == 0x0F and (b & 0xF0) == 0x80):
            # probability index: E8 -> 2 + prev byte, E9 -> 1, jcc -> 0
            if b == 0xE8:
                idx = 2 + prev
            elif b == 0xE9:
                idx = 1
            else:
                idx = 0
            bit = rdec.decode_bit(probs, idx)
            if bit:
                src = call if b == 0xE8 else jump
                sp = cp if b == 0xE8 else jp
                absv = int.from_bytes(src[sp:sp + 4], "big")
                if b == 0xE8:
                    cp += 4
                else:
                    jp += 4
                rel = (absv - (len(out) + 4)) & 0xFFFFFFFF
                out += rel.to_bytes(4, "little")
                prev = (rel >> 24) & 0xFF
                continue
        prev = b
    return bytes(out[:out_size])

"""Brotli in the port (tpu7z_torch/models/brotli) against tpu7z's
(tpu7z/models/brotli) on the CPU.

`compress` and `compress_mt_container` give tpu7z's bytes at qualities
0, 1, 2, 4, 5, 8, 9, 10 and 11 on inputs made from seeds (empty, one
byte, random bytes, zeros, 4 KiB and 64 KiB of the corpus's text; at
qualities 10 and 11 also 150000 bytes of its records and logs, where the
literal context modelling keeps several trees); each decoder reads the
other's streams. The pieces the encoder runs as tensor code are held
against tpu7z's host code: a meta-block's commands, ring and body
(`_encode_metablock`, with rings that repeat and nearly repeat
distances), and the sink's packing of host and tensor fields against
tpu7z's `_BitSink`. Streams tpu7z's encoder never writes are built here
by a small bit writer: uncompressed and metadata meta-blocks, static
dictionary references through many transforms, and a meta-block with two
block types in every category, NPOSTFIX 1 and NDIRECT 4, a context map
with RLE and IMTF, context modes and both distance trees; the port's
decoder gives tpu7z's bytes on each, and tpu7z's error (class and
message) on each prefix of them and with each of their bits flipped.
Everything compared is bytes, integers or messages: equality is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.models import brotli as jbr  # noqa: E402
from tpu7z.models.brotli import decoder as jdec  # noqa: E402
from tpu7z.models.brotli import encoder as jenc  # noqa: E402
from tpu7z_torch.models import brotli as tbr  # noqa: E402
from tpu7z_torch.models.brotli import decoder as tdec  # noqa: E402
from tpu7z_torch.models.brotli import encoder as tenc  # noqa: E402
from tpu7z_torch.utils.corpus import make_corpus  # noqa: E402

TEXT = 696156            # the corpus's first byte past its sparse chunk
MIXED = 1 << 20          # records and logs, where contexts cluster
QUALITIES = [0, 1, 2, 4, 5, 8, 9, 10, 11]
KINDS = ["empty", "one", "random", "zeros", "text4k", "text64k"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(MIXED + 150000)


def _input(corpus, kind) -> bytes:
    rng = np.random.default_rng(len(kind))
    return {
        "empty": b"",
        "one": b"q",
        "random": rng.integers(0, 256, 5000, np.uint8).tobytes(),
        "zeros": bytes(3000),
        "text4k": corpus[TEXT:TEXT + 4096],
        "text64k": corpus[TEXT:TEXT + 65536],
        "mixed150k": corpus[MIXED:MIXED + 150000],
    }[kind]


def _outcome(fn, data):
    """fn(data), or what it raised: the class name and message of a
    format error, the class name of anything else (an IndexError from a
    read past the end names numpy's array in tpu7z, bytes here)."""
    try:
        return fn(data)
    except Exception as e:  # noqa: BLE001 - the decoders must agree on any error
        if type(e).__name__ in ("CorruptError", "UnsupportedError", "ParamError"):
            return (type(e).__name__, str(e))
        return type(e).__name__


def test_tables_equal_tpu7z():
    import os
    for name in ("dictionary.bin", "transforms.bin", "context_lut.bin"):
        with open(os.path.join(os.path.dirname(jdec.__file__), name), "rb") as f:
            want = f.read()
        with open(os.path.join(os.path.dirname(tdec.__file__), name), "rb") as f:
            assert f.read() == want, name
    assert tdec._TRANSFORMS == jdec._TRANSFORMS and len(tdec._DICT) == 122784


@pytest.mark.parametrize("quality,kind", [(q, k) for q in QUALITIES for k in KINDS]
                         + [(10, "mixed150k"), (11, "mixed150k")])
def test_compress_equals_tpu7z(corpus, quality, kind):
    data = _input(corpus, kind)
    want = jbr.compress(data, quality)
    got = tbr.compress(data, quality, device="cpu")
    assert got == want
    assert tbr.decompress(want) == data
    assert jbr.decompress(got) == data


def test_context_modelling_keeps_several_trees(corpus, monkeypatch):
    """The mixed input does reach clustering with more than one tree."""
    seen = []
    cluster = tenc._cluster_contexts

    def spy(hist, *a):
        out = cluster(hist, *a)
        seen.append(out[1])
        return out

    monkeypatch.setattr(tenc, "_cluster_contexts", spy)
    data = _input(corpus, "mixed150k")
    assert tbr.compress(data, 10, device="cpu") == jbr.compress(data, 10)
    assert seen and max(seen) > 1


@pytest.mark.parametrize("kind", ["empty", "random", "text4k"])
@pytest.mark.parametrize("quality", QUALITIES)
def test_mt_container_equals_tpu7z(corpus, quality, kind):
    data = _input(corpus, kind)
    want = jbr.compress_mt_container(data, quality)
    got = tbr.compress_mt_container(data, quality, device="cpu")
    assert got == want
    assert tbr.decompress_mt_container(want) == data
    assert jbr.decompress_mt_container(got) == data


def test_mt_container_of_several_frames_and_bad_magic(corpus):
    a, b = _input(corpus, "text4k"), _input(corpus, "random")
    two = jbr.compress_mt_container(a, 5) + jbr.compress_mt_container(b, 2)
    assert tbr.decompress_mt_container(two) == a + b
    bad = bytearray(two)
    bad[12:14] = b"XX"
    assert _outcome(tbr.decompress_mt_container, bytes(bad)) == \
        _outcome(jbr.decompress_mt_container, bytes(bad)) == \
        ("CorruptError", "brotli-mt: bad BR magic")


def _tring(jring):
    """The port's (fourth, third, second, last) of tpu7z's ring list."""
    idx = jring[4]
    return tuple(jring[(idx + k) & 3] for k in range(4))


@pytest.mark.parametrize("quality", [5, 10])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metablock_commands_ring_and_body_equal_tpu7z(corpus, seed, quality):
    """Synthetic matches over the text, their distances drawn so that the
    ring codes 0-15, the tail command and long inserts all occur; the
    ring comes in from an earlier meta-block. The port's commands (a
    prefix count for the ring), histograms and body give tpu7z's bits."""
    rng = np.random.default_rng(seed)
    data = corpus[TEXT:TEXT + 40000]
    a, b = 1000, 39000 - seed * 700
    pos, mp, ml, mo = a, [], [], []
    ring_vals = [16, 15, 11, 4, 7, 300, 301, 299, 1000]
    while True:
        pos += int(rng.choice([0, 0, 1, 3, 9, 40, 700]))
        ln = int(rng.choice([4, 5, 9, 17, 60, 300, 2200]))
        if pos + ln > b:
            break
        if rng.random() < 0.7:
            d = int(rng.choice(ring_vals)) + int(rng.choice([0, 0, 0, -3, -2, -1, 1, 2, 3]))
        else:
            d = int(rng.integers(1, pos))
        mp.append(pos)
        ml.append(ln)
        mo.append(max(d, 1))
        pos += ln
    seqs = tuple(np.asarray(x, np.int64) for x in (mp, ml, mo))
    jr = [300, 7, 16, 299, 2]
    ring_in = _tring(jr)
    want_sink = jenc._encode_metablock(data, a, b, seqs, jr, quality=quality)
    s = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    sink, ring = tenc._encode_metablock(s, a, b, seqs, ring_in, quality=quality)
    assert sink.bits == want_sink.bit_length()
    assert sink.close() == want_sink.close()
    assert ring == _tring(jr)


def test_sink_packs_as_bitsink():
    """Host fields, device fields, alignments and raw bytes in one order
    give `_BitSink`'s bytes (fields up to 56 bits)."""
    rng = np.random.default_rng(5)
    want = jenc._BitSink()
    got = tenc._Sink(torch.device("cpu"))
    for step in range(40):
        kind = step % 4
        if kind == 0:
            nb = int(rng.integers(0, 57))
            v = int(rng.integers(0, 1 << 62)) & ((1 << nb) - 1)
            want.put(v, nb)
            got.put(v, nb)
        elif kind == 1:
            nb = rng.integers(0, 57, 50)
            v = rng.integers(0, 1 << 62, 50) & ((1 << nb) - 1)
            want.put_arrays(v, nb)
            got.put_tensor(torch.from_numpy(v), torch.from_numpy(nb), int(nb.sum()))
        elif kind == 2:
            want.align()
            got.align()
        else:
            raw = rng.integers(0, 256, int(rng.integers(0, 20)), np.uint8)
            want.raw(raw.tobytes())
            got.raw(torch.from_numpy(raw))
        assert got.bits == want.bit_length()
    assert got.close() == want.close()


# ---------------------------------------------------------------------------
# Streams built here: a bit writer and the decoder's code shapes
# ---------------------------------------------------------------------------

class _Bits:
    def __init__(self):
        self.v = 0
        self.n = 0

    def put(self, v, n):
        self.v |= (v & ((1 << n) - 1)) << self.n
        self.n += n

    def align(self):
        self.n = (self.n + 7) & ~7

    def raw(self, data):
        self.align()
        for b in data:
            self.put(b, 8)

    def bytes(self):
        return self.v.to_bytes((self.n + 7) // 8, "little")


def _canonical(lengths):
    """sym -> (bit-reversed code, length) for the decoder's (len, sym)
    ordered canonical code."""
    out, code, prev = {}, 0, 0
    for ln, sym in sorted((ln, s) for s, ln in lengths.items()):
        code <<= ln - prev
        prev = ln
        out[sym] = (int(f"{code:0{ln}b}"[::-1], 2) if ln else 0, ln)
        code += 1
    return out


def _simple(w, syms, alphabet, tree=0):
    """A simple prefix code (hskip 1) of `syms` in write order; returns
    the table the decoder builds from it."""
    w.put(1, 2)
    w.put(len(syms) - 1, 2)
    nb = max(1, (alphabet - 1).bit_length())
    for s in syms:
        w.put(s, nb)
    if len(syms) == 1:
        return {syms[0]: (0, 0)}
    if len(syms) == 2:
        return _canonical({s: 1 for s in syms})
    if len(syms) == 3:
        b, c = sorted(syms[1:])
        return _canonical({syms[0]: 1, b: 2, c: 2})
    w.put(tree, 1)
    if tree:
        c, d = sorted(syms[2:])
        return _canonical({syms[0]: 1, syms[1]: 2, c: 3, d: 3})
    return _canonical({s: 2 for s in syms})


def _sym(w, table, s):
    code, ln = table[s]
    w.put(code, ln)


def _varlen(w, v):
    tenc._put_varlen_uint8(w, v)


def _count_code(c):
    for sym, (base, extra) in enumerate(zip(jdec.BLOCK_COUNT_BASE, jdec.BLOCK_COUNT_EXTRA)):
        if base <= c < base + (1 << extra):
            return sym, c - base, extra
    raise ValueError(c)


def _header(w, mlen, islast):
    w.put(islast, 1)
    if islast:
        w.put(0, 1)
    w.put(0, 2)
    w.put(mlen - 1, 16)


def _stream_stored_and_metadata():
    w = _Bits()
    w.put(1, 1)
    w.put(3, 3)              # WBITS 20
    _header(w, 5, 0)
    w.put(1, 1)              # ISUNCOMPRESSED
    w.raw(b"hello")
    w.put(0, 1)              # metadata: ISLAST 0, MNIBBLES code 3
    w.put(3, 2)
    w.put(0, 1)              # reserved
    w.put(1, 2)              # MSKIPBYTES 1
    w.put(2, 8)              # skip 3 bytes
    w.raw(b"\x01\x02\x03")
    _header(w, 3, 0)
    w.put(1, 1)
    w.raw(b"!!!")
    w.put(1, 1)              # ISLAST, ISLASTEMPTY
    w.put(1, 1)
    return w.bytes()


def _stream_dictionary(transform, length=6, index=5):
    """One literal, then a static dictionary word of `length` through
    `transform`; the meta-block's length is what tpu7z's transform gives."""
    off = jdec.OFFSETS_BY_LENGTH[length] + index * length
    word = jdec._transform_word(jdec._DICT[off:off + length], transform)
    w = _Bits()
    w.put(0, 1)              # WBITS 16
    _header(w, 1 + len(word), 1)
    for _ in range(3):
        w.put(0, 1)          # NBLTYPES 1
    w.put(0, 2)              # NPOSTFIX
    w.put(0, 4)              # NDIRECT
    w.put(0, 2)              # context mode
    w.put(0, 1)              # NTREESL 1
    w.put(0, 1)              # NTREESD 1
    _simple(w, [ord("X")], 256)
    cpy = next(c for c, (base, nb) in enumerate(zip(jdec.COPY_BASE, jdec.COPY_EXTRA))
               if base <= length < base + (1 << nb))
    cell = 2 if cpy < 8 else 3                 # cells (0, 0) and (0, 8), explicit
    _simple(w, [(cell << 6) | (1 << 3) | (cpy & 7)], 704)   # insert code 1
    dist = 1 + 1 + (index | (transform << jdec.SIZE_BITS_BY_LENGTH[length]))
    dcode, extra, nb = jenc._dist_code(dist, [16, 15, 11, 4, 0], 0)
    _simple(w, [dcode], 64)
    # the body: every symbol has a zero-bit code, so only extra bits
    w.put(length - jdec.COPY_BASE[cpy], jdec.COPY_EXTRA[cpy])
    w.put(extra, nb)
    return w.bytes()


# each literal-free cell's command symbols the writer picks from, by
# block type: (cell << 6) | (insert code - its offset) << 3 | (copy
# code - its offset); cells 0 and 1 take the last distance implicitly
_CMDS = ([(0 << 6) | (1 << 3) | 3, (2 << 6) | (2 << 3) | 2, (3 << 6) | (0 << 3) | 1,
          (4 << 6) | (0 << 3) | 0],
         [(1 << 6) | (3 << 3) | 0, (2 << 6) | (0 << 3) | 4, (2 << 6) | (5 << 3) | 7,
          (5 << 6) | (1 << 3) | 0])
_DISTS = ([0, 1, 3, 16], [4, 17, 21, 40])


def _stream_block_types():
    """Two block types in each category, NPOSTFIX 1, NDIRECT 4, a literal
    context map with RLE and IMTF, context modes 1 and 2, a distance
    context map over two trees; commands with implicit distances, ring
    codes, direct codes and postfix codes, and all four block-type
    switch symbols. The writer mirrors the decoder's block switches and
    distances and picks only commands the decoder accepts; the literal
    trees share one shape, so each literal is any two bits."""
    rng = np.random.default_rng(11)
    npostfix, ndirect = 1, 2 << 1
    body = _Bits()
    tables, state = {}, {}
    for cat in ("L", "I", "D"):
        _varlen(body, 1)     # NBLTYPES 2
        tables[cat + "type"] = _simple(body, [0, 1, 2, 3], 4)
        tables[cat + "count"] = _simple(body, [0, 1], 26)
        state[cat] = [0, 1, 3]              # type, previous type, count left
        sym, extra, nb = _count_code(3)
        _sym(body, tables[cat + "count"], sym)
        body.put(extra, nb)
    body.put(npostfix, 2)
    body.put(ndirect >> npostfix, 4)
    body.put(1, 2)           # context mode of literal type 0: MSB6
    body.put(2, 2)           # type 1: UTF8
    _varlen(body, 1)         # NTREESL 2
    body.put(1, 1)           # use_rle
    body.put(1, 4)           # rlemax 2
    cm = _simple(body, [0, 1, 2, 3], 4)
    filled = 0
    while filled < 128:
        pick = int(rng.integers(0, 4))
        if pick == 1 and filled + 3 <= 128:
            _sym(body, cm, 1)
            body.put(1, 1)
            filled += 3
        elif pick == 2 and filled + 7 <= 128:
            _sym(body, cm, 2)
            body.put(3, 2)
            filled += 7
        elif pick in (0, 3):
            _sym(body, cm, pick)
            filled += 1
    body.put(1, 1)           # IMTF
    _varlen(body, 1)         # NTREESD 2
    body.put(0, 1)           # no RLE
    dm = _simple(body, [0, 1], 2)
    cmap_d = [1, 0, 1, 1, 0, 0, 1, 0]
    for v in cmap_d:
        _sym(body, dm, v)
    body.put(0, 1)           # no IMTF
    for syms in ("abcd", "wxyz"):
        _simple(body, [ord(c) for c in syms], 256)
    cmd_tables = [_simple(body, c, 704, tree=t) for t, c in enumerate(_CMDS)]
    dist_alpha = 16 + ndirect + (48 << npostfix)
    dist_tables = [_simple(body, d, dist_alpha) for d in _DISTS]

    def switch(cat, turn):
        st = state[cat]
        if st[2] == 0:
            sym = turn % 4
            _sym(body, tables[cat + "type"], sym)
            new = st[1] if sym == 0 else (st[0] + 1) % 2 if sym == 1 else sym - 2
            st[0], st[1] = new, st[0]
            c = 1 + turn % 8
            sym, extra, nb = _count_code(c)
            _sym(body, tables[cat + "count"], sym)
            body.put(extra, nb)
            st[2] = c
        st[2] -= 1
        return st[0]

    def distance(dcode, ring, extra):
        ridx = ring[4]
        if dcode < 4:
            return ring[(ridx + 3 - dcode) & 3], 0
        if dcode < 16:
            base = ring[(ridx + 3) & 3] if dcode < 10 else ring[(ridx + 2) & 3]
            k = dcode - 4 if dcode < 10 else dcode - 10
            return (base + 1 + (k >> 1) if k & 1 else base - 1 - (k >> 1)), 0
        if dcode < 16 + ndirect:
            return dcode - 15, 0
        x = dcode - ndirect - 16
        hcode, lcode = x >> npostfix, x & 1
        nbits = 1 + (hcode >> 1)
        e = extra % (1 << nbits)
        return ((((2 + (hcode & 1)) << nbits) - 4 + e) << npostfix) + lcode + ndirect + 1, nbits

    ring = [16, 15, 11, 4, 0]
    out_len = 0
    for turn in range(60):
        t = switch("I", turn)
        done = False
        for k in range(4):
            sym = _CMDS[t][(turn + k) % 4]
            cell = jdec._CMD_CELLS[sym >> 6]
            ic, cc = cell[0] + ((sym >> 3) & 7), cell[1] + (sym & 7)
            ilen, clen = jdec.INSERT_BASE[ic], jdec.COPY_BASE[cc]
            avail = out_len + ilen
            if cell[2]:
                if ring[(ring[4] + 3) & 3] <= avail:
                    done = True
                    break
                continue
            # the distance block type this command will switch to
            st = state["D"]
            dt = ((st[1] if turn % 4 == 0 else (st[0] + 1) % 2 if turn % 4 == 1
                   else turn % 4 - 2) if st[2] == 0 else st[0])
            tree = cmap_d[4 * dt + min(clen - 2, 3)]
            extra = int(rng.integers(0, 1 << 20))
            opts = [d for d in _DISTS[tree] if 0 < distance(d, ring, extra)[0] <= avail]
            if opts:
                done = True
                break
        if not done:
            break
        _sym(body, cmd_tables[t], sym)
        body.put(0, jdec.INSERT_EXTRA[ic])
        body.put(0, jdec.COPY_EXTRA[cc])
        for _ in range(ilen):
            switch("L", turn)
            body.put(int(rng.integers(0, 4)), 2)
        out_len += ilen
        if cell[2]:
            dcode = 0
        else:
            assert switch("D", turn) == dt
            dcode = opts[turn % len(opts)]
            _sym(body, dist_tables[tree], dcode)
            dist, nbits = distance(dcode, ring, extra)
            body.put(extra, nbits)
            if dcode != 0:
                ring[ring[4] & 3] = dist
                ring[4] = (ring[4] + 1) & 3
        out_len += clen
    w = _Bits()
    w.put(1, 1)
    w.put(0, 3)
    w.put(0, 3)              # WBITS 17
    _header(w, out_len, 1)
    w.put(body.v, body.n)
    return w.bytes()


STREAMS = {
    "stored_and_metadata": _stream_stored_and_metadata,
    "block_types": _stream_block_types,
    **{f"dictionary_t{t}": (lambda t=t: _stream_dictionary(t))
       for t in (0, 3, 9, 10, 11, 12, 20, 44, 68, 120)},
    "dictionary_len4": lambda: _stream_dictionary(1, length=4, index=1000),
    "dictionary_len24": lambda: _stream_dictionary(2, length=24, index=30),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_built_streams_decode_as_tpu7z(name):
    stream = STREAMS[name]()
    want = jdec.decompress(stream)
    assert len(want) > 0
    assert tdec.decompress(stream) == want


@pytest.mark.parametrize("name", ["stored_and_metadata", "block_types", "dictionary_t10"])
def test_built_streams_broken_fail_as_tpu7z(name):
    """Every prefix, and every bit flipped: the same bytes or the same
    error class and message."""
    stream = STREAMS[name]()
    for cut in range(len(stream)):
        assert _outcome(tdec.decompress, stream[:cut]) == \
            _outcome(jdec.decompress, stream[:cut]), cut
    for bit in range(8 * len(stream)):
        bad = bytearray(stream)
        bad[bit >> 3] ^= 1 << (bit & 7)
        bad = bytes(bad)
        assert _outcome(tdec.decompress, bad) == _outcome(jdec.decompress, bad), bit


def test_port_streams_broken_fail_as_tpu7z(corpus):
    """tpu7z's own q5 and q10 streams of 4 KiB, cut and flipped."""
    rng = np.random.default_rng(3)
    for q in (5, 10):
        stream = jbr.compress(_input(corpus, "text4k"), q)
        for cut in rng.integers(0, len(stream), 40):
            assert _outcome(tdec.decompress, stream[:cut]) == \
                _outcome(jdec.decompress, stream[:cut])
        for bit in rng.integers(0, 8 * len(stream), 120):
            bad = bytearray(stream)
            bad[bit >> 3] ^= 1 << (bit & 7)
            bad = bytes(bad)
            assert _outcome(tdec.decompress, bad) == _outcome(jdec.decompress, bad)


def test_invalid_window_bits_and_output_limit():
    for stream in (bytes([0b0010001]), bytes([0b0000001, 0])):
        assert _outcome(tdec.decompress, stream) == _outcome(jdec.decompress, stream)
    stream = jbr.compress(b"abcabcabc" * 50, 5)
    assert _outcome(lambda s: tdec.decompress(s, max_out=100), stream) == \
        _outcome(lambda s: jdec.decompress(s, max_out=100), stream) == \
        ("CorruptError", "brotli: output limit exceeded")


def test_encoder_runs_on_the_card_unless_told():
    """`device` defaults to the card; with none, the call raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="none is available"):
        tbr.compress(b"abc" * 100, 5)

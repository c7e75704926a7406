"""CRAM 3.0 codec layer: rANS 4x8, Huffman, beta, byte-array codecs
(counterpart of seqlib_tpu/io/cram_codecs.py).

The codecs a CRAM 3.0 reader needs (CRAM specification sections 12-13),
and the ITF8/LTF8 varints they and the container layer share:

* rANS 4x8 (compression method 4): order-0 and order-1 decode,
  order-0 encode, byte-oriented renormalisation, TOTFREQ 4096,
  4 interleaved states, htscodecs ``rans_static`` stream layout
  (order byte, compressed/uncompressed sizes, RLE frequency tables,
  4 little-endian u32 seed states).
* HUFFMAN integer codec (canonical codes; the common degenerate
  zero-bit single-symbol form used by htslib for constant series).
* BETA (fixed-width big-endian bits with offset).
* EXTERNAL (ITF8 or byte streams from external blocks).
* BYTE_ARRAY_LEN / BYTE_ARRAY_STOP for variable byte arrays.

Host code: CRAM is a sequential byte format.
"""

from __future__ import annotations

import struct

TOTFREQ = 4096
RANS_BYTE_L = 1 << 23


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------

def write_itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF,
                      (v >> 8) & 0xFF, v & 0xFF])
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF,
                  (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def read_itf8(buf: bytes, off: int) -> tuple[int, int]:
    b0 = buf[off]
    if b0 < 0x80:
        return b0, off + 1
    if b0 < 0xC0:
        return ((b0 & 0x7F) << 8) | buf[off + 1], off + 2
    if b0 < 0xE0:
        return ((b0 & 0x3F) << 16) | (buf[off + 1] << 8) | buf[off + 2], \
            off + 3
    if b0 < 0xF0:
        return ((b0 & 0x1F) << 24) | (buf[off + 1] << 16) \
            | (buf[off + 2] << 8) | buf[off + 3], off + 4
    v = ((b0 & 0x0F) << 28) | (buf[off + 1] << 20) | (buf[off + 2] << 12) \
        | (buf[off + 3] << 4) | (buf[off + 4] & 0x0F)
    return v, off + 5


def write_ltf8(v: int) -> bytes:
    v &= 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        return bytes([v])
    # encode with k leading 1-bits
    for k in range(1, 9):
        if v < (1 << (7 - k + 8 * k)) or k == 8:
            prefix = (0xFF << (8 - k)) & 0xFF
            body = v.to_bytes(k + 1, "big") if k < 8 \
                else v.to_bytes(8, "big")
            if k < 8:
                first = prefix | body[0]
                if k < 7 and body[0] >= (1 << (7 - k)):
                    continue
                return bytes([first]) + body[1:]
            return bytes([0xFF]) + body
    raise AssertionError


def read_ltf8(buf: bytes, off: int) -> tuple[int, int]:
    b0 = buf[off]
    k = 0
    while k < 8 and (b0 << k) & 0x80:
        k += 1
    if k == 0:
        return b0, off + 1
    if k == 8:
        return int.from_bytes(buf[off + 1:off + 9], "big"), off + 9
    v = b0 & (0x7F >> k)
    for i in range(k):
        v = (v << 8) | buf[off + 1 + i]
    return v, off + 1 + k


# ---------------------------------------------------------------------------
# rANS 4x8 (CRAM compression method 4)
# ---------------------------------------------------------------------------

def _write_freqs(freqs: dict[int, int]) -> bytes:
    """RLE frequency table (htscodecs rans_static order-0 layout)."""
    out = bytearray()
    syms = sorted(freqs)
    present = [False] * 256
    for s in syms:
        present[s] = True
    rle = 0
    for j in range(256):
        if not present[j]:
            continue
        f = freqs[j]
        if rle:
            rle -= 1
        else:
            out.append(j)
            if j and present[j - 1]:
                # run of consecutive symbols follows
                k = j + 1
                while k < 256 and present[k]:
                    k += 1
                rle = k - j - 1
                out.append(rle)
        if f < 128:
            out.append(f)
        else:
            out.append(128 | (f >> 8))
            out.append(f & 0xFF)
    out.append(0)
    return bytes(out)


def _read_freqs(buf: bytes, off: int) -> tuple[list[int], int]:
    """Inverse of _write_freqs -> (256 freqs, new offset)."""
    F = [0] * 256
    j = buf[off]; off += 1
    rle = 0
    while True:
        f = buf[off]; off += 1
        if f >= 128:
            f = ((f & 127) << 8) | buf[off]; off += 1
        F[j] = f
        if rle:
            rle -= 1
            j += 1
        else:
            nj = buf[off]; off += 1
            if nj == j + 1:
                rle = buf[off]; off += 1
            j = nj
        if j == 0 and rle == 0:
            break
    return F, off


def _normalise(hist: list[int], total: int = TOTFREQ) -> dict[int, int]:
    n = sum(hist)
    out = {}
    if n == 0:
        return out
    acc = 0
    last = None
    for s in range(256):
        if hist[s]:
            f = max(1, hist[s] * total // n)
            out[s] = f
            acc += f
            last = s
    out[last] += total - acc
    if out[last] <= 0:
        # steal from the largest
        need = 1 - out[last]
        big = max(out, key=lambda k: out[k])
        out[big] -= need
        out[last] = 1
    return out


def rans_encode_o0(data: bytes) -> bytes:
    """Order-0 rANS 4x8 encode (htscodecs-compatible stream)."""
    n = len(data)
    if n == 0:
        body = b"\x00\x00\x00\x00" * 4
        return b"\x00" + struct.pack("<II", len(body), 0) + body
    hist = [0] * 256
    for b in data:
        hist[b] += 1
    freqs = _normalise(hist)
    # cumulative table
    C = {}
    acc = 0
    for s in sorted(freqs):
        C[s] = acc
        acc += freqs[s]
    ftab = _write_freqs(freqs)

    out = bytearray()          # built backward
    states = [RANS_BYTE_L] * 4

    def put(si, sym):
        x = states[si]
        f = freqs[sym]
        x_max = ((RANS_BYTE_L >> 12) << 8) * f
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        states[si] = ((x // f) << 12) + (x % f) + C[sym]

    # encode backward; byte i is handled by state i & 3
    for i in range(n - 1, -1, -1):
        put(i & 3, data[i])
    # htscodecs flushes r3 first into a backward-built buffer, so the
    # forward stream carries r0, r1, r2, r3 then the rans bytes
    head = b"".join(struct.pack("<I", states[si]) for si in range(4))
    comp = head + bytes(reversed(out))
    return b"\x00" + struct.pack("<II", len(comp) + len(ftab),
                                 n) + ftab + comp


def _dec_tables(F: list[int]):
    """symbol-at-slot and cumulative tables for decode."""
    C = [0] * 257
    for s in range(256):
        C[s + 1] = C[s] + F[s]
    slot = bytearray(TOTFREQ)
    for s in range(256):
        if F[s]:
            slot[C[s]:C[s + 1]] = bytes([s]) * F[s]
    return C, bytes(slot)


def rans_decode(buf: bytes) -> bytes:
    """Decode an rANS 4x8 stream (order 0 or 1)."""
    order = buf[0]
    comp_sz, n_out = struct.unpack_from("<II", buf, 1)
    off = 9
    if n_out == 0:
        return b""
    if order == 0:
        F, off = _read_freqs(buf, off)
        C, slot = _dec_tables(F)
        states = list(struct.unpack_from("<4I", buf, off))
        off += 16
        out = bytearray(n_out)
        for i in range(n_out):
            si = i & 3
            x = states[si]
            lo = x & (TOTFREQ - 1)
            s = slot[lo]
            out[i] = s
            x = F[s] * (x >> 12) + lo - C[s]
            while x < RANS_BYTE_L and off < len(buf):
                x = (x << 8) | buf[off]
                off += 1
            states[si] = x
        return bytes(out)
    # order-1: context tables, 4 states each decoding a quarter
    # frequency tables: outer RLE over contexts, inner per context
    F1 = {}
    i = buf[off]; off += 1
    rle_i = 0
    while True:
        Fi, off = _read_freqs(buf, off)
        F1[i] = Fi
        if rle_i:
            rle_i -= 1
            i += 1
        else:
            ni = buf[off]; off += 1
            if ni == i + 1:
                rle_i = buf[off]; off += 1
            i = ni
        if i == 0 and rle_i == 0:
            break
    tabs = {c: _dec_tables(Fq) for c, Fq in F1.items()}
    states = list(struct.unpack_from("<4I", buf, off))
    off += 16
    out = bytearray(n_out)
    nq = n_out >> 2
    last = [0, 0, 0, 0]
    ptr = off

    def advance(si, pos):
        nonlocal ptr
        x = states[si]
        ctx = last[si]
        F = F1.get(ctx)
        if F is None:
            F = [0] * 256
            F[0] = TOTFREQ
            Ctab, slot = _dec_tables(F)
        else:
            Ctab, slot = tabs[ctx]
        lo = x & (TOTFREQ - 1)
        s = slot[lo]
        out[pos] = s
        x = F[s] * (x >> 12) + lo - Ctab[s]
        while x < RANS_BYTE_L and ptr < len(buf):
            x = (x << 8) | buf[ptr]
            ptr += 1
        states[si] = x
        last[si] = s

    for k in range(nq):
        for si in range(4):
            advance(si, si * nq + k)
    # remainder handled by state 3 continuing past its quarter
    for pos in range(4 * nq, n_out):
        advance(3, pos)
    return bytes(out)


# ---------------------------------------------------------------------------
# bit reader / writer (for HUFFMAN and BETA core codecs)
# ---------------------------------------------------------------------------

class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0           # bit position

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v


class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.bit = 0

    def write(self, v: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            if self.bit == 0:
                self.buf.append(0)
            if (v >> k) & 1:
                self.buf[-1] |= 1 << (7 - self.bit)
            self.bit = (self.bit + 1) & 7

    def getvalue(self) -> bytes:
        return bytes(self.buf)


# ---------------------------------------------------------------------------
# core codecs (driven by the compression-header encoding map)
# ---------------------------------------------------------------------------

class Codec:
    """One data-series codec instance.

    codec id (CRAM 3.0): 0 NULL, 1 EXTERNAL, 3 HUFFMAN, 4
    BYTE_ARRAY_LEN, 5 BYTE_ARRAY_STOP, 6 BETA, 7 SUBEXP, 9 GAMMA.
    """

    def __init__(self, codec_id: int, params: bytes):
        self.id = codec_id
        p = params
        o = 0
        if codec_id == 0:      # NULL
            pass
        elif codec_id == 1:    # EXTERNAL
            self.content_id, o = read_itf8(p, o)
        elif codec_id == 3:    # HUFFMAN
            n, o = read_itf8(p, o)
            self.alphabet = []
            for _ in range(n):
                v, o = read_itf8(p, o)
                self.alphabet.append(v)
            n2, o = read_itf8(p, o)
            self.lengths = []
            for _ in range(n2):
                v, o = read_itf8(p, o)
                self.lengths.append(v)
            self._build_huffman()
        elif codec_id == 4:    # BYTE_ARRAY_LEN
            ln_id, o = read_itf8(p, o)
            ln_params_len, o = read_itf8(p, o)
            self.len_codec = Codec(ln_id, p[o:o + ln_params_len])
            o += ln_params_len
            v_id, o = read_itf8(p, o)
            v_params_len, o = read_itf8(p, o)
            self.val_codec = Codec(v_id, p[o:o + v_params_len])
            o += v_params_len
        elif codec_id == 5:    # BYTE_ARRAY_STOP
            self.stop = p[0]
            o = 1
            self.content_id, o = read_itf8(p, o)
        elif codec_id == 6:    # BETA
            self.offset, o = read_itf8(p, o)
            self.nbits, o = read_itf8(p, o)
        else:
            raise NotImplementedError(f"CRAM codec id {codec_id}")

    def _build_huffman(self):
        # canonical codes from (symbol, length) sorted by (len, symbol)
        pairs = sorted(zip(self.lengths, self.alphabet))
        self.codes = {}
        code = 0
        prev_len = 0
        for ln, sym in pairs:
            code <<= (ln - prev_len)
            self.codes[sym] = (code, ln)
            code += 1
            prev_len = ln
        # decode table: (len, code) -> symbol
        self.dec = {(ln, c): s for s, (c, ln) in self.codes.items()}
        self.zero_bit = (len(self.alphabet) == 1
                         and self.lengths[0] == 0)

    # -- decode ----------------------------------------------------------

    def read_int(self, core: BitReader, ext: dict[int, "ByteStream"]
                 ) -> int:
        if self.id == 1:
            return ext[self.content_id].read_itf8()
        if self.id == 3:
            if self.zero_bit:
                return self.alphabet[0]
            code, ln = 0, 0
            while True:
                code = (code << 1) | core.read(1)
                ln += 1
                s = self.dec.get((ln, code))
                if s is not None:
                    return s
                if ln > 31:
                    raise ValueError("bad huffman stream")
        if self.id == 6:
            return core.read(self.nbits) - self.offset
        raise NotImplementedError(f"read_int for codec {self.id}")

    def read_byte(self, core: BitReader, ext) -> int:
        if self.id == 1:
            return ext[self.content_id].read_byte()
        return self.read_int(core, ext)

    def read_bytes(self, n: int, core: BitReader, ext) -> bytes:
        if self.id == 1:
            return ext[self.content_id].read_bytes(n)
        if self.id == 4:
            ln = self.len_codec.read_int(core, ext)
            return bytes(self.val_codec.read_byte(core, ext)
                         for _ in range(ln))
        if self.id == 5:
            return ext[self.content_id].read_until(self.stop)
        raise NotImplementedError(f"read_bytes for codec {self.id}")

    def read_array(self, core: BitReader, ext) -> bytes:
        """Length-carrying byte array (BYTE_ARRAY_LEN/STOP)."""
        if self.id == 4:
            ln = self.len_codec.read_int(core, ext)
            v = self.val_codec
            if v.id == 1:
                return ext[v.content_id].read_bytes(ln)
            return bytes(v.read_byte(core, ext) for _ in range(ln))
        if self.id == 5:
            return ext[self.content_id].read_until(self.stop)
        raise NotImplementedError(f"read_array for codec {self.id}")


class ByteStream:
    """Sequential reader over one decompressed external block."""

    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def read_byte(self) -> int:
        b = self.data[self.off]
        self.off += 1
        return b

    def read_bytes(self, n: int) -> bytes:
        b = self.data[self.off:self.off + n]
        self.off += n
        return b

    def read_until(self, stop: int) -> bytes:
        i = self.data.index(stop, self.off)
        out = self.data[self.off:i]
        self.off = i + 1
        return out

    def read_itf8(self) -> int:
        v, self.off = read_itf8(self.data, self.off)
        return v


# -- encoding parameters (writer side) --------------------------------------

def enc_external(content_id: int) -> tuple[int, bytes]:
    return 1, write_itf8(content_id)


def enc_huffman_const(value: int) -> tuple[int, bytes]:
    return 3, (write_itf8(1) + write_itf8(value)
               + write_itf8(1) + write_itf8(0))


def enc_byte_array_stop(stop: int, content_id: int) -> tuple[int, bytes]:
    return 5, bytes([stop]) + write_itf8(content_id)


def enc_byte_array_len_ext(len_id: int, val_id: int) -> tuple[int, bytes]:
    li, lp = enc_external(len_id)
    vi, vp = enc_external(val_id)
    return 4, (write_itf8(li) + write_itf8(len(lp)) + lp
               + write_itf8(vi) + write_itf8(len(vp)) + vp)

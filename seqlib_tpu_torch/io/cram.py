"""CRAM 3.0 container + record I/O (counterpart of seqlib_tpu/io/cram.py).

SeqLib's CRAM capability (``BamWriter(SeqLib::CRAM)``, which HTSlib's
CRAM codec serves there).

Container model per the CRAM 3.0 spec: file definition, ITF8/LTF8
varints, containers with landmarks + CRC32, blocks with gzip/bzip2/
lzma/rANS-4x8 compression methods, SAM-header container, canonical EOF
container.  Records use the spec's self-describing layout: a
compression header carrying preservation / data-series / tag encoding
maps, slice header blocks, and the standard data series (BF CF RI RL
AP RG RN MF NS NP TS TL FN FC FP + feature payload series), with read
bases carried by features (reference-free profile, RR=0).  The READER
is driven entirely by the file's encoding maps (EXTERNAL, HUFFMAN,
BETA, BYTE_ARRAY_LEN, BYTE_ARRAY_STOP codecs; rANS order-0/1 blocks),
i.e. it decodes spec-conformant files rather than a private layout;
the codec layer follows the public spec and htscodecs stream formats
(io/cram_codecs.py).  The file definition names ``seqlib_tpu`` as the
writer, as the JAX package's does, so both write the same bytes.
"""

from __future__ import annotations

import bz2
import gzip
import hashlib
import lzma
import os
import struct
import zlib

import numpy as np

from ..core.cigar import Cigar, CigarField
from ..core.header import BamHeader
from ..core.record import BamRecord
from .cram_codecs import (BitReader, ByteStream, Codec,
                          enc_byte_array_len_ext, enc_byte_array_stop,
                          enc_external, rans_decode, rans_encode_o0,
                          read_itf8, read_ltf8, write_itf8, write_ltf8)
from .refgenome import RefGenome

CRAM_MAGIC = b"CRAM\x03\x00"

# canonical CRAM 3.0 EOF container (spec section 9)
CRAM_EOF = bytes.fromhex(
    "0f000000ffffffff0fe045" "4f4600000000010005bdd94f" "0001000606"
    "01000100010000ee63014b")


# ---------------------------------------------------------------------------
# blocks / containers
# ---------------------------------------------------------------------------

RAW, GZIP, BZIP2, LZMA, RANS = 0, 1, 2, 3, 4
FILE_HEADER, COMPRESSION_HEADER, SLICE_HEADER, EXTERNAL = 0, 1, 2, 4


def write_block(method: int, ctype: int, content_id: int,
                data: bytes) -> bytes:
    raw_size = len(data)
    if method == GZIP:
        data = zlib.compress(data, 6)
    elif method == BZIP2:
        data = bz2.compress(data)
    elif method == LZMA:
        data = lzma.compress(data)
    elif method == RANS:
        data = rans_encode_o0(data)
    out = bytes([method, ctype]) + write_itf8(content_id) \
        + write_itf8(len(data)) + write_itf8(raw_size) + data
    return out + struct.pack("<I", zlib.crc32(out) & 0xFFFFFFFF)


def read_block(buf: bytes, off: int):
    start = off
    method, ctype = buf[off], buf[off + 1]
    off += 2
    content_id, off = read_itf8(buf, off)
    csize, off = read_itf8(buf, off)
    rsize, off = read_itf8(buf, off)
    data = buf[off:off + csize]
    off += csize
    crc = struct.unpack_from("<I", buf, off)[0]
    if crc != zlib.crc32(buf[start:off]) & 0xFFFFFFFF:
        raise ValueError("CRAM: block CRC mismatch")
    off += 4
    if method == GZIP:
        data = zlib.decompress(data)
    elif method == BZIP2:
        data = bz2.decompress(data)
    elif method == LZMA:
        data = lzma.decompress(data)
    elif method == RANS:
        data = rans_decode(data)
    if len(data) != rsize:
        raise ValueError("CRAM: block size mismatch")
    return dict(method=method, ctype=ctype, content_id=content_id,
                data=data), off


def write_container(blocks: list[bytes], ref_id: int = -2, start: int = 0,
                    span: int = 0, n_records: int = 0,
                    counter: int = 0, bases: int = 0) -> bytes:
    body = b"".join(blocks)
    landmarks = []
    pos = 0
    for b in blocks:
        landmarks.append(pos)
        pos += len(b)
    hdr = (write_itf8(ref_id & 0xFFFFFFFF) + write_itf8(start)
           + write_itf8(span) + write_itf8(n_records)
           + write_ltf8(counter) + write_ltf8(bases)
           + write_itf8(len(blocks)) + write_itf8(len(landmarks))
           + b"".join(write_itf8(l) for l in landmarks))
    hdr_with_len = struct.pack("<i", len(body)) + hdr
    crc = zlib.crc32(hdr_with_len) & 0xFFFFFFFF
    return hdr_with_len + struct.pack("<I", crc) + body


def read_container_header(fh):
    raw = fh.read(4)
    if len(raw) < 4:
        return None
    (length,) = struct.unpack("<i", raw)
    # read varint fields byte-wise
    rest = fh.read(64)  # enough for the header fields
    buf = raw + rest
    off = 4
    ref_id, off = read_itf8(buf, off)
    start, off = read_itf8(buf, off)
    span, off = read_itf8(buf, off)
    n_records, off = read_itf8(buf, off)
    counter, off = read_ltf8(buf, off)
    bases, off = read_ltf8(buf, off)
    n_blocks, off = read_itf8(buf, off)
    n_land, off = read_itf8(buf, off)
    landmarks = []
    for _ in range(n_land):
        if off + 5 > len(buf):
            buf += fh.read(64)
        v, off = read_itf8(buf, off)
        landmarks.append(v)
    off += 4  # crc
    # rewind extra bytes
    fh.seek(off - len(buf), 1)
    if ref_id >= 0x80000000:
        ref_id -= 0x100000000
    return dict(length=length, ref_id=ref_id, start=start, span=span,
                n_records=n_records, counter=counter, bases=bases,
                n_blocks=n_blocks)


# ---------------------------------------------------------------------------
# compression header / slice header / record codec (CRAM 3.0 spec)
# ---------------------------------------------------------------------------

CORE = 5

# fixed external content ids for the data series this writer emits
_DS_IDS = {k: i + 1 for i, k in enumerate(
    ["BF", "CF", "RI", "RL", "AP", "RG", "RN", "MF", "NS", "NP", "TS",
     "NF", "TL", "FN", "FC", "FP", "DL", "RS", "PD", "HC", "MQ", "BA",
     "QS", "SC", "IN", "BB", "BBL", "BS"])}

_DEFAULT_SM = bytes([0x1B, 0x1B, 0x1B, 0x1B, 0x1B])


def _tag_key(tag: str, typ: str) -> int:
    return (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)


def _bam_tag_bytes(typ: str, val) -> bytes:
    if typ == "A":
        return val.encode() if isinstance(val, str) else bytes([val])
    if typ in "cC":
        return struct.pack("<B" if typ == "C" else "<b", int(val))
    if typ in "sS":
        return struct.pack("<H" if typ == "S" else "<h", int(val))
    if typ in "iI":
        return struct.pack("<I" if typ == "I" else "<i",
                           int(val) & 0xFFFFFFFF if typ == "I"
                           else int(val))
    if typ == "f":
        return struct.pack("<f", float(val))
    if typ in "ZH":
        return str(val).encode() + b"\x00"
    raise ValueError(f"unsupported tag type {typ}")


def _bam_tag_parse(typ: str, data: bytes):
    if typ == "A":
        return data[:1].decode()
    if typ == "c":
        return struct.unpack("<b", data[:1])[0]
    if typ == "C":
        return data[0]
    if typ == "s":
        return struct.unpack("<h", data[:2])[0]
    if typ == "S":
        return struct.unpack("<H", data[:2])[0]
    if typ == "i":
        return struct.unpack("<i", data[:4])[0]
    if typ == "I":
        return struct.unpack("<I", data[:4])[0]
    if typ == "f":
        return struct.unpack("<f", data[:4])[0]
    return data.rstrip(b"\x00").decode()


def _write_map(entries: list[tuple[bytes, bytes]]) -> bytes:
    body = b"".join(k + v for k, v in entries)
    inner = write_itf8(len(entries)) + body
    return write_itf8(len(inner)) + inner


def _enc_bytes(codec_id: int, params: bytes) -> bytes:
    return write_itf8(codec_id) + write_itf8(len(params)) + params


def build_compression_header(tag_lines: list[list[tuple[str, str]]],
                             rr: bool = False) -> bytes:
    """Preservation map + data-series encodings + tag encodings.

    Two writer profiles (spec section 8.4): reference-free (RR=0, all
    bases carried by 'b' features) and reference-based (RR=1, bases
    implicit from the reference with X/BS substitution features —
    htslib's default profile, which SeqLib gets from
    hts_set_fai_filename)."""
    pres = [
        (b"RN", b"\x01"),            # read names preserved
        (b"AP", b"\x00"),            # AP not delta-encoded
        (b"RR", b"\x01" if rr else b"\x00"),
        (b"SM", _DEFAULT_SM),
        (b"TD", (lambda td: write_itf8(len(td)) + td)(
            b"".join(b"".join(t.encode() + y.encode()
                              for t, y in line) + b"\x00"
                     for line in tag_lines))),
    ]
    ds = []
    keys = ["BF", "CF", "RI", "RL", "AP", "RG", "MF", "NS", "NP",
            "TS", "NF", "TL", "FN", "FP", "DL", "RS", "PD", "HC",
            "MQ"] + (["BS"] if rr else [])
    for key in keys:
        cid, params = enc_external(_DS_IDS[key])
        ds.append((key.encode(), _enc_bytes(cid, params)))
    for key in ["BA", "QS", "FC"]:
        cid, params = enc_external(_DS_IDS[key])
        ds.append((key.encode(), _enc_bytes(cid, params)))
    cid, params = enc_byte_array_stop(0x00, _DS_IDS["RN"])
    ds.append((b"RN", _enc_bytes(cid, params)))
    cid, params = enc_byte_array_stop(0x00, _DS_IDS["SC"])
    ds.append((b"SC", _enc_bytes(cid, params)))
    cid, params = enc_byte_array_stop(0x00, _DS_IDS["IN"])
    ds.append((b"IN", _enc_bytes(cid, params)))
    cid, params = enc_byte_array_len_ext(_DS_IDS["BBL"], _DS_IDS["BB"])
    ds.append((b"BB", _enc_bytes(cid, params)))
    tags = []
    seen = set()
    for line in tag_lines:
        for t, y in line:
            k = _tag_key(t, y)
            if k in seen:
                continue
            seen.add(k)
            cid, params = enc_byte_array_len_ext(k, k)
            tags.append((write_itf8(k), _enc_bytes(cid, params)))
    return _write_map(pres) + _write_map(ds) + _write_map(tags)


class CompressionHeader:
    """Parsed compression header: preservation flags, per-series and
    per-tag Codec instances (self-describing decode)."""

    def __init__(self, data: bytes):
        off = 0
        self.rn = True
        self.ap_delta = False
        self.rr = True
        self.sm = _DEFAULT_SM
        self.td: list[list[tuple[str, str]]] = [[]]
        # preservation map
        _, off = read_itf8(data, off)
        n, off = read_itf8(data, off)
        for _ in range(n):
            key = data[off:off + 2]; off += 2
            if key == b"RN":
                self.rn = bool(data[off]); off += 1
            elif key == b"AP":
                self.ap_delta = bool(data[off]); off += 1
            elif key == b"RR":
                self.rr = bool(data[off]); off += 1
            elif key == b"SM":
                self.sm = data[off:off + 5]; off += 5
            elif key == b"TD":
                ln, off = read_itf8(data, off)
                raw = data[off:off + ln]; off += ln
                self.td = []
                lines = raw.split(b"\x00")
                if raw.endswith(b"\x00"):
                    lines = lines[:-1]
                for line in lines:
                    trips = [(line[i:i + 2].decode(),
                              chr(line[i + 2]))
                             for i in range(0, len(line), 3)]
                    self.td.append(trips)
                if not self.td:
                    self.td = [[]]
            else:
                raise ValueError(f"unknown preservation key {key}")
        # data series encodings
        _, off = read_itf8(data, off)
        n, off = read_itf8(data, off)
        self.series: dict[str, Codec] = {}
        for _ in range(n):
            key = data[off:off + 2].decode(); off += 2
            cid, off = read_itf8(data, off)
            plen, off = read_itf8(data, off)
            self.series[key] = Codec(cid, data[off:off + plen])
            off += plen
        # tag encodings
        _, off = read_itf8(data, off)
        n, off = read_itf8(data, off)
        self.tags: dict[int, Codec] = {}
        for _ in range(n):
            k, off = read_itf8(data, off)
            cid, off = read_itf8(data, off)
            plen, off = read_itf8(data, off)
            self.tags[k] = Codec(cid, data[off:off + plen])
            off += plen


def write_slice_header(ref_id: int, start: int, span: int, n_rec: int,
                       counter: int, content_ids: list[int],
                       md5: bytes = b"\x00" * 16) -> bytes:
    body = (write_itf8(ref_id & 0xFFFFFFFF) + write_itf8(start)
            + write_itf8(span) + write_itf8(n_rec)
            + write_ltf8(counter) + write_itf8(len(content_ids))
            + b"".join(write_itf8(c) for c in content_ids)
            + write_itf8(0xFFFFFFFF)     # embedded ref block id = -1
            + md5)                       # reference-span MD5
    return body


def read_slice_header(data: bytes):
    off = 0
    ref_id, off = read_itf8(data, off)
    start, off = read_itf8(data, off)
    span, off = read_itf8(data, off)
    n_rec, off = read_itf8(data, off)
    counter, off = read_ltf8(data, off)
    n_ids, off = read_itf8(data, off)
    ids = []
    for _ in range(n_ids):
        v, off = read_itf8(data, off)
        ids.append(v)
    emb, off = read_itf8(data, off)
    return dict(ref_id=_u2i(ref_id), start=start, span=span,
                n_rec=n_rec, counter=counter, content_ids=ids,
                embedded_ref_id=_u2i(emb))


def _u2i(v: int) -> int:
    return v - 0x100000000 if v >= 0x80000000 else v


_CIGAR_FEAT = {"I": "I", "D": "D", "S": "S", "N": "N", "H": "H",
               "P": "P"}

# ---------------------------------------------------------------------------
# reference plumbing (RR=1 profile)
# ---------------------------------------------------------------------------

_BASES = "ACGTN"


def _sm_sub_base(sm: bytes, ref_base: int, code: int) -> int:
    """Decode a BS substitution code (spec section 10.2): the SM byte
    for reference base r packs 2-bit codes for the 4 alternative bases
    in ACGTN-minus-r order (first alternative in bits 7..6); the read
    base is the alternative whose packed code equals ``code``."""
    r = chr(ref_base).upper()
    ri = _BASES.find(r)
    if ri < 0:
        ri = 4
    byte = sm[ri]
    k = 0
    for b in _BASES:
        if b == _BASES[ri]:
            continue
        if (byte >> (6 - 2 * k)) & 3 == code:
            return ord(b)
        k += 1
    return ord("N")


def _sm_sub_code(sm: bytes, ref_base: str, read_base: str) -> int | None:
    """Encode: ref base + read base -> BS code, or None when the pair
    is not representable (non-ACGTN read base)."""
    ri = _BASES.find(ref_base.upper())
    if ri < 0:
        ri = 4
    rb = read_base.upper()
    byte = sm[ri]
    k = 0
    for b in _BASES:
        if b == _BASES[ri]:
            continue
        if b == rb:
            return (byte >> (6 - 2 * k)) & 3
        k += 1
    return None


def make_ref_get(reference, header: BamHeader):
    """Normalize a reference argument into ``ref_get(tid, pos0, ln) ->
    uppercase bytes`` (N-padded out of range).  Accepts a dict
    name->sequence, a FASTA path (faidx random access via RefGenome),
    or any object with ``query_region(name, p1, p2)``.

    SeqLib attaches a reference to HTSlib's CRAM codec with
    hts_set_fai_filename."""
    if reference is None:
        return None
    src = RefGenome(reference) if isinstance(reference, str) else reference

    cache: dict[int, bytes] = {}

    def fetch_contig(tid: int) -> bytes:
        seq = cache.get(tid)
        if seq is None:
            name = header.id2name(tid)
            if isinstance(src, dict):
                seq = src.get(name, "").upper().encode()
            else:
                n = src.get_sequence_length(name) \
                    if hasattr(src, "get_sequence_length") else -1
                seq = src.query_region(name, 0, n - 1).upper().encode() \
                    if n > 0 else b""
            cache[tid] = seq
        return seq

    def ref_get(tid: int, pos0: int, ln: int) -> bytes:
        if ln <= 0:
            return b""
        seq = fetch_contig(tid)
        lo = max(pos0, 0)
        hi = min(pos0 + ln, len(seq))
        body = seq[lo:hi] if hi > lo else b""
        return (b"N" * (lo - pos0) + body
                + b"N" * (ln - (lo - pos0) - len(body)))

    return ref_get


def _encode_records(recs: list[BamRecord], ref_get=None,
                    sm: bytes = _DEFAULT_SM):
    """Records -> (external block bytes by content id, tag_lines).

    With ``ref_get`` the reference-based profile is produced (RR=1):
    matching bases are implicit, substitutions become X/BS features,
    and only insert/clip bases are carried verbatim."""
    cols: dict[int, bytearray] = {i: bytearray()
                                  for i in _DS_IDS.values()}
    tag_lines: list[list[tuple[str, str]]] = []
    line_index: dict[tuple, int] = {}
    tag_cols: dict[int, bytearray] = {}

    def put(key, v):
        cols[_DS_IDS[key]] += write_itf8(v & 0xFFFFFFFF)

    for r in recs:
        seq = r.seq or ""
        put("BF", r.flag)
        cf = 2 | (1 if r.qual is not None else 0)   # detached, quals?
        put("CF", cf)
        put("RI", r.tid)
        put("RL", len(seq))
        put("AP", r.pos + 1)              # AP is 1-based (spec 10.3)
        put("RG", -1)
        cols[_DS_IDS["RN"]] += r.qname.encode() + b"\x00"
        mf = (1 if (r.flag & 0x20) else 0) | (2 if (r.flag & 0x8) else 0)
        put("MF", mf)
        put("NS", r.mtid)
        put("NP", r.mpos + 1)             # NP is 1-based (spec 10.3)
        put("TS", r.isize)
        line = tuple(sorted((t, ty) for t, (ty, v) in r.tags.items()))
        tl = line_index.get(line)
        if tl is None:
            tl = len(tag_lines)
            line_index[line] = tl
            tag_lines.append(list(line))
        put("TL", tl)
        for t, ty in tag_lines[tl]:
            v = r.tags[t][1]
            k = _tag_key(t, ty)
            col = tag_cols.setdefault(k, bytearray())
            data = _bam_tag_bytes(ty, v)
            col += write_itf8(len(data)) + data
        if r.flag & 0x4:                      # unmapped: BA verbatim
            cols[_DS_IDS["BA"]] += seq.encode()
        else:
            # features from CIGAR.  Reference-free: M runs carried by
            # 'b' features.  Reference-based (RR=1): matches implicit,
            # substitutions as X (BS code) or B (verbatim base+qual).
            feats = []                        # (fp_pos_1based, code, payload)
            qpos = 1
            refpos = r.pos                    # 0-based reference cursor
            fields = list(r.cigar)
            if ref_get is not None and not fields and seq:
                # mapped record without a CIGAR: carry bases verbatim
                feats.append((1, "b", seq))
            for field in fields:
                op, ln = field.type, field.length
                if op in ("M", "=", "X"):
                    if ref_get is None:
                        feats.append((qpos,
                                      "b", seq[qpos - 1:qpos - 1 + ln]))
                    else:
                        refseg = ref_get(r.tid, refpos, ln)
                        sseg = seq[qpos - 1:qpos - 1 + ln].upper()
                        for k in range(ln):
                            qb = sseg[k]
                            rb = chr(refseg[k])
                            if qb == rb:
                                continue      # implicit match
                            code = _sm_sub_code(sm, rb, qb)
                            if code is not None:
                                feats.append((qpos + k, "X", code))
                            else:             # exotic base: verbatim
                                qv = int(r.qual[qpos - 1 + k]) & 0xFF \
                                    if r.qual is not None else 0xFF
                                feats.append((qpos + k, "B",
                                              (ord(seq[qpos - 1 + k]),
                                               qv)))
                        refpos += ln
                    qpos += ln
                elif op == "I":
                    feats.append((qpos, "I", seq[qpos - 1:qpos - 1 + ln]))
                    qpos += ln
                elif op == "S":
                    feats.append((qpos, "S", seq[qpos - 1:qpos - 1 + ln]))
                    qpos += ln
                elif op == "D":
                    feats.append((qpos, "D", ln))
                    refpos += ln
                elif op == "N":
                    feats.append((qpos, "N", ln))
                    refpos += ln
                elif op == "H":
                    feats.append((qpos, "H", ln))
                elif op == "P":
                    feats.append((qpos, "P", ln))
            put("FN", len(feats))
            last = 0
            for fp, code, payload in feats:
                cols[_DS_IDS["FC"]].append(ord(code))
                put("FP", fp - last)
                last = fp
                if code == "b":
                    cols[_DS_IDS["BBL"]] += write_itf8(len(payload))
                    cols[_DS_IDS["BB"]] += payload.encode()
                elif code == "X":
                    cols[_DS_IDS["BS"]] += write_itf8(payload)
                elif code == "B":
                    ba, qv = payload
                    cols[_DS_IDS["BA"]].append(ba)
                    cols[_DS_IDS["QS"]].append(qv)
                elif code == "I":
                    cols[_DS_IDS["IN"]] += payload.encode() + b"\x00"
                elif code == "S":
                    cols[_DS_IDS["SC"]] += payload.encode() + b"\x00"
                elif code == "D":
                    cols[_DS_IDS["DL"]] += write_itf8(payload)
                elif code == "N":
                    cols[_DS_IDS["RS"]] += write_itf8(payload)
                elif code == "H":
                    cols[_DS_IDS["HC"]] += write_itf8(payload)
                elif code == "P":
                    cols[_DS_IDS["PD"]] += write_itf8(payload)
            put("MQ", r.mapq)
        if r.qual is not None:
            cols[_DS_IDS["QS"]] += bytes(
                int(q) & 0xFF for q in r.qual)
    blocks = {}
    for cid, col in cols.items():
        if col:
            blocks[cid] = bytes(col)
    for k, col in tag_cols.items():
        blocks[k] = bytes(col)
    return blocks, tag_lines


def _decode_records(ch: CompressionHeader, slc: dict,
                    ext: dict[int, bytes], core_data: bytes, ref_get=None,
                    embedded=None) -> list[BamRecord]:
    """Generic CRAM 3.0 record decode driven by the compression
    header's encoding maps (spec section 8.5).

    ``ref_get(tid, pos0, ln)`` supplies reference bases for RR=1
    slices; ``embedded`` is (bytes, start0) when the slice carries an
    embedded reference block (spec 8.5: embedded ref overrides the
    external one).  MD5 slice checksums are not verified."""
    streams = {cid: ByteStream(d) for cid, d in ext.items()}
    core = BitReader(core_data)
    S = ch.series

    def ref_fetch(tid, pos0, ln):
        if ln <= 0:
            return b""
        if embedded is not None:
            data0, s0 = embedded
            lo = pos0 - s0
            a, b = max(lo, 0), min(lo + ln, len(data0))
            body = data0[a:b] if b > a else b""
            return (b"N" * (a - lo) + body
                    + b"N" * (ln - (a - lo) - len(body)))
        if ref_get is None:
            raise ValueError(
                "CRAM: reference-based slice (RR=1) needs a reference"
                " — supply one via CramReader(reference=...) /"
                " BamReader.set_cram_reference")
        return ref_get(tid, pos0, ln)

    def r_int(key, default=None):
        c = S.get(key)
        if c is None:
            if default is not None:
                return default
            raise ValueError(f"CRAM: series {key} missing")
        return c.read_int(core, streams)

    def r_bytes_arr(key):
        return S[key].read_array(core, streams)

    recs = []
    last_ap = slc["start"]
    for _ in range(slc["n_rec"]):
        r = BamRecord()
        bf = r_int("BF")
        cf = r_int("CF")
        if slc["ref_id"] == -2:
            tid = _u2i(r_int("RI"))
        else:
            tid = slc["ref_id"]
        rl = r_int("RL")
        ap = _u2i(r_int("AP"))
        if ch.ap_delta:
            ap = last_ap + ap
            last_ap = ap
        r_int("RG", default=-1)
        if ch.rn:
            r.qname = r_bytes_arr("RN").decode()
        if cf & 2:                        # detached
            mf = r_int("MF", default=0)
            if not ch.rn:
                r.qname = r_bytes_arr("RN").decode()
            r.mtid = _u2i(r_int("NS"))
            r.mpos = _u2i(r_int("NP")) - 1   # NP is 1-based (spec 10.3)
            r.isize = _u2i(r_int("TS"))
            bf |= (0x20 if (mf & 1) else 0) | (0x8 if (mf & 2) else 0)
        elif cf & 4:                      # mate downstream
            r_int("NF")
        tl = r_int("TL", default=0)
        for t, ty in ch.td[tl] if tl < len(ch.td) else []:
            k = _tag_key(t, ty)
            raw = ch.tags[k].read_array(core, streams)
            r.tags[t] = (ty, _bam_tag_parse(ty, raw))
        seq = bytearray(b"N" * rl)
        cig: list[tuple[str, int]] = []
        # Qualities carried per-feature (B/Q/q codes) rather than as a
        # full QS array; kept unless a full array follows.
        fqual: np.ndarray | None = None

        def set_fq(pos0, val):
            nonlocal fqual
            if fqual is None:
                fqual = np.full(rl, 0xFF, np.uint8)
            fqual[pos0] = val

        if not (bf & 0x4):                # mapped
            fn = r_int("FN")
            qpos = 1
            cpos = 1                      # next unaccounted read base
            ap0 = ap - 1                  # AP is 1-based (spec 10.3)
            use_ref = ch.rr and tid >= 0
            roff = 0                      # reference bases consumed

            def add(op, ln):
                if ln <= 0:
                    return
                if cig and cig[-1][0] == op:
                    cig[-1] = (op, cig[-1][1] + ln)
                else:
                    cig.append((op, ln))

            def fill(g):
                """Implicit-match gap of g bases: with a reference the
                bases come from it; reference-free they stay N unless a
                'b' feature carried them."""
                nonlocal roff
                if use_ref and g > 0:
                    seq[cpos - 1:cpos - 1 + g] = \
                        ref_fetch(tid, ap0 + roff, g)
                roff += g

            for _f in range(fn):
                fc = chr(S["FC"].read_byte(core, streams))
                fp = r_int("FP")
                qpos += fp if _f else fp - 1
                # implicit M gap before this feature
                if fc == "b":
                    bb = r_bytes_arr("BB")
                    add("M", qpos - cpos)
                    fill(qpos - cpos)
                    seq[qpos - 1:qpos - 1 + len(bb)] = bb
                    add("M", len(bb))
                    roff += len(bb)
                    cpos = qpos + len(bb)
                elif fc == "X":
                    sub = r_int("BS")
                    add("M", qpos - cpos + 1)
                    fill(qpos - cpos)
                    if use_ref:
                        rb = ref_fetch(tid, ap0 + roff, 1)[0]
                        seq[qpos - 1] = _sm_sub_base(ch.sm, rb, sub)
                    roff += 1
                    cpos = qpos + 1
                elif fc == "B":
                    ba = S["BA"].read_byte(core, streams)
                    set_fq(qpos - 1, S["QS"].read_byte(core, streams))
                    add("M", qpos - cpos + 1)
                    fill(qpos - cpos)
                    seq[qpos - 1] = ba
                    roff += 1
                    cpos = qpos + 1
                elif fc == "i":
                    ba = S["BA"].read_byte(core, streams)
                    add("M", qpos - cpos)
                    fill(qpos - cpos)
                    add("I", 1)
                    seq[qpos - 1] = ba
                    cpos = qpos + 1
                elif fc == "I":
                    ins = r_bytes_arr("IN")
                    add("M", qpos - cpos)
                    fill(qpos - cpos)
                    add("I", len(ins))
                    seq[qpos - 1:qpos - 1 + len(ins)] = ins
                    cpos = qpos + len(ins)
                elif fc == "S":
                    sc = r_bytes_arr("SC")
                    add("M", qpos - cpos)
                    fill(qpos - cpos)
                    add("S", len(sc))
                    seq[qpos - 1:qpos - 1 + len(sc)] = sc
                    cpos = qpos + len(sc)
                elif fc == "D":
                    add("M", qpos - cpos)
                    fill(qpos - cpos)
                    dl = r_int("DL")
                    add("D", dl)
                    roff += dl
                    cpos = qpos
                elif fc == "N":
                    add("M", qpos - cpos)
                    fill(qpos - cpos)
                    rs = r_int("RS")
                    add("N", rs)
                    roff += rs
                    cpos = qpos
                elif fc == "H":
                    add("M", qpos - cpos)
                    fill(qpos - cpos)
                    add("H", r_int("HC"))
                    cpos = qpos
                elif fc == "P":
                    add("M", qpos - cpos)
                    fill(qpos - cpos)
                    add("P", r_int("PD"))
                    cpos = qpos
                elif fc == "Q":
                    # single quality substitution: base stays an
                    # implicit match; no cigar/ref effect
                    set_fq(qpos - 1, S["QS"].read_byte(core, streams))
                elif fc == "q":
                    qq = np.frombuffer(r_bytes_arr("QQ"), np.uint8)
                    if len(qq):
                        set_fq(slice(qpos - 1, qpos - 1 + len(qq)), qq)
                else:
                    raise ValueError(f"CRAM: feature code {fc!r}")
            add("M", rl - cpos + 1)
            fill(rl - cpos + 1)
            r.mapq = r_int("MQ")
        else:
            ba = streams[S["BA"].content_id].read_bytes(rl) \
                if S.get("BA") and S["BA"].id == 1 else b"N" * rl
            seq[:] = ba
        if cf & 1:
            q = streams[S["QS"].content_id].read_bytes(rl) \
                if S.get("QS") and S["QS"].id == 1 else b""
            r.qual = np.frombuffer(q, np.uint8).copy() if q else None
        if r.qual is None and fqual is not None:
            r.qual = fqual
        r.flag = bf
        r.tid = tid
        r.pos = ap - 1                    # AP is 1-based (spec 10.3)
        r.seq = seq.decode()
        if cig:
            r.cigar = Cigar([CigarField(o, ln) for o, ln in cig])
        recs.append(r)
    return recs


# ---------------------------------------------------------------------------
# .crai index (CRAM spec appendix: gzip-compressed TSV, one line per
# slice: ref_id, start, span, container byte offset, slice byte offset
# within the container body (= its landmark), slice size in bytes)
# ---------------------------------------------------------------------------

def write_crai(path: str, entries) -> None:
    with gzip.open(path, "wb") as fh:
        for ref_id, start, span, coff, soff, ssize in entries:
            fh.write(f"{ref_id}\t{start}\t{span}\t{coff}\t{soff}\t"
                     f"{ssize}\n".encode())


def read_crai(path: str) -> list[tuple[int, int, int, int, int, int]]:
    out = []
    with gzip.open(path, "rb") as fh:
        for line in fh.read().decode().splitlines():
            if not line.strip():
                continue
            f = line.split("\t")
            out.append((int(f[0]), int(f[1]), int(f[2]), int(f[3]),
                        int(f[4]), int(f[5])))
    return out


# ---------------------------------------------------------------------------
# reader / writer
# ---------------------------------------------------------------------------

class CramWriter:
    RECORDS_PER_CONTAINER = 10000

    def __init__(self, path_or_fileobj, reference=None):
        """``reference`` (dict name->seq, FASTA path, or RefGenome)
        switches the writer to the reference-based profile (RR=1) —
        the profile htslib emits by default when SeqLib attaches one
        via hts_set_fai_filename."""
        if hasattr(path_or_fileobj, "write"):
            self._fh = path_or_fileobj
            self._owns = False
            self.path = None
        else:
            self._fh = open(path_or_fileobj, "wb")
            self._owns = True
            self.path = path_or_fileobj
        self._offset = 0
        self._write(CRAM_MAGIC + b"seqlib_tpu".ljust(20, b"\x00"))
        self._pending: list[BamRecord] = []
        self._counter = 0
        self._header_written = False
        self._reference = reference
        self._ref_get = None
        self._header: BamHeader | None = None
        # .crai entries: (ref_id, start, span, container_offset,
        # slice_offset, slice_size) per written slice
        self.index_entries: list[tuple[int, int, int, int, int, int]] = []

    def _write(self, data: bytes) -> None:
        self._fh.write(data)
        self._offset += len(data)

    def set_reference(self, reference) -> None:
        """Attach/replace the reference before any record is flushed."""
        self._reference = reference
        self._ref_get = None

    def write_header(self, hdr: BamHeader) -> None:
        text = hdr.as_string().encode()
        blk = write_block(GZIP, FILE_HEADER, 0,
                          struct.pack("<i", len(text)) + text)
        self._write(write_container([blk], ref_id=-1))
        self._header_written = True
        self._header = hdr

    def write_record(self, rec: BamRecord) -> None:
        self._pending.append(rec)
        if len(self._pending) >= self.RECORDS_PER_CONTAINER:
            self._flush()

    def _flush(self) -> None:
        if not self._pending:
            return
        recs = self._pending
        if self._reference is not None and self._ref_get is None:
            if self._header is None:
                raise ValueError("CramWriter: write_header before "
                                 "records when a reference is set")
            self._ref_get = make_ref_get(self._reference, self._header)
        ext, tag_lines = _encode_records(recs, ref_get=self._ref_get)
        comp = write_block(GZIP, COMPRESSION_HEADER, 0,
                           build_compression_header(
                               tag_lines, rr=self._ref_get is not None))
        cids = sorted(ext)
        # Per-slice ref_id/start/span: a slice whose
        # records all map to one reference is declared single-ref —
        # htslib-family readers key RR=1 decoding off these fields.
        # Mixed/unmapped containers keep the multi-ref marker (-2).
        mapped = [r for r in recs if r.tid >= 0 and not (r.flag & 0x4)]
        tids = {r.tid for r in recs}
        if len(tids) == 1 and len(mapped) == len(recs):
            s_ref = recs[0].tid
            s_start = min(r.pos for r in mapped) + 1        # 1-based
            s_span = max(r.position_end() for r in mapped) - s_start + 1
        elif not mapped and all(r.tid < 0 for r in recs):
            s_ref, s_start, s_span = -1, 0, 0
        else:
            s_ref, s_start, s_span = -2, 0, 0
        md5 = b"\x00" * 16
        if s_ref >= 0 and self._ref_get is not None and s_span > 0:
            md5 = hashlib.md5(
                self._ref_get(s_ref, s_start - 1, s_span)).digest()
        sl = write_block(GZIP, SLICE_HEADER, 0, write_slice_header(
            s_ref, s_start, s_span, len(recs), self._counter, cids,
            md5=md5))
        blocks = [comp, sl, write_block(RAW, CORE, 0, b"")]
        for cid in cids:
            # rANS for the bulky base/qual series, gzip elsewhere
            method = RANS if cid in (_DS_IDS["QS"], _DS_IDS["BB"],
                                     _DS_IDS["BA"]) else GZIP
            blocks.append(write_block(method, EXTERNAL, cid, ext[cid]))
        container_offset = self._offset
        self.index_entries.append(
            (s_ref, s_start, s_span, container_offset, len(comp),
             sum(len(b) for b in blocks[1:])))
        self._write(write_container(
            blocks, ref_id=s_ref, start=s_start, span=s_span,
            n_records=len(recs), counter=self._counter,
            bases=sum(len(r.seq or "") for r in recs)))
        self._counter += len(recs)
        self._pending = []

    def close(self) -> None:
        self._flush()
        self._write(CRAM_EOF)
        if self._owns:
            self._fh.close()

    def write_index(self, crai_path: str | None = None) -> str:
        """Write the .crai for the finished file (call after close; as
        SeqLib's BamWriter::BuildIndex, whose sam_index_build emits a
        .crai for CRAM)."""
        if crai_path is None:
            if self.path is None:
                raise ValueError("CramWriter.write_index: no path")
            crai_path = self.path + ".crai"
        write_crai(crai_path, self.index_entries)
        return crai_path


class CramReader:
    def __init__(self, path_or_fileobj, reference=None):
        """``reference`` (dict name->seq, FASTA path, or RefGenome) is
        required to decode reference-based (RR=1) slices without an
        embedded reference block (SeqLib's hts_set_fai_filename)."""
        if hasattr(path_or_fileobj, "read"):
            self._fh = path_or_fileobj
            self._path = None
        else:
            self._fh = open(path_or_fileobj, "rb")
            self._path = path_or_fileobj
        magic = self._fh.read(6)
        if magic != CRAM_MAGIC:
            raise ValueError("not a CRAM 3.0 file")
        self._fh.read(20)  # file id
        self.header = self._read_header_container()
        self._queue: list[BamRecord] = []
        self._eof = False
        self._reference = reference
        self._ref_get = None

    def set_reference(self, reference) -> None:
        self._reference = reference
        self._ref_get = None

    def _read_header_container(self) -> BamHeader:
        ch = read_container_header(self._fh)
        body = self._fh.read(ch["length"])
        blk, _ = read_block(body, 0)
        (l_text,) = struct.unpack_from("<i", blk["data"], 0)
        return BamHeader(blk["data"][4:4 + l_text].decode())

    def _decode_container_body(self, ch, body) -> list[BamRecord]:
        off = 0
        comp_hdr = None
        slices = []          # (slice dict, ext blocks, core bytes)
        cur = None
        for _ in range(ch["n_blocks"]):
            blk, off = read_block(body, off)
            if blk["ctype"] == COMPRESSION_HEADER:
                comp_hdr = CompressionHeader(blk["data"])
            elif blk["ctype"] == SLICE_HEADER:
                cur = (read_slice_header(blk["data"]), {},
                       bytearray())
                slices.append(cur)
            elif blk["ctype"] == CORE and cur is not None:
                cur[2][:] = blk["data"]
            elif blk["ctype"] == EXTERNAL and cur is not None:
                cur[1][blk["content_id"]] = blk["data"]
        if comp_hdr is None:
            raise ValueError("CRAM: container missing "
                             "compression header")
        if comp_hdr.rr and self._ref_get is None \
                and self._reference is not None:
            self._ref_get = make_ref_get(self._reference,
                                         self.header)
        out = []
        for slc, ext, core in slices:
            embedded = None
            emb_id = slc.get("embedded_ref_id", -1)
            if emb_id is not None and emb_id >= 0 \
                    and emb_id in ext:
                # embedded reference block covers the slice span
                # starting at its (1-based) start position
                embedded = (ext[emb_id], slc["start"] - 1)
            out.extend(_decode_records(
                comp_hdr, slc, ext, bytes(core),
                ref_get=self._ref_get, embedded=embedded))
        return out

    def set_regions(self, regions) -> bool:
        """Region-restricted iteration through the .crai (SeqLib's
        SetRegions + Next work on CRAM as on BAM, htslib's iterator
        being format-agnostic).  ``regions``:
        GenomicRegion-like objects (``chr`` tid, 1-based ``pos1``,
        ``pos2``).  Requires <path>.crai (written by CramWriter.
        write_index / BamWriter.build_index)."""
        if self._path is None:
            return False
        crai = self._path + ".crai"
        if not os.path.exists(crai):
            return False
        self._crai = read_crai(crai)
        self._regions = list(regions)
        self._region_idx = 0
        self._queue = []
        self._region_mode = True
        self._arm_region()
        return True

    def _arm_region(self) -> None:
        """Build the ascending container-offset plan for the current
        region: single-ref slices overlapping it, plus every multi-ref
        (-2) slice (those need decoding to know their contents)."""
        while self._region_idx < len(self._regions):
            gr = self._regions[self._region_idx]
            beg = max(gr.pos1 - 1, 0)
            end = gr.pos2
            offs = []
            for ref_id, start, span, coff, _soff, _ssz in self._crai:
                if ref_id == -2:
                    offs.append(coff)
                elif ref_id == gr.chr and start - 1 < end \
                        and start - 1 + max(span, 0) > beg:
                    offs.append(coff)
            self._plan = sorted(set(offs))
            self._plan_idx = 0
            if self._plan:
                return
            self._region_idx += 1
        self._plan = []
        self._plan_idx = 0

    def _next_region(self) -> BamRecord | None:
        while self._region_idx < len(self._regions):
            gr = self._regions[self._region_idx]
            beg, end = max(gr.pos1 - 1, 0), gr.pos2
            while True:
                while self._queue:
                    rec = self._queue.pop(0)
                    if rec.tid != gr.chr:
                        continue
                    if rec.pos >= end:
                        # coordinate-sorted file: past the region
                        self._queue = []
                        self._plan_idx = len(self._plan)
                        break
                    if rec.position_end() > beg:
                        return rec
                if self._plan_idx >= len(self._plan):
                    break
                coff = self._plan[self._plan_idx]
                self._plan_idx += 1
                self._fh.seek(coff)
                ch = read_container_header(self._fh)
                if ch is None:
                    break
                body = self._fh.read(ch["length"])
                if ch["n_records"]:
                    self._queue = self._decode_container_body(ch, body)
            self._region_idx += 1
            if self._region_idx < len(self._regions):
                self._arm_region()
        return None

    def next(self) -> BamRecord | None:
        if getattr(self, "_region_mode", False):
            return self._next_region()
        while not self._queue and not self._eof:
            ch = read_container_header(self._fh)
            if ch is None or ch["ref_id"] == -1 and ch["n_records"] == 0 \
                    and ch["length"] <= 15:
                self._eof = True
                break
            body = self._fh.read(ch["length"])
            if ch["n_records"] == 0:
                continue
            self._queue = self._decode_container_body(ch, body)
        if self._queue:
            return self._queue.pop(0)
        return None

    def __iter__(self):
        return self

    def __next__(self):
        r = self.next()
        if r is None:
            raise StopIteration
        return r

    def close(self) -> None:
        self._fh.close()

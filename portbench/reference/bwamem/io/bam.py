# Frozen copy of seqlib_tpu_torch/io/bam.py for the benchmark's reference
# (plain PyTorch path only): later changes to the port do not reach it.
"""BAM binary codec (counterpart of seqlib_tpu/io/bam.py): the header
(magic, SAM text, reference dictionary) and alignment records, to and
from bytes; ``read_*`` take any object with ``read(n)`` (a BgzfReader).
Also the SAM spec's bins: ``reg2bin`` for one interval, ``reg2bins`` for
all bins that overlap it (2^14 .. 2^29 bp)."""

from __future__ import annotations

import struct

import numpy as np

from ..core.cigar import Cigar
from ..core.header import BamHeader
from ..core.record import BamRecord
from ..core.seq import ASCII_TO_NIB, NIB_TO_ASCII

BAM_MAGIC = b"BAM\x01"

_CORE = struct.Struct("<iiBBHHHiiii")  # refID..tlen (after block_size)

_TAG_FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i",
            "I": "<I", "f": "<f"}
_ARRAY_DTYPE = {"c": np.int8, "C": np.uint8, "s": np.int16, "S": np.uint16,
                "i": np.int32, "I": np.uint32, "f": np.float32}


def reg2bin(beg: int, end: int) -> int:
    """SAM-spec distributed binning (bins of 2^14 .. 2^29)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> list[int]:
    """All bins overlapping [beg, end) (SAM spec)."""
    bins = [0]
    end -= 1
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


def write_bam_header(w, header: BamHeader) -> None:
    text = header.as_string().encode()
    seqs = header.sequences()
    out = bytearray()
    out += BAM_MAGIC
    out += struct.pack("<i", len(text))
    out += text
    out += struct.pack("<i", len(seqs))
    for s in seqs:
        name = s.name.encode() + b"\x00"
        out += struct.pack("<i", len(name))
        out += name
        out += struct.pack("<i", s.length)
    w.write(bytes(out))


def read_bam_header(r) -> BamHeader:
    """The header's SAM text where it names references, else the binary
    reference dictionary (the text kept)."""
    magic = r.read(4)
    if magic != BAM_MAGIC:
        raise ValueError("not a BAM file (bad magic)")
    (l_text,) = struct.unpack("<i", r.read(4))
    text = r.read(l_text).split(b"\x00", 1)[0].decode()
    (n_ref,) = struct.unpack("<i", r.read(4))
    seqs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", r.read(4))
        name = r.read(l_name)[:-1].decode()
        (l_ref,) = struct.unpack("<i", r.read(4))
        seqs.append((name, l_ref))
    if text.strip():
        hdr = BamHeader(text)
        if hdr.num_sequences() == 0 and seqs:
            hdr = BamHeader(seqs)
            hdr._text = text
    else:
        hdr = BamHeader(seqs)
    return hdr


def encode_record(rec: BamRecord) -> bytes:
    name = rec.qname.encode() + b"\x00"
    cig = rec.cigar.to_bam_encoded()
    seq = rec.seq.encode()
    l_seq = len(seq)
    nibs = ASCII_TO_NIB[np.frombuffer(seq, dtype=np.uint8)]
    if l_seq % 2:
        nibs = np.concatenate([nibs, np.zeros(1, dtype=np.uint8)])
    packed_seq = ((nibs[0::2] << 4) | nibs[1::2]).tobytes()
    if rec.qual is None:
        qual = b"\xff" * l_seq
    else:
        qual = rec.qual.astype(np.uint8).tobytes()
    end = rec.pos + max(rec.cigar.num_reference_consumed(), 1)
    bin_ = reg2bin(max(rec.pos, 0), max(end, 1))
    core = _CORE.pack(rec.tid, rec.pos, len(name), rec.mapq, bin_,
                      len(cig), rec.flag, l_seq, rec.mtid, rec.mpos,
                      rec.isize)
    aux = _encode_aux(rec.tags)
    body = core + name + cig.tobytes() + packed_seq + qual + aux
    return struct.pack("<i", len(body)) + body


def _encode_aux(tags: dict) -> bytes:
    out = bytearray()
    for tag, (typ, val) in tags.items():
        t = tag.encode()[:2]
        if typ == "A":
            out += t + b"A" + str(val).encode()[:1]
        elif typ == "i":
            out += t + b"i" + struct.pack("<i", int(val))
        elif typ in _TAG_FMT:
            out += t + typ.encode() + struct.pack(_TAG_FMT[typ], val)
        elif typ in ("Z", "H"):
            out += t + typ.encode() + str(val).encode() + b"\x00"
        elif typ == "B":
            sub, arr = val
            arr = np.asarray(arr, dtype=_ARRAY_DTYPE[sub])
            out += t + b"B" + sub.encode() + struct.pack("<i", arr.size)
            out += arr.tobytes()
        else:
            raise ValueError(f"unsupported tag type {typ!r}")
    return bytes(out)


def decode_record(body: bytes) -> BamRecord:
    """One record's bytes after block_size -> BamRecord (qualities of
    0xff -> ``None``)."""
    (tid, pos, l_qname, mapq, _bin, n_cigar, flag, l_seq, mtid, mpos,
     isize) = _CORE.unpack_from(body, 0)
    off = _CORE.size
    rec = BamRecord()
    rec.qname = body[off:off + l_qname - 1].decode()
    off += l_qname
    if n_cigar:
        enc = np.frombuffer(body, dtype="<u4", count=n_cigar, offset=off)
        rec.cigar = Cigar.from_bam_encoded(enc)
        off += 4 * n_cigar
    if l_seq:
        nbytes = (l_seq + 1) // 2
        packed = np.frombuffer(body, dtype=np.uint8, count=nbytes, offset=off)
        nibs = np.empty(nbytes * 2, dtype=np.uint8)
        nibs[0::2] = packed >> 4
        nibs[1::2] = packed & 0xF
        rec.seq = NIB_TO_ASCII[nibs[:l_seq]].tobytes().decode()
        off += nbytes
        qual = np.frombuffer(body, dtype=np.uint8, count=l_seq, offset=off)
        rec.qual = None if qual[0] == 0xFF else qual.copy()
        off += l_seq
    rec.tid, rec.pos, rec.mapq, rec.flag = tid, pos, mapq, flag
    rec.mtid, rec.mpos, rec.isize = mtid, mpos, isize
    rec.tags = _decode_aux(body, off)
    return rec


def _decode_aux(body: bytes, off: int) -> dict:
    tags: dict[str, tuple[str, object]] = {}
    n = len(body)
    while off + 3 <= n:
        tag = body[off:off + 2].decode()
        typ = chr(body[off + 2])
        off += 3
        if typ == "A":
            tags[tag] = ("A", chr(body[off]))
            off += 1
        elif typ in _TAG_FMT:
            fmt = _TAG_FMT[typ]
            (v,) = struct.unpack_from(fmt, body, off)
            off += struct.calcsize(fmt)
            tags[tag] = (typ, v)
        elif typ in ("Z", "H"):
            end = body.index(b"\x00", off)
            tags[tag] = (typ, body[off:end].decode())
            off = end + 1
        elif typ == "B":
            sub = chr(body[off])
            (cnt,) = struct.unpack_from("<i", body, off + 1)
            dt = _ARRAY_DTYPE[sub]
            arr = np.frombuffer(body, dtype=dt, count=cnt, offset=off + 5)
            tags[tag] = ("B", (sub, arr.copy()))
            off += 5 + arr.nbytes
        else:
            raise ValueError(f"unknown aux tag type {typ!r} for {tag}")
    return tags


def read_record(r) -> BamRecord | None:
    """The next record, ``None`` at the end of the stream; a record cut
    short raises ValueError."""
    hdr = r.read(4)
    if len(hdr) < 4:
        return None
    (block_size,) = struct.unpack("<i", hdr)
    body = r.read(block_size)
    if len(body) < block_size:
        raise ValueError("truncated BAM record")
    return decode_record(body)

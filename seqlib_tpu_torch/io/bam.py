"""BAM binary record encoder (counterpart of seqlib_tpu/io/bam.py's
``encode_record``, ``_encode_aux`` and ``reg2bin``): one BamRecord ->
the bytes of a BAM alignment block, block_size included."""

from __future__ import annotations

import struct

import numpy as np

from ..core.record import BamRecord
from ..core.seq import ASCII_TO_NIB

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

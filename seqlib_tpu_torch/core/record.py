"""BamRecord: one SAM/BAM alignment record (counterpart of
seqlib_tpu/core/record.py: the fields, flags, tags and SAM text that the
aligner's object API and pairing emit; region queries are not ported
yet).

Positions are 0-based; ``seq`` is an upper-case ASCII string; ``qual``
is a numpy uint8 array of raw phred values or ``None`` for "no
qualities"; ``tags`` maps a 2-char tag to (type char, value).
"""

from __future__ import annotations

import numpy as np

from .cigar import Cigar
from .header import BamHeader

# BAM flag bits (SAM spec)
FPAIRED = 0x1
FPROPER_PAIR = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FSUPPLEMENTARY = 0x800


class BamRecord:
    """A single alignment record."""

    __slots__ = ("qname", "flag", "tid", "pos", "mapq", "cigar",
                 "mtid", "mpos", "isize", "seq", "qual", "tags")

    def __init__(self):
        self.qname: str = ""
        self.flag: int = 0
        self.tid: int = -1
        self.pos: int = -1
        self.mapq: int = 0
        self.cigar: Cigar = Cigar()
        self.mtid: int = -1
        self.mpos: int = -1
        self.isize: int = 0
        self.seq: str = ""
        self.qual: np.ndarray | None = None
        self.tags: dict[str, tuple[str, object]] = {}

    def reverse_flag(self) -> bool:
        return (self.flag & FREVERSE) != 0

    def secondary_flag(self) -> bool:
        return (self.flag & FSECONDARY) != 0

    def proper_pair(self) -> bool:
        return (self.flag & FPROPER_PAIR) != 0

    def mapped_flag(self) -> bool:
        return (self.flag & FUNMAP) == 0

    def supplementary_flag(self) -> bool:
        return (self.flag & FSUPPLEMENTARY) != 0

    def position_end(self) -> int:
        """End of the alignment on the reference (bam_endpos)."""
        if len(self.seq) > 0:
            rlen = self.cigar.num_reference_consumed()
            return self.pos + rlen if rlen > 0 else self.pos + 1
        return self.pos + self.cigar.num_query_consumed()

    def qualities(self, offset: int = 33) -> str:
        """Phred string with offset ("" without qualities)."""
        if self.qual is None:
            return ""
        return (self.qual + offset).tobytes().decode("latin1")

    def add_z_tag(self, tag: str, val: str) -> None:
        self.tags[tag] = ("Z", val)

    def add_int_tag(self, tag: str, val: int) -> None:
        self.tags[tag] = ("i", int(val))

    def get_z_tag(self, tag: str):
        t = self.tags.get(tag)
        if t and t[0] in ("Z", "H", "A"):
            return str(t[1])
        return None

    def get_int_tag(self, tag: str):
        t = self.tags.get(tag)
        if t and t[0] in "cCsSiI":
            return int(t[1])
        return None

    def to_sam(self, hdr: BamHeader | None = None) -> str:
        """One SAM text line (no trailing newline)."""
        rname = "*"
        if self.tid >= 0:
            rname = hdr.id2name(self.tid) if hdr else str(self.tid)
        rnext = "*"
        if self.mtid >= 0:
            if self.mtid == self.tid:
                rnext = "="
            else:
                rnext = hdr.id2name(self.mtid) if hdr else str(self.mtid)
        qual = self.qualities() if self.qual is not None else "*"
        fields = [
            self.qname or "*", str(self.flag), rname, str(self.pos + 1),
            str(self.mapq), str(self.cigar) if len(self.cigar) else "*",
            rnext, str(self.mpos + 1), str(self.isize),
            self.seq or "*", qual or "*",
        ]
        for tag, (typ, val) in self.tags.items():
            if typ in "cCsSiI":
                fields.append(f"{tag}:i:{val}")
            elif typ == "f":
                fields.append(f"{tag}:f:{val:g}")
            elif typ == "A":
                fields.append(f"{tag}:A:{val}")
            elif typ == "B":
                fields.append(f"{tag}:B:{val}")
            else:
                fields.append(f"{tag}:{typ}:{val}")
        return "\t".join(fields)

    def __repr__(self):
        strand = "-" if self.reverse_flag() else "+"
        return (f"BamRecord({self.qname} {self.tid + 1}:{self.pos:,}"
                f"({strand}) {self.cigar!s} flag={self.flag})")

# Frozen copy of seqlib_tpu_torch/core/region.py for the benchmark's reference
# (plain PyTorch path only): later changes to the port do not reach it.
"""GenomicRegion: an interval on the genome (counterpart of
seqlib_tpu/core/region.py).

A value type: reference id (int), 1-based inclusive ``pos1``..``pos2``
and a strand of '+', '-' or '*'.  Readers turn it into the 0-based
half-open ``[pos1 - 1, pos2)`` of BAM positions.
"""

from __future__ import annotations

import re

from .header import BamHeader

_REGION_RE = re.compile(r"^([!-)+-<>-~][!-~]*):([0-9,]+)(?:-([0-9,]+))?$")


def parse_region_string(reg: str):
    """samtools-style region: ``chr``, ``chr:pos`` or ``chr:beg-end``,
    commas allowed in the numbers.

    Returns (chrname, beg0, end): 0-based beg, 1-based inclusive end; or
    (reg, 0, None) for a bare reference name.
    """
    m = _REGION_RE.match(reg)
    if not m:
        if ":" in reg:
            raise ValueError(
                f"GenomicRegion: failed to parse region string {reg!r}")
        return reg, 0, None
    name = m.group(1)
    beg = int(m.group(2).replace(",", "")) - 1
    if m.group(3) is not None:
        end = int(m.group(3).replace(",", ""))
    else:
        end = beg + 1
    if beg < 0 or end < beg:
        raise ValueError(
            f"GenomicRegion: failed to parse region string {reg!r}")
    return name, beg, end


class GenomicRegion:
    """Genomic interval (reference id, 1-based inclusive pos1..pos2,
    strand).  Built from numbers, from a region string and a header
    (``GenomicRegion("chr1:100-200", hdr=hdr)``), or from a name and two
    position strings (``GenomicRegion("chr2", "1,000", "2,000", hdr)``;
    without a header the id is guessed: "1" -> 0, "X" -> 22, "chr2" ->
    1)."""

    __slots__ = ("chr", "pos1", "pos2", "strand")

    def __init__(self, chr=-1, pos1=0, pos2=0, strand="*",
                 hdr: BamHeader | None = None):
        if isinstance(chr, str) and pos1 == 0 and pos2 == 0 \
                and hdr is not None:
            self._from_region_string(chr, hdr)
            return
        if isinstance(chr, str):
            self._from_strings(chr, pos1, pos2, hdr)
            return
        pos1, pos2 = int(pos1), int(pos2)
        if pos2 < pos1:
            raise ValueError(
                "GenomicRegion constructor: end pos must be >= start pos")
        if strand not in ("+", "-", "*"):
            raise ValueError(
                "GenomicRegion constructor: strand must be one of +, -, *")
        self.chr = int(chr)
        self.pos1 = pos1
        self.pos2 = pos2
        self.strand = strand

    def _from_region_string(self, reg: str, hdr: BamHeader) -> None:
        if hdr is None or hdr.is_empty():
            raise ValueError(
                "GenomicRegion constructor - supplied empty BamHeader")
        name, beg, end = parse_region_string(reg)
        tid = hdr.name2id(name)
        if tid < 0:
            raise ValueError(
                f"GenomicRegion constructor: Failed to set region for {reg}")
        if end is None:  # whole reference
            beg, end = 0, hdr.get_sequence_length(name)
        self.chr = tid
        self.pos1 = beg + 1
        self.pos2 = end
        self.strand = "*"

    def _from_strings(self, tchr: str, tpos1, tpos2,
                      hdr: BamHeader | None) -> None:
        self.strand = "*"
        self.pos1 = int(str(tpos1).replace(",", ""))
        self.pos2 = int(str(tpos2).replace(",", ""))
        if hdr is None or hdr.is_empty():
            if tchr in ("X", "chrX"):
                self.chr = 22
            elif tchr in ("Y", "chrY"):
                self.chr = 23
            else:
                self.chr = int(tchr.replace("chr", "")) - 1
        else:
            chrid = hdr.name2id(tchr)
            if chrid == -1 and re.fullmatch(r"[0-9XY]+", tchr):
                chrid = hdr.name2id("chr" + tchr)
            self.chr = chrid

    def width(self) -> int:
        """pos2 - pos1 + 1."""
        return self.pos2 - self.pos1 + 1

    def is_empty(self) -> bool:
        return self.chr == -1 and self.pos1 == 0 and self.pos2 == 0

    def get_overlap(self, gr: "GenomicRegion") -> int:
        """0 none, 1 partial, 2 argument inside self, 3 self inside
        argument."""
        if gr.chr != self.chr:
            return 0
        gr1_in = self.pos1 <= gr.pos1 <= self.pos2
        gr2_in = self.pos1 <= gr.pos2 <= self.pos2
        pos1_in = gr.pos1 <= self.pos1 <= gr.pos2
        pos2_in = gr.pos1 <= self.pos2 <= gr.pos2
        if pos1_in and pos2_in:
            return 3
        if gr1_in and gr2_in:
            return 2
        if gr1_in or gr2_in or pos1_in or pos2_in:
            return 1
        return 0

    def pad(self, pad: int) -> None:
        """Pad both ends; a negative pad may not obliterate the region."""
        if -pad * 2 > self.width():
            raise ValueError(
                "GenomicRegion::pad - negative pad values can't obliterate "
                f"GenomicRegion {self.chr}:{self.pos1}-{self.pos2} pad {pad}")
        self.pos1 -= pad
        self.pos2 += pad

    def distance_between_starts(self, gr: "GenomicRegion") -> int:
        return -1 if gr.chr != self.chr else abs(self.pos1 - gr.pos1)

    def distance_between_ends(self, gr: "GenomicRegion") -> int:
        return -1 if gr.chr != self.chr else abs(self.pos2 - gr.pos2)

    def chr_name(self, hdr: BamHeader | None = None) -> str:
        """The reference's name from ``hdr``, else the default human
        naming."""
        if hdr is not None and not hdr.is_empty():
            if self.chr >= hdr.num_sequences():
                raise ValueError(
                    "GenomicRegion::ChrName - not enough targets in "
                    "BamHeader to cover ref id")
            return hdr.id2name(self.chr)
        return self._chr_to_string(self.chr)

    @staticmethod
    def _chr_to_string(ref: int) -> str:
        """Default human naming: 22 -> X, 23 -> Y, 24 -> M, else the
        1-based number."""
        if ref < 0:
            return str(ref)
        if ref == 22:
            return "X"
        if ref == 23:
            return "Y"
        if ref == 24:
            return "M"
        return str(ref + 1)

    def point_string(self, hdr: BamHeader | None = None) -> str:
        return f"{self.chr_name(hdr)}:{self.pos1:,}({self.strand})"

    def to_string(self, hdr: BamHeader | None = None) -> str:
        return (f"{self.chr_name(hdr)}:{self.pos1:,}-{self.pos2:,}"
                f"({self.strand})")

    # ordering by (chr, pos1, pos2); the strand takes no part
    def _key(self):
        return (self.chr, self.pos1, self.pos2)

    def __lt__(self, b):
        return self._key() < b._key()

    def __eq__(self, b):
        return (isinstance(b, GenomicRegion) and self.chr == b.chr
                and self.pos1 == b.pos1 and self.pos2 == b.pos2)

    def __le__(self, b):
        return self < b or self == b

    def __gt__(self, b):
        return not self == b and not self < b

    def __ge__(self, b):
        return self > b or self == b

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"{self._chr_to_string(self.chr)}:{self.pos1:,}-"
                f"{self.pos2:,}({self.strand})")

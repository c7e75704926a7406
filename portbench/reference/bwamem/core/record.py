# Frozen copy of seqlib_tpu_torch/core/record.py for the benchmark's reference
# (plain PyTorch path only): later changes to the port do not reach it.
"""BamRecord: one SAM/BAM alignment record (counterpart of
seqlib_tpu/core/record.py).

Plain fields (qname, flag, tid, pos, ...) that ``io.bam`` packs into and
unpacks from BAM bytes.  Positions are 0-based; ``seq`` is an upper-case
ASCII string; ``qual`` is a numpy uint8 array of raw phred values or
``None`` for "no qualities" (BAM's 0xff); ``tags`` maps a 2-char tag to
(type char, value).

``==`` and ``<`` compare (tid, pos) only, as the reference API's
operators do; ``hash`` adds qname and flag.  Compare records by their
SAM lines or BAM bytes where their content matters.
"""

from __future__ import annotations

import numpy as np

from .cigar import Cigar
from .header import BamHeader
from .region import GenomicRegion
from .seq import revcomp  # noqa: F401  (re-exported, as in seqlib_tpu)

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
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800

# pair orientations
FRORIENTATION = 0
FFORIENTATION = 1
RFORIENTATION = 2
RRORIENTATION = 3
UDORIENTATION = 4


class BamRecord:
    """A single alignment record; with no arguments an empty one, or
    built by hand from a name, a sequence, a GenomicRegion and a CIGAR
    (MAPQ 60, FREVERSE on a '-' region)."""

    __slots__ = ("qname", "flag", "tid", "pos", "mapq", "cigar",
                 "mtid", "mpos", "isize", "seq", "qual", "tags")

    def __init__(self, qname=None, seq=None, gr: GenomicRegion | None = None,
                 cigar: Cigar | str | None = None):
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
        if qname is None:
            return
        # manual construction
        if isinstance(cigar, str):
            cigar = Cigar(cigar)
        if cigar.num_query_consumed() != len(seq):
            raise ValueError(
                "Sequence length mismatches CIGAR query consumption")
        if gr is not None and cigar.num_reference_consumed() != gr.width():
            raise ValueError(
                "GenomicRegion width mismatches CIGAR reference consumption")
        self.qname = str(qname)
        self.seq = str(seq).upper()
        self.cigar = cigar
        self.tid = gr.chr
        # gr.pos1 goes into pos unchanged, as in seqlib_tpu
        self.pos = gr.pos1
        self.mapq = 60
        self.flag = FREVERSE if gr.strand == "-" else 0

    # ------------------------------------------------------------------
    # flags
    # ------------------------------------------------------------------

    def _f(self, bit: int) -> bool:
        return (self.flag & bit) != 0

    def paired_flag(self) -> bool: return self._f(FPAIRED)
    def proper_pair(self) -> bool: return self._f(FPROPER_PAIR)
    def mapped_flag(self) -> bool: return not self._f(FUNMAP)
    def mate_mapped_flag(self) -> bool: return not self._f(FMUNMAP)
    def reverse_flag(self) -> bool: return self._f(FREVERSE)
    def mate_reverse_flag(self) -> bool: return self._f(FMREVERSE)
    def first_flag(self) -> bool: return self._f(FREAD1)
    def secondary_flag(self) -> bool: return self._f(FSECONDARY)
    def qc_fail_flag(self) -> bool: return self._f(FQCFAIL)
    def duplicate_flag(self) -> bool: return self._f(FDUP)
    def supplementary_flag(self) -> bool: return self._f(FSUPPLEMENTARY)

    def pair_mapped_flag(self) -> bool:
        """Read mapped AND mate mapped AND paired."""
        return (not self._f(FMUNMAP) and not self._f(FUNMAP)
                and self._f(FPAIRED))

    def interchromosomal(self) -> bool:
        """tid != mtid and both mapped in pair."""
        return self.tid != self.mtid and self.pair_mapped_flag()

    def set_qc_fail(self, f: bool) -> None:
        self._set_flag(FQCFAIL, f)

    def set_pair_mapped_flag(self, f: bool) -> None:
        self._set_flag(FPAIRED, f)

    def set_mate_reverse_flag(self, f: bool) -> None:
        self._set_flag(FMREVERSE, f)

    def _set_flag(self, bit: int, on: bool) -> None:
        if on:
            self.flag |= bit
        else:
            self.flag &= ~bit

    # ------------------------------------------------------------------
    # positions
    # ------------------------------------------------------------------

    def position(self) -> int:
        return self.pos

    def position_end(self) -> int:
        """End of the alignment on the reference (htslib's bam_endpos)."""
        if len(self.seq) > 0:
            rlen = self.cigar.num_reference_consumed()
            return self.pos + rlen if rlen > 0 else self.pos + 1
        return self.pos + self.cigar.num_query_consumed()

    def position_end_mate(self) -> int:
        """mpos + query length."""
        qlen = len(self.seq) if self.seq else self.cigar.num_query_consumed()
        return self.mpos + qlen

    def as_genomic_region(self) -> GenomicRegion:
        s = "*"
        if self.mapped_flag():
            s = "-" if self.reverse_flag() else "+"
        return GenomicRegion(self.tid, self.pos,
                             max(self.position_end(), self.pos), s)

    def as_genomic_region_mate(self) -> GenomicRegion:
        s = "*"
        if self.mate_mapped_flag():
            s = "-" if self.mate_reverse_flag() else "+"
        return GenomicRegion(self.mtid, self.mpos,
                             max(self.position_end_mate(), self.mpos), s)

    # ------------------------------------------------------------------
    # sequence / qualities
    # ------------------------------------------------------------------

    def sequence(self) -> str:
        return self.seq

    def length(self) -> int:
        return len(self.seq)

    def qualities(self, offset: int = 33) -> str:
        """Phred string with offset."""
        if self.qual is None:
            return ""
        return (self.qual + offset).tobytes().decode("latin1")

    def set_qualities(self, quals: str, offset: int = 33) -> None:
        if quals and len(quals) != len(self.seq):
            raise ValueError("New quality string must match sequence length")
        if not quals:
            self.qual = None
            return
        self.qual = (np.frombuffer(quals.encode("latin1"), dtype=np.uint8)
                     - offset).astype(np.uint8)

    def set_sequence(self, seq: str) -> None:
        self.seq = seq.upper()

    def set_qname(self, name: str) -> None:
        self.qname = name

    def set_cigar(self, c: Cigar | str) -> None:
        self.cigar = Cigar(c) if isinstance(c, str) else c

    def set_position(self, pos: int) -> None:
        self.pos = pos

    def set_id(self, tid: int) -> None:
        self.tid = tid

    set_chr_id = set_id

    def set_chr_id_mate(self, tid: int) -> None:
        self.mtid = tid

    def set_position_mate(self, pos: int) -> None:
        self.mpos = pos

    def set_map_quality(self, m: int) -> None:
        self.mapq = m

    def count_n_bases(self) -> int:
        return self.seq.count("N")

    def quality_trimmed_sequence(self, qual_trim: int) -> tuple[int, int]:
        """(startpoint, endpoint) of the quality-trimmed window:
        endpoint -1 without qualities, startpoint len when no base
        passes."""
        if len(self.seq) == 0 or self.qual is None:
            return 0, -1
        ok = self.qual >= qual_trim
        idx = np.flatnonzero(ok)
        if idx.size == 0:
            return len(self.seq), -1
        return int(idx[0]), int(idx[-1]) + 1

    # ------------------------------------------------------------------
    # cigar-derived quantities
    # ------------------------------------------------------------------

    def get_cigar(self) -> Cigar:
        return self.cigar

    def get_reverse_cigar(self) -> Cigar:
        c = Cigar()
        c.fields = list(reversed(self.cigar.fields))
        return c

    def cigar_string(self) -> str:
        return str(self.cigar)

    def num_aligned_bases(self) -> int:
        """Sum of M/I/=/X/D lengths."""
        return sum(f.length for f in self.cigar if f.type in "MI=XD")

    def max_insertion_bases(self) -> int:
        return max((f.length for f in self.cigar if f.type == "I"), default=0)

    def max_deletion_bases(self) -> int:
        return max((f.length for f in self.cigar if f.type == "D"), default=0)

    def num_match_bases(self) -> int:
        return sum(f.length for f in self.cigar if f.type == "M")

    def alignment_position(self) -> int:
        """Leading soft-clip length, ignoring hard clips."""
        pos = 0
        for f in self.cigar:
            if f.type == "H":
                continue
            if f.type == "S":
                pos += f.length
            else:
                break
        return pos

    def alignment_end_position(self) -> int:
        """Read length minus trailing clips."""
        clip = 0
        for f in reversed(self.cigar.fields):
            if f.type in "SH":
                clip += f.length
            else:
                break
        return len(self.seq) - clip

    def alignment_position_reverse(self) -> int:
        """Trailing clip length."""
        clip = 0
        for f in reversed(self.cigar.fields):
            if f.type in "SH":
                clip += f.length
            else:
                break
        return clip

    def alignment_end_position_reverse(self) -> int:
        return len(self.seq) - self.alignment_position_reverse()

    def num_soft_clip(self) -> int:
        return sum(f.length for f in self.cigar if f.type == "S")

    def num_hard_clip(self) -> int:
        return sum(f.length for f in self.cigar if f.type == "H")

    def num_clip(self) -> int:
        return sum(f.length for f in self.cigar if f.type in "SH")

    def overlapping_coverage(self, r: "BamRecord") -> int:
        """Count M-bases of r covered by M-bases of self at the same
        query offsets."""
        len1 = self.cigar.num_query_consumed()
        cov = np.zeros(max(len1, r.cigar.num_query_consumed()), dtype=np.uint8)
        pos = 0
        for f in self.cigar:
            if f.type == "M":
                cov[pos:pos + f.length] = 1
            if f.consumes_query():
                pos += f.length
        ocov = 0
        pos = 0
        for f in r.cigar:
            if f.type == "M":
                ocov += int(cov[pos:pos + f.length].sum())
            if f.consumes_query():
                pos += f.length
        return ocov

    # ------------------------------------------------------------------
    # pair orientation
    # ------------------------------------------------------------------

    def pair_orientation(self) -> int:
        if not self.mapped_flag() or not self.mate_mapped_flag():
            return UDORIENTATION
        left_is_this = (self.tid < self.mtid
                        or (self.tid == self.mtid and self.pos <= self.mpos))
        left_rev = self.reverse_flag() if left_is_this else self.mate_reverse_flag()
        right_rev = self.mate_reverse_flag() if left_is_this else self.reverse_flag()
        if not left_rev and right_rev:
            return FRORIENTATION
        if not left_rev and not right_rev:
            return FFORIENTATION
        if left_rev and right_rev:
            return RRORIENTATION
        return RFORIENTATION

    def proper_orientation(self) -> bool:
        """FR orientation on same chromosome."""
        if self.tid != self.mtid:
            return False
        return self.pair_orientation() == FRORIENTATION

    # ------------------------------------------------------------------
    # tags
    # ------------------------------------------------------------------

    def add_z_tag(self, tag: str, val: str) -> None:
        self.tags[tag] = ("Z", val)

    def add_int_tag(self, tag: str, val: int) -> None:
        self.tags[tag] = ("i", int(val))

    def add_float_tag(self, tag: str, val: float) -> None:
        self.tags[tag] = ("f", float(val))

    def get_z_tag(self, tag: str):
        t = self.tags.get(tag)
        if t and t[0] in ("Z", "H", "A"):
            return str(t[1])
        return None

    def get_int_tag(self, tag: str):
        t = self.tags.get(tag)
        if t and t[0] in "cCsSiI":
            return int(t[1])
        if t and t[0] == "i":
            return int(t[1])
        return None

    def get_float_tag(self, tag: str):
        t = self.tags.get(tag)
        if t and t[0] in ("f", "d"):
            return float(t[1])
        return None

    def get_tag(self, tag: str):
        """Z first, then int, then float."""
        v = self.get_z_tag(tag)
        if v is not None:
            return v
        v = self.get_int_tag(tag)
        if v is not None:
            return str(v)
        v = self.get_float_tag(tag)
        if v is not None:
            return str(v)
        return None

    def append_tag(self, tag: str, val: str, delim: str = "x") -> None:
        """Append to an existing Z tag, delimited."""
        cur = self.get_z_tag(tag)
        if cur is None:
            self.add_z_tag(tag, val)
        else:
            self.tags[tag] = ("Z", f"{cur}{delim}{val}")

    def remove_tag(self, tag: str) -> None:
        self.tags.pop(tag, None)

    def clear_seq_qual_and_tags(self) -> None:
        self.seq = ""
        self.qual = None
        self.tags.clear()

    def parse_read_group(self) -> str:
        """RG tag, else qname prefix before ':', else 'NA'."""
        rg = self.get_z_tag("RG")
        if rg is not None:
            return rg
        if ":" in self.qname:
            return self.qname.split(":", 1)[0]
        return "NA"

    # ------------------------------------------------------------------
    # display / compare
    # ------------------------------------------------------------------

    def chr_name(self, hdr: BamHeader) -> str:
        if self.tid < 0:
            return str(self.tid)
        return hdr.id2name(self.tid)

    def brief(self) -> str:
        strand = "-" if self._f(FREVERSE) else "+"
        return f"{self.tid + 1}:{self.pos:,}({strand})"

    def brief_mate(self) -> str:
        strand = "-" if self._f(FMREVERSE) else "+"
        return f"{self.mtid + 1}:{self.mpos:,}({strand})"

    def chr_id(self) -> int:
        return self.tid

    def mate_chr_id(self) -> int:
        return self.mtid

    def map_quality(self) -> int:
        return self.mapq

    def mate_position(self) -> int:
        return self.mpos

    def insert_size(self) -> int:
        return self.isize

    def full_insert_size(self) -> int:
        """|pos - mpos| + query length, 0 when interchromosomal or not
        both mapped."""
        if self.tid != self.mtid or not self.pair_mapped_flag():
            return 0
        return abs(self.pos - self.mpos) + self.cigar.num_query_consumed()

    def __lt__(self, other: "BamRecord") -> bool:
        return (self.tid, self.pos) < (other.tid, other.pos)

    def __eq__(self, other) -> bool:
        return (isinstance(other, BamRecord)
                and (self.tid, self.pos) == (other.tid, other.pos))

    def __hash__(self):
        return hash((self.tid, self.pos, self.qname, self.flag))

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
        return (f"BamRecord({self.qname} {self.brief()} "
                f"{self.cigar!s} flag={self.flag})")


# sort functors (stable: equal keys keep their order)
def sort_by_position(records):
    return sorted(records, key=lambda r: (r.tid, r.pos))


def sort_by_qname(records):
    return sorted(records, key=lambda r: r.qname)


BamRecordVector = list

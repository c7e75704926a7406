"""SeqPlot: IGV-like ASCII pileup of alignment records (counterpart of
seqlib_tpu/plot/seqplot.py).

Gapped-sequence reconstruction from CIGAR (M substrings, D dashes),
greedy first-fit packing into lines, qname>>>chr:pos annotations.  A
record is drawn only when it lies wholly inside the view.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.record import BamRecord
from ..core.region import GenomicRegion


@dataclass
class PlottedRead:
    pos: int
    seq: str
    info: str

    def __lt__(self, other):
        return self.pos < other.pos


@dataclass
class PlottedReadLine:
    reads: list[PlottedRead] = field(default_factory=list)
    available: int = 0
    contig_len: int = 0
    pad: int = 5

    def read_fits(self, r: PlottedRead) -> bool:
        return r.pos >= self.available

    def add_read(self, r: PlottedRead) -> None:
        self.reads.append(r)
        self.available = r.pos + len(r.seq) + self.pad

    def render(self) -> str:
        out = []
        last = 0
        for r in self.reads:
            out.append(" " * (r.pos - last))
            out.append(r.seq)
            last = r.pos + len(r.seq)
        out.append(" " * max(self.contig_len - last, 5))
        for r in self.reads:
            out.append(r.info + ",")
        return "".join(out)


class SeqPlot:
    def __init__(self):
        self.m_view = GenomicRegion()
        self.m_pad = 5

    def set_view(self, g: GenomicRegion) -> None:
        self.m_view = g

    def set_padding(self, p: int) -> None:
        self.m_pad = p

    def plot_alignment_records(self, brv: list[BamRecord]) -> str:
        plot_vec: list[PlottedRead] = []
        for r in brv:
            if r.tid != self.m_view.chr:
                continue
            pos = r.pos - self.m_view.pos1
            if pos < 0:
                continue
            if r.position_end() > self.m_view.pos2:
                continue
            tseq = r.seq
            gapped = []
            p = r.alignment_position()
            for c in r.cigar:
                if c.type == "M":
                    gapped.append(tseq[p:p + c.length])
                elif c.type == "D":
                    gapped.append("-" * c.length)
                if c.type in ("I", "M"):
                    p += c.length
            info = f"{r.qname}>>>{r.tid + 1}:{r.pos}"
            plot_vec.append(PlottedRead(pos, "".join(gapped), info))
        plot_vec.sort()
        lines: list[PlottedReadLine] = []
        for pr in plot_vec:
            for line in lines:
                if line.read_fits(pr):
                    line.add_read(pr)
                    break
            else:
                line = PlottedReadLine(pad=self.m_pad,
                                       contig_len=self.m_view.width())
                line.add_read(pr)
                lines.append(line)
        return "".join(line.render() + "\n" for line in lines)

    SetView = set_view
    SetPadding = set_padding
    PlotAlignmentRecords = plot_alignment_records

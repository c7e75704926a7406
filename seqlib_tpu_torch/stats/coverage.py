"""STCoverage: per-position coverage tracks (counterpart of
seqlib_tpu/stats/coverage.py).

SeqLib's STCoverage: addRead with buff/full_length handling,
per-chromosome maps, getCoverageAtPosition, bedgraph export.  Backed by
dicts; a dense uint16 track serves the region-bounded constructor (it
wraps past 65,535, as SeqLib's does).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..core.record import BamRecord
from ..core.region import GenomicRegion


class STCoverage:
    def __init__(self, gr: GenomicRegion | None = None):
        self.m_gr = gr or GenomicRegion()
        self.m_map: list[dict[int, int]] = []
        if gr is not None and not gr.is_empty():
            self.v = np.zeros(gr.width(), dtype=np.uint16)
        else:
            self.v = np.zeros(0, dtype=np.uint16)

    def clear(self) -> None:
        self.m_map = []
        self.v = np.zeros(0, dtype=np.uint16)

    def add_read(self, r: BamRecord, buff: int = 0,
                 full_length: bool = False) -> None:
        if full_length:
            c = r.cigar
            if len(c) and c[0].type == "S":
                p = max(0, r.pos - c[0].length)
            else:
                p = r.pos
            if len(c) and c[-1].type == "S":
                e = r.position_end() + c[-1].length
            else:
                e = r.position_end()
        else:
            p = r.pos + buff
            e = r.position_end() - buff
        if p < 0 or e < 0:
            return
        while r.tid >= len(self.m_map):
            self.m_map.append(defaultdict(int))
        cm = self.m_map[r.tid]
        for pos in range(p, e + 1):
            cm[pos] += 1
        # dense-array mode too, when bounded
        if self.v.size and r.tid == self.m_gr.chr:
            lo = max(p - self.m_gr.pos1, 0)
            hi = min(e + 1 - self.m_gr.pos1, self.v.size)
            if hi > lo:
                self.v[lo:hi] += 1

    def get_coverage_at_position(self, chrid: int, pos: int) -> int:
        if chrid >= len(self.m_map):
            return 0
        return self.m_map[chrid].get(pos, 0)

    def max_cov(self) -> int:
        if self.v.size:
            return int(self.v.max())
        best = 0
        for cm in self.m_map:
            if cm:
                best = max(best, max(cm.values()))
        return best

    def to_bedgraph(self, hdr=None) -> str:
        """Run-length bedgraph of the dense region track."""
        if self.m_gr.chr == -1 or self.v.size == 0:
            return ""
        name = self.m_gr.chr_name(hdr)
        out = []
        curr_start = 0
        curr_val = int(self.v[0])
        for i in range(self.v.size):
            if int(self.v[i]) != curr_val:
                out.append(f"{name}\t{curr_start + self.m_gr.pos1}\t"
                           f"{i + self.m_gr.pos1}\t{curr_val}")
                curr_start = i
                curr_val = int(self.v[i])
        if curr_start + 1 != self.v.size:
            out.append(f"{name}\t{curr_start + self.m_gr.pos1}\t"
                       f"{self.v.size + self.m_gr.pos1 - 1}\t{curr_val}")
        return "\n".join(out) + ("\n" if out else "")

    addRead = add_read
    getCoverageAtPosition = get_coverage_at_position
    maxCov = max_cov
    ToBedgraph = to_bedgraph

"""Fractions: per-interval subsampling fractions from BED (counterpart
of seqlib_tpu/stats/fractions.py).

FracRegion (GenomicRegion + keep fraction) and the 4-column BED reader.
"""

from __future__ import annotations

from ..core.header import BamHeader
from ..core.region import GenomicRegion
from ..intervals.collection import GRC, _open_maybe_gz


class FracRegion(GenomicRegion):
    __slots__ = ("frac",)

    def __init__(self, c="-1", p1=0, p2=0, hdr: BamHeader | None = None,
                 frac: float = 0.0):
        if isinstance(c, str) and hdr is not None:
            super().__init__(c, p1, p2, hdr=hdr)
        else:
            super().__init__(c if not isinstance(c, str) else -1,
                             p1, p2)
        self.frac = float(frac)

    def __repr__(self):
        return f"{super().__repr__()} frac={self.frac}"


class Fractions:
    def __init__(self):
        self.m_frc = GRC()

    def size(self) -> int:
        return len(self.m_frc)

    def read_from_bed(self, path: str, hdr: BamHeader) -> bool:
        """4-column BED: chr start end fraction."""
        try:
            fh = _open_maybe_gz(path)
        except OSError:
            return False
        with fh:
            for line in fh:
                if line.startswith("#") or not line.strip():
                    continue
                parts = line.split()
                if len(parts) < 4:
                    continue
                try:
                    fr = FracRegion(parts[0], parts[1], parts[2], hdr,
                                    float(parts[3]))
                except (ValueError, TypeError):
                    continue
                if fr.chr >= 0:
                    self.m_frc.add(fr)
        return True

    def find_fraction(self, chrid: int, pos1: int, pos2: int) -> float:
        """Fraction of the first region overlapping the query (1.0 when
        none — keep everything by default)."""
        if self.m_frc.num_tree() == 0:
            self.m_frc.create_tree_map()
        ids = self.m_frc.find_overlapped_intervals(
            GenomicRegion(chrid, pos1, pos2), True)
        if not ids:
            return 1.0
        return self.m_frc[ids[0]].frac

    readFromBed = read_from_bed

"""Per-read-group BAM statistics (counterpart of
seqlib_tpu/stats/bamstats.py).

SeqLib's BamStats: BamReadGroup counters (reads/supp/unmap/qcfail/dup/
mate_unmap) and histograms of mapq/nm/isize/clip/phred/len with SeqLib's
bin ranges.
"""

from __future__ import annotations

import numpy as np

from ..core.record import BamRecord
from .histogram import Histogram


def mean_phred(r: BamRecord) -> float:
    if r.qual is None or len(r.qual) == 0:
        return -1.0
    return float(np.mean(r.qual))


class BamReadGroup:
    def __init__(self, name: str = ""):
        self.name = name
        self.reads = 0
        self.supp = 0
        self.unmap = 0
        self.qcfail = 0
        self.duplicate = 0
        self.mate_unmap = 0
        self.mapq = Histogram(0, 100, 1)
        self.nm = Histogram(0, 100, 1)
        self.isize = Histogram(-2, 2000, 10)
        self.clip = Histogram(0, 100, 5)
        self.phred = Histogram(0, 100, 1)
        self.len = Histogram(0, 250, 1)

    def add_read(self, r: BamRecord) -> None:
        self.reads += 1
        if r.secondary_flag():
            self.supp += 1
        if r.qc_fail_flag():
            self.qcfail += 1
        if r.duplicate_flag():
            self.duplicate += 1
        if not r.mapped_flag():
            self.unmap += 1
        if not r.mate_mapped_flag():
            self.mate_unmap += 1
        if 0 <= r.mapq <= 100:
            self.mapq.add_elem(r.mapq)
        nm = r.get_int_tag("NM") or 0
        if nm <= 100:
            self.nm.add_elem(nm)
        if not r.pair_mapped_flag():
            isize = -2
        elif not r.interchromosomal():
            isize = abs(r.isize)
        else:
            isize = -1
        self.isize.add_elem(isize)
        self.clip.add_elem(r.num_clip())
        self.len.add_elem(r.length())
        self.phred.add_elem(int(mean_phred(r)))

    def __repr__(self):
        sep = "\t"
        return sep.join([
            self.name, str(self.reads), str(self.supp), str(self.unmap),
            str(self.mate_unmap), str(self.qcfail), str(self.duplicate),
            self.mapq.to_file_string(), self.nm.to_file_string(),
            self.isize.to_file_string(), self.clip.to_file_string(),
            self.phred.to_file_string(), self.len.to_file_string()])


class BamStats:
    HEADER = ("ReadGroup\tReadCount\tSupplementary\tUnmapped\tMateUnmapped"
              "\tQCFailed\tDuplicate\tMappingQuality\tNM\tInsertSize"
              "\tClippedBases\tMeanPhredScore\tReadLength")

    def __init__(self):
        self.group_map: dict[str, BamReadGroup] = {}

    def add_read(self, r: BamRecord) -> None:
        rg = r.get_z_tag("RG") or ""
        if not rg:
            rg = "QNAMED_" + r.parse_read_group()
        if rg not in self.group_map:
            self.group_map[rg] = BamReadGroup(rg)
        self.group_map[rg].add_read(r)

    def __repr__(self):
        lines = [self.HEADER]
        for g in self.group_map.values():
            lines.append(repr(g))
        return "\n".join(lines)

    addRead = add_read

"""GenomicRegionCollection (GRC): container + overlap engine
(counterpart of seqlib_tpu/intervals/collection.py).

SeqLib's GenomicRegionCollection API and semantics, backed by a Python
list of GenomicRegion plus a per-chromosome :class:`IntervalIndex`
built by ``create_tree_map``.  ``shuffle`` draws from the module-global
``random``, so ``random.seed(s)`` fixes its order.
"""

from __future__ import annotations

import gzip
import random

import numpy as np

from ..core.header import BamHeader
from ..core.region import GenomicRegion
from .tree import IntervalIndex


def _open_maybe_gz(path: str):
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "r")


class GenomicRegionCollection:
    def __init__(self, arg=None, *, width=None, ovlp=None, header=None):
        self.regions: list[GenomicRegion] = []
        self._trees: dict[int, IntervalIndex] = {}
        self._sorted = False
        self.idx = 0
        if arg is None and width is None:
            return
        if width is not None:
            self._init_tiled(width, ovlp or 0, arg, header)
        elif isinstance(arg, GenomicRegion):
            self.regions.append(arg)
            self._sorted = True
        elif isinstance(arg, str):
            self._init_from_file(arg, header)
        elif arg is not None:
            for x in arg:
                if isinstance(x, GenomicRegion):
                    self.regions.append(x)
                else:  # BamRecord-like
                    self.regions.append(x.as_genomic_region())

    # -- tiling constructors --------------------------------------------------

    def _init_tiled(self, width, ovlp, arg, header) -> None:
        if width <= ovlp:
            raise ValueError("Width should be > ovlp")
        if isinstance(arg, BamHeader) or header is not None and arg is None:
            hdr = arg if isinstance(arg, BamHeader) else header
            for chridx, hs in enumerate(hdr.sequences()):
                gr = GenomicRegion(chridx, 0, hs.length)
                if width >= gr.width():
                    self.regions.append(gr)
                    continue
                start, end = gr.pos1, gr.pos1 + width
                while end <= gr.pos2:
                    self.regions.append(GenomicRegion(gr.chr, start, end))
                    end += width - ovlp
                    start += width - ovlp
            return
        gr = arg
        if width >= gr.width():
            self.regions.append(gr)
            return
        start, end = gr.pos1, gr.pos1 + width
        while end <= gr.pos2:
            self.regions.append(GenomicRegion(gr.chr, start, end))
            end += width - ovlp
            start += width - ovlp
        # finish the tail (region form only)
        if self.regions and self.regions[-1].pos2 != gr.pos2:
            self.regions.append(
                GenomicRegion(gr.chr, self.regions[-1].pos2 - ovlp, gr.pos2))
        self._sorted = True

    # -- file readers ---------------------------------------------------------

    def _init_from_file(self, path: str, hdr: BamHeader) -> None:
        if ":" in path:
            self._sorted = True
            self.regions.append(GenomicRegion(path, hdr=hdr))
            return
        if ".vcf" in path:
            self.read_vcf(path, hdr)
        else:
            self.read_bed(path, hdr)

    def read_bed(self, path: str, hdr: BamHeader | None = None) -> bool:
        """First 3 BED columns; lines containing '#' skipped; raw
        coordinates kept as-is."""
        self._sorted = False
        self.idx = 0
        try:
            fh = _open_maybe_gz(path)
        except OSError:
            return False
        with fh:
            for line in fh:
                if "#" in line or not line.strip():
                    continue
                parts = line.split()
                if len(parts) < 3:
                    continue
                try:
                    gr = GenomicRegion(parts[0], parts[1], parts[2], hdr=hdr)
                except (ValueError, TypeError):
                    continue
                if gr.chr >= 0:
                    self.regions.append(gr)
        return True

    def read_vcf(self, path: str, hdr: BamHeader | None = None) -> bool:
        """chr + pos as width-1 regions."""
        self._sorted = False
        self.idx = 0
        try:
            fh = _open_maybe_gz(path)
        except OSError:
            return False
        with fh:
            for line in fh:
                if not line.strip() or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) < 2:
                    continue
                try:
                    gr = GenomicRegion(parts[0], parts[1], parts[1], hdr=hdr)
                except (ValueError, TypeError):
                    continue
                if gr.chr >= 0:
                    self.regions.append(gr)
        return True

    # -- basic container ------------------------------------------------------

    def add(self, gr: GenomicRegion) -> None:
        self.regions.append(gr)
        self._sorted = False

    def __len__(self):
        return len(self.regions)

    size = __len__

    def __getitem__(self, i):
        return self.regions[i]

    def at(self, i):
        if i >= len(self.regions):
            raise IndexError(i)
        return self.regions[i]

    def __iter__(self):
        return iter(self.regions)

    def is_empty(self) -> bool:
        return not self.regions

    def clear(self) -> None:
        self.regions.clear()
        self._trees.clear()

    def concat(self, other: "GenomicRegionCollection") -> None:
        if not len(other):
            return
        self._sorted = False
        self.regions.extend(other.regions)

    def pad(self, v: int) -> None:
        for r in self.regions:
            r.pad(v)

    def total_width(self) -> int:
        return sum(r.width() for r in self.regions)

    # -- sorting / shuffling --------------------------------------------------

    def coordinate_sort(self) -> None:
        self.regions.sort(key=lambda g: (g.chr, g.pos1, g.pos2))
        self._sorted = True

    def shuffle(self) -> None:
        random.shuffle(self.regions)

    def sort_and_stretch_right(self, maxv: int) -> None:
        if not self.regions:
            return
        self.coordinate_sort()
        if 0 < maxv < self.regions[-1].pos2:
            raise ValueError(
                "SortAndStretchRight: already past max")
        for i in range(len(self.regions) - 1):
            self.regions[i].pos2 = self.regions[i + 1].pos1 - 1
        if maxv > 0:
            self.regions[-1].pos2 = maxv

    def sort_and_stretch_left(self, minv: int) -> None:
        if not self.regions:
            return
        self.coordinate_sort()
        if 0 <= minv < self.regions[0].pos1:
            self.regions[0].pos1 = minv
        elif minv >= 0:
            raise ValueError("SortAndStretchLeft: already below min")
        for i in range(1, len(self.regions)):
            self.regions[i].pos1 = self.regions[i - 1].pos2 + 1

    # -- merge ----------------------------------------------------------------

    def merge_overlapping_intervals(self) -> None:
        """GenomicRanges-style reduce; touching intervals merge."""
        if not self.regions:
            return
        rs = sorted(self.regions, key=lambda g: (g.chr, g.pos1, g.pos2))
        out = [GenomicRegion(rs[0].chr, rs[0].pos1, rs[0].pos2, rs[0].strand)]
        for r in rs[1:]:
            last = out[-1]
            if last.chr == r.chr and last.pos2 >= r.pos1:
                if r.pos2 > last.pos2:
                    last.pos2 = r.pos2
            else:
                out.append(GenomicRegion(r.chr, r.pos1, r.pos2, r.strand))
        self.regions = out
        self._trees.clear()

    # -- tree map -------------------------------------------------------------

    def create_tree_map(self) -> None:
        self._trees.clear()
        if not self.regions:
            return
        if not self._sorted:
            self.coordinate_sort()
        bychr: dict[int, list[tuple[int, int, int]]] = {}
        for i, r in enumerate(self.regions):
            bychr.setdefault(r.chr, []).append((r.pos1, r.pos2, i))
        for c, rows in bychr.items():
            arr = np.asarray(rows, dtype=np.int64)
            self._trees[c] = IntervalIndex(arr[:, 0], arr[:, 1], arr[:, 2])

    def num_tree(self) -> int:
        return len(self._trees)

    def _require_tree(self) -> None:
        if not self._trees and self.regions:
            raise RuntimeError(
                "Need to run CreateTreeMap to make the interval tree "
                "before doing range queries")

    # -- queries --------------------------------------------------------------

    def count_overlaps(self, gr: GenomicRegion) -> int:
        if not self._trees and self.regions:
            return 0  # SeqLib warns and returns 0
        t = self._trees.get(gr.chr)
        return t.count_overlapping(gr.pos1, gr.pos2) if t else 0

    def find_overlapped_intervals(self, gr: GenomicRegion,
                                  ignore_strand: bool = True) -> list[int]:
        self._require_tree()
        t = self._trees.get(gr.chr)
        if not t:
            return []
        ids = t.find_overlapping(gr.pos1, gr.pos2)
        return [int(i) for i in ids
                if ignore_strand or self.regions[int(i)].strand == gr.strand]

    def find_overlaps(self, query, ignore_strand: bool = True):
        """One-vs-many or many-vs-many overlap.

        * gr query -> GRC of trimmed intersections.
        * GRC query -> (GRC, query_ids, subject_ids): self is the QUERY
          collection, the argument is the SUBJECT with the tree.
        """
        if isinstance(query, GenomicRegion):
            self._require_tree()
            out = GenomicRegionCollection()
            t = self._trees.get(query.chr)
            if not t:
                return out
            for sid, s, e in t.find_overlapping_intervals(query.pos1,
                                                          query.pos2):
                if ignore_strand or self.regions[sid].strand == query.strand:
                    out.add(GenomicRegion(query.chr, max(s, query.pos1),
                                          min(e, query.pos2)))
            return out
        # many-vs-many: query=self, subject=argument
        subject = query
        out = GenomicRegionCollection()
        query_ids: list[int] = []
        subject_ids: list[int] = []
        if subject.num_tree() == 0 and len(subject) != 0:
            return out, query_ids, subject_ids
        for i, q in enumerate(self.regions):
            t = subject._trees.get(q.chr)
            if not t:
                continue
            for sid, s, e in t.find_overlapping_intervals(q.pos1, q.pos2):
                if ignore_strand or subject.regions[sid].strand == q.strand:
                    query_ids.append(i)
                    subject_ids.append(sid)
                    out.add(GenomicRegion(q.chr, max(s, q.pos1),
                                          min(e, q.pos2)))
        return out, query_ids, subject_ids

    def find_overlap_width(self, gr: GenomicRegion,
                           ignore_strand: bool = True) -> int:
        out = self.find_overlaps(gr, ignore_strand)
        if not len(out):
            return 0
        out.merge_overlapping_intervals()
        return sum(r.width() for r in out)

    def overlap_same_interval(self, gr1: GenomicRegion,
                              gr2: GenomicRegion) -> bool:
        """True if gr1 and gr2 overlap a common subject interval."""
        if gr1.chr != gr2.chr:
            return False
        t1 = self._trees.get(gr1.chr)
        t2 = self._trees.get(gr2.chr)
        if not t1 or not t2:
            return False
        a = set(int(i) for i in t1.find_overlapping(gr1.pos1, gr1.pos2))
        b = set(int(i) for i in t2.find_overlapping(gr2.pos1, gr2.pos2))
        return bool(a & b)

    def intersection(self, other: "GenomicRegionCollection",
                     ignore_strand: bool = True) -> "GenomicRegionCollection":
        """Trimmed overlaps of the two collections; the tree goes on the
        larger one."""
        if len(other) > len(self):
            if other.num_tree() == 0:
                other.create_tree_map()
            out, _, _ = self.find_overlaps(other, ignore_strand)
        else:
            if self.num_tree() == 0:
                self.create_tree_map()
            out, _, _ = other.find_overlaps(self, ignore_strand)
        return out

    # -- batch (columnar count path) -----------------------------------------

    def count_overlaps_batch(self, chrs, p1s, p2s) -> np.ndarray:
        """Vectorized CountOverlaps over parallel arrays — the fast path
        used by the ReadFilter engine on read batches."""
        chrs = np.asarray(chrs)
        p1s = np.asarray(p1s, dtype=np.int64)
        p2s = np.asarray(p2s, dtype=np.int64)
        out = np.zeros(chrs.size, dtype=np.int64)
        for c, t in self._trees.items():
            m = chrs == c
            if m.any():
                out[m] = t.count_overlapping_batch(p1s[m], p2s[m])
        return out

    # -- export ---------------------------------------------------------------

    def as_bed_string(self, hdr: BamHeader | None = None) -> str:
        """One ``chr\tpos1\tpos2\tstrand`` line per region."""
        if not self.regions:
            return ""
        return "".join(
            f"{r.chr_name(hdr)}\t{r.pos1}\t{r.pos2}\t{r.strand}\n"
            for r in self.regions)

    def as_genomic_region_vector(self) -> list[GenomicRegion]:
        return [GenomicRegion(r.chr, r.pos1, r.pos2, r.strand)
                for r in self.regions]

    # reference-style aliases
    CoordinateSort = coordinate_sort
    Shuffle = shuffle
    MergeOverlappingIntervals = merge_overlapping_intervals
    CreateTreeMap = create_tree_map
    CountOverlaps = count_overlaps
    FindOverlaps = find_overlaps
    ReadBED = read_bed
    ReadVCF = read_vcf
    TotalWidth = total_width
    Concat = concat
    Pad = pad


GRC = GenomicRegionCollection

"""Histogram with explicit bin bounds (counterpart of
seqlib_tpu/stats/histogram.py).

Bin (inclusive [start, end] bounds + count) and Histogram with either a
fixed-width constructor or quantile initialization from data.
"""

from __future__ import annotations

import bisect

import numpy as np

INTERCHR = 250000000


class Bin:
    __slots__ = ("count", "lo", "hi")

    def __init__(self, lo: int = 0, hi: int = 1, count: int = 0):
        self.lo = lo
        self.hi = hi
        self.count = count

    def contains(self, elem: int) -> bool:
        return self.lo <= elem <= self.hi

    def __lt__(self, other):
        return (self.lo, self.hi) < (other.lo, other.hi)

    def __repr__(self):
        return f"{self.lo},{self.hi},{self.count}"


class Histogram:
    def __init__(self, start: int | None = None, end: int | None = None,
                 width: int | None = None):
        self.bins: list[Bin] = []
        if start is None:
            return
        if end <= start:
            raise ValueError("Histogram: end must be > start")
        lo = start
        while lo <= end:
            hi = min(lo + width - 1, end)
            self.bins.append(Bin(lo, hi))
            lo += width

    # -- quantile initialization (Histogram::Initialize) --------------------

    def initialize(self, num_bins: int, spans: list[int],
                   min_bin_width: int = 0) -> None:
        if not spans:
            return
        s = sorted(spans)
        self.bins = []
        per = max(1, len(s) // num_bins)
        i = 0
        lo = s[0]
        while i < len(s):
            j = min(i + per, len(s)) - 1
            hi = s[j]
            if min_bin_width and hi - lo + 1 < min_bin_width:
                hi = lo + min_bin_width - 1
            if self.bins and lo <= self.bins[-1].hi:
                lo = self.bins[-1].hi + 1
            if hi >= lo:
                self.bins.append(Bin(lo, hi))
            # advance past values covered
            while i < len(s) and s[i] <= hi:
                i += 1
            if i < len(s):
                lo = s[i]
        if self.bins:
            self.bins[-1].hi = max(self.bins[-1].hi, s[-1])

    # -- element ops --------------------------------------------------------

    def retrieve_bin_id(self, elem: int) -> int:
        los = [b.lo for b in self.bins]
        i = bisect.bisect_right(los, elem) - 1
        if i < 0:
            return 0
        return i

    def add_elem(self, elem: int) -> None:
        if not self.bins:
            return
        i = self.retrieve_bin_id(elem)
        if self.bins[i].contains(elem) or True:
            self.bins[i].count += 1

    def remove_elem(self, elem: int) -> None:
        if not self.bins:
            return
        self.bins[self.retrieve_bin_id(elem)].count -= 1

    # -- queries ------------------------------------------------------------

    def total_count(self) -> int:
        return sum(b.count for b in self.bins)

    def bin_count(self, i: int) -> int:
        return self.bins[i].count

    def num_bins(self) -> int:
        return len(self.bins)

    def to_file_string(self) -> str:
        """Comma string of per-bin counts (used in BamStats output)."""
        return ",".join(str(b.count) for b in self.bins if b.count > 0) \
            or "0"

    def to_csv(self) -> str:
        return "".join(f"{b.lo},{b.hi},{b.count}\n" for b in self.bins)

    def __repr__(self):
        return f"Histogram({len(self.bins)} bins, n={self.total_count()})"

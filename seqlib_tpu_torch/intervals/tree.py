"""Interval overlap index (counterpart of seqlib_tpu/intervals/tree.py).

In place of SeqLib's pointer-based centered interval tree, numpy
columnar arrays per chromosome:

* ``starts`` sorted ascending (with ``ids`` carrying original indices),
* ``maxend[i]`` = running max of ``ends[0..i]`` (augmented list),
* a separately sorted copy of ``ends``.

Overlap *counting* is two binary searches (count = #(start <= q2) -
#(end < q1)); overlap *retrieval* walks backwards from the start-bound
using ``maxend`` for early exit.  Both keep SeqLib's
``findOverlapping`` semantics (inclusive endpoints), and counting
vectorizes across query batches.  Results keep the order of a stable
sort by start.
"""

from __future__ import annotations

import numpy as np


class IntervalIndex:
    """Overlap index over one chromosome's intervals."""

    def __init__(self, starts, ends, ids=None):
        starts = np.asarray(starts, dtype=np.int64)
        ends = np.asarray(ends, dtype=np.int64)
        if ids is None:
            ids = np.arange(starts.size, dtype=np.int64)
        else:
            ids = np.asarray(ids, dtype=np.int64)
        order = np.argsort(starts, kind="stable")
        self.starts = starts[order]
        self.ends = ends[order]
        self.ids = ids[order]
        self.maxend = np.maximum.accumulate(self.ends) if len(self.ends) \
            else self.ends
        self.ends_sorted = np.sort(ends)

    def __len__(self):
        return self.starts.size

    # -- single query --------------------------------------------------------

    def _overlapping_positions(self, q1: int, q2: int) -> list[int]:
        hi = int(np.searchsorted(self.starts, q2, side="right"))
        out = []
        i = hi - 1
        while i >= 0 and self.maxend[i] >= q1:
            if self.ends[i] >= q1:
                out.append(i)
            i -= 1
        out.reverse()
        return out

    def find_overlapping(self, q1: int, q2: int) -> np.ndarray:
        """Original ids of intervals with start <= q2 and end >= q1."""
        pos = self._overlapping_positions(q1, q2)
        return self.ids[pos] if pos else np.empty(0, dtype=np.int64)

    def find_overlapping_intervals(self, q1: int, q2: int):
        """(id, start, end) triples of overlapping intervals."""
        pos = self._overlapping_positions(q1, q2)
        return [(int(self.ids[i]), int(self.starts[i]), int(self.ends[i]))
                for i in pos]

    def find_contained(self, q1: int, q2: int) -> np.ndarray:
        """Ids of intervals fully inside [q1, q2] (SeqLib's
        findContained)."""
        pos = [i for i in self._overlapping_positions(q1, q2)
               if self.starts[i] >= q1 and self.ends[i] <= q2]
        return self.ids[pos] if pos else np.empty(0, dtype=np.int64)

    def count_overlapping(self, q1: int, q2: int) -> int:
        a = np.searchsorted(self.starts, q2, side="right")
        b = np.searchsorted(self.ends_sorted, q1, side="left")
        return int(a - b)

    # -- batch queries -------------------------------------------------------

    def count_overlapping_batch(self, q1: np.ndarray, q2: np.ndarray
                                ) -> np.ndarray:
        a = np.searchsorted(self.starts, q2, side="right")
        b = np.searchsorted(self.ends_sorted, q1, side="left")
        return (a - b).astype(np.int64)

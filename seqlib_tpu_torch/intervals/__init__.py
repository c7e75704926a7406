"""Interval collections and their overlap index (counterpart of
seqlib_tpu.intervals)."""

from .collection import GRC, GenomicRegionCollection
from .tree import IntervalIndex

__all__ = ["GRC", "GenomicRegionCollection", "IntervalIndex"]

"""Coverage tracks, BAM statistics, histograms and subsampling fractions
(counterpart of seqlib_tpu.stats)."""

from .bamstats import BamReadGroup, BamStats, mean_phred
from .coverage import STCoverage
from .fractions import FracRegion, Fractions
from .histogram import Bin, Histogram

__all__ = ["BamReadGroup", "BamStats", "mean_phred", "STCoverage",
           "FracRegion", "Fractions", "Bin", "Histogram"]

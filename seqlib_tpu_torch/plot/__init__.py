"""ASCII pileup plots of alignment records (counterpart of
seqlib_tpu.plot)."""

from .seqplot import PlottedRead, PlottedReadLine, SeqPlot

__all__ = ["PlottedRead", "PlottedReadLine", "SeqPlot"]

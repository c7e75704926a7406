"""seqlib_tpu_torch: the PyTorch/CUDA port of seqlib_tpu.

Short-read, long-read and paired alignment (seed, locate, chain, banded
extension, dedup, global DP and traceback, native SAM/BAM emission) on
an NVIDIA Hopper GPU, on indexes of any size (int64 ranks past a 2L text
of 2^31) and on sharded indexes, BFC and string-graph assembly, SAM/BAM/CRAM file
I/O, bwa's index files, interval collections, the JSON read-filter
engine, coverage and BAM statistics, ASCII plots and the ``seqtools``
command line (``python -m seqlib_tpu_torch.cli``).  The package mirrors
``seqlib_tpu``'s layout (``core``, ``index``, ``ops``, ``align``,
``assembly``, ``io``, ``intervals``, ``filters``, ``stats``, ``plot``)
so each module has a named counterpart.

Entry points run on ``device="cuda"`` by default and raise when no GPU
is present; pass ``device="cpu"`` to run every stage through the plain
PyTorch versions of the kernels (the CPU tests do).

Importing the package imports the record model (``core``) and nothing
that builds a kernel or touches the GPU; ``seqlib_tpu_torch.BWAAligner``
and the other subsystem names import their module on first use.
"""

__version__ = "0.1.0"

from .core import (BamHeader, BamRecord, Cigar, CigarField,  # noqa: E402
                   GenomicRegion, HeaderSequence, UnalignedSequence)
from .device import resolve_device  # noqa: E402

_LAZY = {
    "FMIndex": "seqlib_tpu_torch.index",
    "BWAAligner": "seqlib_tpu_torch.align",
    "AlignerOptions": "seqlib_tpu_torch.align",
    "BamReader": "seqlib_tpu_torch.io",
    "BamWriter": "seqlib_tpu_torch.io",
    "FastqReader": "seqlib_tpu_torch.io",
    "RefGenome": "seqlib_tpu_torch.io",
    "BFC": "seqlib_tpu_torch.assembly",
    "FermiAssembler": "seqlib_tpu_torch.assembly",
    "GRC": "seqlib_tpu_torch.intervals",
    "GenomicRegionCollection": "seqlib_tpu_torch.intervals",
    "ReadFilterCollection": "seqlib_tpu_torch.filters",
    "SeqPlot": "seqlib_tpu_torch.plot",
    "BamStats": "seqlib_tpu_torch.stats",
    "STCoverage": "seqlib_tpu_torch.stats",
}


def __getattr__(name):
    """Subsystems on first use: ``seqlib_tpu_torch.BWAAligner`` etc."""
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(name)


__all__ = ["BamHeader", "BamRecord", "Cigar", "CigarField", "GenomicRegion",
           "HeaderSequence", "UnalignedSequence", "resolve_device",
           "__version__", *_LAZY]

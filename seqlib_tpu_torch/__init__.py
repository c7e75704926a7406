"""seqlib_tpu_torch: the PyTorch/CUDA port of seqlib_tpu.

Short-read, long-read and paired alignment (seed, locate, chain, banded
extension, dedup, global DP and traceback, native SAM/BAM emission) on
an NVIDIA Hopper GPU, BFC and string-graph assembly, and SAM/BAM file
I/O.  The package mirrors ``seqlib_tpu``'s layout (``core``, ``index``,
``ops``, ``align``, ``assembly``, ``io``) so each module has a named
counterpart.

Entry points run on ``device="cuda"`` by default and raise when no GPU
is present; pass ``device="cpu"`` to run every stage through the plain
PyTorch versions of the kernels (the CPU tests do).

Importing the package imports no submodule: ``from seqlib_tpu_torch.align
import BWAAligner`` and ``from seqlib_tpu_torch.index import FMIndex``.
"""

__all__ = ["resolve_device"]

from .device import resolve_device  # noqa: E402

"""seqlib_tpu_torch: the PyTorch/CUDA port of seqlib_tpu.

Single-end short-read alignment (seed, locate, chain, banded extension,
dedup, global DP and traceback, native SAM/BAM emission) on an NVIDIA
Hopper GPU.  The package mirrors ``seqlib_tpu``'s layout (``core``,
``index``, ``ops``, ``align``) so each module has a named counterpart.

Entry points run on ``device="cuda"`` by default and raise when no GPU
is present; pass ``device="cpu"`` to run every stage through the plain
PyTorch versions of the kernels (the CPU tests do).

Importing the package imports no submodule: ``from seqlib_tpu_torch.align
import BWAAligner`` and ``from seqlib_tpu_torch.index import FMIndex``.
"""

__all__ = ["resolve_device"]

from .device import resolve_device  # noqa: E402

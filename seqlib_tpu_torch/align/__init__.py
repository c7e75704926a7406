"""Single-end BWA-MEM-style alignment (counterpart of seqlib_tpu.align)."""

from .aligner import BWAAligner, FusedOverflowError  # noqa: F401
from .options import AlignerOptions  # noqa: F401

"""Reference packing and FM-index construction (counterpart of
seqlib_tpu.index)."""

from .fmindex import FMIndex  # noqa: F401
from .pack import both_strands, pack_sequences  # noqa: F401

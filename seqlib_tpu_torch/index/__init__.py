"""Reference packing, FM-index construction, bwa's index files and
sharded indexes (counterpart of seqlib_tpu.index)."""

from .bwa_files import OCC_INTERVAL, SA_INTERVAL
from .fmindex import FMIndex
from .pack import (Lrand48, PackedReference, both_strands, codes_from_pac,
                   pac_bytes, pack_sequences)
from .sharded import ShardedFMIndex

__all__ = ["FMIndex", "ShardedFMIndex", "Lrand48", "PackedReference",
           "both_strands", "pack_sequences", "pac_bytes", "codes_from_pac",
           "OCC_INTERVAL", "SA_INTERVAL"]

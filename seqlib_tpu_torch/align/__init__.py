"""Single-end BWA-MEM-style alignment (counterpart of seqlib_tpu.align)."""

from .aligner import AlnReg, BWAAligner, FusedOverflowError
from .chain import Chain, chain_seeds, filter_chains
from .options import AlignerOptions
from .sharded import ShardedBWAAligner

__all__ = ["BWAAligner", "ShardedBWAAligner", "AlnReg", "Chain",
           "chain_seeds", "filter_chains", "AlignerOptions",
           "FusedOverflowError"]

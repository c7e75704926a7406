"""BFC error correction and string-graph assembly (counterpart of
seqlib_tpu.assembly)."""

from .bfc import BFC, KmerTable, auto_kmer, canonical_kmers
from .fermi import AssemblyOptions, FermiAssembler, Unitig

__all__ = ["BFC", "KmerTable", "auto_kmer", "canonical_kmers",
           "AssemblyOptions", "FermiAssembler", "Unitig"]

"""Sequence codes, CIGARs, headers, regions and alignment records
(counterpart of seqlib_tpu.core, with the same exports)."""

from .cigar import Cigar, CigarField, CIGAR_OPS
from .header import BamHeader, HeaderSequence
from .record import (BamRecord, BamRecordVector, sort_by_position,
                     sort_by_qname,
                     FPAIRED, FPROPER_PAIR, FUNMAP, FMUNMAP, FREVERSE,
                     FMREVERSE, FREAD1, FREAD2, FSECONDARY, FQCFAIL, FDUP,
                     FSUPPLEMENTARY,
                     FRORIENTATION, FFORIENTATION, RFORIENTATION,
                     RRORIENTATION, UDORIENTATION)
from .region import GenomicRegion, parse_region_string
from .seq import (revcomp, revcomp_nt4, encode_nt4, decode_nt4,
                  pack_nibbles, unpack_nibbles)
from .unaligned import UnalignedSequence, UnalignedSequenceVector

__all__ = [
    "Cigar", "CigarField", "CIGAR_OPS", "BamHeader", "HeaderSequence",
    "BamRecord", "BamRecordVector", "sort_by_position", "sort_by_qname",
    "GenomicRegion", "parse_region_string", "revcomp", "revcomp_nt4",
    "encode_nt4", "decode_nt4", "pack_nibbles", "unpack_nibbles",
    "UnalignedSequence", "UnalignedSequenceVector",
]

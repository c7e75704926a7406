"""Sequence codes, CIGARs, headers and alignment records (counterpart of
seqlib_tpu.core)."""

from .cigar import Cigar, CigarField  # noqa: F401
from .header import BamHeader, HeaderSequence  # noqa: F401
from .record import BamRecord  # noqa: F401
from .seq import (NT4_TABLE, decode_nt4, encode_nt4, revcomp,  # noqa: F401
                  revcomp_nt4)
from .unaligned import UnalignedSequence  # noqa: F401

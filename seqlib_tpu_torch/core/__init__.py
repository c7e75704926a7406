"""Sequence codes (counterpart of seqlib_tpu.core)."""

from .seq import NT4_TABLE, encode_nt4, revcomp  # noqa: F401

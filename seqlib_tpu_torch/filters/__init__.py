"""The JSON read-filter engine and its Aho-Corasick motif matcher
(counterpart of seqlib_tpu.filters)."""

from .ahocorasick import AhoCorasick, AhoCorasickTrie
from .readfilter import (AbstractRule, Flag, FlagRule, Range, ReadFilter,
                         ReadFilterCollection, wang_hash, x31_hash)

__all__ = ["AhoCorasick", "AhoCorasickTrie", "AbstractRule", "Flag",
           "FlagRule", "Range", "ReadFilter", "ReadFilterCollection",
           "wang_hash", "x31_hash"]

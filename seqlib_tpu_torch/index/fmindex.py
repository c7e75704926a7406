"""In-memory FM-index construction (counterpart of
seqlib_tpu/index/fmindex.py, ``FMIndex.construct``).

Rank space: ranks 0..n over the n+1 suffixes of T$ (rank 0 = sentinel),
bwa's bwtint space.  The checkpointed layout is the one the device
kernels read: per 128-base block, 4 cumulative occurrence counts and 8
packed 32-bit words (16 bases per word, first base in the top 2 bits).
The full suffix array is kept, so a device locate is one gather.
"""

from __future__ import annotations

import numpy as np

from ..core.header import BamHeader
from ..native import suffix_array
from .pack import Annotation, Hole, PackedReference, both_strands, \
    pack_sequences

OCC_INTERVAL = 128


def occ_layout(bwt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """BWT codes -> (cp_counts int64 [nb+1, 4], bwt_words uint32 [nb, 8]).

    cp_counts[b] counts each code in bwt[0 : 128*b]; the last row holds
    the totals."""
    n = bwt.size
    nb = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    padded = np.full(nb * OCC_INTERVAL, 255, dtype=np.uint8)
    padded[:n] = bwt
    blocks = padded.reshape(nb, OCC_INTERVAL)
    cps = np.zeros((nb + 1, 4), dtype=np.int64)
    for c in range(4):
        np.cumsum((blocks == c).sum(axis=1), out=cps[1:, c])
    q = np.where(blocks == 255, 0, blocks).reshape(nb, 8, 16) \
        .astype(np.uint32)
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    words = (q << shifts).sum(axis=2, dtype=np.uint32)
    return cps, words


class FMIndex:
    """FM-index over forward + reverse complement of the reference."""

    def __init__(self):
        self.ref: PackedReference | None = None
        self.sa_full: np.ndarray | None = None   # int64 [seq_len + 1]
        self.seq_len = 0                          # 2 * l_pac
        self.primary = 0                          # rank of suffix 0
        self.L2 = np.zeros(5, dtype=np.int64)     # cumulative counts
        self.cp_counts: np.ndarray | None = None  # int64 [nb + 1, 4]
        self.bwt_words: np.ndarray | None = None  # uint32 [nb, 8]

    @classmethod
    def construct(cls, seqs) -> "FMIndex":
        """Build from [(name, seq)] pairs or objects with ``.name`` and
        ``.seq`` (``UnalignedSequence``, what ``FastqReader`` yields)."""
        idx = cls()
        idx.ref = pack_sequences([(s.name, s.seq) if hasattr(s, "name")
                                  else (s[0], s[1]) for s in seqs])
        text = both_strands(idx.ref.codes)
        n = text.size
        idx.seq_len = n
        sa_full = suffix_array(text + 1)
        idx.primary = int(np.nonzero(sa_full == 0)[0][0])
        sel = sa_full[sa_full > 0]
        bwt = text[sel - 1]
        counts = np.bincount(text, minlength=4)[:4]
        idx.L2[1:] = np.cumsum(counts)
        idx.cp_counts, idx.bwt_words = occ_layout(bwt)
        idx.sa_full = sa_full
        return idx

    @classmethod
    def from_arrays(cls, *, codes: np.ndarray, anns, bwt_words: np.ndarray,
                    cp_counts: np.ndarray, L2: np.ndarray, primary: int,
                    sa_full: np.ndarray, holes=()) -> "FMIndex":
        """Build the port's index from host arrays made elsewhere.

        codes: forward nt4 codes; anns: (name, offset, length, n_amb)
        tuples; the rest as in :meth:`construct`.  Lets two
        implementations align against the very same index state."""
        idx = cls()
        idx.ref = PackedReference(
            np.asarray(codes, np.uint8).copy(),
            [Annotation(str(a[0]), int(a[1]), int(a[2]), int(a[3]))
             for a in anns],
            [Hole(int(h[0]), int(h[1]), str(h[2])) for h in holes])
        idx.seq_len = 2 * idx.ref.l_pac
        idx.primary = int(primary)
        idx.L2 = np.asarray(L2, np.int64).copy()
        idx.cp_counts = np.asarray(cp_counts, np.int64).copy()
        idx.bwt_words = np.asarray(bwt_words, np.uint32).copy()
        idx.sa_full = np.asarray(sa_full, np.int64).copy()
        nb = (idx.seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL
        if idx.bwt_words.shape != (nb, 8) or idx.cp_counts.shape != (nb + 1, 4) \
                or idx.sa_full.shape != (idx.seq_len + 1,):
            raise ValueError("FMIndex.from_arrays: inconsistent shapes")
        return idx

    @property
    def l_pac(self) -> int:
        return self.ref.l_pac

    def contig_names(self) -> list[str]:
        return [a.name for a in self.ref.anns]

    def contig_lengths(self) -> np.ndarray:
        return np.array([a.length for a in self.ref.anns], np.int64)

    def contig_offsets(self) -> np.ndarray:
        return np.array([a.offset for a in self.ref.anns], np.int64)

    def sam_header_text(self) -> str:
        return "".join(f"@SQ\tSN:{a.name}\tLN:{a.length}\n"
                       for a in self.ref.anns)

    def header_from_index(self) -> BamHeader:
        return BamHeader(self.sam_header_text())

    def pos_to_ref(self, pos: int) -> tuple[int, int]:
        """Forward-strand text offset -> (reference id, offset in it)."""
        offs = self.contig_offsets()
        rid = int(np.searchsorted(offs, pos, side="right") - 1)
        return rid, pos - int(offs[rid])

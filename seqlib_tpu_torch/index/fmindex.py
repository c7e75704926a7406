"""FM-index: construction, bwa's index files and host search
(counterpart of seqlib_tpu/index/fmindex.py).

Rank space: ranks 0..n over the n+1 suffixes of T$ (rank 0 = sentinel),
bwa's bwtint space, so the sampled suffix array round-trips byte for
byte with ``bwa index``'s files.  The checkpointed layout is the one
the .bwt file holds and the device kernels read: per 128-base block, 4
cumulative occurrence counts and 8 packed 32-bit words (16 bases per
word, first base in the top 2 bits).

A constructed index keeps the full suffix array, so a device locate is
one gather; a loaded one has the samples only (``sa_full`` is None),
and a locate walks LF to a sample.
"""

from __future__ import annotations

import numpy as np

from .. import profiling
from ..core.header import BamHeader
from ..native import suffix_array
from .bwa_files import (OCC_INTERVAL, SA_INTERVAL, deinterleave_occ,
                        interleave_occ, read_amb, read_ann, read_bwt,
                        read_pac, read_sa, write_amb, write_ann, write_bwt,
                        write_pac, write_sa)
from .pack import Annotation, Hole, PackedReference, both_strands, \
    pack_sequences

_SHIFTS = np.arange(15, -1, -1, dtype=np.uint32) * 2


def split_occ(words: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The .bwt body (:func:`interleave_occ`) -> (cp_counts int64
    [nb+1, 4], bwt_words uint32 [nb, 8]); cp_counts[b] counts each code
    in bwt[0 : 128 b], the last row holds the totals."""
    nb = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    body = words[:nb * 16].reshape(nb, 16)
    cps = np.empty((nb + 1, 4), dtype=np.int64)
    cps[:-1] = body[:, :8].copy().view(np.uint64).reshape(nb, 4)
    cps[-1] = words[nb * 16:nb * 16 + 8].copy().view(np.uint64)
    return cps, body[:, 8:].copy()


def occ_layout(bwt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """BWT codes -> (cp_counts, bwt_words), the device layout, read off
    the .bwt body so the two cannot disagree."""
    return split_occ(interleave_occ(bwt), bwt.size)


class FMIndex:
    """FM-index over forward + reverse complement of the reference."""

    def __init__(self):
        self.ref: PackedReference | None = None
        self.sa_full: np.ndarray | None = None   # int64 [seq_len + 1]
        self.seq_len = 0                          # 2 * l_pac
        self.primary = 0                          # rank of suffix 0
        self.L2 = np.zeros(5, dtype=np.int64)     # cumulative counts
        self.bwt: np.ndarray | None = None        # uint8 [seq_len], no $
        self.cp_counts: np.ndarray | None = None  # int64 [nb + 1, 4]
        self.bwt_words: np.ndarray | None = None  # uint32 [nb, 8]
        self.sa_intv = SA_INTERVAL
        self.sa_samples: np.ndarray | None = None  # uint64, [0] all ones

    @classmethod
    def construct(cls, seqs) -> "FMIndex":
        """Build from [(name, seq)] pairs or objects with ``.name`` and
        ``.seq`` (``UnalignedSequence``, what ``FastqReader`` yields)."""
        idx = cls()
        idx.ref = pack_sequences([(s.name, s.seq) if hasattr(s, "name")
                                  else (s[0], s[1]) for s in seqs])
        text = both_strands(idx.ref.codes)
        idx.seq_len = text.size
        sa_full = suffix_array(text + 1)
        idx.primary = int(np.nonzero(sa_full == 0)[0][0])
        idx.L2[1:] = np.cumsum(np.bincount(text, minlength=4)[:4])
        idx.bwt = text[sa_full[sa_full > 0] - 1]
        idx.cp_counts, idx.bwt_words = occ_layout(idx.bwt)
        idx._set_sa_full(sa_full)
        return idx

    def _set_sa_full(self, sa_full: np.ndarray) -> None:
        """The full SA and its samples by rank: sa_samples[j] =
        sa_full[j * sa_intv], [0] all ones (bwa's placeholder)."""
        self.sa_full = sa_full
        self.sa_samples = sa_full[::self.sa_intv].astype(np.uint64)
        self.sa_samples[0] = np.uint64(0xFFFFFFFFFFFFFFFF)

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
        nb = (idx.seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL
        sa_full = np.asarray(sa_full, np.int64).copy()
        if idx.bwt_words.shape != (nb, 8) or idx.cp_counts.shape != (nb + 1, 4) \
                or sa_full.shape != (idx.seq_len + 1,):
            raise ValueError("FMIndex.from_arrays: inconsistent shapes")
        codes = (idx.bwt_words[:, :, None] >> _SHIFTS) & 3
        idx.bwt = codes.astype(np.uint8).reshape(-1)[:idx.seq_len]
        idx._set_sa_full(sa_full)
        return idx

    # ------------------------------------------------------------------
    # bwa's index files
    # ------------------------------------------------------------------

    def write(self, prefix: str) -> None:
        """``prefix``.{pac, ann, amb, bwt, sa}, as ``bwa index`` writes
        them."""
        if self.ref is None:
            raise RuntimeError("FMIndex.write: no index constructed")
        L2 = self.L2.astype(np.uint64)
        write_pac(prefix + ".pac", self.ref.codes)
        write_ann(prefix + ".ann", self.ref)
        write_amb(prefix + ".amb", self.ref)
        write_bwt(prefix + ".bwt", self.primary, L2,
                  interleave_occ(self.bwt))
        write_sa(prefix + ".sa", self.primary, L2, self.sa_intv,
                 self.seq_len, self.sa_samples)

    @classmethod
    def load(cls, prefix: str) -> "FMIndex":
        """Read ``prefix``.{pac, ann, amb, bwt, sa}; the full SA stays
        None (a locate walks to a sample).  While the tracer is on, the
        span ``index.load`` holds ``index.read_pac`` (.ann, .amb, .pac),
        ``index.read_bwt``, ``index.layout`` (the .bwt body split into
        BWT codes, checkpoints and words) and ``index.read_sa``."""
        idx = cls()
        with profiling.span("index.load"):
            with profiling.span("index.read_pac"):
                l_pac, seed, anns = read_ann(prefix + ".ann")
                holes = read_amb(prefix + ".amb")
                codes = read_pac(prefix + ".pac")
            if codes.size != l_pac:
                raise ValueError(f"{prefix}.pac holds {codes.size} bases, "
                                 f".ann says {l_pac}")
            idx.ref = PackedReference(codes, anns, holes, seed)
            with profiling.span("index.read_bwt"):
                primary, L2, words = read_bwt(prefix + ".bwt")
            idx.primary = int(primary)
            idx.L2 = L2.astype(np.int64)
            idx.seq_len = n = int(L2[4])
            with profiling.span("index.layout"):
                idx.bwt = deinterleave_occ(words, n)[0]
                idx.cp_counts, idx.bwt_words = split_occ(words, n)
            with profiling.span("index.read_sa"):
                sp, intv, seq_len, sa = read_sa(prefix + ".sa")
            if sp != primary or seq_len != n:
                raise ValueError(f"{prefix}.sa does not match {prefix}.bwt")
            idx.sa_intv = intv
            idx.sa_samples = sa
        return idx

    # ------------------------------------------------------------------
    # annotations and header
    # ------------------------------------------------------------------

    @property
    def l_pac(self) -> int:
        return self.ref.l_pac

    def num_sequences(self) -> int:
        return len(self.ref.anns)

    def chr_id_to_name(self, i: int) -> str:
        if i < 0 or i >= len(self.ref.anns):
            raise IndexError(f"BWAIndex::ChrIDToName - id {i} out of bounds")
        return self.ref.anns[i].name

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

    # ------------------------------------------------------------------
    # host rank and search (numpy)
    # ------------------------------------------------------------------

    def rank(self, c: int, k) -> np.ndarray:
        """Occurrences of c in bwt[0..k-1], k in [0, seq_len];
        vectorised over k."""
        k = np.asarray(k, dtype=np.int64)
        blk = k >> 7
        within = k & 127
        words = self.bwt_words[np.minimum(blk, self.bwt_words.shape[0] - 1)]
        codes = ((words[..., :, None] >> _SHIFTS) & 3).reshape(
            *k.shape, 128)
        cnt = ((codes == c) & (np.arange(128) < within[..., None])).sum(
            axis=-1)
        return self.cp_counts[blk, c] + cnt

    def rank_full(self, c: int, k) -> np.ndarray:
        """Rank over BWT_full (the sentinel at row ``primary``)."""
        k = np.asarray(k, dtype=np.int64)
        return self.rank(c, k - (k > self.primary))

    def backward_ext(self, l, u, c):
        """One backward-search step: [l, u) over ranks [0, seq_len + 1)
        -> the interval of c + pattern."""
        C = self.L2[c] + 1
        return C + self.rank_full(c, l), C + self.rank_full(c, u)

    def search(self, pattern: np.ndarray) -> tuple[int, int]:
        """Exact-match SA interval [l, u) of an nt4 pattern; (0, 0) when
        it is absent or holds a code over 3."""
        l, u = 0, self.seq_len + 1
        for c in pattern[::-1]:
            if c > 3:
                return 0, 0
            l, u = self.backward_ext(l, u, int(c))
            if l >= u:
                return 0, 0
        return int(l), int(u)

    def sa_lookup(self, r: int) -> int:
        """Text position of rank r: LF walk to a sample."""
        steps = 0
        while True:
            if r % self.sa_intv == 0 and r // self.sa_intv > 0:
                return int(self.sa_samples[r // self.sa_intv]) + steps
            if r == 0:
                return self.seq_len + steps   # the sentinel
            if r == self.primary:
                return steps                  # SA[primary] = 0
            c = int(self.bwt[r - 1 if r > self.primary else r])
            r = int(self.L2[c]) + 1 + int(self.rank_full(c, r))
            steps += 1

    def locate(self, l: int, u: int, max_hits: int = 512) -> np.ndarray:
        """Text positions of ranks [l, u), at most max_hits."""
        rs = range(l, min(u, l + max_hits))
        return np.array([self.sa_lookup(r) for r in rs], dtype=np.int64)

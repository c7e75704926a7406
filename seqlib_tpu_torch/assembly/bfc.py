"""BFC-style k-mer spectrum error correction (counterpart of
seqlib_tpu/assembly/bfc.py).

``train`` counts canonical k-mers on the device (pack, sort, unique
counts: ``ops/kmer.py``); ``error_correct`` estimates k-mer coverage
from the count histogram (kcov = tot_k / sum_k over counts >= min_cnt;
min_cov = clamp(int(0.1 * kcov + 0.499), min_cnt, max_cnt)), pre-scans
the reads for a weak window and walks only those through the device
spectrum walk.  The host mirror ``table`` (a ``KmerTable`` of uint64
keys) is built from the device table.  API parity: AddSequence /
SetKmer / Train / ErrorCorrect / GetSequence / kcov.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.seq import NT4_TABLE, decode_nt4
from ..device import resolve_device
from ..ops.kmer import (canonical_kmers_device, correct_reads_device,
                        count_kmers_device, to_uint64, weak_reads_device)

BFC_EC_MIN_COV_COEF = 0.1


def _pack_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """All k-mers of a [L] nt4 array as uint64 (invalid where N)."""
    L = codes.size
    if L < k:
        return np.empty(0, dtype=np.uint64)
    n = L - k + 1
    out = np.zeros(n, dtype=np.uint64)
    bad = np.zeros(n, dtype=bool)
    for j in range(k):
        c = codes[j:j + n]
        out = (out << np.uint64(2)) | c.astype(np.uint64)
        bad |= c > 3
    return np.where(bad, np.uint64(0xFFFFFFFFFFFFFFFF), out)


def _revcomp_kmers(kmers: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement packed k-mers."""
    x = ~kmers  # complement each 2-bit base
    out = np.zeros_like(kmers)
    for _ in range(k):
        out = (out << np.uint64(2)) | (x & np.uint64(3))
        x >>= np.uint64(2)
    return out


def canonical_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    f = _pack_kmers(codes, k)
    valid = f != np.uint64(0xFFFFFFFFFFFFFFFF)
    r = _revcomp_kmers(f, k)
    return np.where(valid, np.minimum(f, r),
                    np.uint64(0xFFFFFFFFFFFFFFFF))


class KmerTable:
    """Sorted-array k-mer count table (bfc_ch_t analog): counting is a
    sort + segment-reduce, lookup is searchsorted."""

    def __init__(self, kmers: np.ndarray):
        valid = kmers[kmers != np.uint64(0xFFFFFFFFFFFFFFFF)]
        self.keys, self.counts = np.unique(valid, return_counts=True)

    def lookup(self, kmers: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self.keys, kmers)
        idx = np.minimum(idx, max(self.keys.size - 1, 0))
        if self.keys.size == 0:
            return np.zeros(kmers.shape, dtype=np.int64)
        hit = self.keys[idx] == kmers
        return np.where(hit, self.counts[idx], 0)

    def hist(self, max_cnt: int = 255) -> np.ndarray:
        h = np.zeros(max_cnt + 1, dtype=np.int64)
        np.add.at(h, np.minimum(self.counts, max_cnt), 1)
        return h


def auto_kmer(total_len: int) -> int:
    """Auto k selection (fml_opt_adjust analog): grows with data size,
    clamped to [17, 27] and forced odd."""
    if total_len <= 0:
        return 17
    k = int(math.log(total_len) / math.log(4) + 8.5)
    k = max(17, min(27, k))
    return k | 1


def encode_reads(seqs: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """Reads as one [B, max length] nt4 matrix (4 past a read's end)
    and int64 lengths."""
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    L = int(lens.max()) if lens.size else 0
    reads = np.full((len(seqs), L), 4, np.uint8)
    flat = NT4_TABLE[np.frombuffer("".join(seqs).encode(), np.uint8)]
    reads[np.arange(L)[None, :] < lens[:, None]] = flat
    return reads, lens


class BFC:
    """API parity: SeqLib/SeqLib/BFC.h:22-115.  Runs on
    ``device`` ("cuda" by default; "cpu" runs the plain PyTorch path)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.m_seqs: list[str] = []
        self.m_names: list[str] = []
        self.m_quals: list[str] = []
        self.m_idx = 0
        self.kmer = 0          # 0 = auto (SetKmer parity)
        self.kcov = 0.0
        self.table: KmerTable | None = None
        self.min_cov = 3
        self.flt_uniq = 0
        self.min_cnt = 4       # fml_opt_init defaults
        self.max_cnt = 8
        self._dev = None       # (keys, counts) on self.device

    # -- reads ----------------------------------------------------------

    def add_sequence(self, seq: str, qual: str = "", name: str = "") -> bool:
        if not seq:
            return False
        self.m_seqs.append(seq.upper())
        self.m_quals.append(qual)
        self.m_names.append(name)
        return True

    def allocate_from_reads(self, brv) -> None:
        """From BamRecords (parity: allocate_sequences_from_reads)."""
        for r in brv:
            self.add_sequence(r.seq, r.qualities(), r.qname)

    def num_sequences(self) -> int:
        return len(self.m_seqs)

    def clear_reads(self) -> None:
        self.m_seqs = []
        self.m_names = []
        self.m_quals = []
        self.m_idx = 0

    def get_sequence(self):
        """Iterator-style retrieval, uppercased
        (parity: GetSequence BFC.cpp:141-151); returns (seq, name) or
        None."""
        if self.m_idx >= len(self.m_seqs):
            return None
        s = self.m_seqs[self.m_idx].upper()
        n = self.m_names[self.m_idx]
        self.m_idx += 1
        return s, n

    def reset_get_sequence(self) -> None:
        self.m_idx = 0

    def get_kcov(self) -> float:
        return self.kcov

    def get_kmer(self) -> int:
        return self.kmer

    def set_kmer(self, k: int) -> None:
        self.kmer = k

    # -- training (parity: Train BFC.cpp:208-280) -----------------------

    def _device_batch(self):
        """The reads on the device: nt4 codes [B, max length], lengths."""
        return (torch.from_numpy(a).to(self.device)
                for a in encode_reads(self.m_seqs))

    def train(self) -> None:
        if not self.m_seqs:
            return
        total = sum(len(s) for s in self.m_seqs)
        if self.kmer <= 0:
            self.kmer = auto_kmer(total)
        k = self.kmer
        reads, lens = self._device_batch()
        keys, cnt = count_kmers_device(
            *canonical_kmers_device(reads, lens, k))
        self._dev = (keys, cnt)
        # host mirror for the KmerTable API (fermi filters, tests)
        t = KmerTable.__new__(KmerTable)
        t.keys = to_uint64(keys.cpu().numpy(), k)
        t.counts = cnt.cpu().numpy().astype(np.int64)
        self.table = t

    # -- correction (parity: ErrorCorrect BFC.cpp:282-362) --------------

    def error_correct(self) -> None:
        if self.table is None:
            self.train()
        if self.table is None or self.table.keys.size == 0:
            return
        k = self.kmer
        # exact reference coverage estimate (BFC.cpp:326-346):
        # counts capped at 255, summed over i >= min_cnt
        h = self.table.hist(max_cnt=255)
        idx = np.arange(256)
        sel = idx >= self.min_cnt
        sum_k = int(h[sel].sum())
        tot_k = int((idx[sel] * h[sel]).sum())
        self.kcov = float(tot_k) / sum_k if sum_k else 0.0
        raw = int(BFC_EC_MIN_COV_COEF * self.kcov + 0.499)
        self.min_cov = max(self.min_cnt, min(raw, self.max_cnt))
        reads, lens = self._device_batch()
        keys, cnt = self._dev
        # cheap pre-scan: only reads with at least one weak window go
        # through the (expensive) walk
        weak = weak_reads_device(reads, lens, keys, cnt, k, self.min_cov)
        idx = torch.nonzero(weak)[:, 0]
        if idx.numel() == 0:
            return
        sl = lens[idx]
        corr, nchg = correct_reads_device(
            reads[idx, :int(sl.max())], sl, keys, cnt, k, self.min_cov)
        changed = torch.nonzero(nchg > 0)[:, 0]
        for i, row, n in zip(idx[changed].tolist(),
                             corr[changed].cpu().numpy(),
                             sl[changed].tolist()):
            self.m_seqs[i] = decode_nt4(row[:n])

    # reference-style aliases
    AddSequence = add_sequence
    Train = train
    ErrorCorrect = error_correct
    GetSequence = get_sequence
    SetKmer = set_kmer
    NumSequences = num_sequences
    ClearReads = clear_reads
    GetKCov = get_kcov
    GetKMer = get_kmer

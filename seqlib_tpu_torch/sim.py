"""Seeded synthetic reference and read simulators (numpy only).

``make_genome`` builds one random contig with planted exact repeat
pairs, 1%-divergent copies and a tandem block (the repeat classes of
the repository's hermetic golden corpus, scaled up).  ``simulate_reads``
draws wgsim-like single-end reads: uniform positions on both strands,
substitutions at a fixed rate, a share with a 1-4 bp insertion or
deletion, and a share with a random soft-clip flank.  Each read name
carries its truth: ``<prefix><i>_<pos>_<strand>`` with ``pos`` the
0-based leftmost reference base of the read's aligned part.

``simulate_long_reads`` draws long reads (1.5-10 kb by default) named
the same way, with substitutions, about one short indel per kb and a
share with a random 3' tail.  ``simulate_pairs`` is the port's copy of
``seqlib_tpu.sim.simulate_pairs`` (wgsim-like pairs, truth in the
names): the same seed gives the same pairs.

``kmer_batch`` and ``kmer_region_reads`` are the seeded k-mer test
batches (random reads with repeats, and a 4 kb region with a planted
tie, an N and an early error) that the k-mer pipeline is checked on.

``make_repeat_genome`` / ``make_repeat_reads`` are the port's copy of
the hermetic repeat corpus of ``tests/regen_golden.py`` (131 kb contig
'rep1', 1000 reads in 10 classes), whose golden SAM
``tests/golden/sam_repeat_1k.txt`` the JAX package produced.
"""

from __future__ import annotations

import numpy as np

from .core.seq import revcomp
from .core.unaligned import UnalignedSequence

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_genome(length: int = 4_600_000, seed: int = 7, n_segments: int = 4,
                seg_len: int = 5000, tandem_unit: int = 60,
                tandem_copies: int = 50) -> str:
    """Random contig with, per segment, two exact copies and one copy
    at 1% divergence, plus one tandem block."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, length).astype(np.uint8)
    stride = length // (3 * n_segments + 2)
    slot = 1
    for _ in range(n_segments):
        seg = rng.integers(0, 4, seg_len).astype(np.uint8)
        div = seg.copy()
        nmut = seg_len // 100
        muts = rng.choice(seg_len, nmut, replace=False)
        div[muts] = (div[muts] + rng.integers(1, 4, nmut)) % 4
        for copy in (seg, seg, div):
            g[slot * stride:slot * stride + seg_len] = copy
            slot += 1
    unit = rng.integers(0, 4, tandem_unit).astype(np.uint8)
    t0 = slot * stride
    g[t0:t0 + tandem_unit * tandem_copies] = np.tile(unit, tandem_copies)
    return BASES[g].tobytes().decode()


_COMP = np.zeros(256, np.uint8)
_COMP[list(b"ACGT")] = list(b"TGCA")


def _rc(b: np.ndarray) -> np.ndarray:
    return _COMP[b][::-1]


def simulate_reads(genome: str, n: int, seed: int = 11, length: int = 150,
                   sub_rate: float = 0.002, indel_frac: float = 0.08,
                   clip_frac: float = 0.04, prefix: str = "sim"):
    """n reads as (name, seq) pairs; see the module docstring."""
    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome.encode(), np.uint8)
    span = length + 8
    starts = rng.integers(0, g.size - span, n)
    rev = rng.random(n) < 0.5
    kind = rng.random(n)
    reads = []
    for i in range(n):
        p = int(starts[i])
        lead = 0                 # bases before the aligned part (fwd frame)
        if kind[i] < indel_frac:
            k = int(rng.integers(1, 5))
            cut = int(rng.integers(40, length - 40))
            if rng.random() < 0.5:                        # deletion
                frag = np.concatenate([g[p:p + cut],
                                       g[p + cut + k:p + length + k]])
            else:                                          # insertion
                ins = BASES[rng.integers(0, 4, k)]
                frag = np.concatenate([g[p:p + cut], ins,
                                       g[p + cut:p + length - k]])
        else:
            frag = g[p:p + length].copy()
            if kind[i] < indel_frac + clip_frac:
                c = int(rng.integers(20, 41))
                frag[:c] = BASES[rng.integers(0, 4, c)]
                lead = c
        frag = frag.copy()
        hit = rng.random(length) < sub_rate
        if hit.any():
            idx = np.flatnonzero(hit)
            cur = np.searchsorted(BASES, frag[idx])
            frag[idx] = BASES[(cur + rng.integers(1, 4, idx.size)) % 4]
        if rev[i]:
            frag = _rc(frag)
        name = f"{prefix}{i}_{p + lead}_{'-' if rev[i] else '+'}"
        reads.append((name, frag.tobytes().decode()))
    return reads


def simulate_long_reads(genome: str, n: int, seed: int = 13,
                        min_len: int = 1500, max_len: int = 10_000,
                        sub_rate: float = 0.002, tail_frac: float = 0.1,
                        tail_len: tuple[int, int] = (200, 400),
                        prefix: str = "long"):
    """n long reads as (name, seq) pairs: lengths uniform in [min_len,
    max_len] (the genomic part), uniform positions on both strands, one
    1-4 bp insertion or deletion in every full kb, substitutions at
    ``sub_rate``, and for a ``tail_frac`` share a random 3' tail of
    ``tail_len`` bases (appended after the strand flip, so a reverse
    read's tail is clipped on the left of its record).  The name's
    position is the 0-based leftmost reference base of the genomic
    part."""
    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome.encode(), np.uint8)
    lengths = rng.integers(min_len, max_len + 1, n)
    rev = rng.random(n) < 0.5
    tails = rng.random(n) < tail_frac
    reads = []
    for i in range(n):
        length = int(lengths[i])
        p = int(rng.integers(0, g.size - length - 8 * (length // 1000) - 8))
        parts, cur = [], p
        for k in range(length // 1000):
            cut = p + 1000 * k + int(rng.integers(100, 900))
            parts.append(g[cur:cut])
            d = int(rng.integers(1, 5))
            if rng.random() < 0.5:                         # deletion
                cur = cut + d
            else:                                          # insertion
                parts.append(BASES[rng.integers(0, 4, d)])
                cur = cut
        got = sum(x.size for x in parts)
        parts.append(g[cur:cur + length - got])
        frag = np.concatenate(parts)
        hit = np.flatnonzero(rng.random(frag.size) < sub_rate)
        cur_b = np.searchsorted(BASES, frag[hit])
        frag[hit] = BASES[(cur_b + rng.integers(1, 4, hit.size)) % 4]
        if rev[i]:
            frag = _rc(frag)
        if tails[i]:
            t = int(rng.integers(tail_len[0], tail_len[1] + 1))
            frag = np.concatenate([frag, BASES[rng.integers(0, 4, t)]])
        name = f"{prefix}{i}_{p}_{'-' if rev[i] else '+'}"
        reads.append((name, frag.tobytes().decode()))
    return reads


def simulate_pairs(seqs: list[tuple[str, str]], n_pairs: int,
                   read_len: int = 150, dist: int = 300, stdev: int = 30,
                   error_rate: float = 0.002, seed: int = 7):
    """wgsim-like pairs: (reads1, reads2) lists of UnalignedSequence.

    Fragments of Normal(dist, stdev) length (at least read_len + 10) at
    uniform positions of contigs drawn by length; mate 1 is the
    fragment's start and mate 2 the reverse complement of its end, or
    the other way round with probability 1/2; substitutions at
    ``error_rate``.  Names are ``<contig>_<beg1>_<end>_0:0:0_0:0:0_<k>``
    with /1 and /2."""
    rng = np.random.default_rng(seed)
    lengths = np.array([len(s) for _, s in seqs], dtype=np.float64)
    probs = lengths / lengths.sum()
    reads1, reads2 = [], []
    qual = "2" * read_len

    def mutate(s: str) -> str:
        arr = np.frombuffer(s.encode(), dtype=np.uint8).copy()
        for e in np.flatnonzero(rng.random(arr.size) < error_rate):
            arr[e] = rng.choice(BASES[BASES != arr[e]])
        return arr.tobytes().decode()

    made = 0
    while made < n_pairs:
        ci = int(rng.choice(len(seqs), p=probs))
        name, seq = seqs[ci]
        isize = max(int(rng.normal(dist, stdev)), read_len + 10)
        if len(seq) <= isize:
            continue
        beg = int(rng.integers(0, len(seq) - isize))
        frag = seq[beg:beg + isize]
        if "N" in frag:
            continue
        r1, r2 = frag[:read_len], revcomp(frag[-read_len:])
        if rng.random() < 0.5:
            r1, r2 = revcomp(frag[-read_len:]), frag[:read_len]
        nm = f"{name}_{beg + 1}_{beg + isize}_0:0:0_0:0:0_{made:x}"
        reads1.append(UnalignedSequence(nm + "/1", mutate(r1), qual))
        reads2.append(UnalignedSequence(nm + "/2", mutate(r2), qual))
        made += 1
    return reads1, reads2


def edge_read_batch(genome: str, B: int, L: int, seed: int = 0):
    """B simulated reads as nt4 codes at the edges of the SMEM machine:
    uint8 [B, L] (4 = N or padding), lens int32 [B], active bool [B].
    Reads are L - L // 16 bases long; every 5th is cut to a random
    length >= 1, every 7th carries a single N and a run of three N, every
    13th is empty (length 0) and every 11th is inactive."""
    rng = np.random.default_rng(seed)
    n = L - L // 16
    code = np.full(256, 4, np.uint8)
    code[list(b"ACGT")] = [0, 1, 2, 3]
    reads = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, (_, s) in enumerate(simulate_reads(genome, B, seed=seed,
                                              length=n)):
        r = code[np.frombuffer(s.encode(), np.uint8)]
        reads[i, :r.size] = r
        lens[i] = r.size
    idx = np.arange(B)
    cut = idx % 5 == 4
    lens[cut] = rng.integers(1, n + 1, int(cut.sum()))
    for i in np.flatnonzero(idx % 7 == 3):
        a, b = rng.integers(0, n - 3, 2)
        reads[i, a] = 4
        reads[i, b:b + 3] = 4
    lens[idx % 13 == 6] = 0
    reads[np.arange(L)[None, :] >= lens[:, None]] = 4
    active = (lens > 0) & (idx % 11 != 5)
    return reads, lens, active


def kmer_batch():
    """24 reads of 72 random bases (seed 0), one N and one read of 40;
    rows 12-17 repeat rows 0-5 and rows 18-23 are the reverse
    complements of rows 6-11, so a table of them has counts of 2 and
    more.  Returns (reads uint8 [24, 72], lens int64)."""
    rng = np.random.default_rng(0)
    B, L = 24, 72
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    reads[12:18] = reads[0:6]
    reads[18:24] = 3 - reads[6:12, ::-1]
    reads[3, 10] = 4
    lens = np.full(B, L, np.int64)
    lens[5] = 40
    reads[5, 40:] = 4
    return reads, lens


KMER_READ = 80
KMER_REP = (1000, 3000)           # a 200 bp segment planted twice
KMER_REP_DIFF = 100               # the copies differ here: A, then C


def kmer_region_reads():
    """A seeded 4 kb region with a 200 bp segment at 1000 and 3000 whose
    copies differ in one base (A at 1100, C at 3100).  Error-free reads
    of 80 bp tile the region every 4 bp on alternating strands, so both
    copies have the same counts; 150 reads with 1% substitutions start
    away from the copies; then five probes: a read with G at 1100 (50
    bases in; its candidates A and C tie), one from 2000 with an N at
    60, one from 2500 with an error at 5 (left of its first solid
    window), one of 12 bases (shorter than every k) and one of 20.
    Returns (region codes, reads uint8 [B, 80], lens int64, index of the
    first probe)."""
    rng = np.random.default_rng(42)
    g = rng.integers(0, 4, 4000).astype(np.uint8)
    seg = rng.integers(0, 4, 200).astype(np.uint8)
    for r in KMER_REP:
        g[r:r + seg.size] = seg
    g[KMER_REP[0] + KMER_REP_DIFF], g[KMER_REP[1] + KMER_REP_DIFF] = 0, 1
    n = KMER_READ

    def rc(x):
        return 3 - x[::-1]

    reads = [g[s:s + n] if i % 2 == 0 else rc(g[s:s + n])
             for i, s in enumerate(range(0, g.size - n + 1, 4))]
    for s in np.concatenate([rng.integers(1300, 2800 - n, 100),
                             rng.integers(3300, 4000 - n, 50)]):
        x = g[s:s + n].copy()
        err = np.flatnonzero(rng.random(n) < 0.01)
        x[err] = (x[err] + rng.integers(1, 4, err.size)) % 4
        reads.append(x if rng.random() < 0.5 else rc(x))
    at = KMER_REP[0] + KMER_REP_DIFF
    tie = g[at - 50:at + 30].copy()
    tie[50] = 2
    nread = g[2000:2000 + n].copy()
    nread[60] = 4
    back = g[2500:2500 + n].copy()
    back[5] = (back[5] + 1) % 4
    n_plain = len(reads)
    reads += [tie, nread, back, g[100:112].copy(), g[200:220].copy()]
    lens = np.array([len(x) for x in reads], np.int64)
    arr = np.full((len(reads), n), 4, np.uint8)
    for i, x in enumerate(reads):
        arr[i, :len(x)] = x
    return g, arr, lens, n_plain


def make_repeat_genome() -> str:
    """Repeat-heavy synthetic genome, fully deterministic (seed 7):
    random background with two exact copies of a 3 kb segment (20k,
    60k), a 1%-divergent third copy (90k), a 50 x 60 bp tandem block
    (120k) and a random tail; 131 kb."""
    rng = np.random.default_rng(7)
    g = rng.integers(0, 4, 131_000).astype(np.uint8)
    seg = rng.integers(0, 4, 3000).astype(np.uint8)
    g[20_000:23_000] = seg
    g[60_000:63_000] = seg
    div = seg.copy()
    muts = rng.choice(3000, 30, replace=False)
    div[muts] = (div[muts] + rng.integers(1, 4, 30)) % 4
    g[90_000:93_000] = div
    unit = rng.integers(0, 4, 60).astype(np.uint8)
    g[120_000:123_000] = np.tile(unit, 50)
    return BASES[g].tobytes().decode()


def make_repeat_reads(genome: str):
    """1000 deterministic 150 bp reads in 10 classes of 100: exact
    forward, exact reverse complement, 2 mismatches, 4 bp deletion, 4 bp
    insertion, 40 bp chimeric clip, exact-duplicate multimapper,
    divergent copy (XA), tandem repeat, and seed-dense truncation
    stress."""
    rng = np.random.default_rng(11)
    L = 150
    reads = []

    def sub(p):
        return genome[p:p + L]

    def rc(s):
        return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]

    def mutate(s, n):
        b = np.frombuffer(s.encode(), dtype=np.uint8).copy()
        for p in rng.choice(L, n, replace=False):
            cur = b"ACGT".index(b[p])
            b[p] = BASES[(cur + int(rng.integers(1, 4))) % 4]
        return b.tobytes().decode()

    def bg():
        return int(rng.integers(0, 119_000 - L))

    for i in range(100):
        reads.append((f"rep_exact_{i}", sub(bg())))
    for i in range(100):
        reads.append((f"rep_rc_{i}", rc(sub(bg()))))
    for i in range(100):
        reads.append((f"rep_mm2_{i}", mutate(sub(bg()), 2)))
    for i in range(100):
        p = bg()
        reads.append((f"rep_del4_{i}",
                      genome[p:p + 70] + genome[p + 74:p + 74 + (L - 70)]))
    for i in range(100):
        p = bg()
        ins = BASES[rng.integers(0, 4, 4)].tobytes().decode()
        reads.append((f"rep_ins4_{i}",
                      genome[p:p + 70] + ins + genome[p + 70:p + 70
                                                      + (L - 74)]))
    for i in range(100):
        flank = BASES[rng.integers(0, 4, 40)].tobytes().decode()
        reads.append((f"rep_clip_{i}", flank + sub(bg())[:110]))
    for i in range(100):
        reads.append((f"rep_dup_{i}",
                      sub(20_000 + int(rng.integers(0, 3000 - L)))))
    for i in range(100):
        reads.append((f"rep_xa_{i}",
                      sub(90_000 + int(rng.integers(0, 3000 - L)))))
    for i in range(100):
        reads.append((f"rep_tandem_{i}",
                      sub(120_000 + int(rng.integers(0, 3000 - L)))))
    for i in range(100):
        p = 120_000 + int(rng.integers(0, 2800))
        reads.append((f"rep_stress_{i}", genome[p:p + 50]
                      + genome[p + 60:p + 110] + genome[p + 120:p + 170]))
    return reads


def placement_rate(sam_text: str, tol: int = 5) -> tuple[int, int]:
    """(reads whose primary record lies within ``tol`` bp of the truth
    in its name, on the right strand; reads with a primary record)."""
    ok = total = 0
    for line in sam_text.splitlines():
        f = line.split("\t", 4)
        flag = int(f[1])
        if flag & 0x904:          # secondary, supplementary, unmapped
            continue
        total += 1
        _, pos, strand = f[0].rsplit("_", 2)
        if abs(int(f[3]) - 1 - int(pos)) <= tol \
                and bool(flag & 16) == (strand == "-"):
            ok += 1
    return ok, total

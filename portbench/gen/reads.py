"""Single-end reads and read pairs, drawn in whole arrays.

``simulate_reads`` is ``sim.simulate_reads``'s model: uniform positions
on both strands (contigs drawn by length), substitutions at
``sub_rate``, an ``indel_frac`` share with one 1-4 bp insertion or
deletion 40 bases or more from either end, and a ``clip_frac`` share
whose first 20-40 bases are random (a clipped flank).  A read's name
carries its truth: ``<prefix><i>_<contig>_<pos>_<strand>``, ``pos`` the
0-based leftmost reference base of its aligned part.

``simulate_pairs`` is ``sim.simulate_pairs``'s model: fragments of
Normal(dist, stdev) length (at least read_len + 10) at uniform
positions of contigs drawn by length, mate 1 the fragment's start and
mate 2 the reverse complement of its end, or the other way round with
probability 1/2, substitutions at ``error_rate``; names
``<contig>_<beg1>_<end>_0:0:0_0:0:0_<k>`` with /1 and /2."""

from __future__ import annotations

import numpy as np

from . import BASES


def _rows_to_str(codes: np.ndarray) -> list[str]:
    """uint8 [n, L] nt4 codes -> n ACGT strings."""
    n, L = codes.shape
    blob = BASES[codes].tobytes().decode()
    return [blob[i * L:(i + 1) * L] for i in range(n)]


def _substitute(codes: np.ndarray, rate: float,
                rng: np.random.Generator) -> None:
    """Replace each base with probability ``rate`` by another, in place."""
    hit = rng.random(codes.shape) < rate
    codes[hit] = (codes[hit] + rng.integers(1, 4, int(hit.sum()),
                                            dtype=np.uint8)) % 4


def _concat(contigs):
    """(all codes, contig starts, contig lengths)."""
    lens = np.array([c.size for _, c in contigs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return np.concatenate([c for _, c in contigs]), starts, lens


def simulate_reads(contigs, n: int, rng: np.random.Generator,
                   length: int = 150, sub_rate: float = 0.002,
                   indel_frac: float = 0.08, clip_frac: float = 0.04,
                   prefix: str = "r"):
    """n reads of ``length`` bases from [(name, nt4 codes)] contigs:
    (names, seqs)."""
    g, starts, lens = _concat(contigs)
    span = length + 8
    room = np.maximum(lens - span, 0)
    ci = rng.choice(len(contigs), n, p=room / room.sum())
    pos = (rng.random(n) * room[ci]).astype(np.int64)
    rev = rng.random(n) < 0.5
    kind = rng.random(n)
    indel = kind < indel_frac
    clip = (kind >= indel_frac) & (kind < indel_frac + clip_frac)
    k = rng.integers(1, 5, n)
    cut = rng.integers(40, length - 40, n)
    dele = rng.random(n) < 0.5
    c = rng.integers(20, 41, n)
    j = np.arange(length, dtype=np.int64)[None, :]
    frag = g[(starts[ci] + pos)[:, None] + j]
    # a deletion skips k reference bases at the cut; an insertion puts k
    # random bases there and shifts the rest of the read
    m = np.flatnonzero(indel)
    after = j >= cut[m, None]
    shift = np.where(dele[m], k[m], -k[m])[:, None]
    off = np.where(after, j + shift, j)
    frag[m] = g[(starts[ci[m]] + pos[m])[:, None] + np.maximum(off, 0)]
    ins = m[~dele[m]]
    jj = j[:, :8]
    put = (cut[ins, None] + jj, jj < k[ins, None])
    rows = np.broadcast_to(ins[:, None], put[0].shape)[put[1]]
    frag[rows, put[0][put[1]]] = rng.integers(0, 4, rows.size,
                                              dtype=np.uint8)
    cl = np.flatnonzero(clip)
    flank = j < c[cl, None]
    frag[cl] = np.where(flank, rng.integers(0, 4, (cl.size, length),
                                            dtype=np.uint8), frag[cl])
    _substitute(frag, sub_rate, rng)
    frag[rev] = 3 - frag[rev, ::-1]
    lead = np.where(clip, c, 0)
    names = [f"{prefix}{i}_{contigs[q][0]}_{p}_{'-' if r else '+'}"
             for i, (q, p, r) in enumerate(zip(ci.tolist(),
                                                (pos + lead).tolist(),
                                                rev.tolist()))]
    return names, _rows_to_str(frag)


def simulate_pairs(contigs, n_pairs: int, rng: np.random.Generator,
                   read_len: int = 150, dist: int = 300, stdev: int = 30,
                   error_rate: float = 0.002):
    """n_pairs wgsim-like pairs from [(name, nt4 codes)] contigs:
    (names1, seqs1, names2, seqs2)."""
    g, starts, lens = _concat(contigs)
    ci = rng.choice(len(contigs), n_pairs, p=lens / lens.sum())
    isize = np.maximum(rng.normal(dist, stdev, n_pairs).astype(np.int64),
                       read_len + 10)
    if (lens[ci] <= isize).any():
        raise ValueError("simulate_pairs: a contig shorter than a fragment")
    beg = (rng.random(n_pairs) * (lens[ci] - isize)).astype(np.int64)
    j = np.arange(read_len)[None, :]
    head = g[(starts[ci] + beg)[:, None] + j]
    tail = g[(starts[ci] + beg + isize - read_len)[:, None] + j]
    tail = 3 - tail[:, ::-1]
    swap = rng.random(n_pairs) < 0.5
    r1 = np.where(swap[:, None], tail, head)
    r2 = np.where(swap[:, None], head, tail)
    _substitute(r1, error_rate, rng)
    _substitute(r2, error_rate, rng)
    names = [f"{contigs[q][0]}_{b + 1}_{b + s}_0:0:0_0:0:0_{m:x}"
             for m, (q, b, s) in enumerate(zip(ci.tolist(), beg.tolist(),
                                               isize.tolist()))]
    return ([x + "/1" for x in names], _rows_to_str(r1),
            [x + "/2" for x in names], _rows_to_str(r2))


def placement_rate(records, tol: int = 5) -> tuple[int, int]:
    """(reads whose primary record lies within ``tol`` bp of the truth in
    its name, on the right contig and strand; reads with a primary
    record).  ``records``: (qname, flag, contig name, 0-based pos)."""
    ok = total = 0
    for qname, flag, contig, pos in records:
        if flag & 0x904:          # secondary, supplementary, unmapped
            continue
        total += 1
        rest, p, strand = qname.rsplit("_", 2)
        if rest.split("_", 1)[1] == contig and abs(pos - int(p)) <= tol \
                and bool(flag & 16) == (strand == "-"):
            ok += 1
    return ok, total

"""The port's long-read path on the planted truths of
tests/test_long_reads.py: contigs of 1.5-5 kb on the 60 kb reference
(seed 11) must land at their planted position and strand with the
planted CIGAR layout, NM, and an AS equal to the score of walking the
CIGAR.  The queries of one reference go through ``align_batch`` in one
batch (its cost on the CPU is the seed machine's longest read, so one
batch of several reads costs about what one read costs).  The port runs
on the CPU.
"""

import numpy as np
import pytest
import torch

from seqlib_tpu_torch.align import BWAAligner
from seqlib_tpu_torch.core.seq import revcomp
from seqlib_tpu_torch.index import FMIndex


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(11)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, 60_000))


def _mutated_5kb(ref):
    """5 kb slice with 10 spread mismatches, an 8 bp deletion at query
    offset 1500 and a 5 bp insertion at ~3500."""
    rng = np.random.default_rng(5)
    start = 20_000
    piece = list(ref[start:start + 5_000])
    for k in range(10):
        p = 200 + k * 450
        piece[p] = {"A": "C", "C": "G", "G": "T", "T": "A"}[piece[p]]
    del piece[1500:1508]
    piece[3500:3500] = list("".join("ACGT"[i]
                                    for i in rng.integers(0, 4, 5)))
    return "".join(piece)


@pytest.fixture(scope="module")
def planted(ref):
    """Records of the clean 5 kb contig, the mutated one and a 2 kb
    reverse-complemented one, aligned in one batch."""
    aln = BWAAligner(FMIndex.construct([("chrL", ref)]), device="cpu")
    seqs = [ref[10_000:15_000], _mutated_5kb(ref), revcomp(ref[30_000:32_000])]
    out = aln.align_batch(seqs, ["contig5k", "mut5k", "rc2k"])
    return dict(zip(("clean", "mut", "rc"), out)), seqs


def _walk_score(rec, a=1, b=4, o=6, e=1):
    score = 0
    for f in rec.cigar:
        if f.type == "M":
            score += a * f.length
        elif f.type in ("I", "D"):
            score -= o + e * f.length
    n_gap = sum(f.length for f in rec.cigar if f.type in ("I", "D"))
    return score - (rec.get_int_tag("NM") - n_gap) * (a + b)


def _primary(recs):
    prim = [r for r in recs if not r.secondary_flag()]
    assert len(prim) == 1
    return prim[0]


def test_clean_5kb_contig(planted):
    r = _primary(planted[0]["clean"])
    assert (r.tid, r.pos, r.reverse_flag()) == (0, 10_000, False)
    assert str(r.cigar) == "5000M"
    assert (r.get_int_tag("NM"), r.get_int_tag("AS")) == (0, 5000)


def test_mutated_5kb_with_indels(planted):
    r = _primary(planted[0]["mut"])
    seq = planted[1][1]
    assert (r.tid, r.pos) == (0, 20_000)
    cig = [(f.type, f.length) for f in r.cigar]
    assert ("D", 8) in cig and ("I", 5) in cig
    assert sum(l for t, l in cig if t in ("M", "I", "S")) == len(seq)
    assert r.get_int_tag("NM") == 10 + 8 + 5
    assert r.get_int_tag("AS") == _walk_score(r)


def test_revcomp_2kb(planted):
    r = _primary(planted[0]["rc"])
    assert (r.tid, r.pos, r.reverse_flag()) == (0, 30_000, True)
    assert str(r.cigar) == "2000M"


def test_mixed_long_batch_and_duplicate_locus(ref):
    """1.5-5 kb queries in one batch, one of them planted twice: both
    loci surface (primary plus secondary or XA)."""
    dup = ref[40_000:41_600]
    ref2 = ref[:55_000] + dup + ref[55_000:]
    aln = BWAAligner(FMIndex.construct([("chrD", ref2)]), device="cpu")
    out = aln.align_batch([dup, ref2[5_000:10_000],
                           revcomp(ref2[12_000:13_536])],
                          ["dup", "q5k", "rc"])
    prim = [r for r in out[0] if not r.secondary_flag()]
    assert prim and prim[0].pos in (40_000, 55_000)
    assert len({r.pos for r in out[0]}) == 2 or prim[0].get_z_tag("XA")
    for recs, want in zip(out[1:], (5_000, 12_000)):
        p = [r for r in recs if not r.secondary_flag()]
        assert p and p[0].pos == want

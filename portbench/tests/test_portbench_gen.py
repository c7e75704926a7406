"""The generators repeat for a seed, differ across seeds, and keep
sim.py's read model; frozen counting arithmetic equals hand-worked
values."""

import numpy as np
import pytest
import torch

from portbench import roofline
from portbench.gen import genome, reads, stream

CFG = {"contigs": [["c1", 60000], ["c2", 30000], ["m", 9000]],
       "genome_model": {"segments_per_mbp": 50.0, "seg_len": 2000,
                        "tandem_unit": 60, "tandem_copies": 50}}


def _codes(s):
    return np.frombuffer(s.encode(), np.uint8)


def test_genome_repeats_and_differs():
    a, b, c = (genome.make_genome(CFG, s) for s in (5, 5, 6))
    assert [n for n, _ in a] == ["c1", "c2", "m"]
    assert all((x[1] == y[1]).all() for x, y in zip(a, b))
    assert not (a[0][1] == c[0][1]).all()
    assert [x.size for _, x in a] == [60000, 30000, 9000]


def test_genome_model_planted_repeats():
    g = genome.make_contig(60000, stream(1, 1), n_segments=3, seg_len=2000)
    stride = 60000 // 11
    s1, s2, s3 = (g[k * stride:k * stride + 2000] for k in (1, 2, 3))
    assert (s1 == s2).all() and (s1 != s3).sum() == 20
    unit = g[10 * stride:10 * stride + 60]
    assert (g[10 * stride:10 * stride + 3000] == np.tile(unit, 50)).all()


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_reads_repeat_and_differ(seed):
    ct = genome.make_genome(CFG, 5)
    a = reads.simulate_reads(ct, 500, stream(seed, 2))
    b = reads.simulate_reads(ct, 500, stream(seed, 2))
    c = reads.simulate_reads(ct, 500, stream(seed + 1, 2))
    assert a == b and a != c


def test_read_model():
    ct = genome.make_genome(CFG, 7)
    text = {n: genome.as_text(c) for n, c in ct}
    n = 20000
    names, seqs = reads.simulate_reads(ct, n, stream(7, 2), sub_rate=0.002)
    assert all(len(s) == 150 for s in seqs)
    assert names[12].startswith("r12_")
    exact = placed = fwd = 0
    mism = []
    for name, s in zip(names, seqs):
        rest, pos, strand = name.rsplit("_", 2)
        contig = rest.split("_", 1)[1]
        ref = text[contig][int(pos):int(pos) + 150]
        if strand == "-":
            s = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
        else:
            fwd += 1
        d = int((_codes(s) != _codes(ref)).sum()) if len(ref) == 150 else 150
        mism.append(d)
        exact += d == 0
        placed += d <= 3
    share = np.array(mism)
    # 88% of reads are neither indel nor clipped; of those, the
    # substitutions are Binomial(150, 0.002): mean 0.3 a read
    low = share[share <= 3]
    assert 0.84 < placed / n < 0.92
    assert 0.2 < low.mean() < 0.4
    assert 0.47 < fwd / n < 0.53
    # reads drawn by contig length
    by = np.array([nm.rsplit("_", 2)[0].split("_", 1)[1] == "c1"
                   for nm in names])
    assert 0.55 < by.mean() < 0.67


def test_read_model_indels_and_clips():
    ct = [("c", genome.make_contig(100000, stream(2, 1), 0))]
    text = genome.as_text(ct[0][1])
    names, seqs = reads.simulate_reads(ct, 4000, stream(3, 2),
                                       sub_rate=0.0)
    kinds = {"exact": 0, "clip": 0, "indel": 0}
    for name, s in zip(names, seqs):
        _, pos, strand = name.rsplit("_", 2)
        p = int(pos)
        if strand == "-":
            s = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
        if text[p:p + 150] == s:
            kinds["exact"] += 1
        elif s[40:] == text[p:p + 110] or any(
                s[c:] == text[p:p + 150 - c] for c in range(20, 41)):
            kinds["clip"] += 1
        else:
            # an indel read agrees with the reference over its first 40
            # bases and is shifted by 1-4 after its cut
            assert s[:40] == text[p:p + 40]
            kinds["indel"] += 1
    assert 0.06 < kinds["indel"] / 4000 < 0.10
    assert 0.025 < kinds["clip"] / 4000 < 0.055


def test_pairs_model():
    ct = genome.make_genome(CFG, 4)
    text = {n: genome.as_text(c) for n, c in ct}
    n1, s1, n2, s2 = reads.simulate_pairs(ct, 3000, stream(4, 3),
                                          error_rate=0.0)
    assert n1[0].endswith("/1") and n2[0].endswith("/2")
    again = reads.simulate_pairs(ct, 3000, stream(4, 3), error_rate=0.0)
    assert again[1] == s1
    sizes = []
    for name, a, b in zip(n1, s1, s2):
        f = name[:-2].split("_")
        contig, beg, end = f[0], int(f[1]), int(f[2])
        frag = text[contig][beg - 1:end]
        rc = frag[::-1].translate(str.maketrans("ACGT", "TGCA"))
        assert {a, b} == {frag[:150], rc[:150]}
        sizes.append(end - beg + 1)
    assert 290 < np.mean(sizes) < 310 and 25 < np.std(sizes) < 35


def test_placement_rate():
    recs = [("r0_c1_100_+", 0, "c1", 103), ("r1_c1_100_-", 16, "c1", 94),
            ("r2_c1_100_+", 16, "c1", 100), ("r3_c1_100_+", 0, "c2", 100),
            ("r4_c1_100_+", 4, "*", -1), ("r5_c1_100_+", 256, "c1", 100)]
    assert reads.placement_rate(recs) == (1, 4)


def test_k1_bound_counts():
    # two lanes, Lq 4, Lt 6, w 1: lane 0 runs 4 rows over tlen 6, lane 1
    # 2 rows over tlen 3; row R has columns max(0, R-1)..min(tlen, R+1)
    q = torch.zeros(2, 4, dtype=torch.int8)
    t = torch.zeros(2, 6, dtype=torch.int8)
    tl = torch.tensor([6, 3])
    rows = torch.tensor([4, 2])
    # lane 0: R=1: 0..2 (3), R=2: 1..3 (3), R=3: 2..4, R=4: 3..5 -> 12
    # lane 1: R=1: 0..2 (3), R=2: 1..3 (3) -> 6
    assert roofline.band_cells_needed(q, t, tl, 1, rows) == 18
    ms, by = roofline.k1_bound_ms(q, None, t, tl, None, 1, rows)
    nbytes = 8 + 12 + 2 * 32
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / 3.35e12)


def test_k2_bound_counts():
    reads_ = torch.zeros(4, 32, dtype=torch.uint8)
    ms, by = roofline.k2_bound_ms(1000, reads_, max_seeds=2, p3_seeds=0,
                                  wide=False, exts=10**6, rank_words=10**6)
    ops = 32 * 10**6 + 39 * 10**6
    assert by == "operations"
    assert ms == pytest.approx(1e3 * ops / 16.75e12)
    ms, by = roofline.k2_bound_ms(1000, reads_, 2, 0, False, 0, 0)
    nbytes = 1000 + 128 + 64 + 4 + 8 * 4 * 4 + 2 * 4 * 4 + 4 * 4
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / 3.35e12)


def test_global_dp_counts():
    # band 1: a row of qlen 3 over tlen 4 has R=1: 0..2, R=2: 1..3,
    # R=3: 2..4 -> 9 cells; a row of qlen 2 over tlen 1: R=1: 0..1 (2),
    # R=2: 1..1 (1) -> 3
    ql, tl = torch.tensor([3, 2]), torch.tensor([4, 1])
    assert roofline.global_dp_cells(ql, tl, 1) == 12
    assert roofline.global_dp_cells(ql, tl, 208) == 3 * 5 + 2 * 2
    q = torch.zeros(2, 4, dtype=torch.uint8)
    t = torch.zeros(2, 6, dtype=torch.uint8)
    ms, by = roofline.global_dp_bound_ms(q, t, ql, tl, 1)
    walk = ((2 * 10 + 7) // 4 * 4 + 3) // 4
    assert by == "bytes" and ms == pytest.approx(
        1e3 * (12 + 8 + 12 + 16 + 2 * walk) / 3.35e12)

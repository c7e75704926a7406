"""The port's paired-end alignment against the JAX package.

``local_batch`` (mate rescue's local Smith-Waterman) gets the same
random lanes in both packages, within its caps and at the 511 score
clamp; ``infer_dir`` and ``mate_window`` get crafted cases.  Then one
batch of pairs through ``align_pairs``: a seeded two-contig reference
(150 kb), pairs from the JAX package's ``simulate_pairs``, and mate 2 of
every eighth pair mutated at period 8, which leaves it no 19 bp exact
seed, so only rescue can place it.  The SAM lines of both ends and the
inferred insert-size statistics must be equal.  The port runs on the
CPU.

The JAX package global-aligns each rescued mate in its own call, padded
to 64 rows (``aligner._bucket``), which on the CPU takes about ten
seconds a mate; its run here pads to the exact row count instead.  Rows
are independent, so the padding changes no output (tests/test_torch_long.py
checks this on a batch run both ways).
"""

import numpy as np
import pytest
import torch

import seqlib_tpu.align.aligner as jax_aligner_module
from seqlib_tpu.align import BWAAligner as JaxAligner
from seqlib_tpu.align import pairing as jpair
from seqlib_tpu.index import FMIndex as JaxFMIndex
from seqlib_tpu.ops import sw as jsw
from seqlib_tpu.sim import simulate_pairs as jax_simulate_pairs
from seqlib_tpu_torch.align import BWAAligner
from seqlib_tpu_torch.align import pairing as tpair
from seqlib_tpu_torch.index import FMIndex
from seqlib_tpu_torch.ops import sw as tsw
from seqlib_tpu_torch.sim import simulate_pairs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _local_lanes(seed, B, Lq, Lt):
    """Random lanes; every other one holds a mutated copy of its query
    somewhere in its target."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (B, Lq)).astype(np.int8)
    t = rng.integers(0, 5, (B, Lt)).astype(np.int8)
    ql = rng.integers(1, Lq + 1, B).astype(np.int32)
    tl = rng.integers(1, Lt + 1, B).astype(np.int32)
    for b in range(0, B, 2):
        n = int(min(ql[b], tl[b]))
        p = int(rng.integers(0, tl[b] - n + 1))
        t[b, p:p + n] = q[b, :n]
        for x in rng.integers(p, p + n, int(rng.integers(0, 6))):
            t[b, x] = rng.integers(0, 4)
    ql[3] = 0
    return q, ql, t, tl


@pytest.mark.parametrize("Lq,Lt", [(40, 120), (150, 700), (700, 760)])
def test_local_batch_equals_jax(Lq, Lt):
    """Equal outputs on random lanes, mutated copies, an empty query and,
    at Lq 700, exact copies past the 511 score clamp."""
    q, ql, t, tl = _local_lanes(Lq + Lt, 24, Lq, Lt)
    if Lq == 700:
        t[:4, 30:730] = np.where(q[:4] == 4, 0, q[:4])
        q[:4] = t[:4, 30:730]
        ql[:4], tl[:4] = Lq, Lt
    want = jsw.local_batch(*(np.asarray(a) for a in (q, ql, t, tl)))
    got = tsw.local_batch(*(torch.from_numpy(a) for a in (q, ql, t, tl)))
    for k in ("score", "qb", "qe", "tb", "te"):
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k
    if Lq == 700:
        assert (got["score"][:4] == tsw.LOCAL_MAX_SCORE).all()


def test_local_batch_refuses_past_its_caps():
    q = torch.zeros((2, 2048), dtype=torch.int8)
    n = torch.tensor([5, 5], dtype=torch.int32)
    with pytest.raises(ValueError):
        tsw.local_batch(q, n, q[:, :100], n)
    with pytest.raises(ValueError):
        tsw.local_batch(q[:, :100], n, q, n)


def test_infer_dir_equals_jax():
    l_pac = 1000
    rng = np.random.default_rng(4)
    cases = [(100, 300), (300, 100), (100, 1599), (100, 1959), (1100, 1300),
             (999, 1000), (0, 1999), (500, 500)]
    cases += [tuple(int(x) for x in rng.integers(0, 2 * l_pac, 2))
              for _ in range(200)]
    for b1, b2 in cases:
        assert tpair.infer_dir(l_pac, b1, b2) \
            == jpair.infer_dir(l_pac, b1, b2), (b1, b2)


def test_mate_window_equals_jax():
    """All four orientations, anchors on both halves and near both ends
    (clamped windows, windows too short), and a failed orientation."""
    l_pac = 10_000
    stats = []
    for mod in (tpair, jpair):
        st = mod.InsertSizeStats(l_pac=l_pac)
        for d, (low, high) in enumerate([(200, 400), (150, 900), (1, 50),
                                         (300, 301)]):
            st.dirs[d].failed = False
            st.dirs[d].low, st.dirs[d].high = low, high
        stats.append(st)
    for d in range(4):
        for b in (0, 40, 3000, 9_950, 10_000, 10_100, 17_000, 19_990):
            for l_mate in (100, 151):
                assert tpair.mate_window(stats[0], d, b, l_mate) \
                    == jpair.mate_window(stats[1], d, b, l_mate), (d, b)
    stats[0].dirs[tpair.FR].failed = True
    assert tpair.mate_window(stats[0], tpair.FR, 3000, 100) is None


def _mutate_period(seq, period):
    out = list(seq)
    for i in range(0, len(seq), period):
        out[i] = {"A": "C", "C": "G", "G": "T", "T": "A"}[out[i]]
    return "".join(out)


@pytest.fixture(scope="module")
def pair_setup():
    rng = np.random.default_rng(21)
    contigs = [(name, "".join("ACGT"[i] for i in rng.integers(0, 4, n)))
               for name, n in (("ctgA", 90_000), ("ctgB", 60_000))]
    r1, r2 = jax_simulate_pairs(contigs, 64, read_len=120, dist=400,
                                stdev=40, seed=5)
    s1 = [u.seq for u in r1]
    s2 = [u.seq for u in r2]
    for i in range(0, 64, 8):
        s2[i] = _mutate_period(s2[i], 8)
    return contigs, r1, r2, s1, s2, [u.name for u in r1]


def test_simulate_pairs_equals_jax(pair_setup):
    contigs, r1, r2, *_ = pair_setup
    t1, t2 = simulate_pairs(contigs, 64, read_len=120, dist=400, stdev=40,
                            seed=5)
    for a, b in zip(t1 + t2, r1 + r2):
        assert (a.name, a.seq, a.qual) == (b.name, b.seq, b.qual)


def test_align_pairs_equals_jax(pair_setup, monkeypatch):
    """SAM lines of both ends and the inferred insert-size statistics are
    equal; the period-8 mates were rescued (proper pairs, read 2)."""
    contigs, _, _, s1, s2, names = pair_setup
    monkeypatch.setattr(jax_aligner_module, "_bucket",
                        lambda n, mn=64: max(int(n), 1))
    jaln = JaxAligner(JaxFMIndex.construct(contigs))
    jo1, jo2, jst = jpair.align_pairs(jaln, s1, s2, names)
    aln = BWAAligner(FMIndex.construct(contigs), device="cpu")
    to1, to2, tst = tpair.align_pairs(aln, s1, s2, names)
    hdr = aln.index.header_from_index()
    for jo, to in ((jo1, to1), (jo2, to2)):
        want = [r.to_sam(hdr) for rs in jo for r in rs]
        got = [r.to_sam(hdr) for rs in to for r in rs]
        assert got == want
    assert tst.l_pac == jst.l_pac
    for dt, dj in zip(tst.dirs, jst.dirs):
        assert (dt.failed, dt.low, dt.high, dt.avg, dt.std, dt.count) \
            == (dj.failed, dj.low, dj.high, dj.avg, dj.std, dj.count)
    rescued = [i for i in range(0, 64, 8)
               if to2[i] and to2[i][0].proper_pair()
               and to2[i][0].flag & 0x80]
    assert len(rescued) >= 6, rescued
    assert aln.stats["rescue_windows_dropped"] == 0
    # the same batch with the statistics given: the same records
    go1, go2, gst = tpair.align_pairs(aln, s1, s2, names, stats=tst)
    assert gst is tst
    assert [r.to_sam(hdr) for rs in go1 + go2 for r in rs] \
        == [r.to_sam(hdr) for rs in to1 + to2 for r in rs]


def test_wide_rescue_windows_dropped_and_counted(pair_setup):
    """A window wider than local_batch takes: the JAX package rescues
    nothing in that call; the port does the same and counts the call's
    windows."""
    contigs, _, _, s1, _, _ = pair_setup
    aln = BWAAligner(FMIndex.construct(contigs), device="cpu")
    st = tpair.InsertSizeStats(l_pac=aln.index.l_pac)
    st.dirs[tpair.FR].failed = False
    st.dirs[tpair.FR].low, st.dirs[tpair.FR].high = 1, 3000
    jobs = [(0, s1[1], 5000), (1, s1[2], 20_000)]
    assert tpair.rescue_candidates(aln, st, jobs) == {}
    assert aln.stats["rescue_windows_dropped"] == 2
    jaln = JaxAligner(JaxFMIndex.construct(contigs))
    jst = jpair.InsertSizeStats(l_pac=aln.index.l_pac)
    jst.dirs[jpair.FR].failed = False
    jst.dirs[jpair.FR].low, jst.dirs[jpair.FR].high = 1, 3000
    assert jpair.rescue_candidates(jaln, jst, jobs) == {}

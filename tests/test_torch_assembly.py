"""The port's BFC and FermiAssembler (seqlib_tpu_torch.assembly) against
the JAX package's (seqlib_tpu.assembly) on the CPU, tolerance 0, and
the API and option surfaces of tests/test_assembly.py on the port.

Inputs: a seeded random 4 kb region and 550 simulated pairs of 2 x 150
bp at error rate 0.005 (seed 3); error-free pairs (seeds 1 and 9) for
direct assembly and GFA export.  The JAX package runs on the CPU as its
own tests run it; the port runs with ``device="cpu"``.  Corrected
reads, kmer, kcov, min_cov, table keys and counts, contigs, unitig
fields (seq, nsr, cov, links) and GFA text must be equal.
"""

import io

import numpy as np
import pytest

from seqlib_tpu import assembly as ja
from seqlib_tpu.core.unaligned import UnalignedSequence as JUnaligned
from seqlib_tpu_torch import assembly as ta
from seqlib_tpu_torch.assembly.bfc import KmerTable, canonical_kmers
from seqlib_tpu_torch.core.record import BamRecord
from seqlib_tpu_torch.core.seq import encode_nt4, revcomp
from seqlib_tpu_torch.core.unaligned import UnalignedSequence
from seqlib_tpu_torch.sim import simulate_pairs


def _region(n: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)] \
        .tobytes().decode()


@pytest.fixture(scope="module")
def region():
    return _region(4000, 2024)


@pytest.fixture(scope="module")
def sim_reads(region):
    r1, r2 = simulate_pairs([("r", region)], 550, read_len=150,
                            error_rate=0.005, seed=3)
    return [u.seq for u in r1] + [u.seq for u in r2]


def _perfect(region, n, seed):
    r1, r2 = simulate_pairs([("r", region)], n, error_rate=0.0, seed=seed)
    return [(u.name, u.seq) for u in r1 + r2]


def _bfc(mod, reads, **kw):
    b = mod.BFC(**kw)
    for s in reads:
        b.add_sequence(s)
    b.train()
    table = (b.table.keys.copy(), b.table.counts.copy())
    b.error_correct()
    return b, table


@pytest.fixture(scope="module")
def bfc_pair(sim_reads):
    return _bfc(ja, sim_reads), _bfc(ta, sim_reads, device="cpu")


def _fermi(mod, named, **kw):
    f = mod.FermiAssembler(**kw)
    U = JUnaligned if mod is ja else UnalignedSequence
    f.add_reads([U(n, s) for n, s in named])
    return f


def _unitigs(f):
    return [(u.seq, u.nsr, u.cov, u.links) for u in f.get_unitigs()]


def _gfa(f):
    buf = io.StringIO()
    f.write_gfa(buf)
    return buf.getvalue()


def _same_assembly(fj, ft):
    assert ft.get_contigs() == fj.get_contigs()
    assert _unitigs(ft) == _unitigs(fj)
    assert _gfa(ft) == _gfa(fj)


# -- BFC ------------------------------------------------------------------

def test_bfc_parity(region, sim_reads, bfc_pair):
    (bj, tj), (bt, tt) = bfc_pair
    assert bt.device.type == "cpu"
    assert bt.kmer == bj.kmer >= 17
    assert bt.kcov == bj.kcov and bt.kcov > 10
    assert bt.min_cov == bj.min_cov
    assert tt[0].dtype == np.uint64 and np.array_equal(tt[0], tj[0])
    assert np.array_equal(tt[1], tj[1])
    assert bt.m_seqs == bj.m_seqs
    # the JAX test's bar: most imperfect reads are repaired
    before = sum(1 for s in sim_reads if s in region or revcomp(s) in region)
    after = sum(1 for s in bt.m_seqs if s in region or revcomp(s) in region)
    assert after > before + 0.5 * (len(sim_reads) - before)
    assert after >= 0.9 * len(sim_reads)


def test_bfc_explicit_k32(sim_reads):
    """k = 32 (the int64 sign bit) through train and correct."""
    bs = []
    for mod, kw in ((ja, {}), (ta, dict(device="cpu"))):
        b = mod.BFC(**kw)
        b.set_kmer(32)
        for s in sim_reads[:300]:
            b.add_sequence(s)
        b.train()
        b.error_correct()
        bs.append(b)
    assert np.array_equal(bs[1].table.keys, bs[0].table.keys)
    assert np.array_equal(bs[1].table.counts, bs[0].table.counts)
    assert bs[1].m_seqs == bs[0].m_seqs and bs[1].kcov == bs[0].kcov


def test_bfc_keeps_an_n_in_a_read_without_weak_windows():
    """The JAX package's pre-scan counts only valid windows, and a window
    over an N is invalid: a read whose only flaw is an N is not walked,
    so the N stays (the walk itself would replace it).  The port does
    the same."""
    region = _region(2000, 1)
    reads = [region[s:s + 100] for s in range(0, 1900, 5)]
    nread = region[500:550] + "N" + region[551:600]
    out = []
    for mod, kw in ((ja, {}), (ta, dict(device="cpu"))):
        b = mod.BFC(**kw)
        for s in reads + [nread]:
            b.add_sequence(s)
        b.train()
        b.error_correct()
        out.append((b.m_seqs, b.min_cov))
    assert out[1] == out[0]
    assert out[1][0][-1] == nread


def test_bfc_api_surface():
    b = ta.BFC(device="cpu")
    assert b.add_sequence("ACGTACGT", "IIIIIIII", "r1")
    assert not b.add_sequence("")
    assert b.num_sequences() == 1
    s, n = b.get_sequence()
    assert s == "ACGTACGT" and n == "r1"
    assert b.get_sequence() is None
    b.reset_get_sequence()
    assert b.get_sequence() is not None
    b.clear_reads()
    assert b.num_sequences() == 0
    b.set_kmer(21)
    assert b.get_kmer() == 21
    for alias, name in (("AddSequence", "add_sequence"), ("Train", "train"),
                        ("ErrorCorrect", "error_correct"),
                        ("GetSequence", "get_sequence"),
                        ("SetKmer", "set_kmer"),
                        ("NumSequences", "num_sequences"),
                        ("ClearReads", "clear_reads"),
                        ("GetKCov", "get_kcov"), ("GetKMer", "get_kmer")):
        assert getattr(ta.BFC, alias) is getattr(ta.BFC, name)
    rec = BamRecord()
    rec.qname, rec.seq = "q", "acgtn"
    b.allocate_from_reads([rec])
    assert b.m_seqs == ["ACGTN"] and b.m_names == ["q"]
    # reads shorter than k: an empty table, nothing corrected
    b.set_kmer(17)
    b.train()
    b.error_correct()
    assert b.table.keys.size == 0 and b.m_seqs == ["ACGTN"]


def test_kmer_host_helpers():
    codes = encode_nt4("ACGTACGTACGTACGTACGTA")
    k = canonical_kmers(codes, 17)
    assert k.size == 5
    k2 = canonical_kmers(encode_nt4(revcomp("ACGTACGTACGTACGTACGTA")), 17)
    assert set(k.tolist()) == set(k2.tolist())
    codes = encode_nt4("A" * 21)
    t = KmerTable(canonical_kmers(codes, 17))
    assert t.keys.size == 1 and t.counts[0] == 5
    assert t.lookup(canonical_kmers(codes, 17)[:1])[0] == 5
    absent = canonical_kmers(encode_nt4("ACGT" * 5 + "A"), 17)[:1]
    assert t.lookup(absent)[0] == 0
    for n in (0, 10_000, 10**6, 10**8, 10**9, 10**12):
        assert ta.auto_kmer(n) == ja.auto_kmer(n)
    assert ta.auto_kmer(10**12) <= 27 and ta.auto_kmer(10**8) % 2 == 1


# -- FermiAssembler -------------------------------------------------------

def test_fermi_api_and_options():
    f = ta.FermiAssembler(device="cpu")
    assert f.get_min_overlap() == 33
    f.set_min_overlap(50)
    assert f.get_min_overlap() == 50
    f.set_drop_overlap_ratio(0.5)
    f.set_kmer_min_threshold(3)
    f.set_kmer_max_threshold(10)
    f.set_aggressive_trim()
    f.set_simplify_bubble()
    assert (f.opt.min_dratio1, f.opt.min_cnt, f.opt.max_cnt,
            f.opt.aggressive) == (0.5, 3, 10, True)
    f.add_read(UnalignedSequence("a", "ACGT" * 40))
    rec = BamRecord()
    rec.qname, rec.seq = "b", "acgt" * 40
    f.add_read(rec)
    assert f.num_sequences() == 2
    assert [u.seq for u in f.get_sequences()] == ["ACGT" * 40] * 2
    with pytest.raises(ValueError):
        f.add_read(UnalignedSequence("bad", ""))
    f.clear_reads()
    assert f.num_sequences() == 0
    f.clear_contigs()
    assert f.get_contigs() == []
    for alias in ("AddRead", "AddReads", "ClearReads", "ClearContigs",
                  "CorrectReads", "CorrectAndFilterReads", "PerformAssembly",
                  "DirectAssemble", "GetContigs", "GetSequences",
                  "NumSequences", "SetMinOverlap", "GetMinOverlap",
                  "SetAggressiveTrim", "SetSimplifyBubble",
                  "SetDropOverlapRatio", "SetKmerMinThreshold",
                  "SetKmerMaxThreshold", "WriteGFA"):
        assert callable(getattr(ta.FermiAssembler, alias))
    assert ta.AssemblyOptions() == ta.AssemblyOptions(**vars(
        ja.AssemblyOptions()))


def test_perform_assembly_parity(region, bfc_pair):
    (bj, _), _ = bfc_pair
    named = [(f"r{i}", s) for i, s in enumerate(bj.m_seqs)]
    fj = _fermi(ja, named)
    ft = _fermi(ta, named, device="cpu")
    fj.perform_assembly()
    ft.perform_assembly()
    _same_assembly(fj, ft)
    big = max(ft.get_contigs(), key=len)
    assert len(big) >= 0.5 * len(region)
    assert big in region or revcomp(big) in region


def test_correct_reads_parity(region, sim_reads):
    named = [(f"r{i}", s) for i, s in enumerate(sim_reads[:400])]
    fj = _fermi(ja, named)
    ft = _fermi(ta, named, device="cpu")
    fj.correct_reads()
    ft.correct_reads()
    assert ft.m_seqs == fj.m_seqs
    keys, counts = ft._flt_cache[1]
    assert keys.device.type == "cpu" and ft._flt_cache[2] == fj._flt_cache[2]
    perf = sum(1 for s in ft.m_seqs if s in region or revcomp(s) in region)
    assert perf >= 0.85 * len(ft.m_seqs)
    # the cached table feeds the read filter of the assembly that follows
    fj.perform_assembly()
    ft.perform_assembly()
    _same_assembly(fj, ft)


def test_correct_and_filter_parity(sim_reads):
    named = [(f"r{i}", s) for i, s in enumerate(sim_reads)]
    fj = _fermi(ja, named)
    ft = _fermi(ta, named, device="cpu")
    fj.correct_and_filter_reads()
    ft.correct_and_filter_reads()
    assert ft.m_seqs == fj.m_seqs and ft.m_names == fj.m_names
    assert 0 < ft.num_sequences() < len(sim_reads)


def test_direct_assemble_parity(region):
    named = _perfect(region, 300, 9)
    fj = _fermi(ja, named)
    ft = _fermi(ta, named, device="cpu")
    fj.direct_assemble(kcov=20.0)
    ft.direct_assemble(kcov=20.0)
    _same_assembly(fj, ft)
    assert (ft.opt.min_ensr, ft.opt.min_insr) == (4, 3)
    ctgs = sorted(ft.get_contigs(), key=len, reverse=True)
    assert ctgs and (ctgs[0] in region or revcomp(ctgs[0]) in region)


def test_gfa_parity(region):
    named = _perfect(region, 300, 1)
    fj = _fermi(ja, named)
    ft = _fermi(ta, named, device="cpu")
    fj.perform_assembly()
    ft.perform_assembly()
    _same_assembly(fj, ft)
    gfa = _gfa(ft)
    assert gfa.startswith("H\tVN:Z:1.0")
    s_lines = [l for l in gfa.splitlines() if l.startswith("S\t")]
    assert len(s_lines) == len(ft.get_contigs())
    for l in s_lines:
        parts = l.split("\t")
        assert parts[2] == ft.get_contigs()[int(parts[1])]
        assert parts[3] == f"LN:i:{len(parts[2])}"
        assert parts[4].startswith("RC:i:") and parts[5].startswith("PD:Z:")


def test_repeat_links_parity():
    """A 300 bp segment planted twice in a 6 kb region: the graph
    branches at the repeat, so unitigs carry links and the GFA L lines."""
    g = list(_region(6000, 5))
    seg = _region(300, 6)
    g[1500:1800] = seg
    g[4000:4300] = seg
    r1, r2 = simulate_pairs([("r", "".join(g))], 600, error_rate=0.0,
                            seed=4)
    named = [(u.name, u.seq) for u in r1 + r2]
    fj = _fermi(ja, named)
    ft = _fermi(ta, named, device="cpu")
    fj.perform_assembly()
    ft.perform_assembly()
    _same_assembly(fj, ft)
    assert len(ft.get_unitigs()) >= 3
    assert sum(len(u.links) for u in ft.get_unitigs()) >= 4
    assert "\nL\t" in _gfa(ft)


def test_config3_analog_one_contig():
    """Configuration 3 at CI size: BFC-correct and assemble 1,000 pairs
    over a 10 kb region on the port: exactly one contig, >= 99% of the
    region, an exact substring of it or of its reverse complement."""
    region = _region(10_000, 11)
    r1, r2 = simulate_pairs([("r", region)], 1000, read_len=150,
                            error_rate=0.005, seed=7)
    b = ta.BFC(device="cpu")
    for u in r1 + r2:
        b.add_sequence(u.seq)
    b.train()
    b.error_correct()
    f = ta.FermiAssembler(device="cpu")
    f.add_reads([UnalignedSequence(f"r{i}", s)
                 for i, s in enumerate(b.m_seqs)])
    f.perform_assembly()
    ctgs = f.get_contigs()
    assert len(ctgs) == 1
    assert len(ctgs[0]) >= 0.99 * len(region)
    assert ctgs[0] in region or revcomp(ctgs[0]) in region

"""The rest of the port's library surface against the JAX package:
``chain_seeds`` / ``filter_chains``, ``BWAAligner.align_stream``,
``utils``, ``profiling`` and the top-level and subpackage exports.
Inputs come from numpy seeds; tolerance: exact equality.
"""

import os

import numpy as np
import pytest
import torch

import seqlib_tpu
import seqlib_tpu_torch
from seqlib_tpu import profiling as jax_profiling
from seqlib_tpu import utils as jax_utils
from seqlib_tpu.align import chain as jax_chain
from seqlib_tpu_torch import profiling, utils
from seqlib_tpu_torch.align import (AlignerOptions, AlnReg, BWAAligner,
                                    Chain, FusedOverflowError, chain_seeds,
                                    filter_chains)
from seqlib_tpu_torch.core.unaligned import UnalignedSequence
from seqlib_tpu_torch.index import FMIndex
from seqlib_tpu_torch.sim import make_genome, simulate_reads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the suite's workers
    share the cores, and idle pool threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain_tuples(chains):
    return [(c.qbeg, c.qend, c.rbeg, c.rend, list(c.seeds), c.weight,
             c.anchor) for c in chains]


def test_chain_seeds_and_filter_chains_equal_jax():
    """~200 random occurrence sets, drawn from small ranges so that
    positions, diagonals and weights tie; both strands."""
    rng = np.random.default_rng(31)
    n_chains = 0
    for case in range(200):
        l_pac = int(rng.integers(200, 2000))
        n = int(rng.integers(0, 25))
        occs = []
        for _ in range(n):
            qb = int(rng.integers(0, 60)) * 5
            ln = int(rng.integers(4, 12)) * 4
            rb = int(rng.choice([rng.integers(0, 40) * 5,
                                 l_pac + rng.integers(0, 40) * 5,
                                 rng.integers(0, 2 * l_pac - ln)]))
            occs.append((qb, qb + ln, rb))
        occs += occs[:int(rng.integers(0, 3))]          # exact duplicates
        gap, band = int(rng.choice([50, 10000])), int(rng.choice([5, 100]))
        got = chain_seeds(occs, l_pac, max_chain_gap=gap, band=band)
        want = jax_chain.chain_seeds(occs, l_pac, max_chain_gap=gap,
                                     band=band)
        assert _chain_tuples(got) == _chain_tuples(want), case
        n_chains += len(got)
        for drop, mw, keep in ((0.5, 0, 8), (0.0, 20, 3), (0.9, 0, 1)):
            assert _chain_tuples(filter_chains(got, drop, mw, keep)) == \
                _chain_tuples(jax_chain.filter_chains(want, drop, mw, keep))
    assert n_chains > 1000
    assert filter_chains([]) == [] and chain_seeds([], 100) == []


@pytest.fixture(scope="module")
def aligner():
    g = make_genome(30_000, seed=4, n_segments=1, seg_len=300,
                    tandem_copies=3)
    idx = FMIndex.construct([("c1", g[:15_000]), ("c2", g[15_000:])])
    return BWAAligner(idx, device="cpu"), g


def test_align_stream_yields_align_batch_records_in_order(aligner):
    """Three batches (40, 40, 16 reads) on two workers: each read object
    comes back in input order with the records ``align_batch`` gives."""
    aln, g = aligner
    reads = [UnalignedSequence(n, s) for n, s in
             simulate_reads(g, 96, seed=6, length=90)]
    hdr = aln.index.header_from_index()
    out = list(aln.align_stream(iter(reads), batch_size=40, workers=2))
    assert [r for r, _ in out] == reads
    assert all(a is b for (a, _), b in zip(out, reads))
    want = aln.align_batch([r.seq for r in reads], [r.name for r in reads])
    assert [[x.to_sam(hdr) for x in recs] for _, recs in out] == \
        [[x.to_sam(hdr) for x in recs] for recs in want]
    assert sum(1 for _, recs in out if recs and recs[0].mapped_flag()) >= 90


def test_utils_equal_jax():
    for x in (0, 7, 999, 1000, 1234567, -9876543):
        assert utils.add_commas(x) == jax_utils.add_commas(x)
    for a, b in ((0, 0), (1, 3), (5, 5), (7, -1), (2, 7)):
        assert utils.percent_calc(a, b) == jax_utils.percent_calc(a, b)
    for s, t in (("aXbXc", "X"), ("abc", ""), ("abab", "ab"), ("", "x")):
        assert utils.scrub_string(s, t) == jax_utils.scrub_string(s, t)
    here = os.path.abspath(__file__)
    for p in (here, here + ".missing"):
        assert utils.read_access_test(p) == jax_utils.read_access_test(p)
    rc, jc = utils.ReadCount(), jax_utils.ReadCount()
    for c in (rc, jc):
        c.keep, c.total = 1234, 56789
    assert (rc.percent(), rc.total_string(), rc.keep_string()) == \
        (jc.percent(), jc.total_string(), jc.keep_string())
    t = utils.RuntimeTimer()
    assert t.display().startswith("CPU: ") and " Wall: 0:00:0" in t.display()


def test_stage_timer_report_has_the_jax_format():
    ours, theirs = profiling.StageTimer(), jax_profiling.StageTimer()
    with ours.stage("seed"):
        pass
    assert ours.counts["seed"] == 1 and ours.totals["seed"] >= 0
    for t in (ours, theirs):
        t.reset()
        for name, sec, n in (("seed", 1.25, 3), ("extend", 0.5, 1),
                             ("a much longer stage name", 3.0, 12)):
            t.totals[name] = sec
            t.counts[name] = n
    assert ours.report() == theirs.report()
    ours.reset()
    assert ours.report() == ""


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.arange(1000).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    assert "traceEvents" in (tmp_path / "trace" / files[0]).read_text()


def test_exports():
    from seqlib_tpu_torch import align, index, io, assembly
    for name in ("FMIndex", "BWAAligner", "AlignerOptions", "BamReader",
                 "BamWriter", "FastqReader", "RefGenome", "BFC",
                 "FermiAssembler"):
        assert name in seqlib_tpu.__all__ and name in seqlib_tpu_torch.__all__
        mod = {"FMIndex": index, "BWAAligner": align,
               "AlignerOptions": align, "BFC": assembly,
               "FermiAssembler": assembly}.get(name, io)
        assert getattr(seqlib_tpu_torch, name) is getattr(mod, name)
    from seqlib_tpu_torch import filters, intervals, plot, stats
    for name, mod in (("GRC", intervals), ("GenomicRegionCollection",
                                           intervals),
                      ("ReadFilterCollection", filters), ("SeqPlot", plot),
                      ("BamStats", stats), ("STCoverage", stats)):
        assert name in seqlib_tpu.__all__ and name in seqlib_tpu_torch.__all__
        assert getattr(seqlib_tpu_torch, name) is getattr(mod, name)
        assert getattr(seqlib_tpu_torch, name).__name__ \
            == getattr(seqlib_tpu, name).__name__
    assert set(seqlib_tpu.__all__) <= set(seqlib_tpu_torch.__all__)
    with pytest.raises(AttributeError):
        seqlib_tpu_torch.NoSuchName
    assert seqlib_tpu_torch.__version__ == seqlib_tpu.__version__
    for name in ("BamHeader", "BamRecord", "Cigar", "CigarField",
                 "GenomicRegion", "HeaderSequence", "UnalignedSequence"):
        assert getattr(seqlib_tpu_torch, name).__name__ == name
    assert set(align.__all__) == {"BWAAligner", "ShardedBWAAligner",
                                  "AlnReg", "Chain", "chain_seeds",
                                  "filter_chains", "AlignerOptions",
                                  "FusedOverflowError"}
    assert [c.__module__ for c in (AlnReg, Chain, AlignerOptions,
                                   FusedOverflowError)] == [
        "seqlib_tpu_torch.align.aligner", "seqlib_tpu_torch.align.chain",
        "seqlib_tpu_torch.align.options", "seqlib_tpu_torch.align.aligner"]
    from seqlib_tpu import index as jax_index
    from seqlib_tpu import align as jax_align
    assert set(index.__all__) == set(jax_index.__all__)
    assert set(align.__all__) == set(jax_align.__all__) \
        | {"FusedOverflowError"}
    assert index.ShardedFMIndex.__name__ == "ShardedFMIndex"
    assert align.ShardedBWAAligner.__module__ \
        == "seqlib_tpu_torch.align.sharded"
    assert index.OCC_INTERVAL == 128 and index.SA_INTERVAL == 32


def test_long_read_bp_is_a_class_attribute_equal_to_jax():
    """``LONG_READ_BP`` lives on the class, as in the JAX package, and
    an instance reads it through itself."""
    from seqlib_tpu.align import BWAAligner as JaxAligner
    assert BWAAligner.LONG_READ_BP == JaxAligner.LONG_READ_BP == 1024
    assert "LONG_READ_BP" in vars(BWAAligner)
    idx = FMIndex.construct([("c", "ACGT" * 100)])
    assert BWAAligner(idx, device="cpu").LONG_READ_BP == 1024


def test_long_read_bp_moves_the_cut_over(aligner):
    """A subclass (or an instance) with ``LONG_READ_BP = 200`` sends a
    300 bp batch down the long-read path, with the long path's records,
    and ``align_stream_bam`` raises FusedOverflowError for it."""
    aln, g = aligner
    seqs = [g[1000:1300], g[20_000:20_300]]
    names = ["r300a", "r300b"]

    class Short(BWAAligner):
        LONG_READ_BP = 200

    short = Short(aln.index, device="cpu")
    calls = []
    orig = Short._align_batch_long

    def spy(self, *a, **kw):
        calls.append(len(a[0]))
        return orig(self, *a, **kw)
    Short._align_batch_long = spy
    hdr = aln.index.header_from_index()
    got = [[r.to_sam(hdr) for r in rs] for rs in short.align_batch(seqs,
                                                                   names)]
    assert calls == [2]
    want = [[r.to_sam(hdr) for r in rs]
            for rs in aln._align_batch_long(seqs, names, False, 0.9, 10)]
    assert got == want and all(got)
    with pytest.raises(FusedOverflowError, match="200 bp"):
        list(short.align_stream_bam(iter(UnalignedSequence(n, s)
                                         for n, s in zip(names, seqs))))
    inst = BWAAligner(aln.index, device="cpu")
    inst.LONG_READ_BP = 200
    with pytest.raises(FusedOverflowError):
        inst.align_batch_bam(seqs, names)
    assert BWAAligner.LONG_READ_BP == 1024

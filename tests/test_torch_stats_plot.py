"""The port's statistics (``seqlib_tpu_torch.stats``) and plots
(``seqlib_tpu_torch.plot``) against the JAX package's.

``Histogram`` text and CSV (fixed-width and quantile bins), the
``BamStats`` table, ``STCoverage`` (per-position queries, ``max_cov``
and the bedgraph of a bounded region, the dense track wrapping past
65,535), ``Fractions`` from a BED, and ``SeqPlot`` text, on the
records of ``test_torch_intervals_filters`` made in each package's
classes.  The port's strings equal the JAX package's.  Tolerance: exact.
"""

import gzip

import numpy as np
import pytest

import seqlib_tpu.core as jcore
import seqlib_tpu.plot as jplot
import seqlib_tpu.stats as jstats
import seqlib_tpu_torch.core as tcore
import seqlib_tpu_torch.plot as tplot
import seqlib_tpu_torch.stats as tstats
from test_torch_intervals_filters import CHROMS, _records

PKGS = {"torch": (tcore, tstats, tplot), "jax": (jcore, jstats, jplot)}


def _both(fn):
    """fn(core, stats, plot) on each package -> (port, jax)."""
    return fn(*PKGS["torch"]), fn(*PKGS["jax"])


def test_histogram_text_equal():
    rng = np.random.default_rng(2)
    vals = rng.integers(-50, 2600, 3000).tolist()
    spans = rng.integers(1, 5000, 800).tolist()

    def run(_, stats, __):
        out = []
        for args in ((0, 100, 1), (-2, 2000, 10), (0, 250, 1), (5, 6, 7)):
            h = stats.Histogram(*args)
            for v in vals:
                h.add_elem(v)
            for v in vals[:100]:
                h.remove_elem(v)
            out.append((h.to_file_string(), h.to_csv(), repr(h),
                        h.total_count(), h.num_bins(), h.bin_count(0),
                        h.retrieve_bin_id(-1000)))
        q = stats.Histogram()
        q.add_elem(3)
        out.append((q.to_file_string(), q.to_csv(), repr(q)))
        for nb, mw in ((10, 0), (37, 50), (800, 0)):
            q = stats.Histogram()
            q.initialize(nb, spans, mw)
            for v in spans:
                q.add_elem(v)
            out.append((q.to_csv(), repr(q)))
        q.initialize(5, [])
        b = stats.Bin(3, 9, 2)
        out.append((repr(b), b.contains(9), b.contains(10),
                    stats.Bin(1, 2) < stats.Bin(1, 3)))
        with pytest.raises(ValueError):
            stats.Histogram(5, 5, 1)
        return out
    port, jax = _both(run)
    assert port == jax


def test_bamstats_repr_equal():
    def run(core, stats, _):
        bs = stats.BamStats()
        recs = _records(core, 500, seed=21)
        recs[0].qual = None
        for r in recs:
            bs.add_read(r)
        return (repr(bs), sorted(bs.group_map),
                [stats.mean_phred(r) for r in recs[:20]])
    port, jax = _both(run)
    assert port == jax
    assert port[0].splitlines()[0] == tstats.BamStats.HEADER
    assert len(port[1]) >= 4


def test_coverage_equal():
    region = (0, 1_000, 30_000)

    def run(core, stats, _):
        hdr = core.BamHeader(list(CHROMS))
        recs = _records(core, 500, seed=31)
        bounded = stats.STCoverage(core.GenomicRegion(*region))
        free = stats.STCoverage()
        for i, r in enumerate(recs):
            bounded.add_read(r)
            free.add_read(r, buff=i % 3, full_length=bool(i % 2))
        rng = np.random.default_rng(5)
        probes = [(int(c), int(p)) for c, p in
                  zip(rng.integers(0, 4, 300), rng.integers(0, 50_000, 300))]
        out = [bounded.max_cov(), free.max_cov(), bounded.to_bedgraph(hdr),
               free.to_bedgraph(hdr),
               [(bounded.get_coverage_at_position(c, p),
                 free.get_coverage_at_position(c, p)) for c, p in probes]]
        bounded.clear()
        out.append((bounded.max_cov(), bounded.to_bedgraph(hdr)))
        return out
    port, jax = _both(run)
    assert port == jax
    assert port[0] >= 2 and port[2].count("\n") > 100


def test_coverage_dense_track_wraps_past_65535():
    """65,540 reads over one 10 bp window: the dense uint16 track wraps
    (to 4), the per-position map does not."""
    def run(core, stats, _):
        hdr = core.BamHeader(list(CHROMS))
        r = core.BamRecord()
        r.qname, r.tid, r.pos, r.seq = "deep", 2, 100, "A" * 10
        r.cigar = core.Cigar("10M")
        cov = stats.STCoverage(core.GenomicRegion(2, 95, 120))
        for _ in range(65_540):
            cov.add_read(r)
        return (cov.max_cov(), cov.to_bedgraph(hdr),
                cov.get_coverage_at_position(2, 105), cov.v.tolist())
    port, jax = _both(run)
    assert port == jax
    assert port[2] == 65_540 and port[0] == 4 and 4 in port[3]


def test_fractions_equal(tmp_path):
    bed = ("#chr\tstart\tend\tfrac\nc1\t100\t5000\t0.25\n"
           "c2\t1\t900\t0.9\nc1\t4000\t9000\t0.5\nbad\t1\t2\t0.1\n"
           "c3\t10\t20\n\nc3\t10\t20\tx\nc3\t50\t500\t1e-3\n")
    (tmp_path / "f.bed").write_text(bed)
    with gzip.open(tmp_path / "f.bed.gz", "wt") as fh:
        fh.write(bed)

    def run(core, stats, _):
        hdr = core.BamHeader(list(CHROMS))
        out = []
        for name in ("f.bed", "f.bed.gz", "absent.bed"):
            fr = stats.Fractions()
            ok = fr.read_from_bed(str(tmp_path / name), hdr)
            out.append((ok, fr.size(), [repr(r) for r in fr.m_frc]))
            out.append([fr.find_fraction(c, p, p + 50)
                        for c in range(3) for p in (0, 150, 4100, 8000)])
        out.append(repr(stats.FracRegion("c2", "5", "10", hdr, 0.5)))
        return out
    port, jax = _both(run)
    assert port == jax
    assert port[0][1] == 4 and 0.25 in port[1]


@pytest.mark.parametrize("view,pad", [((0, 1_000, 16_000), 5),
                                      ((1, 0, 30_000), 0),
                                      ((2, 2_000, 2_400), 12)])
def test_seqplot_text_equal(view, pad):
    def run(core, _, plot):
        recs = _records(core, 500, seed=41)
        sp = plot.SeqPlot()
        sp.set_view(core.GenomicRegion(*view))
        sp.set_padding(pad)
        text = sp.plot_alignment_records(recs)
        line = plot.PlottedReadLine(contig_len=20)
        line.add_read(plot.PlottedRead(3, "ACG", "x"))
        return text, line.render(), line.read_fits(plot.PlottedRead(5, "",
                                                                    ""))
    port, jax = _both(run)
    assert port == jax
    text = port[0]
    inside = [r for r in _records(tcore, 500, seed=41)
              if r.tid == view[0] and r.pos >= view[1]
              and r.position_end() <= view[2]]
    for r in inside:
        assert sum(ln.count(f"{r.qname}>>>") for ln in text.splitlines()) \
            == 1
    assert text.count(">>>") == len(inside) > 0

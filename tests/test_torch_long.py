"""The port's long-read path (reads over 1024 bp) against the JAX package.

``align_batch`` sends a batch with a read over ``LONG_READ_BP`` through
device seeding, host chaining, banded extension and the classic path's
global DP.  Three batches on the 60 kb reference of
tests/test_long_reads.py (seed 11), or on that reference with a planted
duplicate, go through both packages, and the records' SAM lines must be
equal: exact reads of 1.1-4 kb on both strands, two with a random 3'
tail (soft-clipped); reads of ~1.1 kb with an insertion or a deletion;
and a read whose sequence occurs twice (a primary and a secondary or
XA).  The port runs on the CPU.

The JAX package pads each extension and global-DP batch of the long
path to at least 64 rows (``aligner._bucket``).  On the CPU its global
DP over 64 x 1.1k x 1.2k cells takes about two minutes, so the JAX runs
here pad to the exact row count instead.  Rows are independent, so
padding changes no output: the first batch runs both ways and must give
the same records.
"""

import numpy as np
import pytest
import torch

import seqlib_tpu.align.aligner as jax_aligner_module
from seqlib_tpu.align import BWAAligner as JaxAligner
from seqlib_tpu.index import FMIndex as JaxFMIndex
from seqlib_tpu_torch.align import BWAAligner, FusedOverflowError
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


def _pair(contigs):
    return (JaxAligner(JaxFMIndex.construct(contigs)),
            BWAAligner(FMIndex.construct(contigs), device="cpu"))


@pytest.fixture(scope="module")
def aligners(ref):
    return _pair([("chrL", ref)])


def _exact_row_padding(monkeypatch):
    monkeypatch.setattr(jax_aligner_module, "_bucket",
                        lambda n, mn=64: max(int(n), 1))


def _sam(aln, recs):
    hdr = aln.index.header_from_index()
    return [r.to_sam(hdr) for rs in recs for r in rs]


def _tail(n, seed):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def test_exact_long_reads_equal_jax(aligners, ref, monkeypatch):
    """1.1-4 kb exact reads, both strands, two with a 3' tail; the JAX
    package once with its own padding and once with exact padding."""
    ja, ta = aligners
    seqs = [ref[1000:2200], revcomp(ref[5000:6500]),
            ref[9000:10_300] + _tail(300, 1),
            revcomp(ref[20_000:21_100]) + _tail(250, 2),
            ref[24_000:28_000]]
    names = ["fwd1200", "rc1500", "tail1300", "rctail1100", "fwd4000"]
    got = _sam(ta, ta.align_batch(seqs, names))
    assert got == _sam(ja, ja.align_batch(seqs, names))
    _exact_row_padding(monkeypatch)
    assert got == _sam(ja, ja.align_batch(seqs, names))
    cig = [g.split("\t")[5] for g in got]
    assert cig[:2] + cig[4:] == ["1200M", "1500M", "4000M"]
    assert cig[2].endswith("S") and cig[3].split("S")[0].isdigit()


def test_indel_long_reads_equal_jax(aligners, ref, monkeypatch):
    """A 4 bp deletion (forward) and a 3 bp insertion (reverse): regions
    that take the global DP."""
    ja, ta = aligners
    seqs = [ref[30_000:30_500] + ref[30_504:31_100],
            revcomp(ref[40_000:40_600] + "ACG" + ref[40_600:41_080]),
            ref[50_000:50_300] + "T" + ref[50_301:51_200]]
    names = ["del4", "rc_ins3", "sub1"]
    _exact_row_padding(monkeypatch)
    got = _sam(ta, ta.align_batch(seqs, names))
    assert got == _sam(ja, ja.align_batch(seqs, names))
    cig = [g.split("\t")[5] for g in got]
    assert cig[:2] == ["500M4D596M", "600M3I480M"]


def test_duplicated_locus_equals_jax(ref, monkeypatch):
    """A 1.6 kb sequence planted twice: both loci surface (a primary and
    a secondary record or an XA tag), as in the JAX package; and
    align_sequence takes the long read too."""
    dup = ref[40_000:41_600]
    ja, ta = _pair([("chrD", ref[:55_000] + dup + ref[55_000:])])
    _exact_row_padding(monkeypatch)
    seqs = [dup, revcomp(ref[12_000:13_536])]
    names = ["dup", "rc1536"]
    got = ta.align_batch(seqs, names)
    assert _sam(ta, got) == _sam(ja, ja.align_batch(seqs, names))
    prim = [r for r in got[0] if not r.secondary_flag()]
    assert prim and prim[0].pos in (40_000, 55_000)
    assert len({r.pos for r in got[0]}) == 2 or prim[0].get_z_tag("XA")
    one = ta.align_sequence(seqs[1], names[1])
    assert _sam(ta, [one]) == _sam(ta, got[1:])


def test_fused_entry_points_refuse_long_reads(aligners, ref):
    """align_batch_bam and align_stream_bam still refuse reads over 1024
    bp (as the JAX package's native emission does not route them), and
    the error names align_batch."""
    _, ta = aligners

    class Read:
        name, seq = "long", ref[100:1125]

    with pytest.raises(FusedOverflowError, match="align_batch"):
        ta.align_batch_bam([Read.seq], [Read.name], sam=True)
    with pytest.raises(FusedOverflowError, match="align_batch"):
        list(ta.align_stream_bam(iter([Read()]), sam=True))

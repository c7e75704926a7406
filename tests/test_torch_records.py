"""The port's record types and single-read API against the JAX package.

``Cigar``, ``BamRecord.to_sam`` and ``io.bam.encode_record`` get the same
values in both packages and must give the same strings and bytes;
``align_sequence`` (on a string and on an UnalignedSequence whose
comment becomes a BC tag) must return the same records.  The port runs
on the CPU.
"""

import numpy as np
import pytest
import torch

from regen_golden import make_repeat_genome, make_repeat_reads
from seqlib_tpu.align import BWAAligner as JaxAligner
from seqlib_tpu.core import cigar as jcigar
from seqlib_tpu.core import record as jrecord
from seqlib_tpu.core.unaligned import UnalignedSequence as JaxUnaligned
from seqlib_tpu.index import FMIndex as JaxFMIndex
from seqlib_tpu.io import bam as jbam
from seqlib_tpu_torch.align import BWAAligner
from seqlib_tpu_torch.core import BamRecord, Cigar, CigarField
from seqlib_tpu_torch.core.unaligned import UnalignedSequence
from seqlib_tpu_torch.index import FMIndex
from seqlib_tpu_torch.io import bam as tbam


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("text", ["150M", "10S100M2I38M", "5H20M3D30M1N4=2X",
                                  "*", ""])
def test_cigar_equals_jax(text):
    t, j = Cigar(text), jcigar.Cigar(text)
    assert str(t) == str(j)
    assert np.array_equal(t.to_bam_encoded(), j.to_bam_encoded())
    assert t.num_query_consumed() == j.num_query_consumed()
    assert t.num_reference_consumed() == j.num_reference_consumed()
    assert len(t) == len(j)
    assert Cigar([(f.type, f.length) for f in j]) == t
    assert Cigar([CigarField(f.type, f.length) for f in j]) == t


@pytest.mark.parametrize("bad", ["10Q", "M10", "10M5", "0M"])
def test_cigar_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        jcigar.Cigar(bad)
    with pytest.raises(ValueError):
        Cigar(bad)


RECORDS = [
    dict(qname="r1", flag=0, tid=0, pos=99, mapq=60, cigar="150M",
         seq="ACGT" * 37 + "AC", qual=None,
         tags=[("NA", 1), ("NM", 0), ("AS", 150)]),
    dict(qname="r2", flag=0x110, tid=1, pos=0, mapq=0, cigar="3S40M2D10M",
         seq="NACGTTGCAAGGCTNACGTACGTACGTAAAACCCCGGGGTTTTACGTACGTA",
         qual=None, tags=[("NA", 3), ("NM", 4),
                          ("XA", "c2,+17,53M,2;c1,-9,53M,3;"), ("AS", 40)]),
    dict(qname="r3", flag=4, tid=-1, pos=-1, mapq=0, cigar="",
         seq="ACG", qual=np.array([30, 31, 2], np.uint8),
         tags=[("BC", "comment text")]),
]


@pytest.mark.parametrize("spec", RECORDS, ids=[r["qname"] for r in RECORDS])
def test_record_sam_and_bam_equal_jax(spec):
    from seqlib_tpu.core.header import BamHeader as JaxHeader
    from seqlib_tpu_torch.core import BamHeader
    seqs = [("c1", 5000), ("c2", 7000)]
    recs = []
    for cls, cig in ((BamRecord, Cigar), (jrecord.BamRecord, jcigar.Cigar)):
        r = cls()
        for k in ("qname", "flag", "tid", "pos", "mapq", "seq", "qual"):
            setattr(r, k, spec[k])
        r.cigar = cig(spec["cigar"])
        for tag, val in spec["tags"]:
            if isinstance(val, str):
                r.add_z_tag(tag, val)
            else:
                r.add_int_tag(tag, val)
        recs.append(r)
    t, j = recs
    assert t.to_sam(BamHeader(seqs)) == j.to_sam(JaxHeader(seqs))
    assert t.to_sam() == j.to_sam()
    assert tbam.encode_record(t) == jbam.encode_record(j)
    assert tbam.reg2bin(t.pos, t.pos + 60) == jbam.reg2bin(j.pos, j.pos + 60)


@pytest.fixture(scope="module")
def aligners():
    genome = make_repeat_genome()
    ji = JaxFMIndex.construct([("rep1", genome)])
    ti = FMIndex.from_arrays(
        codes=ji.ref.codes,
        anns=[(a.name, a.offset, a.length, a.n_amb) for a in ji.ref.anns],
        bwt_words=ji.bwt_words, cp_counts=ji.cp_counts, L2=ji.L2,
        primary=ji.primary, sa_full=ji.sa_full)
    reads = make_repeat_reads(genome)
    return JaxAligner(ji), BWAAligner(ti, device="cpu"), reads, ji


def test_index_header_and_positions_equal_jax(aligners):
    ja, ta, _, ji = aligners
    assert ta.index.header_from_index().as_string() \
        == ji.header_from_index().as_string()
    for pos in (0, 1, 60_000, ji.ref.l_pac - 1):
        assert ta.index.pos_to_ref(pos) == ji.pos_to_ref(pos)


@pytest.mark.parametrize("form", ["string", "unaligned"])
def test_align_sequence_equals_jax(aligners, form):
    """An XA-class read of the divergent copy: a primary with XA and its
    secondaries; the UnalignedSequence form with copy_comment adds BC."""
    ja, ta, reads, ji = aligners
    name, seq = reads[705]
    hdr = ji.header_from_index()
    if form == "string":
        want = ja.align_sequence(seq, name, hardclip=True)
        out = []
        got = ta.align_sequence(seq, name, out=out, hardclip=True)
        assert out == got
    else:
        ja.set_copy_comment(True)
        ta.set_copy_comment(True)
        want = ja.align_sequence(JaxUnaligned(name, seq, com="lib7"))
        got = ta.align_sequence(UnalignedSequence(name, seq, com="lib7"))
        assert got and all(r.get_z_tag("BC") == "lib7" for r in got)
    assert [r.to_sam(hdr) for r in got] == [r.to_sam(hdr) for r in want]
    assert [tbam.encode_record(r) for r in got] \
        == [jbam.encode_record(r) for r in want]
    assert any(r.get_z_tag("XA") for r in got)

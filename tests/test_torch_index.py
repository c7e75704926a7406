"""The port's FM-index construction against the JAX package's.

Same (name, sequence) inputs go to ``seqlib_tpu.index.FMIndex.construct``
and ``seqlib_tpu_torch.index.FMIndex.construct``; every array of the
index must be equal (exact integer equality).
"""

import numpy as np
import pytest

from regen_golden import make_repeat_genome
from seqlib_tpu.index import FMIndex as JaxFMIndex
from seqlib_tpu_torch.index import FMIndex


ARRAYS = ("bwt_words", "cp_counts", "L2", "sa_full")


def _multi_contig_with_n():
    rng = np.random.default_rng(5)
    seqs = []
    for k, n in enumerate((9000, 4000, 12000)):
        s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
        for _ in range(3):                       # N runs of 1..40 bases
            p = int(rng.integers(0, n - 50))
            s[p:p + int(rng.integers(1, 41))] = ord("N")
        s[int(rng.integers(0, n))] = ord("n")     # a lower-case N
        seqs.append((f"ctg{k}", s.tobytes().decode()))
    return seqs


GENOMES = {
    "repeat": lambda: [("rep1", make_repeat_genome())],
    "multi_contig_n": _multi_contig_with_n,
}


@pytest.fixture(scope="module", params=sorted(GENOMES))
def pair(request):
    seqs = GENOMES[request.param]()
    return JaxFMIndex.construct(seqs), FMIndex.construct(seqs)


def test_construct_equals_jax(pair):
    ji, ti = pair
    for k in ARRAYS:
        a, b = np.asarray(getattr(ji, k)), np.asarray(getattr(ti, k))
        assert a.shape == b.shape, k
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), k
    assert ji.primary == ti.primary
    assert ji.seq_len == ti.seq_len and ji.l_pac == ti.l_pac
    assert np.array_equal(ji.ref.codes, ti.ref.codes)
    assert [(a.name, a.offset, a.length, a.n_amb) for a in ji.ref.anns] == \
        [(a.name, a.offset, a.length, a.n_amb) for a in ti.ref.anns]
    assert [(h.offset, h.length, h.amb) for h in ji.ref.holes] == \
        [(h.offset, h.length, h.amb) for h in ti.ref.holes]
    assert ji.sam_header_text() == ti.sam_header_text()


def test_from_arrays_round_trip(pair):
    ji, ti = pair
    back = FMIndex.from_arrays(
        codes=ji.ref.codes,
        anns=[(a.name, a.offset, a.length, a.n_amb) for a in ji.ref.anns],
        holes=[(h.offset, h.length, h.amb) for h in ji.ref.holes],
        bwt_words=ji.bwt_words, cp_counts=ji.cp_counts, L2=ji.L2,
        primary=ji.primary, sa_full=ji.sa_full)
    for k in ARRAYS:
        assert np.array_equal(getattr(back, k), getattr(ti, k)), k
    assert back.primary == ti.primary and back.seq_len == ti.seq_len
    assert back.contig_names() == ti.contig_names()
    assert np.array_equal(back.contig_lengths(), ti.contig_lengths())
    assert np.array_equal(back.contig_offsets(), ti.contig_offsets())


def test_from_arrays_rejects_inconsistent_shapes(pair):
    ji, _ = pair
    with pytest.raises(ValueError):
        FMIndex.from_arrays(
            codes=ji.ref.codes[:-1],
            anns=[(a.name, a.offset, a.length, a.n_amb)
                  for a in ji.ref.anns],
            bwt_words=ji.bwt_words, cp_counts=ji.cp_counts, L2=ji.L2,
            primary=ji.primary, sa_full=ji.sa_full)


def _assert_same_index(ji, ti):
    for k in ARRAYS:
        assert np.array_equal(np.asarray(getattr(ji, k)).astype(np.int64),
                              np.asarray(getattr(ti, k)).astype(np.int64)), k
    assert ji.primary == ti.primary and ji.seq_len == ti.seq_len
    assert [(a.name, a.offset, a.length, a.n_amb) for a in ji.ref.anns] == \
        [(a.name, a.offset, a.length, a.n_amb) for a in ti.ref.anns]


def test_construct_from_unaligned_sequences():
    """``construct`` takes the port's ``UnalignedSequence`` objects, as
    the JAX package's takes its own, and builds the same index as from
    (name, seq) pairs."""
    from seqlib_tpu_torch.core.unaligned import UnalignedSequence
    seqs = _multi_contig_with_n()
    ti = FMIndex.construct([UnalignedSequence(n, s) for n, s in seqs])
    _assert_same_index(JaxFMIndex.construct(seqs), ti)


def test_construct_from_fasta_reader(tmp_path):
    """``FMIndex.construct(list(FastqReader(fasta)))`` over a 3-contig
    FASTA (how an index is built from a reference file) equals the JAX
    package's index of the same (name, seq) pairs."""
    from seqlib_tpu_torch.io import FastqReader
    seqs = _multi_contig_with_n()
    fa = tmp_path / "ref.fa"
    fa.write_text("".join(f">{n} contig {k}\n" + "\n".join(
        s[p:p + 70] for p in range(0, len(s), 70)) + "\n"
        for k, (n, s) in enumerate(seqs)))
    recs = list(FastqReader(str(fa)))
    assert [(r.name, r.seq) for r in recs] == seqs
    _assert_same_index(JaxFMIndex.construct(seqs), FMIndex.construct(recs))

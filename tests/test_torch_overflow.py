"""The port's classic (overflow) path and object API against the JAX
package, byte for byte.

A batch with more non-trivial chains than extension DP rows
(``dp_rows(B)``) makes the fused program's compacted extension drop
chains; both packages then rerun the batch through the classic path
(seed, chain, uncompacted re-extension, host dedup, global DP per
region) and serialise it through BamRecord objects.  The batch here is
``tests/test_aligner.py``'s overflow construction: 32 reads of a 150 bp
segment that occurs 4 times in the reference, each with one mismatch,
so 128 non-trivial chains > dp_rows(32) = 64.  The port runs on the
CPU through the plain versions of its kernels.
"""

import collections
import os

import numpy as np
import pytest
import torch

import regen_golden
from seqlib_tpu.align import BWAAligner as JaxAligner
from seqlib_tpu.index import FMIndex as JaxFMIndex
from seqlib_tpu_torch.align import BWAAligner
from seqlib_tpu_torch.index import FMIndex
from seqlib_tpu_torch.sim import make_repeat_genome, make_repeat_reads

HERE = os.path.dirname(os.path.abspath(__file__))
Read = collections.namedtuple("Read", "name seq")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_index(ji):
    """The port's index over the very same arrays as the JAX index."""
    return FMIndex.from_arrays(
        codes=ji.ref.codes,
        anns=[(a.name, a.offset, a.length, a.n_amb) for a in ji.ref.anns],
        bwt_words=ji.bwt_words, cp_counts=ji.cp_counts, L2=ji.L2,
        primary=ji.primary, sa_full=ji.sa_full)


@pytest.fixture(scope="module")
def overflow_case():
    rng = np.random.default_rng(11)
    seg = "".join("ACGT"[c] for c in rng.integers(0, 4, 150))
    spacers = ["".join("ACGT"[c] for c in rng.integers(0, 4, 220))
               for _ in range(5)]
    ref = spacers[0] + seg + spacers[1] + seg + spacers[2] + seg \
        + spacers[3] + seg + spacers[4]
    reads = []
    for i in range(32):
        s = list(seg)
        s[50 + i] = "A" if s[50 + i] != "A" else "C"
        reads.append("".join(s))
    names = [f"o{i}" for i in range(len(reads))]
    ji = JaxFMIndex.construct([("rep", ref)])
    return ji, reads, names


@pytest.fixture(scope="module")
def jax_outputs(overflow_case):
    """The JAX package on the overflow batch, its device program run
    once: ``_payload_batch`` (what ``align_batch_bam(sam=True)`` runs
    after the dispatch) gives the SAM payload and the fallback count;
    ``_finish_batch`` (what ``align_batch`` runs) gives the records, and
    their ``encode_record`` bytes are its BAM payload (``_payload_batch``
    serialises an overflowed batch exactly so)."""
    from seqlib_tpu.io.bam import encode_record
    ji, reads, names = overflow_case
    ja = JaxAligner(ji)
    chunk = [Read(n, s) for n, s in zip(names, reads)]
    enc, lens = ja._encode_batch(reads)
    res = ja._dispatch_full(enc, lens)
    ja.reset_stats()
    sam = ja._payload_batch(chunk, enc, lens, res, False, 0.9, 10, sam=True)
    fallback = ja.stats["fused_overflow_fallback"]
    ja.reset_stats()
    records = [recs for _, recs in ja._finish_batch(
        chunk, enc, lens, res, False, 0.9, 10)]
    bam = (b"".join(encode_record(r) for recs in records for r in recs),
           np.array([len(recs) for recs in records], np.int32))
    return {True: sam, False: bam, "fallback": fallback,
            "fallback_records": ja.stats["fused_overflow_fallback"],
            "records": records, "header": ji.header_from_index()}


@pytest.fixture(scope="module")
def port_aligner(overflow_case):
    return BWAAligner(_port_index(overflow_case[0]), device="cpu")


@pytest.mark.parametrize("sam", [True, False])
def test_overflow_payload_equals_jax(overflow_case, jax_outputs,
                                     port_aligner, sam):
    _, reads, names = overflow_case
    port_aligner.reset_stats()
    got = port_aligner.align_batch_bam(reads, names, sam=sam)
    want = jax_outputs[sam]
    # _payload_batch and _finish_batch each see the overflow: 2 on both
    assert port_aligner.stats["fused_overflow_fallback"] \
        == jax_outputs["fallback"] == 2
    assert got[0] == want[0]
    assert np.array_equal(got[1], want[1])
    assert int(got[1].sum()) >= len(reads)


def test_overflow_records_equal_jax(overflow_case, jax_outputs,
                                    port_aligner):
    _, reads, names = overflow_case
    port_aligner.reset_stats()
    got = port_aligner.align_batch(reads, names)
    assert port_aligner.stats["fused_overflow_fallback"] \
        == jax_outputs["fallback_records"] >= 1
    hdr = jax_outputs["header"]
    want = [[r.to_sam(hdr) for r in recs] for recs in jax_outputs["records"]]
    assert [[r.to_sam(hdr) for r in recs] for recs in got] == want
    # the records carry the same fields the SAM text shows, and more
    for g, w in zip(got, jax_outputs["records"]):
        for a, b in zip(g, w):
            assert (a.flag, a.tid, a.pos, a.mapq, str(a.cigar), a.tags) \
                == (b.flag, b.tid, b.pos, b.mapq, str(b.cigar), b.tags)


def test_port_repeat_corpus_is_the_golden_corpus():
    """The port's copy of the repeat corpus (sim.py) is the one the
    golden was made from."""
    genome = make_repeat_genome()
    assert genome == regen_golden.make_repeat_genome()
    assert make_repeat_reads(genome) == regen_golden.make_repeat_reads(genome)


def test_repeat_1k_one_chunk_reproduces_golden():
    """The 1000-read repeat corpus in one chunk overflows the DP rows;
    the classic rerun reproduces the JAX package's golden SAM."""
    genome = make_repeat_genome()
    reads = make_repeat_reads(genome)
    idx = FMIndex.construct([("rep1", genome)])
    aln = BWAAligner(idx, device="cpu")
    res = aln.align_batch([s for _, s in reads], [n for n, _ in reads])
    assert aln.stats["fused_overflow_fallback"] == 1
    hdr = idx.header_from_index()
    got = [r.to_sam(hdr) for recs in res for r in recs]
    with open(os.path.join(HERE, "golden", "sam_repeat_1k.txt")) as f:
        want = [l for l in f.read().splitlines() if not l.startswith("#")]
    assert got == want

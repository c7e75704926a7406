"""The port's fused-path aligner against the JAX package, byte for byte.

The corpus is 60 reads of the hermetic repeat corpus
(tests/regen_golden.py): 6 of each of its 10 classes, some with an N,
in lower case or cut short; in a 64-read batch it stays on the fused
path in the JAX package (no extension DP-row overflow, checked).  A
second 64-read batch, of 50 truncation-stress reads, has more live
regions than global-DP rows, so some take the host global pass
(FLAG_OVER).  A batch of divergent-copy reads overflows the extension
DP rows and goes through the classic path.
``align_batch_bam`` payloads (SAM text and BAM records) and per-read
counts must be byte-identical; the port runs on the CPU through the
plain versions of its kernels.
"""

import collections
import os

import numpy as np
import pytest
import torch

from regen_golden import make_repeat_genome, make_repeat_reads
from seqlib_tpu.align import BWAAligner as JaxAligner
from seqlib_tpu.index import FMIndex as JaxFMIndex
from seqlib_tpu_torch.align import BWAAligner, FusedOverflowError
from seqlib_tpu_torch.align.device_full import FLAG_OVER, NFIELD
from seqlib_tpu_torch.index import FMIndex

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once: one intra-op
    thread per process keeps torch's CPU thread pools from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


Read = collections.namedtuple("Read", "name seq")


@pytest.fixture(scope="module")
def genome():
    return make_repeat_genome()


@pytest.fixture(scope="module")
def all_reads(genome):
    return make_repeat_reads(genome)


@pytest.fixture(scope="module")
def corpus(all_reads):
    picks = [r for c in range(10) for r in all_reads[100 * c:100 * c + 6]]
    out = []
    for k, (name, seq) in enumerate(picks):
        if k % 9 == 4:
            seq = seq[:75] + "N" + seq[76:]
        if k % 11 == 5:
            seq = seq.lower()
        if k % 13 == 6:
            seq = seq[20:120]
        out.append((name, seq))
    return out


@pytest.fixture(scope="module")
def aligners(genome):
    ji = JaxFMIndex.construct([("rep1", genome)])
    ti = FMIndex.from_arrays(
        codes=ji.ref.codes,
        anns=[(a.name, a.offset, a.length, a.n_amb) for a in ji.ref.anns],
        bwt_words=ji.bwt_words, cp_counts=ji.cp_counts, L2=ji.L2,
        primary=ji.primary, sa_full=ji.sa_full)
    return JaxAligner(ji), BWAAligner(ti, device="cpu")


@pytest.fixture(scope="module")
def jax_device_result(aligners, corpus):
    """The JAX package's fused device program on the corpus, run once
    (its CPU run is the costly part); every emission variant below is the
    JAX aligner's own finisher (``_payload_batch``, the code
    ``align_batch_bam`` runs after the dispatch) on this result."""
    ja, _ = aligners
    enc, lens = ja._encode_batch([s for _, s in corpus])
    return enc, lens, ja._dispatch_full(enc, lens)


@pytest.mark.parametrize("sam,hardclip,keep_sec_frac", [
    (True, False, 0.9),
    (False, False, 0.9),
    (True, True, 0.9),
    (True, False, -1.0),       # secondaries filtered out
    (False, True, 0.5),
])
def test_align_batch_bam_equals_jax(aligners, corpus, jax_device_result,
                                    sam, hardclip, keep_sec_frac):
    ja, ta = aligners
    enc, lens, s1 = jax_device_result
    ja.reset_stats()
    want = ja._payload_batch([Read(n, s) for n, s in corpus], enc, lens, s1,
                             hardclip, keep_sec_frac, 10, sam)
    assert ja.stats["fused_overflow_fallback"] == 0
    got = ta.align_batch_bam([s for _, s in corpus], [n for n, _ in corpus],
                             hardclip=hardclip, keep_sec_frac=keep_sec_frac,
                             sam=sam)
    assert got[0] == want[0]
    assert np.array_equal(got[1], want[1])
    assert int(got[1].sum()) >= len(corpus)


def test_align_stream_bam_equals_batch(aligners, corpus):
    _, ta = aligners
    mixed = [corpus[i] for i in np.random.default_rng(3).permutation(
        len(corpus))]
    reads = [Read(n, s) for n, s in mixed]
    out = list(ta.align_stream_bam(iter(reads), batch_size=30, sam=True,
                                   workers=2))
    assert [len(c) for c, _, _ in out] == [30, 30]
    for k, (chunk, payload, counts) in enumerate(out):
        part = mixed[30 * k:30 * (k + 1)]
        assert [r.name for r in chunk] == [n for n, _ in part]
        want = ta.align_batch_bam([s for _, s in part],
                                  [n for n, _ in part], sam=True)
        assert payload == want[0]
        assert np.array_equal(counts, want[1])


def test_overflow_batch_sam_equals_golden(aligners, all_reads):
    """60 divergent-copy (XA-class) reads of the repeat corpus in one
    64-read batch overflow the extension DP rows: like the JAX package,
    the port reruns the batch through its classic path and serialises
    the records.  The classic path aligns each read on its own, so its
    SAM equals these reads' lines of the JAX package's golden (made from
    the whole corpus in one chunk), byte for byte."""
    _, ta = aligners
    part = all_reads[700:760]
    ta.reset_stats()
    payload, counts = ta.align_batch_bam([s for _, s in part],
                                         [n for n, _ in part], sam=True)
    assert ta.stats["fused_overflow_fallback"] == 2
    names = {n for n, _ in part}
    with open(os.path.join(HERE, "golden", "sam_repeat_1k.txt")) as f:
        want = [l for l in f.read().splitlines()
                if not l.startswith("#") and l.split("\t", 1)[0] in names]
    assert payload.decode() == "".join(l + "\n" for l in want)
    assert int(counts.sum()) == len(want) and counts.size == len(part)


def test_long_read_raises(aligners, genome):
    _, ta = aligners
    with pytest.raises(FusedOverflowError):
        ta.align_batch_bam([genome[1000:2100]], ["long"], sam=True)


def test_host_global_pass_equals_jax(aligners, all_reads):
    """50 truncation-stress reads in a 64-read batch: more live regions
    than global-DP rows (dp_rows(64) = 64), so some are flagged
    FLAG_OVER and take the host global pass; payloads stay equal."""
    ja, ta = aligners
    part = all_reads[900:950]
    seqs, names = [s for _, s in part], [n for n, _ in part]
    enc, lens = ta._encode_batch(seqs)
    regions = ta._dispatch_full(enc, lens)[0].numpy()
    flags = regions[:, :7 * NFIELD].reshape(-1, 7, NFIELD)[:, :, 8]
    assert ((flags & FLAG_OVER) != 0).sum() > 0
    ja.reset_stats()
    want = ja.align_batch_bam(seqs, names, sam=True)
    assert ja.stats["fused_overflow_fallback"] == 0
    got = ta.align_batch_bam(seqs, names, sam=True)
    assert got[0] == want[0]
    assert np.array_equal(got[1], want[1])

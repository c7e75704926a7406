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
import math
import os

import numpy as np
import pytest
import torch

from regen_golden import make_repeat_genome, make_repeat_reads
from seqlib_tpu.align import BWAAligner as JaxAligner
from seqlib_tpu.index import FMIndex as JaxFMIndex
from seqlib_tpu_torch.align import (AlignerOptions, AlnReg, BWAAligner,
                                    FusedOverflowError)
from seqlib_tpu_torch.align.aligner import approx_mapq
from seqlib_tpu_torch.align.device_full import (FLAG_OVER,
                                                FLAG_PERFECT, NFIELD)
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


@pytest.fixture(scope="module")
def host_pass_results(aligners, all_reads):
    """50 truncation-stress reads in a 64-read batch and the JAX
    package's fused device program on them, run once: more live regions
    than global-DP rows (dp_rows(64) = 64), so some are flagged
    FLAG_OVER and take the host global pass; and the port's, on the
    CPU."""
    ja, ta = aligners
    part = all_reads[900:950]
    enc, lens = ja._encode_batch([s for _, s in part])
    return part, enc, lens, ja._dispatch_full(enc, lens), \
        ta._dispatch_full(enc, lens)


def test_host_global_pass_equals_jax(aligners, host_pass_results):
    """The truncation-stress batch: some regions take the host global
    pass; the payload equals the JAX package's (its finisher on its own
    device result, what its ``align_batch_bam`` runs)."""
    ja, ta = aligners
    part, enc, lens, s1, res = host_pass_results
    seqs, names = [s for _, s in part], [n for n, _ in part]
    regions = res[0].numpy()
    flags = regions[:, :7 * NFIELD].reshape(-1, 7, NFIELD)[:, :, 8]
    assert ((flags & FLAG_OVER) != 0).sum() > 0
    ja.reset_stats()
    want = ja._payload_batch([Read(n, s) for n, s in part], enc, lens, s1,
                             False, 0.9, 10, True)
    assert ja.stats["fused_overflow_fallback"] == 0
    got = ta.align_batch_bam(seqs, names, sam=True)
    assert got[0] == want[0]
    assert np.array_equal(got[1], want[1])


def _hits_by_slot(cols):
    """Columnar hits -> {(read, slot): (CIGAR runs as (op, length), NM,
    match length of a hit with no runs)}: the hits compared one by one,
    whatever the arrays' layout."""
    out = {}
    for i in range(cols["read_idx"].size):
        o, n = int(cols["cig_off"][i]), int(cols["cig_n"][i])
        runs = list(zip(cols["run_ops"][o:o + n].tolist(),
                        cols["run_lens"][o:o + n].tolist()))
        out[int(cols["read_idx"][i]), int(cols["slot"][i])] = (
            runs, int(cols["nm"][i]), 0 if n else int(cols["match_len"][i]))
    return out


@pytest.mark.parametrize("batch", ["corpus", "host_pass"])
def test_host_cols_equal_the_code_decode(aligners, corpus, jax_device_result,
                                         host_pass_results, batch):
    """The fused path's columns, hit by hit: each hit's CIGAR runs (the
    global DP's run words, through ``cig_off``/``cig_n``), NM and match
    length equal the JAX package's, whose runs come from the run-length
    decode of its packed traceback codes (``_ops_to_runs(_unpack_ops(
    ...))``, the decode the port's finish ran before its global DP handed
    over runs), on the device's DP rows and, in the truncation batch, on
    the host global pass's FLAG_OVER rows.  The corpus's payload is
    byte-identical (the truncation batch's: the test above)."""
    ja, ta = aligners
    if batch == "corpus":
        enc, lens, s1 = jax_device_result
        part, res = corpus, ta._dispatch_full(enc, lens)
    else:
        part, enc, lens, s1, res = host_pass_results
    want = _hits_by_slot(ja._hits_cols_from_full(enc, lens, s1))
    got = _hits_by_slot(ta._hits_cols_from_full(enc, lens, res))
    assert got == want
    assert sum(len(r) > 1 for r, _, _ in got.values()) > 0
    flags = res[0].numpy()[:, :7 * NFIELD].reshape(-1, 7, NFIELD)[:, :, 8]
    kinds = FLAG_PERFECT if batch == "corpus" else FLAG_OVER
    assert sum(bool(flags[k] & kinds) for k in got) > 0
    if batch != "corpus":
        return
    chunk = [Read(n, s) for n, s in part]
    g = ta._payload_batch(chunk, enc, lens, res, False, 0.9, 10, True)
    w = ja._payload_batch(chunk, enc, lens, s1, False, 0.9, 10, True)
    assert g[0] == w[0] and np.array_equal(g[1], w[1])


def _mapq_se(opt, r):
    """bwa's mem_approx_mapq_se on one region, scalar float64 with
    ``math.log``: the oracle of ``approx_mapq``."""
    sub = r.sub if r.sub else opt.min_seed_len * opt.a
    sub = max(sub, r.csub)
    if sub >= r.score:
        return 0
    length = max(r.qe - r.qb, r.re - r.rb)
    identity = 1.0 - float(length * opt.a - r.score) \
        / (opt.a + opt.b) / length
    if r.score == 0:
        mapq = 0
    else:
        tmp = 1.0 if length < opt.mapQ_coef_len \
            else opt.mapQ_coef_fac / math.log(length)
        tmp *= identity * identity
        mapq = int(6.02 * (r.score - sub) / opt.a * tmp * tmp + 0.499)
    if r.sub_n > 0:
        mapq -= int(4.343 * math.log(r.sub_n + 1) + 0.499)
    mapq = min(mapq, 60)
    mapq = max(mapq, 0)
    return int(mapq * (1.0 - r.frac_rep) + 0.499)


@pytest.mark.parametrize("frac_rep", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("sub_n", range(6))
def test_approx_mapq_equals_scalar_bwa(sub_n, frac_rep):
    """The one MAPQ (``approx_mapq``, numpy arrays, ``np.log``) equals
    bwa's scalar mem_approx_mapq_se on every length 1..10,000 (both
    sides of mapQ_coef_len; at 9,170 ``np.log`` and ``math.log`` differ
    in the last bit), scores 0..span x a (all of them beside 50 and
    9,170), sub 0 and above, the longer span on either side, and a = 1
    and 2."""
    opt = AlignerOptions()
    opt.set_a_score(1 + sub_n % 2)
    rng = np.random.default_rng(10 * sub_n + int(2 * frac_rep))
    # every score at the lengths beside mapQ_coef_len and at 9,170; four
    # (0, span x a, two drawn) at every length
    dense = np.r_[45:56, 9170]
    length = np.concatenate([np.repeat(np.arange(1, 10_001), 4),
                             np.repeat(dense, dense * opt.a + 1)])
    top = length * opt.a
    score = rng.integers(0, top + 1)
    score[0:40_000:4], score[1:40_000:4] = 0, top[1:40_000:4]
    score[40_000:] = np.concatenate([np.arange(n * opt.a + 1)
                                     for n in dense])
    sub = np.where(rng.random(length.size) < 0.5, 0,
                   rng.integers(1, top + 1))
    other = rng.integers(0, length + 1)
    q_long = rng.random(length.size) < 0.5
    qspan = np.where(q_long, length, other)
    tspan = np.where(q_long, other, length)
    want = [_mapq_se(opt, AlnReg(rb=500, re=500 + int(t), qb=3,
                                 qe=3 + int(q), score=int(s), seedcov=0,
                                 frac_rep=frac_rep, sub=int(u),
                                 sub_n=sub_n))
            for q, t, s, u in zip(qspan, tspan, score, sub)]
    got = approx_mapq(opt, score, sub, np.full(length.size, sub_n),
                      np.maximum(qspan, tspan),
                      np.full(length.size, frac_rep))
    assert got.tolist() == want
    assert (max(want) > 0) == (frac_rep < 1.0)

"""The port's wide-index path (int64 ranks and positions) against the JAX
package's hi/lo path, on the CPU.

A reference past 2^31 cannot be built here, so wideness is shown two
ways, as in the JAX package's own tests: arithmetic, through biased
checkpoint counts (rank'(c, k) = rank(c, k) + bias[c], the JAX
package's ``count_bias`` hook) that push ranks past 2^31 on a small
index; and the whole machine and aligner forced onto the wide path
(``wide=True``) on a small index, where every output must equal the JAX
package's ``wide=True`` path and the port's own narrow path.

The reference is the repeat genome of tests/regen_golden.py cut into
three contigs with N runs (one at a contig's start, one inside a
contig); reads are its repeat corpus (IUPAC codes, lower case and short
reads mixed in) and two long reads; tests/test_torch_wide_pairs.py holds
the paired batch.  The port runs on the CPU through the plain versions
of its kernels.  The JAX side's CPU runs are the costly part, so each
runs once: its fused program once for the fused batch
(``_dispatch_full``, then its own finishers), its classic path once for
the overflowing batch.  Tolerance: exact equality throughout.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seqlib_tpu.align.aligner as jax_aligner_module
from regen_golden import make_repeat_genome, make_repeat_reads
from seqlib_tpu.align import BWAAligner as JaxAligner
from seqlib_tpu.align import device_pipeline as jdp
from seqlib_tpu.align import device_pipeline_wide as jdpw
from seqlib_tpu.align.device_pipeline import dp_rows
from seqlib_tpu.align.device_pipeline_wide import unpack_stage1_wide
from seqlib_tpu.index import FMIndex as JaxFMIndex
from seqlib_tpu.ops.fm_hilo import (DeviceFMIndexHiLo, bi_extend_back_hilo,
                                    hl_join, hl_split, rank4_hilo, rank_hilo)
from seqlib_tpu.ops.fm_wide import (sa_lookup_wide, smem_collect_wide,
                                    smem_reseed_wide)
from seqlib_tpu_torch.align import BWAAligner
from seqlib_tpu_torch.align.device_pipeline import chain_device
from seqlib_tpu_torch.core.seq import encode_nt4, revcomp
from seqlib_tpu_torch.index import FMIndex
from seqlib_tpu_torch.ops import fm as tfm

BIAS = np.array([3 << 30, (1 << 32) + 5, 1 << 31, (1 << 33) + 7], np.int64)
Read = collections.namedtuple("Read", "name seq")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def genome():
    return make_repeat_genome()


@pytest.fixture(scope="module")
def contigs(genome):
    """Three contigs: c2 opens with 300 N, c3 holds 150 N inside."""
    g = genome
    return [("c1", g[:52_000]), ("c2", "N" * 300 + g[52_300:100_000]),
            ("c3", g[100_000:110_000] + "N" * 150 + g[110_150:])]


@pytest.fixture(scope="module")
def indexes(contigs, tmp_path_factory):
    """(JAX, port) host indexes: constructed, and loaded from the files
    the port writes (sampled SA, interval 32)."""
    d = tmp_path_factory.mktemp("wide")
    ti = FMIndex.construct(contigs)
    ti.write(str(d / "ref"))
    return dict(constructed=(JaxFMIndex.construct(contigs), ti),
                loaded=(JaxFMIndex.load(str(d / "ref")),
                        FMIndex.load(str(d / "ref"))))


@pytest.fixture(scope="module")
def corpus(genome):
    """64 reads of the repeat corpus (every class), some with an IUPAC
    code, in lower case or cut short."""
    reads = make_repeat_reads(genome)
    picks = [r for c in range(10) for r in reads[100 * c + 10:100 * c + 17]]
    picks = (picks + reads[500:510])[:64]
    out = []
    for k, (name, seq) in enumerate(picks):
        if k % 7 == 3:
            seq = seq[:40] + "RYKM"[k % 4] + seq[41:90] + "N" + seq[91:]
        if k % 11 == 5:
            seq = seq.lower()
        if k % 13 == 6:
            seq = seq[25:125]
        out.append((name, seq))
    return out


def _ks(n, rng, size):
    return np.concatenate([rng.integers(0, n + 1, size),
                           [0, 1, 127, 128, 129, n - 1, n]]).astype(np.int64)


@pytest.mark.parametrize("op", ["rank", "rank4", "bi_extend_back"])
def test_biased_ranks_past_2_31_equal_jax(indexes, op):
    """rank, rank4 and the FMD bi-extension on biased checkpoints equal
    the JAX package's rank_hilo / rank4_hilo / bi_extend_back_hilo joined
    with hl_join; some values pass 2^31."""
    ji, ti = indexes["constructed"]
    jf = DeviceFMIndexHiLo.from_host(ji, count_bias=BIAS)
    tf = tfm.DeviceFMIndex.from_host(ti, device="cpu", wide=True,
                                     count_bias=BIAS)
    assert tf.wide and tf.blocks.dtype == torch.int64
    rng = np.random.default_rng(2)
    n = ti.seq_len
    k = _ks(n, rng, 3000)
    kh, kl = (jnp.asarray(x) for x in hl_split(k))
    if op == "rank":
        got = np.stack([tfm.rank(tf, c, torch.from_numpy(k)).numpy()
                        for c in range(4)])
        want = np.stack([hl_join(*rank_hilo(
            jf, jnp.full(k.size, c, jnp.int32), kh, kl)) for c in range(4)])
    elif op == "rank4":
        got = tfm.rank4(tf, torch.from_numpy(k)).numpy()
        want = hl_join(*rank4_hilo(jf, kh, kl))
    else:
        s = np.minimum(rng.integers(0, 5000, k.size), n + 1 - k)
        ll = rng.integers(0, n + 1, k.size).astype(np.int64)
        got = np.stack([x.numpy() for x in tfm.bi_extend_back(
            tf, *(torch.from_numpy(x) for x in (k, ll, s)))])
        want = np.stack([hl_join(*pair) for pair in bi_extend_back_hilo(
            jf, kh, kl, *(jnp.asarray(x) for x in hl_split(ll)),
            *(jnp.asarray(x) for x in hl_split(s)))])
    assert got.dtype == np.int64
    assert np.array_equal(got, want)
    assert (got >= 2**31).sum() > k.size


def _occurrences(l_pac, seed):
    """[B=16, S=6] seeds with [K=4] located occurrences each: clusters on
    both strands near the top of each strand's range (so reverse-strand
    positions pass 2^30, and at a larger l_pac both strands' pass 2^30
    and the reverse strand's 2^31), a few far or invalid ones."""
    rng = np.random.default_rng(seed)
    B, S, K = 16, 6, 4
    qb = np.sort(rng.integers(0, 100, (B, S)), axis=1).astype(np.int32)
    qe = (qb + rng.integers(19, 45, (B, S))).astype(np.int32)
    base = np.where(rng.random(B) < 0.5, l_pac - 400_000, 2 * l_pac - 400_000)
    pos = base[:, None, None] + qb[:, :, None] \
        + rng.integers(-60, 60, (B, S, K)) \
        + rng.choice([0, 0, 0, 5_000, 300_000], (B, S, K))
    pos = np.where(rng.random((B, S, K)) < 0.15, -1, pos).astype(np.int64)
    return qb, qe, pos


@pytest.mark.parametrize("l_pac", [1_060_000_000, 1_600_000_000])
def test_chain_device_positions_past_2_30(l_pac):
    """Chaining with whole chains past 2^30 (and, at l_pac 1.6e9, past
    2^31): the port's chain_device, whose position sentinels are int64,
    equals the JAX package's int32 chain_device (under 2^31) and its
    hi/lo chain_device_wide."""
    qb, qe, pos = _occurrences(l_pac, 7)
    assert (pos >= 2**30).sum() > pos.size // 3
    got = chain_device(torch.from_numpy(qb), torch.from_numpy(qe),
                       torch.from_numpy(pos), l_pac)
    ph, pl = hl_split(np.maximum(pos, 0))
    ph = np.where(pos < 0, -1, ph).astype(np.int32)
    wide = jdpw.chain_device_wide(jnp.asarray(qb), jnp.asarray(qe),
                                  jnp.asarray(ph), jnp.asarray(pl), l_pac)
    wide["anchor_r"] = hl_join(wide.pop("anchor_rh"), wide.pop("anchor_rl"))
    wants = [wide]
    if 2 * l_pac < 2**31:
        wants.append(jdp.chain_device(jnp.asarray(qb), jnp.asarray(qe),
                                      jnp.asarray(pos.astype(np.int32)),
                                      l_pac))
    for want in wants:
        for k in ("anchor_q", "anchor_len", "anchor_r", "weight", "keep",
                  "n_seg"):
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert int(got["keep"].sum()) >= 16
    assert int((got["anchor_r"][got["keep"]] >= 2**30).sum()) >= 8


def _batch(genome, seed):
    """48 reads of 101 bp from the genome, 2% mutated, some with an N."""
    rng = np.random.default_rng(seed)
    enc = np.full((48, 101), 4, np.uint8)
    for i in range(48):
        p = int(rng.integers(0, len(genome) - 101))
        s = np.array(encode_nt4(genome[p:p + 101]))
        mut = rng.random(101) < 0.02
        s[mut] = rng.integers(0, 4, int(mut.sum()))
        if i % 5 == 0:
            s[int(rng.integers(0, 101))] = 4
        enc[i] = s
    return enc, np.full(48, 101, np.int32)


@pytest.mark.parametrize("which", ["constructed", "loaded"])
@pytest.mark.parametrize("p3", [0, 8])
def test_wide_machine_equals_jax(indexes, genome, which, p3):
    """smem_collect (pass 3 fused or not), smem_reseed from each read's
    longest seed and sa_lookup of its occurrences on the wide index equal
    fm_wide's smem_collect_wide / smem_reseed_wide / sa_lookup_wide, on a
    constructed index (full SA) and a loaded one (sampled SA, the LF
    walk); and equal the port's narrow path."""
    ji, ti = indexes[which]
    jf = DeviceFMIndexHiLo.from_host(ji)
    tw = tfm.DeviceFMIndex.from_host(ti, device="cpu", wide=True)
    tn = tfm.DeviceFMIndex.from_host(ti, device="cpu")
    enc, lens = _batch(genome, 40 + p3)
    reads, tl = torch.from_numpy(enc), torch.from_numpy(lens)
    want = smem_collect_wide(jf, jnp.asarray(enc), jnp.asarray(lens),
                             p3_seeds=p3)
    want["intv_l"] = hl_join(want.pop("il_hi"), want.pop("il_lo"))
    if p3:
        want["p3_intv_l"] = hl_join(want.pop("p3_il_hi"),
                                    want.pop("p3_il_lo"))
    got = tfm.smem_collect(tw, reads, tl, p3_seeds=p3)
    narrow = tfm.smem_collect(tn, reads, tl, p3_seeds=p3)
    assert set(got) == set(want)
    for key in got:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
        assert np.array_equal(got[key].numpy(), narrow[key].numpy()), key
    assert got["intv_l"].dtype == torch.int64
    assert int(got["n_seeds"].sum()) > 48
    # re-seed from each read's longest seed
    slen = np.where(np.arange(16)[None, :] < want["n_seeds"][:, None],
                    np.asarray(want["qend"]) - np.asarray(want["qbeg"]), -1)
    pick = slen.argmax(1)
    rows = np.arange(48)

    def at(key):
        return np.asarray(got[key].numpy()[rows, pick])
    qb, qe, sz = at("qbeg"), at("qend"), at("intv_sz")
    act = slen[rows, pick] >= 19
    jr = smem_reseed_wide(jf, jnp.asarray(enc), jnp.asarray(lens),
                          *(jnp.asarray(x) for x in (qb, qe, sz, act)))
    tr = tfm.smem_reseed(tw, reads, tl, *(torch.from_numpy(x)
                                          for x in (qb, qe, sz, act)))
    want_r = (jr[0], jr[1], hl_join(jr[2], jr[3]), jr[4])
    for g, w in zip(tr, want_r):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # locate up to 4 occurrences of every seed (invalid lanes: -1)
    occ = np.arange(4)[None, None, :]
    ranks = got["intv_l"].numpy()[:, :, None] + occ
    live = (np.arange(16)[None, :, None] < want["n_seeds"][:, None, None]) \
        & (occ < got["intv_sz"].numpy()[:, :, None])
    ranks = np.where(live, ranks, -1).reshape(-1)
    hi, lo = hl_split(np.maximum(ranks, 0))
    hi = np.where(ranks < 0, -1, hi).astype(np.int32)
    ph, pl = sa_lookup_wide(jf, jnp.asarray(hi), jnp.asarray(lo))
    want_pos = np.where(np.asarray(ph) < 0, -1, hl_join(ph, pl))
    got_pos = tfm.sa_lookup(tw, torch.from_numpy(ranks)).numpy()
    assert np.array_equal(got_pos, want_pos)
    assert np.array_equal(got_pos, tfm.sa_lookup(
        tn, torch.from_numpy(ranks)).numpy())
    assert (got_pos >= 0).sum() > 100


@pytest.fixture(scope="module")
def aligners(indexes):
    ji, ti = indexes["constructed"]
    return (JaxAligner(ji, wide=True), BWAAligner(ti, wide=True, device="cpu"),
            BWAAligner(ti, device="cpu"))


@pytest.fixture(scope="module")
def jax_fused(aligners, corpus):
    """The JAX package's wide fused program on the corpus, once: its
    native payload and its object-API records (its own finishers)."""
    ja = aligners[0]
    enc, lens = ja._encode_batch([s for _, s in corpus])
    res = ja._dispatch_full(enc, lens)
    chunk = [Read(n, s) for n, s in corpus]
    payload = ja._payload_batch(chunk, enc, lens, res, False, 0.9, 10, True)
    hdr = ja.index.header_from_index()
    sam = [[r.to_sam(hdr) for r in recs] for _, recs in
           ja._finish_batch(chunk, enc, lens, res, False, 0.9, 10)]
    return payload, sam


def _sam(aln, recs):
    hdr = aln.index.header_from_index()
    return [[r.to_sam(hdr) for r in rs] for rs in recs]


def test_wide_fused_batch_equals_jax_and_narrow(aligners, corpus, jax_fused):
    """align_batch_bam (SAM), align_stream_bam and align_batch on the
    fused path: == the JAX package's wide fused path, == the port's
    narrow path; the region block comes back int64."""
    _, tw, tn = aligners
    seqs, names = [s for _, s in corpus], [n for n, _ in corpus]
    want_payload, want_sam = jax_fused
    tw.reset_stats()
    got = tw.align_batch_bam(seqs, names, sam=True)
    assert tw.stats["fused_overflow_fallback"] == 0
    assert got[0] == want_payload[0]
    assert np.array_equal(got[1], want_payload[1])
    assert int(got[1].sum()) >= len(corpus)
    stream = list(tw.align_stream_bam(iter(Read(n, s) for n, s in corpus),
                                      batch_size=64, sam=True))
    assert len(stream) == 1 and stream[0][1] == want_payload[0]
    assert _sam(tw, tw.align_batch(seqs, names)) == want_sam
    assert tn.align_batch_bam(seqs, names, sam=True)[0] == got[0]
    enc, lens = tw._encode_batch(seqs)
    assert tw._dispatch_full(enc, lens)[0].dtype == torch.int64


def test_wide_overflow_batch_equals_jax(aligners, genome):
    """60 divergent-copy reads in one 64-read batch overflow the
    extension DP rows: the port reruns them on its classic path
    (uncompacted re-extension, host dedup) and its records equal the JAX
    package's wide classic path (what its fused path reruns on this
    batch, checked to overflow there too)."""
    ja, tw, _ = aligners
    part = make_repeat_reads(genome)[700:760]
    seqs, names = [s for _, s in part], [n for n, _ in part]
    enc, lens = ja._encode_batch(seqs)
    B = enc.shape[0]
    stage1 = ja._dispatch_stage1(jnp.asarray(enc),
                                 jnp.asarray(lens.astype(np.int32)))
    assert unpack_stage1_wide(np.asarray(stage1), 7)["n_dp"][0] > dp_rows(B)
    regs = ja._collect_regions(enc, lens, stage1=stage1)[:len(part)]
    hits = ja._regions_to_hits(enc, lens, names, seqs, regs)
    hdr = ja.index.header_from_index()
    want = [r.to_sam(hdr) for b in range(len(part)) for r in
            ja._assemble_records(seqs[b], names[b], hits[b], False, 0.9, 10)]
    tw.reset_stats()
    payload, counts = tw.align_batch_bam(seqs, names, sam=True)
    # counted by the payload's attempt and the object path's, as in the
    # JAX package
    assert tw.stats["fused_overflow_fallback"] == 2
    assert payload.decode() == "".join(ln + "\n" for ln in want)
    assert int(counts.sum()) == len(want) >= len(part)


def test_wide_long_reads_equal_jax(aligners, genome, monkeypatch):
    """Two long reads (1.3 kb inside c1, and 1.2 kb in c2
    reverse-complemented with a 1 bp deletion and a 3' tail) through the
    long-read path; the JAX package pads to exact row counts (rows are
    independent, so padding changes no output)."""
    ja, tw, _ = aligners
    tail = "".join("ACGT"[i] for i in
                   np.random.default_rng(3).integers(0, 4, 200))
    seqs = [genome[30_000:31_300],
            revcomp(genome[70_000:70_600] + genome[70_601:71_000]) + tail]
    names = ["long1", "long2"]
    monkeypatch.setattr(jax_aligner_module, "_bucket",
                        lambda n, mn=64: max(int(n), 1))
    want = _sam(ja, ja.align_batch(seqs, names))
    got = _sam(tw, tw.align_batch(seqs, names))
    assert got == want and all(want)

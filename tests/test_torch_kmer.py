"""The port's device k-mer pipeline (seqlib_tpu_torch.ops.kmer) against
the JAX package's (seqlib_tpu.ops.kmer) on the CPU, tolerance 0.

Keys: the port's int64 keys, mapped back to uint64 (``to_uint64``),
equal the JAX package's (hi, lo) pairs for every window, valid or not,
at k in {15, 16, 17, 25, 31, 32} (16 is the word boundary of the JAX
rolls, 32 uses the int64 sign bit).  Tables, lookups, the weak
pre-scan and the spectrum walk are compared on the same numpy inputs;
the walk runs the port unpadded and the JAX package padded (B to a
multiple of 64, L to a multiple of 32), as its callers pad.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqlib_tpu.assembly.bfc import KmerTable, canonical_kmers
from seqlib_tpu.ops import kmer as jk
from seqlib_tpu_torch.ops import kmer as tk
from seqlib_tpu_torch.sim import (KMER_REP, KMER_REP_DIFF, kmer_batch,
                                  kmer_region_reads)

KS = [15, 16, 17, 25, 31, 32]


def _u64(hi, lo):
    return (np.asarray(hi).astype(np.uint32).astype(np.uint64)
            << np.uint64(32)) | np.asarray(lo).astype(np.uint32)


def _keys(values, k):
    """uint64 k-mer values -> the port's int64 keys."""
    u = np.asarray(values, np.uint64)
    return (u ^ np.uint64(1 << 63) if k == 32 else u).view(np.int64)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def batch():
    return kmer_batch()


def _jax_canonical(reads, lens, k):
    return jk.canonical_kmers_device(jnp.asarray(reads), jnp.asarray(lens), k)


@pytest.mark.parametrize("k", KS)
def test_pack_revcomp_canonical(batch, k):
    reads, lens = batch
    hi, lo, valid = map(np.asarray, jk.pack_kmers(
        jnp.asarray(reads), jnp.asarray(lens), k))
    key, pvalid = tk.pack_kmers(*_t(reads, lens), k)
    assert np.array_equal(pvalid.numpy(), valid)
    assert np.array_equal(tk.to_uint64(key.numpy(), k), _u64(hi, lo))
    rhi, rlo = jk.revcomp_kmers(jnp.asarray(hi), jnp.asarray(lo), k)
    assert np.array_equal(tk.to_uint64(tk.revcomp_kmers(key, k).numpy(), k),
                          _u64(rhi, rlo))
    chi, clo, cvalid = map(np.asarray, _jax_canonical(reads, lens, k))
    can, pcvalid = tk.canonical_kmers_device(*_t(reads, lens), k)
    assert np.array_equal(pcvalid.numpy(), cvalid)
    assert np.array_equal(tk.to_uint64(can.numpy(), k), _u64(chi, clo))
    # and the host packer's keys where valid
    for b in (0, 3, 5):
        hk = canonical_kmers(reads[b][:lens[b]], k)
        ok = hk != np.uint64(0xFFFFFFFFFFFFFFFF)
        got = tk.to_uint64(can[b, :lens[b] - k + 1].numpy(), k)
        assert np.array_equal(got[ok], hk[ok])
    assert np.array_equal(_keys(_u64(chi, clo), k), can.numpy())


@pytest.mark.parametrize("k", KS)
def test_table_and_lookup(batch, k):
    reads, lens = batch
    chi, clo, valid = _jax_canonical(reads, lens, k)
    kh, kl, counts, nu = jk.count_kmers_device(chi, clo, valid)
    can, pvalid = tk.canonical_kmers_device(*_t(reads, lens), k)
    keys, cnt = tk.count_kmers_device(can, pvalid)
    n = int(nu)
    assert keys.dtype == torch.int64 and n == keys.numel()
    assert np.array_equal(tk.to_uint64(keys.numpy(), k),
                          _u64(kh[:n], kl[:n]))
    assert np.array_equal(cnt.numpy(), np.asarray(counts[:n]))
    assert int(cnt.max()) >= 2
    # every window, valid or not, then absent keys and the key extremes
    want = np.asarray(jk.lookup_kmers_device(kh, kl, counts, chi, clo))
    assert np.array_equal(tk.lookup_kmers_device(keys, cnt, can).numpy(),
                          want)
    rng = np.random.default_rng(k)
    top = (1 << (2 * k)) - 1
    q = np.concatenate([rng.integers(0, top, 64, dtype=np.uint64,
                                     endpoint=True),
                        np.array([0, top, top // 2, top // 2 + 1],
                                 np.uint64),
                        tk.to_uint64(keys.numpy()[::3], k)])
    qhi = (q >> np.uint64(32)).astype(np.uint32).astype(np.int32)
    qlo = (q & np.uint64(0xFFFFFFFF)).astype(np.uint32).astype(np.int32)
    want = np.asarray(jk.lookup_kmers_device(kh, kl, counts,
                                             jnp.asarray(qhi),
                                             jnp.asarray(qlo)))
    got = tk.lookup_kmers_device(keys, cnt,
                                 torch.from_numpy(_keys(q, k)))
    assert np.array_equal(got.numpy(), want)
    assert (want > 0).sum() >= len(keys.numpy()[::3])
    # an empty table finds nothing
    empty = tk.lookup_kmers_device(keys[:0], cnt[:0], can)
    assert not bool(empty.any())


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("min_cov", [2, 3])
def test_weak_flags(batch, k, min_cov):
    reads, lens = batch
    chi, clo, valid = _jax_canonical(reads, lens, k)
    kh, kl, counts, _ = jk.count_kmers_device(chi, clo, valid)
    want = np.asarray(jk.weak_reads_device(
        jnp.asarray(reads), jnp.asarray(lens), kh, kl, counts, k, min_cov))
    tr, tl = _t(reads, lens)
    keys, cnt = tk.count_kmers_device(*tk.canonical_kmers_device(tr, tl, k))
    got = tk.weak_reads_device(tr, tl, keys, cnt, k, min_cov).numpy()
    assert np.array_equal(got, want)
    assert 0 < want.sum() < len(want) or min_cov == 3


# ---------------------------------------------------------------------------
# the spectrum walk on a 4 kb region
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def region_reads():
    return kmer_region_reads()


def _walk_both(reads, lens, k, min_cov):
    """(JAX codes, JAX nchg) on padded inputs cut back to the batch, and
    the port's on the unpadded batch."""
    B, L = reads.shape
    Bp, Lp = (B + 63) // 64 * 64, (L + 31) // 32 * 32
    pad = np.full((Bp, Lp), 4, np.uint8)
    pad[:B, :L] = reads
    plens = np.zeros(Bp, np.int64)
    plens[:B] = lens
    chi, clo, valid = _jax_canonical(pad, plens, k)
    kh, kl, counts, _ = jk.count_kmers_device(chi, clo, valid)
    jc, jn = jk.correct_reads_device(jnp.asarray(pad), jnp.asarray(plens),
                                     kh, kl, counts, k, min_cov)
    tr, tl = _t(reads, lens)
    keys, cnt = tk.count_kmers_device(*tk.canonical_kmers_device(tr, tl, k))
    pc, pn = tk.correct_reads_device(tr, tl, keys, cnt, k, min_cov)
    return (np.asarray(jc)[:B, :L], np.asarray(jn)[:B], pc.numpy(),
            pn.numpy())


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("min_cov", [4, 13])
def test_correct_reads(region_reads, k, min_cov):
    g, reads, lens, n_plain = region_reads
    jc, jn, pc, pn = _walk_both(reads, lens, k, min_cov)
    assert pc.dtype == np.uint8 and pn.dtype == np.int32
    assert np.array_equal(pn, jn)
    live = np.arange(reads.shape[1])[None, :] < lens[:, None]
    assert np.array_equal(pc[live], jc[live])
    assert jn.sum() > 0
    if min_cov == 4:
        tie, nread, back = n_plain, n_plain + 1, n_plain + 2
        assert pc[nread, 60] == g[2060] and jn[nread] >= 1
        assert pc[back, 5] == g[2505]
        assert pc[tie, 50] == 0                   # the first of A, C
        assert pn[n_plain + 3] == 0 and pn[n_plain + 4] == 0


@pytest.mark.parametrize("k", [17, 25, 32])
def test_tie_takes_the_first_base(region_reads, k):
    """At the tie probe's column both A and C extend to a solid k-mer
    with the same count: the walk takes A (the first maximum), as
    jnp.argmax does."""
    g, reads, lens, n_plain = region_reads
    table = KmerTable(np.concatenate(
        [canonical_kmers(reads[i, :lens[i]], k) for i in range(len(reads))]))
    at = KMER_REP[0] + KMER_REP_DIFF
    ctx = g[at - k + 1:at + 1].copy()
    cand = []
    for b in (0, 1):
        ctx[-1] = b
        cand.append(int(table.lookup(canonical_kmers(ctx, k))[0]))
    assert cand[0] == cand[1] >= 4
    jc, jn, pc, pn = _walk_both(reads, lens, k, 4)
    assert jc[n_plain, 50] == 0 and pc[n_plain, 50] == 0
    assert np.array_equal(pc[n_plain], jc[n_plain])

"""The port's FM-index ops and SMEM machine against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both
packages; the JAX side runs its XLA functions on the CPU (the SMEM
machine's CPU path, which is what the TPU kernel is pinned to), the
port runs its plain PyTorch versions on the CPU.  Every output is an
integer array and must be exactly equal.  The brute-force SMEM and
pass-3 oracles of tests/test_smem.py pin the port independently.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regen_golden import make_repeat_genome, make_repeat_reads
from seqlib_tpu.index import FMIndex as JaxFMIndex
from seqlib_tpu.ops import fm as jfm
from seqlib_tpu_torch.core.seq import encode_nt4
from seqlib_tpu_torch.index import FMIndex
from seqlib_tpu_torch.ops import fm as tfm
from test_smem import _brute_pass3, _brute_smems, _count_ov, _mk_ref, _rc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once: one intra-op
    thread per process keeps torch's CPU thread pools from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def genome():
    return make_repeat_genome()


@pytest.fixture(scope="module")
def indexes(genome):
    ji = JaxFMIndex.construct([("rep1", genome)])
    ti = FMIndex.construct([("rep1", genome)])
    return jfm.DeviceFMIndex.from_host(ji), tfm.DeviceFMIndex.from_host(
        ti, device="cpu")


@pytest.fixture(scope="module")
def batch(genome):
    """128 reads of the repeat corpus (every class) plus a read with an
    N and a short read; uint8 [B, 160] codes and lengths."""
    reads = make_repeat_reads(genome)
    seqs = [s for _, s in reads[::8]]
    seqs[3] = seqs[3][:70] + "N" + seqs[3][71:]
    seqs[5] = seqs[5][:60]
    enc = np.full((len(seqs), 160), 4, np.uint8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        e = encode_nt4(s)
        enc[i, :e.size] = e
        lens[i] = e.size
    return enc, lens


def _eq(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (msg, a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), msg


def test_device_index_blocks_equal(indexes):
    jf, tf = indexes
    _eq(np.asarray(jf.blocks).view(np.int32), tf.blocks, "blocks")
    _eq(jf.sa_samples, tf.sa, "sa")
    _eq(jf.L2, tf.L2, "L2")
    assert int(jf.primary) == tf.primary and jf.seq_len == tf.seq_len


def test_rank_rank4_bi_extend_sa_lookup(indexes):
    jf, tf = indexes
    rng = np.random.default_rng(1)
    n = jf.seq_len
    k = np.concatenate([rng.integers(0, n + 1, 3000),
                        [0, 1, 127, 128, 129, n - 1, n]]).astype(np.int32)
    for c in range(4):
        _eq(jfm.rank(jf, jnp.int32(c), jnp.asarray(k)),
            tfm.rank(tf, c, torch.from_numpy(k)), f"rank c={c}")
        kf = np.minimum(k + 1, n + 1).astype(np.int32)
        _eq(jfm.rank_full(jf, jnp.int32(c), jnp.asarray(kf)),
            tfm.rank_full(tf, c, torch.from_numpy(kf)), f"rank_full c={c}")
    _eq(jfm.rank4(jf, jnp.asarray(k)), tfm.rank4(tf, torch.from_numpy(k)),
        "rank4")
    # bi-intervals: random (k, l, s) with k + s <= n + 1
    kk = rng.integers(0, n + 1, 2000).astype(np.int32)
    ss = np.minimum(rng.integers(0, 5000, 2000), n + 1 - kk).astype(np.int32)
    ll = rng.integers(0, n + 1, 2000).astype(np.int32)
    got = tfm.bi_extend_back(tf, *(torch.from_numpy(x) for x in (kk, ll, ss)))
    want = jfm.bi_extend_back(jf, *(jnp.asarray(x) for x in (kk, ll, ss)))
    for g, w, name in zip(got, want, ("k4", "l4", "s4")):
        _eq(w, g, name)
    ranks = np.concatenate([rng.integers(0, n + 1, 3000), [-1, -5, 0,
                            int(jf.primary)]]).astype(np.int32)
    _eq(jfm.sa_lookup(jf, jnp.asarray(ranks)),
        tfm.sa_lookup(tf, torch.from_numpy(ranks)), "sa_lookup")


@functools.lru_cache(maxsize=None)
def _jax_machine(**static):
    return jax.jit(functools.partial(jfm._smem_machine, **static))


MACHINE_KEYS = ("qbeg", "qend", "intv_l", "intv_sz", "n_seeds", "n_dropped")
P3_KEYS = ("p3_qbeg", "p3_qend", "p3_intv_l", "p3_intv_sz", "p3_n")


@pytest.mark.parametrize("p3_seeds,step_cap,C", [
    (0, 656, 8), (8, 656, 8),
    (8, 96, 8),  # truncates lanes: n_dropped counts them
    # kernel K2's stack edges: C = 1 wraps at every push, 16 is its most
    (8, 656, 1), (0, 656, 16),
])
def test_smem_machine_equals_jax(indexes, batch, p3_seeds, step_cap, C):
    """_smem_machine == the JAX package's, with an N read, a short read,
    an empty lane and an inactive lane in the batch."""
    jf, tf = indexes
    enc, lens = batch
    B, L = enc.shape
    lens = lens.copy()
    lens[6] = 0                 # an empty lane
    x0 = np.zeros(B, np.int32)
    mi = np.ones(B, np.int32)
    act = lens > 0
    act[7] = False              # an inactive lane
    static = dict(max_seeds=16, min_seed_len=19, C=C, max_rounds=L,
                  step_cap=step_cap, p3_seeds=p3_seeds, p3_max_intv=20)
    want = _jax_machine(**static)(jf, jnp.asarray(enc), jnp.asarray(lens),
                                  jnp.asarray(x0), jnp.asarray(mi),
                                  jnp.asarray(act))
    got = tfm._smem_machine(tf, torch.from_numpy(enc),
                            torch.from_numpy(lens), torch.from_numpy(x0),
                            torch.from_numpy(mi), torch.from_numpy(act),
                            **static)
    keys = MACHINE_KEYS + (P3_KEYS if p3_seeds else ())
    for k in keys:
        _eq(want[k], got[k], k)
    if step_cap < 200:
        assert int(np.asarray(want["n_dropped"]).sum()) > 0


@pytest.mark.parametrize("p3_seeds", [0, 8])
def test_smem_machine_work_counts(indexes, batch, p3_seeds):
    """``count_work`` leaves the machine's outputs as they are, and its
    per-lane counts hang together: a round runs one main and at most one
    pass-3 bi-extension, two ranks each, and each rank popcounts the
    words of its block prefix (checked against Python integers)."""
    _, tf = indexes
    enc, lens = batch
    B, L = enc.shape
    args = [torch.from_numpy(a) for a in (enc, lens, np.zeros(B, np.int32),
                                          np.ones(B, np.int32), lens > 0)]
    kw = dict(max_seeds=16, min_seed_len=19, C=8, max_rounds=L,
              step_cap=656, p3_seeds=p3_seeds, p3_max_intv=20)
    plain = tfm._smem_machine(tf, *args, **kw)
    got = tfm._smem_machine(tf, *args, **kw, count_work=True)
    for k in plain:
        _eq(plain[k], got[k], k)
    steps, rounds, exts, words = (got[k].numpy() for k in
                                  ("steps", "rounds", "exts", "rank_words"))
    assert (rounds <= steps).all() and (steps <= 656).all()
    assert (rounds > 0).sum() == (lens > 0).sum()
    if p3_seeds:
        assert (rounds <= exts).all() and (exts <= 2 * rounds).all()
        assert (exts > rounds).any()
    else:
        _eq(rounds, exts, "one bi-extension per round")
    assert (words <= 2 * 8 * exts).all() and words.sum() > 0
    rng = np.random.default_rng(7)
    k = rng.integers(0, tf.seq_len + 2, 500)
    kk = [int(v) - (int(v) > tf.primary) for v in k]
    _eq(tfm.rank_words(tf, torch.from_numpy(k)),
        [-(-(v % 128) // 16) for v in kk], "rank_words")


def test_smem_collect_and_reseed_equal_jax(indexes, batch):
    jf, tf = indexes
    enc, lens = batch
    want = jfm.smem_collect(jf, jnp.asarray(enc), jnp.asarray(lens),
                            p3_seeds=8)
    got = tfm.smem_collect(tf, torch.from_numpy(enc), torch.from_numpy(lens),
                           p3_seeds=8)
    for k in MACHINE_KEYS + P3_KEYS:
        _eq(want[k], got[k], k)
    # re-seed each read's first seed (min_intv = occ + 1)
    qb = np.asarray(want["qbeg"])[:, 0].astype(np.int32)
    qe = np.asarray(want["qend"])[:, 0].astype(np.int32)
    occ = np.asarray(want["intv_sz"])[:, 0].astype(np.int32)
    act = (np.asarray(want["n_seeds"]) > 0) & (qe - qb >= 28)
    jr = jfm.smem_reseed(jf, jnp.asarray(enc), jnp.asarray(lens),
                         jnp.asarray(qb), jnp.asarray(qe), jnp.asarray(occ),
                         jnp.asarray(act))
    tr = tfm.smem_reseed(tf, torch.from_numpy(enc), torch.from_numpy(lens),
                         torch.from_numpy(qb), torch.from_numpy(qe),
                         torch.from_numpy(occ), torch.from_numpy(act))
    for a, b, name in zip(jr, tr, ("qbeg2", "qend2", "intv_l2", "intv_sz2")):
        _eq(a, b, name)
    assert int(np.asarray(jr[3]).astype(bool).sum()) > 0


def _small_index(ref):
    return tfm.DeviceFMIndex.from_host(FMIndex.construct([("c", ref)]),
                                       device="cpu")


def _encode(reads):
    L = max(len(r) for r in reads)
    enc = np.full((len(reads), L), 4, np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        e = encode_nt4(r)
        enc[i, :e.size] = e
        lens[i] = e.size
    return torch.from_numpy(enc), torch.from_numpy(lens)


@pytest.mark.parametrize("seed", [1, 2])
def test_smem_collect_matches_bruteforce(seed):
    """The port's SMEMs equal the brute-force SMEM oracle of
    tests/test_smem.py."""
    ref = _mk_ref(seed=seed, n=2500,
                  repeat=("ACGTACGTGGCCAATTCCGGATCGATCG",
                          [100, 700, 1400, 2100]))
    text2l = ref + _rc(ref)
    fm = _small_index(ref)
    rng = np.random.default_rng(seed + 50)
    reads = []
    for _ in range(12):
        p = int(rng.integers(0, len(ref) - 80))
        r = list(ref[p:p + 80])
        for _ in range(2):
            i = int(rng.integers(5, 75))
            r[i] = "ACGT"[("ACGT".index(r[i]) + 1) % 4]
        reads.append("".join(r))
    reads.append(ref[90:170])
    nread = list(ref[300:380])
    nread[40] = "N"
    reads.append("".join(nread))
    enc, lens = _encode(reads)
    out = tfm.smem_collect(fm, enc, lens, max_seeds=32, min_seed_len=10)
    for b, q in enumerate(reads):
        want = _brute_smems(text2l, q, 10)
        n = int(out["n_seeds"][b])
        got = {(int(out["qbeg"][b, j]), int(out["qend"][b, j])):
               int(out["intv_sz"][b, j]) for j in range(n)}
        assert got == want, (b, sorted(got), sorted(want))


def test_pass3_matches_bruteforce():
    """The fused pass-3 lanes equal the bwt_seed_strategy1 oracle."""
    ref = _mk_ref(seed=4, n=2500,
                  repeat=("ACGTACGTACGTACGTACGTACGT", [100, 700, 1400]))
    text2l = ref + _rc(ref)
    fm = _small_index(ref)
    rng = np.random.default_rng(104)
    reads = []
    for _ in range(12):
        p = int(rng.integers(0, len(ref) - 130))
        r = list(ref[p:p + 130])
        for _ in range(int(rng.integers(0, 4))):
            r[int(rng.integers(0, 130))] = "ACGT"[int(rng.integers(0, 4))]
        reads.append("".join(r))
    enc, lens = _encode(reads)
    out = tfm.smem_collect(fm, enc, lens, p3_seeds=8)
    for b, r in enumerate(reads):
        exp = _brute_pass3(text2l, r, 19, 20)[:8]
        n = int(out["p3_n"][b])
        have = [(int(out["p3_qbeg"][b, j]), int(out["p3_qend"][b, j]),
                 int(out["p3_intv_sz"][b, j])) for j in range(n)]
        assert have == exp, (b, have, exp)
        for qb, qe, sz in have:
            assert _count_ov(text2l, r[qb:qe]) == sz

"""The port's scale-out layer on the CPU: the greedy seed scan and the
data-parallel steps against the JAX package's, and the mesh aligner, the
threaded sharded aligner, the multihost helpers, the scaling report and
the dry run against the port's single-device runs.  Every comparison is
exact (tolerance 0) on hermetic data: the repeat genome and corpus of
tests/regen_golden.py and the port's ``sim``.

The JAX side runs on the suite's 8-device virtual CPU mesh (conftest.py),
the port's on meshes of 2 and 4 CPU entries (``make_mesh(n,
device="cpu")``).  Each single-device reference runs once per module, as
does the JAX mesh aligner (its CPU runs are the costly part).
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regen_golden import make_repeat_genome, make_repeat_reads
from seqlib_tpu.align import BWAAligner as JaxAligner
from seqlib_tpu.index import FMIndex as JaxFMIndex
from seqlib_tpu.ops import fm as jfm
from seqlib_tpu.parallel import make_mesh as jax_make_mesh
from seqlib_tpu.parallel import sharded_extend_step as jax_extend_step
from seqlib_tpu.parallel import sharded_seed_step as jax_seed_step
from seqlib_tpu.parallel import multihost as jax_multihost
from seqlib_tpu_torch.align import BWAAligner, ShardedBWAAligner
from seqlib_tpu_torch.align.pairing import align_pairs
from seqlib_tpu_torch.index import FMIndex, ShardedFMIndex
from seqlib_tpu_torch.ops import fm as tfm
from seqlib_tpu_torch.parallel import (Mesh, make_mesh, shard_batch,
                                       sharded_extend_step,
                                       sharded_seed_step)
from seqlib_tpu_torch.parallel import multihost
from seqlib_tpu_torch.parallel.dryrun import dryrun_multichip
from seqlib_tpu_torch.parallel.scaling import measure_scaling
from seqlib_tpu_torch.sim import simulate_pairs

Read = collections.namedtuple("Read", "name seq")
SEED_KEYS = ("qbeg", "qend", "intv_l", "intv_sz", "n_seeds")
EXT_KEYS = ("score", "qle", "tle", "gscore", "gtle")


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
def indexes(genome):
    """The JAX index and the port's over the very same arrays."""
    ji = JaxFMIndex.construct([("rep1", genome)])
    ti = FMIndex.from_arrays(
        codes=ji.ref.codes,
        anns=[(a.name, a.offset, a.length, a.n_amb) for a in ji.ref.anns],
        bwt_words=ji.bwt_words, cp_counts=ji.cp_counts, L2=ji.L2,
        primary=ji.primary, sa_full=ji.sa_full)
    return ji, ti


@pytest.fixture(scope="module")
def corpus(genome):
    """24 reads of every class of the repeat corpus, cut to their middle
    96 bases (the plain versions' loops run as long as the longest read)
    with an N, lower case and a shorter read mixed in."""
    reads = make_repeat_reads(genome)
    out = []
    for k, (name, seq) in enumerate(
            r for c in range(10) for r in reads[100 * c + 40:100 * c + 43]):
        seq = seq[27:123]
        if k % 7 == 3:
            seq = seq[:40] + "N" + seq[41:]
        if k % 9 == 5:
            seq = seq.lower()
        if k % 11 == 6:
            seq = seq[10:80]
        out.append((name, seq))
    return out[:24]


@pytest.fixture(scope="module")
def seed_batch(genome):
    """16 reads of 128 codes: substitutions, N codes, empty and short
    lanes, a read off the genome."""
    rng = np.random.default_rng(5)
    g = np.frombuffer(genome.encode(), np.uint8)
    codes = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), g)
    B, L = 16, 128
    enc = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        n = L if b % 4 else int(rng.integers(0, L))
        p = int(rng.integers(0, g.size - n))
        r = codes[p:p + n].astype(np.uint8)
        r[rng.random(n) < 0.03] = rng.integers(0, 5)
        enc[b, :n], lens[b] = r, n
    lens[3] = 0
    enc[7, :L] = rng.integers(0, 4, L)
    return enc, lens


def _device_fms(indexes):
    ji, ti = indexes
    return jfm.DeviceFMIndex.from_host(ji), \
        tfm.DeviceFMIndex.from_host(ti, device="cpu")


def test_collect_seeds_and_backward_ext_equal_jax(indexes, seed_batch):
    """The lockstep greedy scan and its backward extension, on reads with
    N codes and empty lanes, at two seed widths."""
    jd, td = _device_fms(indexes)
    enc, lens = seed_batch
    for max_seeds, min_len in ((16, 19), (4, 12)):
        want = jfm.collect_seeds(jd, jnp.asarray(enc), jnp.asarray(lens),
                                 max_seeds=max_seeds, min_seed_len=min_len)
        got = tfm.collect_seeds(td, torch.from_numpy(enc),
                                torch.from_numpy(lens), max_seeds=max_seeds,
                                min_seed_len=min_len)
        for k in SEED_KEYS:
            assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k
        assert int(got["n_seeds"].sum()) > 0
        assert int(got["n_seeds"][3]) == 0
    rng = np.random.default_rng(6)
    n1 = indexes[0].seq_len + 1
    l = rng.integers(0, n1, (2, 32))
    u = np.minimum(l + rng.integers(0, 50, (2, 32)), n1)
    c = rng.integers(0, 4, (2, 32))
    want = jfm.backward_ext(jd, *(jnp.asarray(a, jnp.int32)
                                  for a in (l, u, c)))
    got = tfm.backward_ext(td, *(torch.from_numpy(a) for a in (l, u, c)))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


def test_sharded_seed_step_equals_jax(indexes, seed_batch):
    """4 CPU entries against the JAX step on 8 devices: seeds and the
    summed stats; whole batches and ``shard_batch`` slices alike."""
    jd, td = _device_fms(indexes)
    enc, lens = seed_batch
    jmesh = jax_make_mesh()
    assert jmesh.shape["dp"] == 8
    want, wstats = jax_seed_step(jd, jmesh)(jnp.asarray(enc),
                                            jnp.asarray(lens))
    mesh = make_mesh(4, device="cpu")
    step = sharded_seed_step(td, mesh)
    got, stats = step(enc, lens)
    for k in SEED_KEYS:
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k
    assert stats.tolist() == np.asarray(wstats).tolist()
    sh = shard_batch(mesh, {"reads": enc, "lens": lens})
    assert [x.shape[0] for x in sh["reads"]] == [4] * 4
    got2, stats2 = step(sh["reads"], sh["lens"])
    assert all(torch.equal(got[k], got2[k]) for k in SEED_KEYS)
    assert torch.equal(stats, stats2)
    with pytest.raises(ValueError, match="multiple"):
        shard_batch(mesh, {"reads": enc[:6]})


@pytest.mark.parametrize("band", [0, 100])
def test_sharded_extend_step_equals_jax(band):
    """The rectangle (band 0, kernel K3's function) and the banded
    extension (K1's) on 4 CPU entries against the JAX step on 8 devices,
    with z-drop and lanes of every length."""
    rng = np.random.default_rng(band + 1)
    M, Lq, Lt = 32, 64, 96
    q = rng.integers(0, 4, (M, Lq)).astype(np.int8)
    t = np.concatenate([q, rng.integers(0, 4, (M, Lt - Lq)).astype(np.int8)],
                       axis=1)
    t[::3, 10:14] = (t[::3, 10:14] + 1) % 4
    ql = rng.integers(0, Lq + 1, M).astype(np.int32)
    tl = rng.integers(0, Lt + 1, M).astype(np.int32)
    h0 = rng.integers(1, 40, M).astype(np.int32)
    kw = dict(zdrop=40, band=band)
    want, wtotal = jax_extend_step(jax_make_mesh(), **kw)(
        *(jnp.asarray(a) for a in (q, ql, t, tl, h0)))
    got, total = sharded_extend_step(make_mesh(4, device="cpu"), **kw)(
        q, ql, t, tl, h0)
    for k in EXT_KEYS:
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k
    assert int(total) == int(wtotal) == int(got["score"].sum())


def test_make_mesh_refuses_absent_cards():
    mesh = make_mesh(3, device="cpu")
    assert mesh.shape["dp"] == 3 and mesh.distinct() == [torch.device("cpu")]
    assert make_mesh(device="cpu").shape["dp"] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh(2)
        with pytest.raises(RuntimeError):
            Mesh(["cuda:0"])
    else:
        with pytest.raises(RuntimeError):
            make_mesh(torch.cuda.device_count() + 1)


def test_mesh_runs_every_entry_and_raises_its_error():
    mesh = make_mesh(4, device="cpu")
    assert mesh.run([lambda k=k: k * k for k in range(4)]) == [0, 1, 4, 9]

    def boom():
        raise KeyError("entry 2")

    with pytest.raises(KeyError, match="entry 2"):
        mesh.run([lambda: 0, lambda: 1, boom, lambda: 3])


# ---------------------------------------------------------------------------
# BWAAligner(mesh=...) against the port's single-device aligner
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def overflow_case():
    """72 reads of a 150 bp segment found 4 times in the reference, one
    mismatch each: 4 non-trivial chains a read, more than the DP rows of
    the whole batch and of each slice of 2 or 4 (dp_rows(32) = 64)."""
    rng = np.random.default_rng(11)
    seg = "".join("ACGT"[c] for c in rng.integers(0, 4, 150))
    sp = ["".join("ACGT"[c] for c in rng.integers(0, 4, 220))
          for _ in range(5)]
    ref = sp[0] + seg + sp[1] + seg + sp[2] + seg + sp[3] + seg + sp[4]
    reads = []
    for i in range(72):
        s = list(seg)
        s[20 + i] = "A" if s[20 + i] != "A" else "C"
        reads.append("".join(s))
    return FMIndex.construct([("rep", ref)]), reads


@pytest.fixture(scope="module")
def pairs(genome):
    r1, r2 = simulate_pairs([("rep1", genome)], 8, read_len=100, dist=250,
                            stdev=20, seed=4)
    return [u.seq for u in r1], [u.seq for u in r2], \
        [u.name[:-2] for u in r1]


def _sam(hdr, recs):
    return [[r.to_sam(hdr) for r in rs] for rs in recs]


def _run(entry, aln, corpus, overflow_case, pairs):
    """What one entry point gives on ``aln`` (records as SAM lines, or a
    payload), and the aligner's fallback count."""
    seqs, names = [s for _, s in corpus], [n for n, _ in corpus]
    hdr = aln.index.header_from_index()
    aln.reset_stats()
    if entry == "align_batch":
        out = _sam(hdr, aln.align_batch(seqs, names))
    elif entry == "align_stream_bam":
        out = [(p, c.tolist()) for _, p, c in aln.align_stream_bam(
            iter(Read(n, s) for n, s in corpus), batch_size=16)]
    elif entry == "overflow":
        reads = overflow_case[1]
        out = _sam(hdr, aln.align_batch(reads, [f"o{i}" for i in
                                                range(len(reads))]))
    elif entry == "align_pairs":
        s1, s2, pn = pairs
        r1, r2, st = align_pairs(aln, s1, s2, pn)
        out = (_sam(hdr, r1), _sam(hdr, r2), st)
    else:                                       # wide=True
        out = aln.align_batch_bam(seqs, names, sam=True)
        out = (out[0], out[1].tolist())
    return out, aln.stats["fused_overflow_fallback"]


def _aligner(entry, indexes, overflow_case, **kw):
    idx = overflow_case[0] if entry == "overflow" else indexes[1]
    return BWAAligner(idx, wide=entry == "wide", **kw)


ENTRIES = ("align_batch", "align_stream_bam", "overflow", "align_pairs",
           "wide")


@pytest.fixture(scope="module")
def single_runs(indexes, corpus, overflow_case, pairs):
    """Each entry point on the port's single-device aligner, run once."""
    cache = {}

    def get(entry):
        if entry not in cache:
            aln = _aligner(entry, indexes, overflow_case, device="cpu")
            cache[entry] = _run(entry, aln, corpus, overflow_case, pairs)
        return cache[entry]

    return get


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("entry", ENTRIES)
def test_mesh_aligner_equals_single_device(n, entry, indexes, corpus,
                                           overflow_case, pairs,
                                           single_runs):
    """Every entry point through a mesh of n CPU entries equals the
    single-device run exactly; the overflow batch takes the classic path
    (its slices overflow) on both."""
    want, want_fb = single_runs(entry)
    aln = _aligner(entry, indexes, overflow_case,
                   mesh=make_mesh(n, device="cpu"))
    assert aln.n_shards == n and aln.device == torch.device("cpu")
    got, fb = _run(entry, aln, corpus, overflow_case, pairs)
    assert got == want
    if entry == "overflow":
        assert want_fb == fb == 1
    elif entry != "align_pairs":
        assert want_fb == fb == 0


def test_mesh_aligner_equals_jax_mesh_aligner(indexes, corpus):
    """``align_batch`` on a 2-entry mesh against the JAX package's
    aligner on its 8-device mesh (the JAX mesh path runs the classic
    path only; the port's runs the fused program per slice)."""
    ji, ti = indexes
    seqs, names = [s for _, s in corpus], [n for n, _ in corpus]
    hdr = ti.header_from_index()
    want = _sam(hdr, JaxAligner(ji, mesh=jax_make_mesh()).align_batch(
        seqs, names))
    got = _sam(hdr, BWAAligner(ti, mesh=make_mesh(2, device="cpu"))
               .align_batch(seqs, names))
    assert got == want
    assert sum(map(len, got)) >= len(corpus)


# ---------------------------------------------------------------------------
# the sharded aligner's threads, multihost helpers, scaling, dry run
# ---------------------------------------------------------------------------

def test_sharded_aligner_threads_equal_sequential(genome, corpus,
                                                  monkeypatch):
    """Two shards on two CPU entries, each on a thread of its own, equal
    the same shards run one after another on the calling thread."""
    import seqlib_tpu_torch.align.sharded as port_sharded
    contigs = [("c1", genome[:52_000]), ("c2", genome[52_000:])]
    sidx = ShardedFMIndex.construct(contigs, max_shard_bp=80_000)
    assert sidx.n_shards == 2
    seqs, names = [s for _, s in corpus[:12]], [n for n, _ in corpus[:12]]
    aln = ShardedBWAAligner(sidx, devices=["cpu", "cpu"])
    hdr = sidx.header_from_index()
    threads = []
    real = port_sharded.run_on_devices

    def counted(groups):
        threads.append(len(groups))
        return real(groups)

    monkeypatch.setattr(port_sharded, "run_on_devices", counted)
    got = _sam(hdr, aln.align_batch(seqs, names))
    assert threads and all(n == 2 for n in threads)

    def sequential(groups):
        return [[fn() for fn in thunks] for _, thunks in groups]

    monkeypatch.setattr(port_sharded, "run_on_devices", sequential)
    want = _sam(hdr, aln.align_batch(seqs, names))
    assert got == want
    assert sum(map(len, got)) >= len(seqs)


def test_multihost_helpers_equal_jax():
    assert multihost.init_multihost() == (0, 1) == \
        jax_multihost.init_multihost()
    items = list(range(11))
    for n in (1, 2, 3):
        for pid in range(n):
            assert list(multihost.host_shard(items, pid, n)) == \
                list(jax_multihost.host_shard(items, pid, n))
    assert list(multihost.host_shard(items)) == items
    vals = {"b": 2.5, "a": 1.0}
    got = multihost.allreduce_stats(vals)
    assert got == jax_multihost.allreduce_stats(vals) == vals
    assert got is not vals
    for out, pid in (("out.bam", 3), ("outdir/x", 0), ("a.b/c.d.bam", 12),
                     ("dir.v2/part", 7), ("x", 10000)):
        assert multihost.part_path(out, pid) == \
            jax_multihost.part_path(out, pid)
    assert multihost.part_path("out.bam") == "out.part0000.bam"


def test_measure_scaling_rows(indexes, corpus):
    _, ti = indexes
    aln = BWAAligner(ti, mesh=make_mesh(2, device="cpu"))
    enc, lens = aln._encode_batch([s[:48] for _, s in corpus[:8]])
    rows = measure_scaling(ti, enc, lens, sizes=[1, 2], iters=1,
                           device="cpu")
    assert [r["n_devices"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["reads_per_s"] > 0 for r in rows)
    assert set(rows[1]) == {"n_devices", "reads_per_s", "efficiency"}


def test_dryrun_multichip_on_cpu():
    res = dryrun_multichip(2, device="cpu")
    assert res["devices"] == ["cpu", "cpu"]
    assert res["shards"] >= 2 and res["records"] >= res["reads"] // 2
    assert res["sharded_records"] >= res["records"] - 2
    assert res["across_junction"] < res["reads"] // 8

"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Run on a machine with a CUDA GPU (``--noconftest``: the suite's
conftest imports jax, which the GPU machine need not have):

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

Every test decides inside itself whether a card is present and skips
without one, so every test worker collects the same tests.  Outputs are
integers and must be bit-equal (tolerance 0).
"""

import functools
import io
import os

import numpy as np
import pytest
import torch

from seqlib_tpu_torch import profiling
from seqlib_tpu_torch.align import BWAAligner
from seqlib_tpu_torch.align.pairing import align_pairs
from seqlib_tpu_torch.assembly import BFC, FermiAssembler
from seqlib_tpu_torch.bench_sw import (RECT_KERNELS, STOP_WIDTHS,
                                       STOP_ZDROPS, k1_edge_inputs,
                                       k1_long_inputs, rect_stop_inputs)
from seqlib_tpu_torch.index import FMIndex
from seqlib_tpu_torch.core import GenomicRegion, sort_by_position
from seqlib_tpu_torch.core.unaligned import UnalignedSequence
from seqlib_tpu_torch.io import BAM, BamReader, BamWriter
from seqlib_tpu_torch.io.bam import read_record
from seqlib_tpu_torch.io.fast_bam import FastBamReader
from seqlib_tpu_torch.ops import cuda_lib, fm_cuda, kmer, sw_cuda
from seqlib_tpu_torch.ops.fm import (DeviceFMIndex, _smem_machine, sa_lookup,
                                     smem_machine)
from seqlib_tpu_torch.ops.sw import extend_batch, extend_rect
from seqlib_tpu_torch.sim import (edge_read_batch, kmer_batch,
                                  kmer_region_reads, make_genome,
                                  make_repeat_genome, make_repeat_reads,
                                  random_bwt_index, simulate_long_reads,
                                  simulate_pairs, simulate_reads)

pytestmark = pytest.mark.gpu

KEYS = ("score", "qle", "tle", "gscore", "gtle")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def genome():
    return make_genome(200_000, seed=3, n_segments=2, seg_len=2000)


def _lanes(seed, M, Lq, Lt, dev):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (M, Lq)).astype(np.int8)
    t = rng.integers(0, 5, (M, Lt)).astype(np.int8)
    ql = rng.integers(0, Lq + 1, M).astype(np.int32)
    tl = rng.integers(0, Lt + 1, M).astype(np.int32)
    h0 = rng.integers(1, 60, M).astype(np.int32)
    for m in range(0, M, 2):                     # near-identical half
        n = int(ql[m])
        t[m, :n] = q[m, :n]
        tl[m] = max(tl[m], n)
        for p in rng.integers(0, max(n, 1), 2):
            t[m, p] = (t[m, p] + 1) % 4
    return [torch.from_numpy(a).to(dev) for a in (q, ql, t, tl, h0)]


@pytest.mark.parametrize("w,zdrop,M", [
    (32, 0, 512), (32, 100, 512), (100, 0, 512), (100, 100, 512),
    (8, 23, 512),
    # the band's edges: w = 1, the widest band, 2w + 2 not a multiple of
    # 32, and M not a multiple of the kernel's 4 lanes per block
    (1, 0, 509), (1, 100, 510), (128, 0, 511), (128, 100, 509),
    (20, 100, 511), (57, 0, 510)])
def test_k1_equals_plain(cuda, w, zdrop, M):
    """K1 == extend_batch(band=w) on random, near-identical and edge
    lanes (qlen = 0, tlen < w, tlen = Lt, tlen > Lt, h0 small enough for
    NEG cells in row 0)."""
    args = k1_edge_inputs(cuda, M, 160, 160 + w + 1, w, seed=w + zdrop)
    n0 = cuda_lib.LAUNCHES["sw_extend"]
    got = sw_cuda.extend_batch_banded(*args, band=w, zdrop=zdrop)
    assert cuda_lib.LAUNCHES["sw_extend"] == n0 + 1
    want = extend_batch(*args, band=w, zdrop=zdrop)
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k


def test_k1_adaptive_equals_full_band(cuda):
    args = _lanes(5, 512, 160, 261, cuda)
    got = sw_cuda.extend_batch_adaptive(*args, band=100, zdrop=100)
    want = extend_batch(*args, band=100, zdrop=100)
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("p3_seeds,step_cap,max_rounds,C,L", [
    (8, 656, 160, 8, 160), (0, 656, 160, 8, 160), (8, 60, 160, 8, 160),
    (0, 328, 1, 8, 160),
    # the stack's edges (C = 1 wraps at every push, C = 16 is the most
    # the kernel holds) and the longest read the fused path takes
    (8, 656, 160, 1, 160), (8, 656, 160, 16, 160), (0, 328, 1, 1, 160),
    (8, 4112, 1024, 8, 1024)])
def test_k2_equals_plain(cuda, genome, p3_seeds, step_cap, max_rounds, C, L):
    """K2 == _smem_machine on simulated reads with N codes, empty and
    inactive lanes."""
    fm = DeviceFMIndex.from_host(FMIndex.construct([("rep1", genome)]),
                                 device=cuda)
    B = 256 if L <= 160 else 64
    enc, lens, active = edge_read_batch(genome, B, L, seed=4)
    rng = np.random.default_rng(1)
    x0 = rng.integers(0, L, B) if max_rounds == 1 else np.zeros(B)
    mi = rng.integers(1, 4, B) if max_rounds == 1 else np.ones(B)
    args = [torch.from_numpy(np.asarray(a)).to(cuda) for a in
            (enc, lens, x0.astype(np.int32), mi.astype(np.int32), active)]
    kw = dict(max_seeds=16 if max_rounds > 1 else 4, min_seed_len=19, C=C,
              max_rounds=max_rounds, step_cap=step_cap, p3_seeds=p3_seeds,
              p3_max_intv=20)
    n0 = cuda_lib.LAUNCHES["smem_machine"]
    got = smem_machine(fm, *args, **kw)
    assert cuda_lib.LAUNCHES["smem_machine"] == n0 + 1
    want = _smem_machine(fm, *args, **kw)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if step_cap == 60:
        assert int(want["n_dropped"].sum()) > 0


@pytest.mark.parametrize("p3_seeds,max_rounds", [(8, 160), (0, 1)])
def test_k2_wide_equals_plain_and_narrow(cuda, genome, p3_seeds, max_rounds):
    """K2's int64 instantiation (64-byte rows) == _smem_machine on the
    wide index, and == the int32 instantiation on the narrow one."""
    idx = FMIndex.construct([("rep1", genome)])
    wide = DeviceFMIndex.from_host(idx, device=cuda, wide=True)
    narrow = DeviceFMIndex.from_host(idx, device=cuda)
    B, L = 256, 160
    enc, lens, active = edge_read_batch(genome, B, L, seed=6)
    rng = np.random.default_rng(2)
    x0 = rng.integers(0, L, B) if max_rounds == 1 else np.zeros(B)
    mi = rng.integers(1, 4, B) if max_rounds == 1 else np.ones(B)
    args = [torch.from_numpy(np.asarray(a)).to(cuda) for a in
            (enc, lens, x0.astype(np.int32), mi.astype(np.int32), active)]
    kw = dict(max_seeds=16 if max_rounds > 1 else 4, min_seed_len=19, C=8,
              max_rounds=max_rounds, step_cap=4 * L + 16,
              p3_seeds=p3_seeds, p3_max_intv=20)
    got = fm_cuda.smem_machine_cuda(wide, *args, **kw)
    want = _smem_machine(wide, *args, **kw)
    ref = fm_cuda.smem_machine_cuda(narrow, *args, **kw)
    assert got["intv_l"].dtype == torch.int64
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], ref[k].to(got[k].dtype)), k


def test_wide_and_sharded_aligners_gpu_equal_cpu(cuda, genome):
    """BWAAligner(wide=True) and a two-shard ShardedBWAAligner: the card's
    SAM == the CPU's; the wide path's == the narrow path's."""
    from seqlib_tpu_torch.align import ShardedBWAAligner
    from seqlib_tpu_torch.index import ShardedFMIndex
    corpus = simulate_reads(genome, 200, seed=8)
    seqs, names = [s for _, s in corpus], [n for n, _ in corpus]
    idx = FMIndex.construct([("rep1", genome)])
    g = BWAAligner(idx, wide=True, device=cuda).align_batch_bam(
        seqs, names, sam=True)
    c = BWAAligner(idx, wide=True, device="cpu").align_batch_bam(
        seqs, names, sam=True)
    n = BWAAligner(idx, device=cuda).align_batch_bam(seqs, names, sam=True)
    assert g[0] == c[0] == n[0]
    contigs = [("a", genome[:120_000]), ("b", genome[120_000:])]
    sidx = ShardedFMIndex.construct(contigs, max_shard_bp=130_000)
    assert sidx.n_shards == 2
    cuda_lib.reset_launches()
    g = ShardedBWAAligner(sidx, devices=[cuda]).align_batch_bam(
        seqs, names, sam=True)
    assert all(cuda_lib.LAUNCHES[k] > 0 for k in cuda_lib.MAIN_PATH)
    c = ShardedBWAAligner(sidx, devices=["cpu"]).align_batch_bam(
        seqs, names, sam=True)
    assert g[0] == c[0] and np.array_equal(g[1], c[1])


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def test_kernels_launch_on_their_tensors_card(two_cards, genome):
    """K1 and K2 on cuda:1, launched while the current device is cuda:0,
    equal their plain versions; inputs on two cards raise."""
    c0, c1 = two_cards
    args = _lanes(21, 512, 160, 260, c1)
    fm = DeviceFMIndex.from_host(FMIndex.construct([("rep1", genome)]),
                                 device=c1)
    enc, lens, active = edge_read_batch(genome, 256, 160, seed=4)
    kargs = [torch.from_numpy(np.asarray(a)).to(c1) for a in
             (enc, lens, np.zeros(256, np.int32), np.ones(256, np.int32),
              active)]
    kw = dict(max_seeds=16, min_seed_len=19, C=8, max_rounds=160,
              step_cap=656, p3_seeds=8, p3_max_intv=20)
    with torch.cuda.device(c0):
        got1 = sw_cuda.extend_batch_banded_cuda(*args, band=100, zdrop=100)
        got2 = fm_cuda.smem_machine_cuda(fm, *kargs, **kw)
        with pytest.raises(ValueError):
            sw_cuda.extend_batch_banded_cuda(args[0], args[1],
                                             args[2].to(c0), *args[3:])
    torch.cuda.synchronize(c1)
    want1 = extend_batch(*args, band=100, zdrop=100)
    want2 = _smem_machine(fm, *kargs, **kw)
    assert all(torch.equal(got1[k], want1[k]) for k in KEYS)
    assert all(torch.equal(got2[k], want2[k]) for k in want2)


def test_mesh_and_shards_on_two_cards_equal_one_card(two_cards, genome):
    """A mesh over two cards and a two-shard index with one shard a card
    give the single card's records."""
    from seqlib_tpu_torch.align import ShardedBWAAligner
    from seqlib_tpu_torch.index import ShardedFMIndex
    from seqlib_tpu_torch.parallel import Mesh
    c0, c1 = two_cards
    corpus = simulate_reads(genome, 600, seed=12)
    seqs, names = [s for _, s in corpus], [n for n, _ in corpus]
    idx = FMIndex.construct([("rep1", genome)])
    want = BWAAligner(idx, device=c0).align_batch_bam(seqs, names, sam=True)
    mesh = BWAAligner(idx, mesh=Mesh([c0, c1]))
    cuda_lib.reset_launches()
    got = mesh.align_batch_bam(seqs, names, sam=True)
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    assert all(cuda_lib.LAUNCHES[k] > 0 for k in cuda_lib.MAIN_PATH)
    contigs = [("a", genome[:120_000]), ("b", genome[120_000:])]
    sidx = ShardedFMIndex.construct(contigs, max_shard_bp=130_000)
    one = ShardedBWAAligner(sidx, devices=[c0]).align_batch_bam(
        seqs, names, sam=True)
    two = ShardedBWAAligner(sidx, devices=[c0, c1]).align_batch_bam(
        seqs, names, sam=True)
    assert two[0] == one[0] and np.array_equal(two[1], one[1])


@pytest.mark.parametrize("Lq,w,zdrop", [
    # past the 4096 rows of the JAX package's packed tie-break
    (4097, 100, 100), (4097, 32, 0),
    # past the 227 KB of shared memory a block can have: the codes are
    # read from global memory
    (30_000, 100, 0), (30_000, 32, 100)])
def test_k1_long_lanes_equal_plain(cuda, Lq, w, zdrop):
    args = k1_long_inputs(cuda, 16, Lq, w, seed=Lq + w)
    got = sw_cuda.extend_batch_banded(*args, band=w, zdrop=zdrop)
    want = extend_batch(*args, band=w, zdrop=zdrop)
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("L", [12_289, 60_000])
def test_k2_long_reads_equal_plain(cuda, genome, L):
    """Reads past 48 KB of shared memory for four (L 12,289) and past the
    227 KB a block can have (L 60,000, read from global memory); x0
    spread along the read and a step cap of 4000 keep the plain version
    short."""
    fm = DeviceFMIndex.from_host(FMIndex.construct([("rep1", genome)]),
                                 device=cuda)
    B = 16
    enc, lens, active = edge_read_batch(genome, B, L, seed=L)
    x0 = np.linspace(0, L - 1, B).astype(np.int32)
    args = [torch.from_numpy(np.asarray(a)).to(cuda) for a in
            (enc, lens, x0, np.ones(B, np.int32), active)]
    kw = dict(max_seeds=64, min_seed_len=19, C=8, max_rounds=L,
              step_cap=4000, p3_seeds=8, p3_max_intv=20)
    got = smem_machine(fm, *args, **kw)
    want = _smem_machine(fm, *args, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_long_read_batch_gpu_equals_cpu(cuda, genome):
    """Eight long reads (1.1-3 kb, some with a 3' tail) through
    align_batch's long-read path on both devices."""
    reads = simulate_long_reads(genome, 8, seed=3, min_len=1100,
                                max_len=3000, tail_frac=0.3)
    idx = FMIndex.construct([("rep1", genome)])
    seqs, names = [s for _, s in reads], [n for n, _ in reads]
    hdr = idx.header_from_index()
    cuda_lib.reset_launches()
    g = BWAAligner(idx, device=cuda).align_batch(seqs, names)
    assert all(cuda_lib.LAUNCHES[k] > 0 for k in cuda_lib.MAIN_PATH)
    c = BWAAligner(idx, device="cpu").align_batch(seqs, names)
    assert [r.to_sam(hdr) for rs in g for r in rs] \
        == [r.to_sam(hdr) for rs in c for r in rs]


def test_pair_batch_gpu_equals_cpu(cuda, genome):
    """64 pairs through align_pairs on both devices, mate 2 of every
    eighth pair mutated past seeding (period 8), so rescue runs."""
    idx = FMIndex.construct([("rep1", genome)])
    r1, r2 = simulate_pairs([("rep1", genome)], 64, dist=400, stdev=40,
                            seed=2)
    s1, s2 = [u.seq for u in r1], [u.seq for u in r2]
    swap = {"A": "C", "C": "G", "G": "T", "T": "A"}
    for i in range(0, 64, 8):
        s2[i] = "".join(swap[c] if k % 8 == 0 else c
                        for k, c in enumerate(s2[i]))
    names = [u.name for u in r1]
    hdr = idx.header_from_index()
    out = {}
    for dev in (cuda, "cpu"):
        o1, o2, st = align_pairs(BWAAligner(idx, device=dev), s1, s2, names)
        out[str(dev)] = ([r.to_sam(hdr) for rs in o1 + o2 for r in rs],
                         [(d.failed, d.low, d.high) for d in st.dirs])
    assert out["cuda"] == out["cpu"]


def test_load_chase_follows_the_chain(cuda):
    rows = 5000
    perm = np.random.default_rng(2).permutation(rows)
    nxt = np.zeros((rows, 12), np.int32)
    nxt[perm, 0] = np.roll(perm, -1)
    out = torch.zeros(1, dtype=torch.int32, device=cuda)
    n0 = cuda_lib.LAUNCHES["smem_machine"]
    fm_cuda.load_chase(torch.from_numpy(nxt).to(cuda), 777, out)
    start = int(np.flatnonzero(perm == 0)[0])
    assert int(out[0]) == int(perm[(start + 777) % rows])
    assert cuda_lib.LAUNCHES["smem_machine"] == n0


@pytest.fixture(scope="module")
def built_index(genome):
    """The genome's index built in memory: the full SA."""
    return FMIndex.construct([("c1", genome[:120_000]),
                              ("c2", "N" * 50 + genome[120_050:])])


@pytest.fixture(scope="module")
def loaded_index(built_index, tmp_path_factory):
    """The genome's index written as bwa's files and loaded back: a
    sampled SA (interval 32), no full SA."""
    prefix = str(tmp_path_factory.mktemp("bwa_index") / "ref.fa")
    built_index.write(prefix)
    idx = FMIndex.load(prefix)
    assert idx.sa_full is None and idx.sa_intv == 32
    return idx


def _sampled(fm, intv: int):
    """``fm`` (a full SA) with its SA sampled at every ``intv``-th rank."""
    return DeviceFMIndex(blocks=fm.blocks, sa=fm.sa[::intv].contiguous(),
                         L2=fm.L2, L2_host=fm.L2_host, primary=fm.primary,
                         seq_len=fm.seq_len, l_pac=fm.l_pac, sa_intv=intv)


def _walk_equal(fm, ranks: np.ndarray, cuda):
    """The walk kernel on the card against the plain loop on the CPU
    (``fm`` a CPU index): positions and steps bit-equal, with and
    without ``return_steps``, exactly one launch a call; under the
    tracer the kernel's device totals equal the plain loop's counters
    and no device read is counted.  Returns the steps."""
    r = torch.from_numpy(ranks)
    profiling.take()
    with profiling.tracing():
        c, cs = sa_lookup(fm, r, return_steps=True)
    want = profiling.take().counters
    gfm, gr = fm.to(cuda), r.to(cuda)
    n0 = cuda_lib.LAUNCHES["sa_walk"]
    with profiling.tracing():
        g, gs = sa_lookup(gfm, gr, return_steps=True)
        torch.cuda.synchronize()
    got = profiling.take().counters
    assert cuda_lib.LAUNCHES["sa_walk"] == n0 + 1
    assert torch.equal(g.cpu(), c) and torch.equal(gs.cpu(), cs)
    assert torch.equal(sa_lookup(gfm, gr).cpu(), c)
    assert cuda_lib.LAUNCHES["sa_walk"] == n0 + 2
    assert got["locate.walk_launches"] == 1
    assert not any(k.startswith("sync.") for k in got)
    for k in fm_cuda.WALK_COUNTERS:
        assert got[k] == want[k], (k, got[k], want[k])
    return cs


@pytest.mark.parametrize("intv", [32, 4])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_sa_lookup_walk_gpu_equals_cpu(cuda, built_index, loaded_index,
                                       wide, intv):
    """The walk kernel on 100,000 random ranks (-1, 0 and primary among
    them) equals the plain loop: the loaded index (interval 32) or the
    built one's SA sampled at 4, narrow and wide rows."""
    idx = loaded_index if intv == 32 else built_index
    fm = DeviceFMIndex.from_host(idx, device="cpu", wide=wide)
    if intv != 32:
        fm = _sampled(fm, intv)
    assert fm.sa_intv == intv and fm.wide == wide
    ranks = np.random.default_rng(12).integers(-1, idx.seq_len + 1, 100_000)
    ranks[:3] = (-1, 0, idx.primary)
    cs = _walk_equal(fm, ranks, cuda)
    assert int(cs.max()) > intv and int(cs[:3].max()) == 0


@pytest.mark.parametrize("intv", [32, 4])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_sa_walk_cap_gpu_equals_cpu(cuda, wide, intv):
    """Lanes still walking at the cap (64 x intv steps) get
    ``sa[r // intv] + steps`` from the kernel as from the plain loop."""
    fm = DeviceFMIndex.from_host(random_bwt_index(2000, 1, intv),
                                 device="cpu", wide=wide)
    ranks = np.arange(-1, 2001)
    ranks[1:3] = (0, fm.primary)
    cs = _walk_equal(fm, ranks, cuda)
    assert int((cs == 64 * intv).sum()) > 0


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_sa_walk_large_interval_gpu(cuda, built_index, wide):
    """An SA sampled at 10,000 (bwa's ``bwt2sa -i`` takes any interval):
    walks of thousands of steps, too long for the plain loop here.  The
    kernel's positions are the full SA's, and its steps those the
    inverse SA implies (a step goes back one text position, to the
    nearest position whose rank is sampled, or 0); one launch, and its
    device totals agree."""
    intv = 10_000
    fm = _sampled(DeviceFMIndex.from_host(built_index, device="cpu",
                                          wide=wide), intv)
    sa = built_index.sa_full.astype(np.int64)
    isa = np.empty_like(sa)
    isa[sa] = np.arange(sa.size)
    stop = isa % intv == 0
    stop[0] = True
    last = np.maximum.accumulate(np.where(stop, np.arange(stop.size), 0))
    ranks = np.random.default_rng(5).integers(1, built_index.seq_len + 1,
                                              4096)
    ranks[:3] = (-1, 0, built_index.primary)
    want_pos = sa[np.maximum(ranks, 0)]
    want_steps = want_pos - last[want_pos]
    want_pos[:3], want_steps[:3] = (-1, 0, 0), 0
    n0 = cuda_lib.LAUNCHES["sa_walk"]
    profiling.take()
    with profiling.tracing():
        pos, steps = sa_lookup(fm.to(cuda), torch.from_numpy(ranks).to(cuda),
                               return_steps=True)
        torch.cuda.synchronize()
    got = profiling.take().counters
    assert cuda_lib.LAUNCHES["sa_walk"] == n0 + 1
    assert np.array_equal(pos.cpu().numpy(), want_pos)
    assert np.array_equal(steps.cpu().numpy(), want_steps)
    assert int(want_steps.max()) > 8191
    assert got["locate.lanes"] == 4095
    assert got["locate.lane_steps"] == int(want_steps.sum())
    assert got["locate.capped"] == 0


def test_sa_lookup_full_sa_launches_no_walk(cuda, built_index):
    """A built index (the full SA) locates by one gather, as on the CPU:
    no walk launch, no walk counter."""
    fm = DeviceFMIndex.from_host(built_index, device="cpu")
    ranks = torch.arange(-1, built_index.seq_len + 1)
    n0 = cuda_lib.LAUNCHES["sa_walk"]
    profiling.take()
    with profiling.tracing():
        pos = sa_lookup(fm.to(cuda), ranks.to(cuda))
    assert not any(k.startswith("locate.")
                   for k in profiling.take().counters)
    assert cuda_lib.LAUNCHES["sa_walk"] == n0
    assert torch.equal(pos.cpu(), sa_lookup(fm, ranks))


def test_loaded_index_gpu_equals_cpu(cuda, genome, loaded_index):
    """512 reads aligned on a loaded index: SAM bytes on the card == on
    the CPU."""
    corpus = simulate_reads(genome, 512, seed=15)
    seqs, names = [s for _, s in corpus], [n for n, _ in corpus]
    cuda_lib.reset_launches()
    g = BWAAligner(loaded_index, device=cuda).align_batch_bam(seqs, names,
                                                              sam=True)
    assert all(cuda_lib.LAUNCHES[k] > 0 for k in cuda_lib.MAIN_PATH)
    assert cuda_lib.LAUNCHES["sa_walk"] > 0
    c = BWAAligner(loaded_index, device="cpu").align_batch_bam(seqs, names,
                                                               sam=True)
    assert g[0] == c[0]
    assert np.array_equal(g[1], c[1])


def test_aligner_gpu_equals_cpu(cuda, genome):
    corpus = simulate_reads(genome, 200, seed=5)
    idx = FMIndex.construct([("rep1", genome)])
    seqs, names = [s for _, s in corpus], [n for n, _ in corpus]
    cuda_lib.reset_launches()
    g = BWAAligner(idx, device=cuda).align_batch_bam(seqs, names, sam=True)
    assert all(cuda_lib.LAUNCHES[k] > 0 for k in cuda_lib.MAIN_PATH)
    c = BWAAligner(idx, device="cpu").align_batch_bam(seqs, names, sam=True)
    assert g[0] == c[0]
    assert np.array_equal(g[1], c[1])


@pytest.mark.parametrize("kernel,variant,Lt,zdrop", [
    ("K3", "", 60, 0), ("K3", "", 250, 100), ("K3", "", 1000, 100),
    ("K4", "", 60, 0), ("K4", "", 250, 100), ("K4", "", 700, 0),
    ("K5", "nch=2", 250, 100), ("K5", "nch=3", 60, 100)]
    # the stop-row lanes (bench_sw.rect_stop_inputs: stops on rows 0, 1,
    # P - 2 .. P and 2P of each pipeline depth and on the last row, ties,
    # empty and oversized lanes), 64 lanes, or 61 (not a multiple of nch)
    + [("K3", "|stop", Lt, zd) for Lt in STOP_WIDTHS
       for zd in (0,) + STOP_ZDROPS + (100,)]
    + [("K4", "|stop", Lt, zd) for Lt in STOP_WIDTHS
       for zd in (0,) + STOP_ZDROPS + (100,)]
    + [("K5", f"nch={n}|stop", Lt, zd) for n in (2, 3) for Lt in STOP_WIDTHS
       for zd in STOP_ZDROPS + (100,)]
    + [("K5", f"nch={n}|stop61", 250, 100) for n in (2, 3)])
def test_rect_kernels_equal_plain(cuda, kernel, variant, Lt, zdrop):
    k = RECT_KERNELS[kernel]
    variant, _, inputs = variant.partition("|")
    if inputs:
        args = rect_stop_inputs(cuda, M=int(inputs[4:] or 64), Lt=Lt)
    else:
        args = _lanes(Lt + zdrop, 300, min(150, Lt), Lt, cuda)
    n0 = cuda_lib.LAUNCHES[k.counter]
    got = k.fns[variant](*args, zdrop=zdrop)
    assert cuda_lib.LAUNCHES[k.counter] == n0 + 1
    want = extend_rect(*args, zdrop=zdrop)
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k


def _extreme_lanes(dev, M, Lq, Lt, match, h0_room, seed):
    """Random lanes (codes 0-4) and, every other lane, near-identical
    ones, whose h0 is set so that h0 + match * min(qlen, tlen) = 32767 +
    h0_room (h0 >= 0): scores at and past the int16 range."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (M, Lq)).astype(np.int8)
    t = rng.integers(0, 5, (M, Lt)).astype(np.int8)
    ql = rng.integers(0, Lq + 1, M).astype(np.int32)
    tl = rng.integers(0, Lt + 1, M).astype(np.int32)
    for m in range(0, M, 2):
        n = min(int(ql[m]), Lt)
        t[m, :n] = q[m, :n]
        tl[m] = max(int(tl[m]), n)
        for p in rng.integers(0, max(n, 1), 2):
            t[m, p] = (t[m, p] + 1) % 4
    g = match * np.minimum(ql, tl)
    h0 = np.maximum(32767 + h0_room - g, 0).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (q, ql, t, tl, h0)]


# (label, M, Lq, Lt, scoring, the h0 rooms of the batch's two halves)
EXTREME_CASES = [
    # best scores at 32767 in one half, one past it in the other
    ("h0 edge", 512, 150, 250, {}, (0, 1)),
    ("large match", 512, 150, 250, dict(match=110), (-20000, -20000)),
    ("large penalties", 512, 150, 250,
     dict(o_del=40, e_del=20, o_ins=40, e_ins=20, mismatch=10),
     (-30000, 1)),
    # the largest shape check_rect_shape takes
    ("largest shape", 64, 4095, 1023, {}, (0, 1)),
    ("mismatch 1", 256, 150, 250, dict(mismatch=1), (-30000, -30000)),
    # a batch that fills the card (K3's segment depends on M)
    ("full card", 4096, 150, 250, {}, (-32000, -32000)),
]


@pytest.mark.parametrize("case", EXTREME_CASES,
                         ids=[c[0] for c in EXTREME_CASES])
def test_k3_extreme_lanes(cuda, case):
    """K3 == extend_rect (tolerance 0) at zdrop 0 and 100 on large
    scores, large match and gap penalties, the largest shape and a batch
    that fills the card; each call launches K3 once."""
    _, M, Lq, Lt, score, rooms = case
    half = M // 2
    a = _extreme_lanes(cuda, half, Lq, Lt, score.get("match", 1), rooms[0],
                       seed=M + Lq)
    b = _extreme_lanes(cuda, M - half, Lq, Lt, score.get("match", 1),
                       rooms[1], seed=M + Lt)
    args = [torch.cat([x, y]) for x, y in zip(a, b)]
    for zdrop in (0, 100):
        n0 = cuda_lib.LAUNCHES["sw_extend_rect"]
        got = sw_cuda.extend_batch_rect(*args, zdrop=zdrop, **score)
        assert cuda_lib.LAUNCHES["sw_extend_rect"] == n0 + 1
        want = extend_rect(*args, zdrop=zdrop, **score)
        for k in KEYS:
            assert torch.equal(got[k], want[k]), (k, zdrop)


def test_overflow_batch_gpu_equals_cpu(cuda):
    """The 1000-read repeat corpus in one batch overflows the DP rows and
    reruns on the classic path on both devices."""
    genome = make_repeat_genome()
    reads = make_repeat_reads(genome)
    idx = FMIndex.construct([("rep1", genome)])
    seqs, names = [s for _, s in reads], [n for n, _ in reads]
    out = {}
    for dev in (cuda, "cpu"):
        aln = BWAAligner(idx, device=dev)
        out[str(dev)] = (aln.align_batch_bam(seqs, names, sam=True),
                         aln.stats["fused_overflow_fallback"])
    (g, gf), (c, cf) = out["cuda"], out["cpu"]
    assert gf == cf == 2
    assert g[0] == c[0]
    assert np.array_equal(g[1], c[1])


@pytest.mark.parametrize("k", [15, 16, 17, 25, 31, 32])
def test_kmer_pipeline_gpu_equals_cpu(cuda, k):
    """ops/kmer on the card == on the CPU: keys and validity, the table,
    lookups, weak flags, and the walk at two min_cov (its tie probe
    takes A, the first maximum, and its N probe gets a base)."""
    out = {}
    for dev in ("cpu", cuda):
        reads, lens = (torch.from_numpy(a).to(dev) for a in kmer_batch())
        can, valid = kmer.canonical_kmers_device(reads, lens, k)
        keys, cnt = kmer.count_kmers_device(can, valid)
        res = [can, valid, keys, cnt,
               kmer.lookup_kmers_device(keys, cnt, can)]
        res += [kmer.weak_reads_device(reads, lens, keys, cnt, k, m)
                for m in (2, 3)]
        g, rr, rl, n_plain = kmer_region_reads()
        rr, rl = torch.from_numpy(rr).to(dev), torch.from_numpy(rl).to(dev)
        rk, rc = kmer.count_kmers_device(
            *kmer.canonical_kmers_device(rr, rl, k))
        for m in (4, 13):
            res += kmer.correct_reads_device(rr, rl, rk, rc, k, m)
        out[str(dev)] = [x.cpu() for x in res]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)
    codes = out["cuda"][7]
    assert int(codes[n_plain, 50]) == 0
    assert int(codes[n_plain + 1, 60]) == int(g[2060])


def test_assembly_gpu_equals_cpu(cuda):
    """BFC and FermiAssembler on the card == on the CPU: corrected reads,
    table, contigs and GFA text."""
    rng = np.random.default_rng(2024)
    region = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 4000)] \
        .tobytes().decode()
    r1, r2 = simulate_pairs([("r", region)], 550, read_len=150,
                            error_rate=0.005, seed=3)
    out = {}
    for dev in (cuda, "cpu"):
        b = BFC(device=dev)
        for u in r1 + r2:
            b.add_sequence(u.seq)
        b.train()
        b.error_correct()
        f = FermiAssembler(device=dev)
        f.add_reads([UnalignedSequence(f"r{i}", s)
                     for i, s in enumerate(b.m_seqs)])
        f.correct_reads()
        assert f._flt_cache[1][0].device.type == torch.device(dev).type
        f.perform_assembly()
        gfa = io.StringIO()
        f.write_gfa(gfa)
        out[str(dev)] = (b.m_seqs, b.table.keys.tolist(),
                         b.table.counts.tolist(), b.kcov, f.m_seqs,
                         f.get_contigs(), gfa.getvalue())
    assert out["cuda"] == out["cpu"]
    assert len(out["cuda"][5]) >= 1


def _bam_path(dev, idx, reads, workdir):
    """The bam phase of chip_smoke.py at a small size on one device:
    align_stream_bam -> write_records_bytes -> FastBamReader -> realign
    the primaries -> sort_by_position -> an indexed BamWriter."""
    hdr = idx.header_from_index()
    aln = BWAAligner(idx, device=dev)
    out = os.path.join(workdir, f"{dev}.bam")
    w = BamWriter(BAM)
    w.open(out)
    w.set_header(hdr)
    for _, payload, _ in aln.align_stream_bam(
            iter([UnalignedSequence(n, s) for n, s in reads]),
            batch_size=len(reads)):
        w.write_records_bytes(payload)
    w.close()
    again = [UnalignedSequence(r.qname, r.seq, r.qualities())
             for r in FastBamReader(out) if not r.flag & 0x904]
    payload, _ = aln.align_batch_bam([u.seq for u in again],
                                     [u.name for u in again])
    recs = sort_by_position(iter(functools.partial(
        read_record, io.BytesIO(payload)), None))
    srt = os.path.join(workdir, f"{dev}.sorted.bam")
    w = BamWriter(BAM)
    w.open(srt)
    w.set_header(hdr)
    w.enable_indexing()
    for r in recs:
        w.write_record(r)
    w.close()
    return [open(p, "rb").read() for p in (out, srt, srt + ".bai")], recs, \
        hdr, srt


def test_bam_path_gpu_equals_cpu(cuda, genome, tmp_path):
    """One 1024-read batch on a three-contig reference (500 N at the
    second's start) to an indexed BAM: .bam, sorted .bam and .bai bytes
    on the card == on the CPU; K1 and K2 launched; 20 regions through
    BamReader equal the brute-force answer."""
    ctgs = [("chr1", genome[:90_000]),
            ("chr2", "N" * 500 + genome[90_500:160_000]),
            ("chr3", genome[160_000:])]
    idx = FMIndex.construct(ctgs)
    reads = simulate_reads(genome, 1024, seed=9)
    cuda_lib.reset_launches()
    g, recs, hdr, srt = _bam_path(cuda, idx, reads, str(tmp_path))
    assert all(cuda_lib.LAUNCHES[k] > 0 for k in cuda_lib.MAIN_PATH)
    c, _, _, _ = _bam_path("cpu", idx, reads, str(tmp_path))
    assert g == c
    rng = np.random.default_rng(4)
    rd = BamReader(srt)
    for k in range(20):
        tid = k % 3
        ln = hdr.get_sequence_length(tid)
        p1 = 1 if k == 1 else int(rng.integers(1, ln))
        p2 = min(ln, p1 + int(rng.integers(0, 20_000)))
        rd.set_region(GenomicRegion(tid, p1, p2))
        assert [r.to_sam(hdr) for r in iter(rd.next, None)] == \
            [r.to_sam(hdr) for r in recs if r.tid == tid and r.pos < p2
             and r.position_end() > p1 - 1]

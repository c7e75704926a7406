"""bwa's index files and the sampled-SA locate: the port against the JAX
package.

Four synthetic references (several contigs, N runs, total lengths with
``l_pac % 4`` of 0, 1, 2 and 3) are made from a numpy seed.  Both
packages write bwa's five files for each, which must be byte-equal; a
file set written by either loads in the other to equal arrays; the host
rank, search and locate on a loaded index, and the port's device
``sa_lookup`` (the LF walk to a sample) on the CPU, equal the JAX
package's; and the port aligns on a loaded index exactly as on the
constructed one.  Tolerance: exact equality everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqlib_tpu.index import FMIndex as JaxFMIndex
from seqlib_tpu.index import Lrand48 as JaxLrand48
from seqlib_tpu.ops import fm as jfm
from seqlib_tpu_torch.align import BWAAligner
from seqlib_tpu_torch.core.seq import encode_nt4, revcomp
from seqlib_tpu_torch.index import FMIndex, Lrand48, pack_sequences
from seqlib_tpu_torch.index.bwa_files import (deinterleave_occ,
                                              interleave_occ)
from seqlib_tpu_torch.index.fmindex import occ_layout
from seqlib_tpu_torch import profiling
from seqlib_tpu_torch.ops import fm as tfm
from seqlib_tpu_torch.ops import fm_cuda
from seqlib_tpu_torch.sim import random_bwt_index

EXTS = (".pac", ".ann", ".amb", ".bwt", ".sa")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the suite's workers
    share the cores, and idle pool threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_reference(mod4: int, seed: int) -> list[tuple[str, str]]:
    """Three contigs of random bases with N runs (one at a contig's
    start, one lower-case), l_pac % 4 == mod4."""
    rng = np.random.default_rng(seed)
    lens = [2400 + int(rng.integers(0, 300)) for _ in range(3)]
    lens[-1] += (mod4 - sum(lens)) % 4
    seqs = []
    for k, n in enumerate(lens):
        s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
        for _ in range(2):
            p = int(rng.integers(0, n - 40))
            s[p:p + int(rng.integers(1, 30))] = ord("N")
        if k == 1:
            s[:17] = ord("N")
        s[int(rng.integers(0, n))] = ord("n")
        seqs.append((f"ctg{k}", s.tobytes().decode()))
    assert sum(len(x) for _, x in seqs) % 4 == mod4
    return seqs


@pytest.fixture(scope="module", params=[0, 1, 2, 3],
                ids=lambda m: f"lpac_mod4_{m}")
def ref(request, tmp_path_factory):
    """(seqs, port index, JAX index, directory with both file sets)."""
    seqs = make_reference(request.param, seed=100 + request.param)
    d = tmp_path_factory.mktemp(f"idx{request.param}")
    ti, ji = FMIndex.construct(seqs), JaxFMIndex.construct(seqs)
    ti.write(str(d / "port"))
    ji.write(str(d / "jax"))
    return seqs, ti, ji, d


def _same_arrays(a, b):
    """Every array of two loaded indexes (either package) is equal; the
    JAX package's samples may carry one more (``test_jax_read_sa_*``)."""
    for k in ("bwt", "bwt_words", "cp_counts", "L2"):
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.shape == y.shape and np.array_equal(
            x.astype(np.int64), y.astype(np.int64)), k
    assert (a.primary, a.seq_len, a.sa_intv) == (b.primary, b.seq_len,
                                                  b.sa_intv)
    n = min(a.sa_samples.size, b.sa_samples.size)
    assert n == (a.seq_len + a.sa_intv) // a.sa_intv
    assert np.array_equal(a.sa_samples[:n], b.sa_samples[:n])
    assert np.array_equal(a.ref.codes, b.ref.codes)
    assert a.ref.seed == b.ref.seed
    assert [(x.name, x.offset, x.length, x.n_amb, x.gi, x.anno)
            for x in a.ref.anns] == \
        [(x.name, x.offset, x.length, x.n_amb, x.gi, x.anno)
         for x in b.ref.anns]
    assert [(h.offset, h.length, h.amb) for h in a.ref.holes] == \
        [(h.offset, h.length, h.amb) for h in b.ref.holes]


def test_files_byte_equal(ref):
    _, ti, _, d = ref
    for ext in EXTS:
        assert (d / f"port{ext}").read_bytes() == \
            (d / f"jax{ext}").read_bytes(), ext
    # .pac's tail: an extra 0 byte when l_pac % 4 == 0, then l_pac % 4
    pac = (d / "port.pac").read_bytes()
    tail = (b"\x00" if ti.l_pac % 4 == 0 else b"") + bytes([ti.l_pac % 4])
    assert pac.endswith(tail) and len(pac) == (ti.l_pac + 3) // 4 + len(tail)


def test_files_load_in_either_package(ref):
    _, ti, _, d = ref
    for prefix in ("port", "jax"):
        p = str(d / prefix)
        tl, jl = FMIndex.load(p), JaxFMIndex.load(p)
        assert tl.sa_full is None
        _same_arrays(tl, jl)
        # the loaded samples are the constructed index's full SA by rank
        assert np.array_equal(tl.sa_samples[1:],
                              ti.sa_full[::32][1:].astype(np.uint64))
        assert tl.sa_samples[0] == np.uint64(2**64 - 1)
    _same_arrays(FMIndex.load(str(d / "port")), ti)


def test_load_write_keeps_gi_and_anno(ref, tmp_path):
    """A .ann made by ``bwa index`` carries gi and a description: load ->
    write keeps them in both packages, byte for byte (the JAX package's
    .sa aside: ``test_jax_read_sa_keeps_one_sample_too_many``)."""
    _, _, _, d = ref
    src = tmp_path / "bwa"
    for ext in EXTS:
        src.with_suffix(ext).write_bytes((d / f"port{ext}").read_bytes())
    lines = (d / "port.ann").read_text().splitlines()
    for i in range(1, len(lines), 2):
        gi, name, _ = lines[i].split(" ", 2)
        lines[i] = f"{1000 + i} {name} {name} description, with spaces"
    src.with_suffix(".ann").write_text("\n".join(lines) + "\n")
    tl, jl = FMIndex.load(str(src)), JaxFMIndex.load(str(src))
    assert tl.ref.anns[0].gi == 1001
    assert tl.ref.anns[0].anno == "ctg0 description, with spaces"
    tl.write(str(tmp_path / "t"))
    jl.write(str(tmp_path / "j"))
    for ext in EXTS:
        want = (d / f"port{ext}").read_bytes() if ext != ".ann" \
            else src.with_suffix(".ann").read_bytes()
        assert (tmp_path / f"t{ext}").read_bytes() == want, ext
        if ext != ".sa":
            assert (tmp_path / f"j{ext}").read_bytes() == want, ext


def test_occ_layout_is_the_bwt_file_layout(ref):
    """The device layout (cp_counts, bwt_words) is read off the .bwt
    body: counts equal a direct cumulative count, words unpack to the
    BWT, and the body round-trips."""
    _, ti, _, _ = ref
    bwt = ti.bwt
    cps, words = occ_layout(bwt)
    n = bwt.size
    for c in range(4):
        cum = np.concatenate([[0], np.cumsum(bwt == c)])
        assert np.array_equal(cps[:, c], cum[np.minimum(
            np.arange(cps.shape[0]) * 128, n)])
    codes, cps2 = deinterleave_occ(interleave_occ(bwt), n)
    assert np.array_equal(codes, bwt)
    assert np.array_equal(cps2.astype(np.int64), cps[:-1])
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    unpacked = ((words[:, :, None] >> shifts) & 3).reshape(-1)[:n]
    assert np.array_equal(unpacked, bwt)


def test_host_rank_search_locate_equal_jax(ref):
    seqs, _, _, d = ref
    tl, jl = FMIndex.load(str(d / "port")), JaxFMIndex.load(str(d / "port"))
    rng = np.random.default_rng(3)
    ks = np.concatenate([[0, 1, tl.primary, tl.primary + 1, tl.seq_len],
                         rng.integers(0, tl.seq_len + 1, 300)])
    for c in range(4):
        assert np.array_equal(tl.rank(c, ks), jl.rank(c, ks))
        assert np.array_equal(tl.rank_full(c, ks), jl.rank_full(c, ks))
        l, u = ks[:150], ks[150:300]
        for a, b in zip(tl.backward_ext(l, u, c), jl.backward_ext(l, u, c)):
            assert np.array_equal(a, b)
    text = "".join(s for _, s in seqs).upper()
    pats = []
    for _ in range(40):
        p = int(rng.integers(0, len(text) - 60))
        pats.append(text[p:p + int(rng.integers(8, 60))])
    pats += ["ACGT" * 12, "TTTTTTTTTTTTTTTTTTTTTGGGGGGGGGGGG", "ACGNACGT",
             text[100:130] + "N"]
    found = 0
    for pat in pats:
        codes = encode_nt4(pat)
        got = tl.search(codes)
        assert got == jl.search(codes), pat
        if got[1] > got[0]:
            found += 1
            assert np.array_equal(tl.locate(*got), jl.locate(*got))
        if "N" in pat:
            assert got == (0, 0)
    assert found >= 30
    ranks = [tl.primary, 32, 64, tl.seq_len] + list(
        rng.integers(1, tl.seq_len + 1, 200))
    assert [tl.sa_lookup(int(r)) for r in ranks] == \
        [jl.sa_lookup(int(r)) for r in ranks]


def _walk_ranks(idx, seed: int, n: int) -> np.ndarray:
    """Ranks -1, 0, primary, samples, the last rank and n random ones,
    as a [2, m, 7] grid."""
    rng = np.random.default_rng(seed)
    fixed = [-1, 0, idx.primary, 32, 64, 32 * (idx.seq_len // 32),
             idx.seq_len]
    return np.concatenate([fixed, rng.integers(-1, idx.seq_len + 1, n)]
                          ).reshape(2, -1, 7)


def test_device_sa_lookup_walk_equals_gather(ref):
    """``ops.fm.sa_lookup`` on a loaded index (the LF walk, CPU) equals
    the full-SA gather of the constructed index."""
    _, ti, _, d = ref
    tl = FMIndex.load(str(d / "port"))
    fl = tfm.DeviceFMIndex.from_host(tl, device="cpu")
    fc = tfm.DeviceFMIndex.from_host(ti, device="cpu")
    assert (fl.sa_intv, fc.sa_intv) == (32, 1)
    assert fl.sa.numel() == (tl.seq_len + 32) // 32
    ranks = _walk_ranks(tl, 9, 4011)
    pos, steps = tfm.sa_lookup(fl, torch.from_numpy(ranks),
                               return_steps=True)
    assert pos.shape == ranks.shape
    assert torch.equal(pos, tfm.sa_lookup(fc, torch.from_numpy(ranks)))
    assert int(steps.max()) > 32 and int(steps[ranks < 0].max()) == 0


def test_device_sa_lookup_walk_equals_jax(tmp_path):
    """The port's walk equals the JAX package's jitted ``sa_lookup`` on
    the same loaded files and ranks; ``bwt_char`` equals the JAX
    package's and the host BWT."""
    seqs = make_reference(2, seed=102)
    FMIndex.construct(seqs).write(str(tmp_path / "ref"))
    tl, jl = (F.load(str(tmp_path / "ref")) for F in (FMIndex, JaxFMIndex))
    fl, jf = (tfm.DeviceFMIndex.from_host(tl, device="cpu"),
              jfm.DeviceFMIndex.from_host(jl))
    ranks = _walk_ranks(tl, 10, 4011)
    pos = tfm.sa_lookup(fl, torch.from_numpy(ranks))
    want = jfm.sa_lookup(jf, jnp.asarray(ranks.astype(np.int32)))
    assert np.array_equal(pos.numpy(), np.asarray(want).astype(np.int64))
    p = np.arange(tl.seq_len)
    got = tfm.bwt_char(fl, torch.from_numpy(p)).numpy()
    assert np.array_equal(got, tl.bwt)
    assert np.array_equal(got, np.asarray(jfm.bwt_char(jf, jnp.asarray(
        p.astype(np.int32)))))


def _fake_indexes(n: int, seed: int):
    """A JAX and a port device index over ``sim.random_bwt_index``."""
    tf = tfm.DeviceFMIndex.from_host(random_bwt_index(n, seed), device="cpu")
    jf = jfm.DeviceFMIndex(
        blocks=jnp.asarray(tf.blocks.numpy().view(np.uint32)),
        sa_samples=jnp.asarray(tf.sa.numpy().astype(np.int32)),
        L2=jnp.asarray(np.asarray(tf.L2_host, np.int32)),
        primary=jnp.asarray(np.int32(tf.primary)), seq_len=n, sa_intv=32,
        l_pac=n // 2)
    return jf, tf


def test_device_sa_lookup_walk_cap_equals_jax(monkeypatch):
    """Lanes still walking at the cap (64 x sa_intv = 2048 steps) get
    ``sa[r // sa_intv] + steps`` as in the JAX package's walk; the
    check interval (5 here, not a divisor of 2048) changes nothing."""
    jf, tf = _fake_indexes(2000, seed=1)
    ranks = np.arange(-1, 2001)
    monkeypatch.setattr(tfm, "WALK_CHECK", 5)
    pos, steps = tfm.sa_lookup(tf, torch.from_numpy(ranks),
                               return_steps=True)
    want = np.asarray(jfm.sa_lookup(jf, jnp.asarray(ranks.astype(np.int32))))
    assert int((steps == 2048).sum()) > 0
    assert np.array_equal(pos.numpy(), want.astype(np.int64))


def _walk_counters(fm, ranks: np.ndarray) -> dict:
    """The plain walk's counters under the tracer, checked against what
    its steps say: ``locate.lanes`` the valid ranks, ``locate.lane_steps``
    their steps' sum, ``locate.capped`` the lanes that walked the cap's
    64 x sa_intv steps; no kernel launch counted; positions and steps
    equal with the tracer off."""
    r = torch.from_numpy(ranks)
    profiling.take()
    off = tfm.sa_lookup(fm, r, return_steps=True)
    with profiling.tracing():
        pos, steps = tfm.sa_lookup(fm, r, return_steps=True)
    c = profiling.take().counters
    assert torch.equal(pos, off[0]) and torch.equal(steps, off[1])
    assert c["locate.lanes"] == int((r >= 0).sum())
    assert c["locate.lane_steps"] == int(steps.sum())
    assert c["locate.capped"] == int((steps == 64 * fm.sa_intv).sum())
    assert c["locate.rounds"] >= -(-int(steps.max()) // tfm.WALK_CHECK)
    assert "locate.walk_launches" not in c
    return c


def test_walk_counters_equal_its_steps(ref):
    """On a loaded index no lane reaches the cap."""
    _, _, _, d = ref
    tl = FMIndex.load(str(d / "port"))
    c = _walk_counters(tfm.DeviceFMIndex.from_host(tl, device="cpu"),
                       _walk_ranks(tl, 11, 4011))
    assert c["locate.lane_steps"] > c["locate.lanes"] > 0
    assert c["locate.capped"] == 0


@pytest.mark.parametrize("check", [8, 5])
def test_walk_counters_equal_its_steps_at_the_cap(check, monkeypatch):
    """Lanes on an LF cycle with no sample walk to the cap and count in
    ``locate.capped``, whatever the check interval."""
    _, tf = _fake_indexes(2000, seed=1)
    monkeypatch.setattr(tfm, "WALK_CHECK", check)
    c = _walk_counters(tf, np.arange(-1, 2001))
    assert c["locate.capped"] > 0


def test_walk_kernel_takes_cuda_tensors_only(ref):
    """The walk kernel's wrapper refuses CPU tensors before it loads or
    builds anything; ``sa_lookup`` routes them to the plain loop."""
    _, _, _, d = ref
    fl = tfm.DeviceFMIndex.from_host(FMIndex.load(str(d / "port")),
                                     device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        fm_cuda.sa_walk_cuda(fl, torch.zeros(3, dtype=torch.int64))


def test_jax_read_sa_keeps_one_sample_too_many(ref):
    """JAX package fault: ``seqlib_tpu/index/bwa_files.py::read_sa``
    allocates ceil(seq_len / sa_intv) + 1 samples where bwa's
    ``bwt_restore_sa`` (and ``construct``) have seq_len // sa_intv + 1;
    when seq_len % sa_intv != 0 its last entry is uninitialised memory,
    and its ``write`` of a loaded index dumps it as one more sample.  The
    port reads exactly the file's samples (no rank reaches that entry,
    so locates agree: see the tests above)."""
    _, ti, _, d = ref
    tl, jl = FMIndex.load(str(d / "port")), JaxFMIndex.load(str(d / "port"))
    assert tl.sa_samples.size == ti.sa_samples.size
    extra = int(tl.seq_len % tl.sa_intv != 0)
    assert jl.sa_samples.size == tl.sa_samples.size + extra
    prefix = str(d / "jax_again")
    jl.write(prefix)
    sa, want = open(prefix + ".sa", "rb").read(), (d / "port.sa").read_bytes()
    assert len(sa) == len(want) + 8 * extra and sa.startswith(want)


def test_header_names_and_pos_to_ref(ref):
    seqs, ti, ji, d = ref
    tl = FMIndex.load(str(d / "port"))
    assert tl.num_sequences() == ti.num_sequences() == 3
    assert [tl.chr_id_to_name(i) for i in range(3)] == [n for n, _ in seqs]
    for bad in (-1, 3):
        msgs = []
        for idx in (tl, ji):
            with pytest.raises(IndexError) as e:
                idx.chr_id_to_name(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    hdr = tl.header_from_index()
    assert hdr.num_sequences() == 3 and hdr.id2name(1) == "ctg1"
    assert hdr.get_sequence_length("ctg2") == len(seqs[2][1])
    assert tl.sam_header_text() == ji.sam_header_text()
    offs = np.cumsum([0] + [len(s) for _, s in seqs])
    for k in range(3):
        for p in (int(offs[k]), int(offs[k + 1]) - 1):
            assert tl.pos_to_ref(p) == ji.pos_to_ref(p) == (k, p - offs[k])


def test_rank_consistency_and_absent_pattern(ref):
    """(hermetic forms of tests/test_index.py) rank at any k equals a
    brute-force count of the BWT; an absent pattern gives an empty
    interval and locates nothing."""
    _, ti, _, d = ref
    tl = FMIndex.load(str(d / "port"))
    ks = np.arange(0, tl.seq_len + 1, 97)
    for c in range(4):
        brute = np.concatenate([[0], np.cumsum(tl.bwt == c)])
        assert np.array_equal(tl.rank(c, ks), brute[ks])
    l, u = tl.search(encode_nt4("ACGT" * 10))
    assert (l, u) == (0, 0) and tl.locate(l, u).size == 0
    # a present pattern on both strands
    text = ti.ref.codes
    pat = "".join("ACGT"[c] for c in text[500:540])
    l, u = tl.search(encode_nt4(pat))
    assert 500 in tl.locate(l, u).tolist()
    l2, u2 = tl.search(encode_nt4(revcomp(pat)))
    assert 500 in [2 * tl.l_pac - h - 40 for h in tl.locate(l2, u2)]


def test_lrand48_and_pack_validation():
    """(hermetic forms of tests/test_index.py) the lrand48 stream, N
    substitution and construct validation, against the JAX package."""
    a, b = Lrand48(11), JaxLrand48(11)
    vals = [a.next() for _ in range(1000)]
    assert vals == [b.next() for _ in range(1000)]
    assert all(0 <= v < 2**31 for v in vals)
    ref = pack_sequences([("c", "ACGTNNACGT")])
    assert ref.codes.size == 10 and ref.codes.max() <= 3
    assert len(ref.holes) == 1 and ref.holes[0].length == 2
    assert ref.anns[0].n_amb == 1
    for bad in ([("", "ACGT")], [("x", "")]):
        with pytest.raises(ValueError):
            pack_sequences(bad)


def test_align_on_loaded_index_equals_constructed(tmp_path):
    """CPU ``align_batch_bam`` (SAM and counts) on a loaded index equals
    the same call on the constructed index: 64 reads of 70 bp over
    three contigs with N runs, one across a contig cut, one across an N
    run, reverse-strand reads among them."""
    rng = np.random.default_rng(21)
    seqs = []
    for k, n in enumerate((5000, 4000, 6000)):
        s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
        s[1000:1040] = ord("N")
        seqs.append((f"chr{k + 1}", s.tobytes().decode()))
    ti = FMIndex.construct(seqs)
    ti.write(str(tmp_path / "ref"))
    tl = FMIndex.load(str(tmp_path / "ref"))
    text = "".join(s for _, s in seqs)
    reads, names = [], []
    starts = [4960, 5000 + 980] + list(rng.integers(0, len(text) - 70, 62))
    for i, p in enumerate(starts):
        r = list(text[p:p + 70].replace("N", "A"))
        for j in rng.integers(0, 70, 2):
            r[j] = "ACGT"[(("ACGT".index(r[j])) + 1) % 4]
        r = "".join(r)
        reads.append(revcomp(r) if i % 3 == 2 else r)
        names.append(f"r{i}_{p}")
    got = BWAAligner(tl, device="cpu").align_batch_bam(reads, names, sam=True)
    want = BWAAligner(ti, device="cpu").align_batch_bam(reads, names,
                                                        sam=True)
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    lines = got[0].decode().splitlines()
    assert sum(1 for ln in lines if ln.split("\t")[2] != "*") >= 60

"""The port's SAM/BAM file I/O against the JAX package's.

The hermetic cases of ``tests/test_io.py`` run on the port (BGZF, BAM
and SAM round trips, BAI region queries, the pooled writer, the native
columnar reader).  Cross-package cases write the same records through
both packages by the same route and compare the ``.bam``, ``.bai``,
SAM and ``.fai`` bytes, read each package's files with the other, and
compare region queries.  Files and FASTA are made in ``tmp_path`` from
seeded generators.  Tolerance: exact.
"""

import io
import os
import random
import sys

import numpy as np
import pytest

import seqlib_tpu.core as jcore
import seqlib_tpu.io as jio
from seqlib_tpu.io import bam as jbam
from seqlib_tpu.io import fast_bam as jfast
from seqlib_tpu_torch import native
from seqlib_tpu_torch.core import GenomicRegion
from seqlib_tpu_torch.io import (BAM, CRAM, SAM, BaiIndex, BamReader,
                                 BamWriter, BgzfReader, BgzfWriter,
                                 PooledBgzfWriter, RefGenome, ThreadPool,
                                 build_faidx, is_bgzf)
from seqlib_tpu_torch.io import bam as tbam
from seqlib_tpu_torch.io.fast_bam import FastBamReader, fetch_region

JAX = dict(core=jcore, io=jio, bam=jbam, fast=jfast)
PORT = dict(core=sys.modules["seqlib_tpu_torch.core"],
            io=sys.modules["seqlib_tpu_torch.io"], bam=tbam,
            fast=sys.modules["seqlib_tpu_torch.io.fast_bam"])


def _make_records(n=500, seed=3, pkg=PORT):
    """tests/test_io.py's records, in either package's classes."""
    core = pkg["core"]
    rng = random.Random(seed)
    hdr = core.BamHeader([("c1", 100000), ("c2", 100000)])
    recs = []
    for i in range(n):
        r = core.BamRecord()
        r.qname = f"read{i:05d}"
        r.tid = rng.randint(0, 1)
        r.pos = rng.randint(0, 99000)
        r.mapq = rng.randint(0, 60)
        r.flag = rng.choice([0, 16, 99, 147, 83, 163, 2048, 1024])
        L = rng.randint(50, 100)
        r.seq = "".join(rng.choice("ACGTN") for _ in range(L))
        r.qual = np.array([rng.randint(0, 41) for _ in range(L)],
                          dtype=np.uint8)
        s = rng.randint(0, 10)
        m = L - s
        r.cigar = core.Cigar(f"{s}S{m}M") if s else core.Cigar(f"{m}M")
        r.mtid = r.tid
        r.mpos = min(r.pos + 200, 99999)
        r.isize = 300
        r.add_int_tag("NM", rng.randint(0, 5))
        r.add_z_tag("RG", "RG1")
        recs.append(r)
    recs.sort(key=lambda r: (r.tid, r.pos))
    return hdr, recs


def _write(path, hdr, recs, pkg=PORT, index=False, fmt=None):
    w = pkg["io"].BamWriter(fmt)
    w.open(str(path))
    w.set_header(hdr)
    w.write_header()
    if index:
        w.enable_indexing()
    for r in recs:
        w.write_record(r)
    w.close()
    return str(path)


def _sam(recs, hdr):
    return [r.to_sam(hdr) for r in recs]


# -- BGZF ---------------------------------------------------------------------

def test_bgzf_roundtrip(tmp_path):
    path = str(tmp_path / "t.bgzf")
    data = bytes(random.Random(7).randbytes(300_000))
    w = BgzfWriter(path)
    for i in range(0, len(data), 1000):
        w.write(data[i:i + 1000])
    w.close()
    assert is_bgzf(path)
    r = BgzfReader(path)
    assert r.read(len(data) + 10) == data
    r.close()


def test_bgzf_virtual_seek(tmp_path):
    path = str(tmp_path / "t.bgzf")
    w = BgzfWriter(path)
    offsets = []
    for i in range(50):
        w.flush_block()
        offsets.append(w.tell_virtual())
        w.write(f"chunk{i:04d}".encode() * 100)
    w.close()
    r = BgzfReader(path)
    for i in (30, 3, 49, 0):
        r.seek_virtual(offsets[i])
        assert r.read(9) == f"chunk{i:04d}".encode()
    r.close()


@pytest.mark.parametrize("size", [1000, 4 * 65280 - 1, 4 * 65280 + 77,
                                  1_000_003])
def test_bgzf_bytes_equal_jax(tmp_path, size):
    """write() and write_bulk(): each route's bytes equal the JAX
    package's; the native route (four blocks and more) inflates to the
    same stream as the Python route."""
    data = bytes(random.Random(size).randbytes(size // 2)) * 2
    out = {}
    for name, mod in (("jax", jio), ("port", PORT["io"])):
        for route in ("write", "write_bulk"):
            p = str(tmp_path / f"{name}_{route}.bgzf")
            w = mod.BgzfWriter(p)
            w.write(b"head")
            getattr(w, route)(data)
            w.close()
            out[name, route] = open(p, "rb").read()
            assert BgzfReader(p).read(size + 10) == b"head" + data
    for route in ("write", "write_bulk"):
        assert out["port", route] == out["jax", route]


# -- BAM round trips -----------------------------------------------------------

def test_bam_roundtrip(tmp_path):
    hdr, recs = _make_records()
    path = _write(tmp_path / "t.bam", hdr, recs)
    rd = BamReader()
    assert rd.open(path)
    assert rd.header().num_sequences() == 2
    assert rd.header().id2name(0) == "c1"
    got = list(rd)
    assert _sam(got, hdr) == _sam(recs, hdr)
    for a, b in zip(recs, got):
        assert np.array_equal(a.qual, b.qual)
        assert b.get_int_tag("NM") == a.get_int_tag("NM")
    rd.close()


def test_bam_reset(tmp_path):
    hdr, recs = _make_records(100)
    path = _write(tmp_path / "t.bam", hdr, recs)
    rd = BamReader(path)
    pass1 = sum(1 for _ in iter(rd.next, None))
    rd.reset()
    pass2 = sum(1 for _ in iter(rd.Next, None))
    assert pass1 == pass2 == 100


def test_bam_region_query(tmp_path):
    hdr, recs = _make_records(2000, seed=11)
    path = _write(tmp_path / "t.bam", hdr, recs, index=True)
    assert os.path.exists(path + ".bai")
    rd = BamReader(path)
    assert rd.set_region(GenomicRegion(0, 20001, 40000))
    got = list(iter(rd.next, None))
    expect = [r for r in recs
              if r.tid == 0 and r.position_end() > 20000 and r.pos < 40000]
    assert [r.qname for r in got] == [r.qname for r in expect]
    rd.reset()
    rd.set_regions([GenomicRegion(0, 1, 10000), GenomicRegion(1, 1, 10000)])
    got2 = list(iter(rd.next, None))
    expect2 = [r for t in (0, 1) for r in recs
               if r.tid == t and r.pos < 10000 and r.position_end() > 0]
    assert [r.qname for r in got2] == [r.qname for r in expect2]
    rd.close()


def test_bam_build_index_post_close(tmp_path):
    hdr, recs = _make_records(200)
    path = _write(tmp_path / "t2.bam", hdr, recs)
    w = BamWriter()
    w.open(str(tmp_path / "t3.bam"))
    w.set_header(hdr)
    for r in recs:
        w.write_record(r)
    w.close()
    assert w.build_index()
    rd = BamReader(str(tmp_path / "t3.bam"))
    rd.set_region(GenomicRegion(0, 1, 100000))
    n = sum(1 for _ in iter(rd.next, None))
    assert n == sum(1 for r in recs if r.tid == 0)
    assert open(path, "rb").read() == open(str(tmp_path / "t3.bam"),
                                            "rb").read()


def test_sam_roundtrip(tmp_path):
    hdr, recs = _make_records(50)
    path = _write(tmp_path / "t.sam", hdr, recs)
    got = list(iter(BamReader(path).next, None))
    assert _sam(got, hdr) == _sam(recs, hdr)


def test_reg2bin_spec():
    assert tbam.reg2bin(0, 1) == 4681
    assert tbam.reg2bin(0, 1 << 14) == 4681
    assert tbam.reg2bin(0, (1 << 14) + 1) == 585
    assert 4681 in tbam.reg2bins(0, 100)
    assert 0 in tbam.reg2bins(0, 100)
    rng = random.Random(1)
    for _ in range(300):
        beg = rng.randrange(1 << 29)
        end = beg + 1 + rng.randrange(1 << rng.randrange(1, 29))
        end = min(end, 1 << 29)
        assert tbam.reg2bin(beg, end) == jbam.reg2bin(beg, end)
        assert tbam.reg2bins(beg, end) == jbam.reg2bins(beg, end)


def test_threadpool_pooled_bgzf(tmp_path):
    pool = ThreadPool(4)
    assert pool.is_valid() and pool.IsValid()
    path = str(tmp_path / "pooled.bgzf")
    data = bytes(random.Random(9).randbytes(500_000))
    w = PooledBgzfWriter(path, pool)
    for i in range(0, len(data), 3000):
        w.write(data[i:i + 3000])
    w.close()
    assert BgzfReader(path).read(len(data) + 1) == data
    jp = jio.ThreadPool(2)
    jw = jio.PooledBgzfWriter(str(tmp_path / "j.bgzf"), jp)
    for i in range(0, len(data), 3000):
        jw.write(data[i:i + 3000])
    jw.close()
    assert open(path, "rb").read() == open(str(tmp_path / "j.bgzf"),
                                            "rb").read()
    pool.shutdown()
    jp.shutdown()
    assert not pool.is_valid()
    with pytest.raises(ValueError):
        ThreadPool(0)


# -- robustness ---------------------------------------------------------------

def test_bad_magic_rejected(tmp_path):
    p = tmp_path / "junk.bam"
    p.write_bytes(b"\x00" * 100)
    rd = BamReader()
    assert rd.open(str(p))              # not BGZF: read as SAM text
    with pytest.raises((ValueError, IndexError)):
        rd.next()
    p2 = tmp_path / "raw.bam"
    w = BgzfWriter(str(p2))
    w.write(b"BAX\x01" + b"\x00" * 40)
    w.close()
    assert BamReader().open(str(p2)) is False
    with pytest.raises(IOError):
        BamReader(str(p2))
    assert BamReader().open(str(tmp_path / "absent.bam")) is False


def test_truncated_bam_raises(tmp_path):
    hdr, recs = _make_records(10)
    path = _write(tmp_path / "t.bam", hdr, recs)
    data = open(path, "rb").read()
    trunc = tmp_path / "trunc.bam"
    trunc.write_bytes(data[:len(data) * 2 // 3])
    rd = BamReader()
    got = 0
    with pytest.raises((ValueError, EOFError)):
        assert rd.open(str(trunc))
        for _ in iter(rd.next, None):
            got += 1
    assert got <= 10


# -- the native columnar reader -----------------------------------------------

def test_fast_bam_reader_parity(tmp_path):
    hdr, recs = _make_records(800, seed=44)
    path = _write(tmp_path / "fast.bam", hdr, recs)
    fast = FastBamReader(path)
    assert fast.header.num_sequences() == 2
    got = list(fast)
    fast.close()
    assert _sam(got, hdr) == _sam(recs, hdr)


def test_fast_bam_batch_columnar(tmp_path):
    hdr, recs = _make_records(300, seed=45)
    path = _write(tmp_path / "col.bam", hdr, recs)
    b = FastBamReader(path).read_batch()
    assert len(b) == 300
    assert np.array_equal(b.tid, np.array([r.tid for r in recs]))
    assert np.array_equal(b.pos, np.array([r.pos for r in recs]))
    assert np.array_equal(b.flag, np.array([r.flag for r in recs]))
    assert np.array_equal(b.mapq, np.array([r.mapq for r in recs]))
    blob, starts = b.sequences_nt4()
    for i in (0, 1, 299):
        assert blob[starts[i]:starts[i + 1]].tobytes().decode() == \
            recs[i].seq
        assert b.record(i).to_sam(hdr) == recs[i].to_sam(hdr)


def test_fetch_region_native_parity(tmp_path):
    hdr, recs = _make_records(1500, seed=77)
    path = _write(tmp_path / "reg.bam", hdr, recs, index=True)
    slow = BamReader(path)
    rng = random.Random(5)
    for _ in range(12):
        p = rng.randint(1, 90000)
        slow.reset()
        slow.set_region(GenomicRegion(0, p, p + 5000))
        expect = [(r.qname, r.pos) for r in iter(slow.next, None)]
        b = fetch_region(path, 0, p - 1, p + 5000)
        got = [] if b is None else [(b.record(i).qname, int(b.pos[i]))
                                    for i in range(len(b))]
        assert got == expect, p
    assert fetch_region(path, 1, 0, 10, bai=BaiIndex(2)) is None
    assert fetch_region(str(tmp_path / "no_index.bam"), 0, 0, 10) is None


# -- across the two packages --------------------------------------------------

@pytest.mark.parametrize("index", ["inline", "after_close", "none"])
def test_bam_and_bai_bytes_equal_jax(tmp_path, index):
    """The same records through write_record: equal .bam bytes, and equal
    .bai bytes from the inline index and from build_index."""
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        hdr, recs = _make_records(1200, seed=13, pkg=pkg)
        path = tmp_path / f"{name}.bam"
        w = pkg["io"].BamWriter()
        w.open(str(path))
        w.set_header(hdr)
        if index == "inline":
            w.enable_indexing()
        for r in recs:
            w.write_record(r)
        w.close()
        if index == "after_close":
            assert w.build_index()
        bai = str(path) + ".bai"
        out[name] = (path.read_bytes(),
                     open(bai, "rb").read() if index != "none" else None)
        assert os.path.exists(bai) == (index != "none")
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("n", [40, 2500])
def test_write_records_bytes_equal_jax(tmp_path, n):
    """Serialised records through write_records_bytes (the Python route
    under four blocks, the native one past it): equal bytes, and the
    inflated stream equals write_record's."""
    files = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        hdr, recs = _make_records(n, seed=17, pkg=pkg)
        payload = b"".join(pkg["bam"].encode_record(r) for r in recs)
        path = str(tmp_path / f"{name}.bam")
        w = pkg["io"].BamWriter(pkg["io"].BAM)
        w.open(path)
        w.set_header(hdr)
        w.write_records_bytes(payload)
        w.close()
        files[name] = open(path, "rb").read()
    assert files["port"] == files["jax"]
    hdr, recs = _make_records(n, seed=17)
    ref = _write(tmp_path / "ref.bam", hdr, recs)
    a, b = BgzfReader(ref), BgzfReader(str(tmp_path / "port.bam"))
    assert a.read(1 << 30) == b.read(1 << 30)
    w = BamWriter(BAM)
    w.open(str(tmp_path / "x.bam"))
    w.set_header(hdr)
    w.enable_indexing()
    with pytest.raises(ValueError):
        w.write_records_bytes(b"")
    w.close()
    w = BamWriter(SAM)
    w.open(str(tmp_path / "x.sam"))
    with pytest.raises(ValueError):
        w.write_records_bytes(b"")
    w.close()


def test_sam_bytes_equal_jax(tmp_path):
    for name, pkg in (("jax", JAX), ("port", PORT)):
        hdr, recs = _make_records(300, seed=19, pkg=pkg)
        _write(tmp_path / f"{name}.sam", hdr, recs, pkg=pkg)
    assert (tmp_path / "port.sam").read_bytes() == \
        (tmp_path / "jax.sam").read_bytes()


@pytest.mark.parametrize("fmt", ["bam", "sam"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_files_read_across_packages(tmp_path, fmt, writer, reader):
    """A file one package writes reads back in the other to the SAM
    lines it was written from (BamReader; FastBamReader for BAM)."""
    wp, rp = (JAX, PORT) if writer == "jax" else (PORT, JAX)
    hdr, recs = _make_records(700, seed=23, pkg=wp)
    path = _write(tmp_path / f"x.{fmt}", hdr, recs, pkg=wp, index=True)
    want = _sam(recs, hdr)
    rd = rp["io"].BamReader(path)
    rhdr = rd.header()
    assert _sam(list(iter(rd.next, None)), rhdr) == want
    if fmt == "bam":
        assert _sam(list(rp["fast"].FastBamReader(path)), rhdr) == want
        rd.reset()
        rd.set_region(rp["core"].GenomicRegion(1, 30001, 60000))
        assert _sam(list(iter(rd.next, None)), rhdr) == \
            [r.to_sam(hdr) for r in recs
             if r.tid == 1 and r.pos < 60000 and r.position_end() > 30000]


def test_region_queries_equal_jax(tmp_path):
    """On one indexed file: each package's BamReader region queries and
    fetch_region give the same records."""
    hdr, recs = _make_records(1500, seed=29, pkg=JAX)
    path = _write(tmp_path / "q.bam", hdr, recs, pkg=JAX, index=True)
    jr, tr = jio.BamReader(path), BamReader(path)
    rng = random.Random(31)
    for _ in range(25):
        tid = rng.randrange(2)
        beg = rng.randrange(100000)
        end = beg + 1 + rng.randrange(20000)
        jr.reset()
        tr.reset()
        jr.set_region(jcore.GenomicRegion(tid, beg + 1, end))
        tr.set_region(GenomicRegion(tid, beg + 1, end))
        a = [r.to_sam(hdr) for r in iter(jr.next, None)]
        assert [r.to_sam(hdr) for r in iter(tr.next, None)] == a
        jb, tb = jfast.fetch_region(path, tid, beg, end), \
            fetch_region(path, tid, beg, end)
        assert (jb is None) == (tb is None)
        if tb is not None:
            assert [tb.record(i).to_sam(hdr) for i in range(len(tb))] == \
                [jb.record(i).to_sam(hdr) for i in range(len(jb))]


# -- FASTA index ---------------------------------------------------------------

def _fasta(path, seed=37):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for k, (n, width) in enumerate(((1234, 60), (77, 60), (5000, 80),
                                        (60, 60))):
            s = np.frombuffer(b"ACGTNacgt", np.uint8)[
                rng.integers(0, 9, n)].tobytes().decode()
            fh.write(f">ctg{k} description {k}\n")
            for i in range(0, n, width):
                fh.write(s[i:i + width] + "\n")
    return str(path)


def test_faidx_bytes_equal_jax(tmp_path):
    a = _fasta(tmp_path / "a.fa")
    b = _fasta(tmp_path / "b.fa")
    assert build_faidx(a) == a + ".fai"
    jio.build_faidx(b)
    assert open(a + ".fai", "rb").read() == open(b + ".fai", "rb").read()


def test_refgenome_query_equals_jax(tmp_path):
    path = _fasta(tmp_path / "g.fa")
    rg, jg = RefGenome(path), jio.RefGenome(path)
    assert not rg.is_empty() and rg.names() == jg.names()
    rng = random.Random(41)
    for name in rg.names():
        n = rg.get_sequence_length(name)
        assert n == jg.get_sequence_length(name)
        for _ in range(20):
            p1 = rng.randrange(n)
            p2 = rng.randrange(p1, n)
            assert rg.query_region(name, p1, p2) == \
                jg.query_region(name, p1, p2)
    s = rg.query_region("ctg0", 55, 64)        # across a line end
    assert s == rg.query_region("ctg0", 55, 59) \
        + rg.query_region("ctg0", 60, 64)
    for bad in (("nope", 0, 10), ("ctg0", 50, 10), ("ctg3", 0, 10 ** 9)):
        with pytest.raises(ValueError):
            rg.query_region(*bad)
    assert RefGenome().is_empty()
    assert not RefGenome().load_index(str(tmp_path / "absent.fa"))
    with pytest.raises(RuntimeError):
        RefGenome().query_region("ctg0", 0, 1)


# -- CRAM through BamWriter / BamReader ---------------------------------------

def test_cram_routes_write_and_read_like_jax(tmp_path):
    """The CRAM routes (``BamWriter(CRAM)``, a ``.cram`` path, and
    ``BamReader`` on the file) raise nothing: each writes or reads the
    records, byte-equal to the JAX package's CRAM."""
    hdr, recs = _make_records(60)
    want = _sam(recs, hdr)
    for fmt, name in ((CRAM, "y.bam"), (None, "y.cram")):
        path = _write(tmp_path / name, hdr, recs, fmt=fmt)
        assert not is_bgzf(path)
        jpath = _write(tmp_path / f"j.{name}", *_make_records(60, pkg=JAX),
                       pkg=JAX, fmt=jio.CRAM)
        assert open(path, "rb").read() == open(jpath, "rb").read()
        rd = BamReader()
        assert rd.open(path)
        assert _sam(list(rd), rd.header()) == want
        rd.close()
    assert CRAM == jio.CRAM and BAM == jio.BAM and SAM == jio.SAM


def test_sam_from_stdin_keeps_header(tmp_path, monkeypatch):
    """SAM on stdin: the port keeps the header's references, so records
    get their reference ids; the JAX package drops the header there and
    reads every record with tid -1 (ROADMAP.md section 3)."""
    hdr, recs = _make_records(20, seed=43)
    path = _write(tmp_path / "s.sam", hdr, recs)
    data = open(path, "rb").read()
    got = {}
    for name, mod in (("port", PORT["io"]), ("jax", jio)):
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(
            io.BufferedReader(io.BytesIO(data))))
        rd = mod.BamReader("-")
        got[name] = list(iter(rd.next, None))
    assert _sam(got["port"], hdr) == _sam(recs, hdr)
    assert [r.tid for r in got["jax"]] == [-1] * len(recs)
    assert [r.qname for r in got["jax"]] == [r.qname for r in recs]


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A BAM I/O library that does not build raises with g++'s message;
    nothing falls back to Python."""
    src = tmp_path / "native"
    src.mkdir()
    (src / "bamio.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(native, "_SRC_DIR", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_bamio", None)
    with pytest.raises(RuntimeError, match="libseqlib_torch_bamio.so"):
        native.get_bamio_lib()
    with pytest.raises(RuntimeError, match="error"):
        FastBamReader(str(tmp_path / "any.bam"))
    with pytest.raises(RuntimeError):
        fetch_region(str(tmp_path / "any.bam"), 0, 0, 10)
    w = BgzfWriter(io.BytesIO())
    with pytest.raises(RuntimeError):
        w.write_bulk(b"A" * (5 * 65280))


def test_native_deflate_failure_raises(monkeypatch):
    monkeypatch.setattr(native, "bgzf_deflate_all", lambda *a: None)
    w = BgzfWriter(io.BytesIO())
    with pytest.raises(RuntimeError, match="deflate"):
        w.write_bulk(b"A" * (5 * 65280))


def test_native_wrappers_on_corrupt_input():
    """Data the native code cannot parse gives None (the readers then
    raise ValueError), not an exception from the wrapper."""
    assert native.bgzf_inflate_all(b"\x1f\x8c" + b"\x00" * 40) is None
    good = native.bgzf_deflate_all(b"ACGT" * 1000)
    assert native.bgzf_inflate_all(good).tobytes() == b"ACGT" * 1000
    assert native.bgzf_inflate_all(good[:-3]) is None
    assert native.bgzf_deflate_all(b"") is None

"""The port's CRAM (``seqlib_tpu_torch.io.cram``, ``cram_codecs`` and the
CRAM hooks of ``BamReader`` / ``BamWriter``) against the JAX package's.

* Writer: the same ~300 records (two contigs, the flags of a paired
  library, soft and hard clips, insertions, deletions, ``N`` skips, N
  bases, ``NM`` / ``RG`` / ``AS`` tags, records without qualities,
  unmapped reads and an all-unmapped last container) through both
  packages' ``CramWriter``, 50 records a container: reference-free,
  and reference-based (RR=1) from a dict and from a FASTA path.  The
  bytes are equal, each package reads the other's file to equal
  records, and those equal the records written.
* The hand-built fixtures of ``tests/data/cram/`` decode in the port to
  the JAX package's records; a reference-based file without its
  reference raises ``ValueError`` in both.
* rANS 4x8 and the varints: equal bytes and round trips, a histogram
  whose last symbol's frequency goes non-positive, the fixture's
  order-1 block.
* ``.crai`` and region queries through ``BamReader``: equal entries,
  and 40 regions on the port's CRAM equal the JAX package's on its CRAM
  and the port's own BAM answers.

Inputs come from numpy seeds; tolerance: exact.
"""

import importlib.util
import io
import os

import numpy as np
import pytest

import seqlib_tpu.core as jcore
import seqlib_tpu.io as jio
import seqlib_tpu.io.cram as jcram
import seqlib_tpu.io.cram_codecs as jcodecs
import seqlib_tpu_torch.core as tcore
import seqlib_tpu_torch.io as tio
import seqlib_tpu_torch.io.cram as tcram
import seqlib_tpu_torch.io.cram_codecs as tcodecs
from seqlib_tpu_torch.core import GenomicRegion
from seqlib_tpu_torch.io import BamReader, BamWriter, CRAM, build_faidx

CRAM_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "cram")
PKGS = {"jax": (jcore, jio, jcram), "torch": (tcore, tio, tcram)}
PER_CONTAINER = 50
N_MAPPED = 250
N_UNMAPPED = 50


def _genmod():
    spec = importlib.util.spec_from_file_location(
        "genfix", os.path.join(CRAM_DIR, "gen_interop_fixture.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


def _ref(seed=21):
    rng = np.random.default_rng(seed)
    return {name: "".join("ACGT"[c] for c in rng.integers(0, 4, ln))
            for name, ln in (("c1", 20_000), ("c2", 15_000))}


def _mutate(rng, s):
    """~3% substitutions, ~1% N."""
    out = []
    for b in s:
        u = rng.random()
        out.append("N" if u < 0.01 else
                   "ACGT"[("ACGT".index(b) + int(rng.integers(1, 4))) % 4]
                   if u < 0.04 else b)
    return "".join(out)


def _cigar_and_seq(rng, ref, pos):
    """A CIGAR of one of eight shapes and the read it gives over ref at
    pos: M runs copy the reference with substitutions and N bases; I and
    S bases are random."""
    rnd = lambda n: "".join("ACGT"[c] for c in rng.integers(0, 4, n))
    a, b = int(rng.integers(20, 60)), int(rng.integers(20, 60))
    k = int(rng.integers(1, 8))
    shape = int(rng.integers(0, 8))
    ops = {0: [("M", a + b)], 1: [("S", k), ("M", a + b)],
           2: [("M", a), ("I", k), ("M", b)],
           3: [("M", a), ("D", k), ("M", b)],
           4: [("M", a), ("N", 200 + 10 * k), ("M", b)],
           5: [("S", k), ("M", a), ("D", k), ("M", b), ("S", 3)],
           6: [("H", k), ("M", a + b)],
           7: [("M", a), ("I", k), ("M", b), ("S", k)]}[shape]
    seq, r = [], pos
    for op, ln in ops:
        if op == "M":
            seq.append(_mutate(rng, ref[r:r + ln]))
            r += ln
        elif op in "IS":
            seq.append(rnd(ln))
        elif op in "DN":
            r += ln
    return "".join(f"{ln}{op}" for op, ln in ops), "".join(seq)


def _corpus(pkg, seed=5):
    """(header, records): N_MAPPED coordinate-sorted records on c1/c2
    (two of them unmapped with their mate's place), then N_UNMAPPED
    unmapped ones, which fill the last container."""
    core = PKGS[pkg][0]
    ref = _ref()
    names = list(ref)
    hdr = core.BamHeader([(n, len(ref[n])) for n in names])
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(N_MAPPED):
        tid = int(rng.integers(0, 2))
        pos = int(rng.integers(0, len(ref[names[tid]]) - 800))
        rows.append((tid, pos, i))
    rows.sort()
    recs = []
    for tid, pos, i in rows:
        r = core.BamRecord()
        r.qname = f"r{i:04d}"
        r.tid, r.pos = tid, pos
        r.flag = int(rng.choice([0, 16, 99, 147, 83, 163, 2048, 1024]))
        r.mapq = int(rng.integers(0, 61))
        if i % 97 == 5:
            r.flag, r.mapq = 0x4 | 0x1 | 0x8, 0
            r.seq = _mutate(rng, ref[names[tid]][pos:pos + 70])
        else:
            cig, r.seq = _cigar_and_seq(rng, ref[names[tid]], pos)
            r.cigar = core.Cigar(cig)
        if i % 9:
            r.qual = rng.integers(2, 41, len(r.seq)).astype(np.uint8)
        r.mtid = tid if r.flag & 1 else -1
        r.mpos = pos + 250 if r.flag & 1 else -1
        r.isize = (300 if r.flag & 0x40 else -300) if r.flag & 1 else 0
        if i % 5:
            r.add_int_tag("NM", int(rng.integers(0, 6)))
        if i % 7:
            r.add_z_tag("RG", f"rg{i % 3}")
        r.add_int_tag("AS", int(rng.integers(0, 150)))
        recs.append(r)
    for i in range(N_UNMAPPED):
        r = core.BamRecord()
        r.qname = f"u{i:03d}"
        r.flag = 4
        r.seq = "".join("ACGTN"[c] for c in rng.integers(0, 5, 60))
        if i % 2:
            r.qual = rng.integers(2, 41, 60).astype(np.uint8)
        r.add_z_tag("RG", "rg0")
        recs.append(r)
    return hdr, recs


def _key(r):
    """Every field a CRAM record carries; tags as a dict (CRAM keeps a
    record's tags in its tag line's order)."""
    return (r.qname, r.flag, r.tid, r.pos, r.mapq, str(r.cigar), r.seq,
            None if r.qual is None else r.qual.tolist(), r.mtid, r.mpos,
            r.isize, dict(r.tags))


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    d = tmp_path_factory.mktemp("cram_ref")
    fa = d / "ref.fa"
    with open(fa, "w") as fh:
        for name, s in _ref().items():
            fh.write(f">{name}\n")
            for i in range(0, len(s), 70):
                fh.write(s[i:i + 70] + "\n")
    build_faidx(str(fa))
    return str(fa)


def _cram_bytes(pkg, reference):
    _, io_mod, cram = PKGS[pkg]
    hdr, recs = _corpus(pkg)
    buf = io.BytesIO()
    w = cram.CramWriter(buf, reference=reference)
    w.RECORDS_PER_CONTAINER = PER_CONTAINER
    w.write_header(hdr)
    for r in recs:
        w.write_record(r)
    w.close()
    return buf.getvalue(), w.index_entries


@pytest.mark.parametrize("profile", ["reference_free", "rr1_dict",
                                     "rr1_fasta"])
def test_writer_bytes_equal_and_cross_read(profile, fasta):
    reference = {"reference_free": None, "rr1_dict": _ref(),
                 "rr1_fasta": fasta}[profile]
    port, port_crai = _cram_bytes("torch", reference)
    jax, jax_crai = _cram_bytes("jax", reference)
    assert port == jax
    assert port_crai == jax_crai
    n_cont = -(-(N_MAPPED + N_UNMAPPED) // PER_CONTAINER)
    assert len(port_crai) == n_cont
    assert port_crai[-1][:3] == (-1, 0, 0)       # all-unmapped container
    assert {e[0] for e in port_crai[:-1]} >= {0, 1, -2}
    _, recs = _corpus("torch")
    want = [_key(r) for r in recs]
    for reader in (tcram.CramReader, jcram.CramReader):
        for data in (port, jax):
            got = [_key(r) for r in reader(io.BytesIO(data),
                                           reference=reference)]
            assert got == want


def test_rr1_smaller_than_reference_free():
    assert len(_cram_bytes("torch", _ref())[0]) \
        < len(_cram_bytes("torch", None)[0])


# -- fixtures not written by either package --------------------------------

@pytest.mark.parametrize("name,reference", [
    ("interop_mini.cram", False), ("interop_multi.cram", False),
    ("interop_rr1_embed.cram", False), ("interop_rr1_embed.cram", True),
    ("interop_rr1_ext.cram", True)])
def test_fixture_decodes_as_jax(name, reference):
    ref = None
    if reference:
        seg = _genmod().RR1_SEG
        ref = {"chr1": "N" * 100 + seg + "N" * (1000 - 100 - len(seg))}
    path = os.path.join(CRAM_DIR, name)
    t, j = tcram.CramReader(path, reference=ref), \
        jcram.CramReader(path, reference=ref)
    assert t.header.as_string() == j.header.as_string()
    got, want = [_key(r) for r in t], [_key(r) for r in j]
    assert got == want and len(got) >= 3
    # through BamReader, the reference attached before and after open
    for before in (True, False):
        rd = BamReader()
        if before and ref:
            rd.set_cram_reference(ref)
        assert rd.open(path)
        if not before and ref:
            rd.set_cram_reference(ref)
        assert [_key(r) for r in rd] == want
        rd.close()


def test_missing_reference_raises():
    path = os.path.join(CRAM_DIR, "interop_rr1_ext.cram")
    for reader in (tcram.CramReader, jcram.CramReader):
        with pytest.raises(ValueError, match="reference"):
            list(reader(path))


# -- rANS and varints ---------------------------------------------------------

def _rans_inputs():
    rng = np.random.default_rng(3)
    steal = bytes([0] * 5000 + list(range(1, 256)))
    return {
        "random": rng.integers(0, 256, 3001).astype(np.uint8).tobytes(),
        "skewed": rng.choice([30, 31, 35, 40], 2050,
                             p=[0.7, 0.2, 0.05, 0.05]).astype(
                                 np.uint8).tobytes(),
        "one_symbol": b"\x07" * 777,
        "one_byte": b"A",
        "empty": b"",
        "steal": steal,
        # two symbols tie for the largest frequency: the first one pays
        "steal_tie": bytes([0] * 2500 + [1] * 2500 + list(range(2, 256))),
    }


@pytest.mark.parametrize("case", list(_rans_inputs()))
def test_rans_order0_equal(case):
    data = _rans_inputs()[case]
    enc = tcodecs.rans_encode_o0(data)
    assert enc == jcodecs.rans_encode_o0(data)
    assert tcodecs.rans_decode(enc) == jcodecs.rans_decode(enc) == data


@pytest.mark.parametrize("case", ["steal", "steal_tie"])
def test_rans_normalise_steals_from_the_largest(case):
    hist = [0] * 256
    for b in _rans_inputs()[case]:
        hist[b] += 1
    f = tcodecs._normalise(hist)
    assert f == jcodecs._normalise(hist)
    assert sum(f.values()) == tcodecs.TOTFREQ and f[255] == 1
    raw = {s: max(1, hist[s] * 4096 // sum(hist)) for s in f}
    assert sum(raw.values()) > 4096 and f[0] < raw[0]
    assert f[1] == raw[1] or case == "steal"


def _raw_blocks(path):
    """(method, ctype, content id, compressed bytes) of every block."""
    data = open(path, "rb").read()
    out = []
    fh = io.BytesIO(data)
    fh.seek(26)
    while True:
        ch = tcram.read_container_header(fh)
        if ch is None:
            break
        body = fh.read(ch["length"])
        off = 0
        for _ in range(ch["n_blocks"]):
            method, ctype = body[off], body[off + 1]
            cid, o = tcram.read_itf8(body, off + 2)
            csize, o = tcram.read_itf8(body, o)
            _, o = tcram.read_itf8(body, o)
            out.append((method, ctype, cid, body[o:o + csize]))
            off = o + csize + 4
    return out


def test_rans_order1_fixture_block():
    o1 = [b for m, _, _, b in _raw_blocks(os.path.join(
        CRAM_DIR, "interop_mini.cram")) if m == tcram.RANS and b[0] == 1]
    assert o1
    for blk in o1:
        assert tcodecs.rans_decode(blk) == jcodecs.rans_decode(blk)
    assert tcodecs.rans_decode(o1[0]) == bytes([30] * 8 + [25] * 10
                                               + [20] * 6)
    gen = _genmod()
    data = bytes((i * 7 + (i >> 3)) % 251 for i in range(1003))
    assert tcodecs.rans_decode(gen.rans_o1(data)) == data


ITF8 = [0, 1, 0x7F, 0x80, 0x3FFF, 0x4000, 0x1FFFFF, 0x200000, 0xFFFFFFF,
        0x10000000, 0x7FFFFFFF, 0xFFFFFFFF]
LTF8 = [0, 0x7F, 0x80] + [v for k in range(2, 10)
                          for v in ((1 << (7 * k)) - 1, 1 << (7 * k))
                          if v < 1 << 64] + [(1 << 64) - 1]


def test_varints_equal_and_round_trip():
    for v in ITF8 + [-1, -2]:
        b = tcram.write_itf8(v)
        assert b == jcram.write_itf8(v)
        assert tcram.read_itf8(b + b"\xff", 0) == (v & 0xFFFFFFFF, len(b))
    for v in LTF8:
        b = tcram.write_ltf8(v)
        assert b == jcram.write_ltf8(v)
        assert tcram.read_ltf8(b + b"\xff", 0) == (v, len(b))
    bits = tcodecs.BitWriter()
    for v, n in ((5, 3), (0, 1), (1023, 10), (1, 1)):
        bits.write(v, n)
    jbits = jcodecs.BitWriter()
    for v, n in ((5, 3), (0, 1), (1023, 10), (1, 1)):
        jbits.write(v, n)
    assert bits.getvalue() == jbits.getvalue()
    rd = tcodecs.BitReader(bits.getvalue())
    assert [rd.read(n) for n in (3, 1, 10, 1)] == [5, 0, 1023, 1]


# -- .crai and region queries through BamReader -----------------------------

def _write_file(pkg, path, fmt, reference=None, monkeypatch=None):
    _, io_mod, cram = PKGS[pkg]
    hdr, recs = _corpus(pkg)
    monkeypatch.setattr(cram.CramWriter, "RECORDS_PER_CONTAINER",
                        PER_CONTAINER)
    w = io_mod.BamWriter(fmt)
    if reference is not None:
        w.set_cram_reference(reference)
    assert w.open(str(path))
    w.set_header(hdr)
    w.write_header()
    for r in recs:
        w.write_record(r)
    w.close()
    assert w.build_index()
    return str(path)


def _regions(n=40, seed=9):
    rng = np.random.default_rng(seed)
    out = [(0, 1, 300), (1, 14_900, 15_000), (0, 19_990, 20_000),
           (1, 1, 15_000)]
    while len(out) < n:
        tid = int(rng.integers(0, 2))
        p1 = int(rng.integers(1, 19_000))
        out.append((tid, p1, p1 + int(rng.integers(0, 3_000))))
    return out


def _query(reader_cls, gr_cls, path, regions, reference=None, one=True):
    rd = reader_cls()
    if reference is not None:
        rd.set_cram_reference(reference)
    assert rd.open(path)
    out = []
    if one:
        for tid, p1, p2 in regions:
            assert rd.set_region(gr_cls(tid, p1, p2))
            out.append([_key(r) for r in rd])
    else:
        assert rd.set_regions([gr_cls(*g) for g in regions])
        out = [_key(r) for r in rd]
    rd.close()
    return out


def test_crai_and_regions_equal_jax_and_bam(tmp_path, fasta, monkeypatch):
    port = _write_file("torch", tmp_path / "t.cram", CRAM, fasta, monkeypatch)
    jax = _write_file("jax", tmp_path / "j.cram", jio.CRAM, fasta,
                      monkeypatch)
    bam = _write_file("torch", tmp_path / "t.bam", None, None, monkeypatch)
    assert open(port, "rb").read() == open(jax, "rb").read()
    entries = tcram.read_crai(port + ".crai")
    assert entries == jcram.read_crai(jax + ".crai") \
        == tcram.read_crai(jax + ".crai")
    copy = str(tmp_path / "copy.crai")
    tcram.write_crai(copy, entries)
    assert jcram.read_crai(copy) == entries
    regions = _regions()
    got = _query(BamReader, GenomicRegion, port, regions, fasta)
    assert got == _query(jio.BamReader, jcore.GenomicRegion, jax, regions,
                         fasta)
    assert got == _query(BamReader, GenomicRegion, bam, regions)
    assert sum(map(len, got)) > 100 and [] in got
    # several regions in one call advance from one to the next
    many = _query(BamReader, GenomicRegion, port, regions[4:12], fasta,
                  one=False)
    assert many == [k for g in got[4:12] for k in g]


def test_bamreader_cram_reset_and_refusals(tmp_path, fasta, monkeypatch):
    path = _write_file("torch", tmp_path / "x.cram", CRAM, None, monkeypatch)
    rd = BamReader(path)
    assert rd.header().as_string() == _corpus("torch")[0].as_string()
    assert rd.set_region(GenomicRegion(0, 1, 2_000))
    n_region = sum(1 for _ in rd)
    rd.reset()
    assert sum(1 for _ in rd) == N_MAPPED + N_UNMAPPED > n_region > 0
    rd.close()
    os.remove(path + ".crai")
    rd = BamReader(path)
    assert not rd.set_region(GenomicRegion(0, 1, 2_000))
    w = BamWriter()
    assert w.open(str(tmp_path / "y.cram")) and w.is_open()
    w.close()
    assert w.build_index() and os.path.exists(tmp_path / "y.cram.crai")
    assert tcram.read_crai(str(tmp_path / "y.cram.crai")) == []
    r = tcram.CramReader(io.BytesIO(open(path, "rb").read()))
    assert not r.set_regions([GenomicRegion(0, 1, 10)])
    with pytest.raises(ValueError, match="CRAM 3.0"):
        tcram.CramReader(io.BytesIO(b"BAM\x01" + b"\x00" * 40))

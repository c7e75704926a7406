"""The port's record model against the JAX package's.

* Signatures: every public name of ``seqlib_tpu.core`` and of
  ``seqlib_tpu.io``, every public method and attribute of
  ``BamRecord``, ``GenomicRegion``, ``BamHeader`` and ``Cigar``, and the
  public names each I/O, interval, filter, statistics and plot module
  defines (and its classes' members), exist in the port.
* The cases of ``tests/test_core.py``, run on each package.
* A table: every ``BamRecord`` accessor on 50 records (40 lines of
  ``tests/golden/sam_repeat_1k.txt``, 10 made by hand) returns in the
  port what it returns in the JAX package, and every setter leaves the
  same SAM line.  Tolerance: exact.
"""

import ast
import inspect
import os
import types

import numpy as np
import pytest

import seqlib_tpu.core as jcore
import seqlib_tpu.core.record as jrecord
import seqlib_tpu.io as jio
import seqlib_tpu.io.sam as jsam
import seqlib_tpu_torch.core as tcore
import seqlib_tpu_torch.core.record as trecord
import seqlib_tpu_torch.io as tio
import seqlib_tpu_torch.io.sam as tsam

HERE = os.path.dirname(os.path.abspath(__file__))
IO_MODULES = ("bam", "bgzf", "bai", "sam", "bam_reader", "bam_writer",
              "threadpool", "refgenome", "fast_bam", "cram", "cram_codecs")
HOST_MODULES = ("intervals.tree", "intervals.collection",
                "filters.ahocorasick", "filters.readfilter",
                "stats.histogram", "stats.bamstats", "stats.coverage",
                "stats.fractions", "plot.seqplot")


def _public(obj):
    return {n for n in dir(obj) if not n.startswith("_")}


# -- signatures ---------------------------------------------------------------

def test_core_exports_match():
    assert set(jcore.__all__) <= set(tcore.__all__)
    for name in jcore.__all__:
        assert hasattr(tcore, name), name


def test_io_exports_match():
    want = set(jio.__all__)
    assert want <= set(tio.__all__)
    for name in want:
        assert hasattr(tio, name), name


@pytest.mark.parametrize("cls", ["BamRecord", "GenomicRegion", "BamHeader",
                                 "Cigar", "CigarField", "HeaderSequence",
                                 "UnalignedSequence"])
def test_class_members_match(cls):
    j, t = getattr(jcore, cls), getattr(tcore, cls)
    missing = _public(j) - _public(t)
    assert not missing, sorted(missing)
    for name in _public(j):
        a, b = getattr(j, name), getattr(t, name)
        if callable(a) and not isinstance(a, type):
            sa, sb = inspect.signature(a), inspect.signature(b)
            assert list(sa.parameters) == list(sb.parameters), name


def _own_names(mod):
    """Public names a module's own top-level statements define (classes,
    functions, assignments), not the names it imports."""
    tree = ast.parse(inspect.getsource(mod))
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in out if not n.startswith("_")}


def test_record_module_names_match():
    missing = {n for n in _own_names(jrecord) if not hasattr(trecord, n)}
    assert not missing, sorted(missing)


def _module_names_match(mod):
    import importlib
    j = importlib.import_module(f"seqlib_tpu.{mod}")
    t = importlib.import_module(f"seqlib_tpu_torch.{mod}")
    own = _own_names(j)
    missing = {n for n in own if not hasattr(t, n)}
    assert not missing, sorted(missing)
    for n in own:
        a = getattr(j, n)
        if isinstance(a, type):
            gone = _public(a) - _public(getattr(t, n))
            assert not gone, (n, sorted(gone))


@pytest.mark.parametrize("mod", IO_MODULES)
def test_io_module_names_match(mod):
    _module_names_match(f"io.{mod}")


@pytest.mark.parametrize("mod", HOST_MODULES)
def test_host_module_names_match(mod):
    _module_names_match(mod)
    pkg = mod.split(".")[0]
    import importlib
    j = importlib.import_module(f"seqlib_tpu.{pkg}")
    t = importlib.import_module(f"seqlib_tpu_torch.{pkg}")
    assert set(j.__all__) == set(t.__all__)


# -- tests/test_core.py on both packages -------------------------------------

@pytest.fixture(params=["jax", "torch"])
def C(request):
    core, rec = (jcore, jrecord) if request.param == "jax" \
        else (tcore, trecord)
    ns = types.SimpleNamespace(**{n: getattr(core, n) for n in core.__all__})
    for n in ("FRORIENTATION", "FFORIENTATION", "UDORIENTATION", "FREVERSE",
              "FMREVERSE", "FPAIRED"):
        setattr(ns, n, getattr(rec, n))
    return ns


def test_cigarfield_prints(C):
    assert repr(C.CigarField("M", 10)) == "10M"
    assert repr(C.CigarField("I", 3)) == "3I"
    assert repr(C.CigarField("D", 7)) == "7D"


def test_cigar_parse(C):
    c = C.Cigar("5M2I3D4S")
    assert [(f.type, f.length) for f in c] == \
        [("M", 5), ("I", 2), ("D", 3), ("S", 4)]


def test_cigar_equality(C):
    a = C.Cigar("10M5I")
    b = C.Cigar()
    b.add(C.CigarField("M", 10))
    b.add(C.CigarField("I", 5))
    assert a == b
    assert not (a == C.Cigar("10M4I"))


def test_cigar_consumed(C):
    assert C.Cigar("5M2I3D4S").num_query_consumed() == 11
    assert C.Cigar("5M2I3D4S").num_reference_consumed() == 8


def test_cigar_invalid(C):
    with pytest.raises(ValueError):
        C.CigarField("Q", 5)
    with pytest.raises(ValueError):
        C.CigarField("M", 0)
    with pytest.raises(ValueError):
        C.Cigar("5M3")


def test_cigar_bam_roundtrip(C):
    c = C.Cigar("5M2I3D4S10H")
    assert C.Cigar.from_bam_encoded(c.to_bam_encoded()) == c
    enc = c.to_bam_encoded()
    assert C.Cigar.from_arrays(enc & 0xF, enc >> 4) == c


def test_region_basic(C):
    g = C.GenomicRegion(0, 100, 200, "+")
    assert g.width() == 101
    assert not g.is_empty()
    assert C.GenomicRegion().is_empty()


def test_region_validation(C):
    with pytest.raises(ValueError):
        C.GenomicRegion(0, 200, 100)
    with pytest.raises(ValueError):
        C.GenomicRegion(0, 100, 200, "x")


def test_region_overlap_codes(C):
    a = C.GenomicRegion(0, 100, 200)
    assert a.get_overlap(C.GenomicRegion(1, 100, 200)) == 0
    assert a.get_overlap(C.GenomicRegion(0, 300, 400)) == 0
    assert a.get_overlap(C.GenomicRegion(0, 150, 250)) == 1
    assert a.get_overlap(C.GenomicRegion(0, 120, 180)) == 2
    assert a.get_overlap(C.GenomicRegion(0, 50, 300)) == 3
    assert a.get_overlap(a) in (2, 3)


def test_region_ordering(C):
    G = C.GenomicRegion
    assert G(0, 1, 10) < G(0, 2, 10)
    assert G(0, 1, 10) < G(1, 1, 10)
    assert G(0, 1, 9) < G(0, 1, 10)
    assert G(0, 1, 10) == G(0, 1, 10, "-")
    assert G(0, 2, 10) > G(0, 1, 10) and G(0, 1, 10) >= G(0, 1, 10)
    assert G(0, 1, 10) <= G(0, 1, 10) and hash(G(0, 1, 10)) == \
        hash(G(0, 1, 10, "+"))


def test_region_pad(C):
    g = C.GenomicRegion(0, 100, 200)
    g.pad(10)
    assert (g.pos1, g.pos2) == (90, 210)
    with pytest.raises(ValueError):
        C.GenomicRegion(0, 100, 110).pad(-100)


def test_region_from_string_with_header(C):
    hdr = C.BamHeader([("chr1", 1000), ("chr2", 2000)])
    g = C.GenomicRegion("chr2:100-200", hdr=hdr)
    assert (g.chr, g.pos1, g.pos2) == (1, 100, 200)
    g2 = C.GenomicRegion("chr1:1,000", hdr=hdr)
    assert (g2.chr, g2.pos1) == (0, 1000)
    g3 = C.GenomicRegion("chr1", hdr=hdr)
    assert (g3.chr, g3.pos1, g3.pos2) == (0, 1, 1000)
    with pytest.raises(ValueError):
        C.GenomicRegion("chrZ:1-2", hdr=hdr)
    with pytest.raises(ValueError):
        C.GenomicRegion("chr1:1-2", hdr=C.BamHeader())
    g4 = C.GenomicRegion("2", "1,000", "2,000", hdr)
    assert (g4.chr, g4.pos1, g4.pos2) == (1, 1000, 2000)
    g5 = C.GenomicRegion("chrX", "5", "9")
    assert (g5.chr, g5.pos1, g5.pos2) == (22, 5, 9)


@pytest.mark.parametrize("reg", ["chr1", "chr1:5", "chr1:1,000-2,000",
                                 "c:d:7-9", "x:0-1", "x:9-3", "a:b"])
def test_parse_region_string(C, reg):
    try:
        got = C.parse_region_string(reg)
    except ValueError:
        got = "ValueError"
    try:
        want = jcore.parse_region_string(reg)
    except ValueError:
        want = "ValueError"
    assert got == want


def test_region_chr_naming(C):
    assert C.GenomicRegion(22, 1, 2).chr_name() == "X"
    assert C.GenomicRegion(23, 1, 2).chr_name() == "Y"
    assert C.GenomicRegion(24, 1, 2).chr_name() == "M"
    assert C.GenomicRegion(0, 1, 2).chr_name() == "1"
    hdr = C.BamHeader([("ctg", 10)])
    assert C.GenomicRegion(0, 1, 2).to_string(hdr) == "ctg:1-2(*)"
    assert C.GenomicRegion(0, 1000, 2000, "+").point_string() == "1:1,000(+)"
    assert repr(C.GenomicRegion(1, 1, 2)) == "2:1-2(*)"


def test_region_distances(C):
    a = C.GenomicRegion(0, 100, 200)
    assert a.distance_between_starts(C.GenomicRegion(0, 150, 160)) == 50
    assert a.distance_between_starts(C.GenomicRegion(1, 150, 160)) == -1
    assert a.distance_between_ends(C.GenomicRegion(0, 100, 300)) == 100


def test_header_from_sequences(C):
    hdr = C.BamHeader([("bcr", 141530), ("abl", 178633)])
    assert hdr.num_sequences() == 2
    assert hdr.name2id("abl") == 1 and hdr.Name2ID("abl") == 1
    assert hdr.name2id("nope") == -1
    assert hdr.id2name(0) == "bcr" and hdr.IDtoName(0) == "bcr"
    assert hdr.get_sequence_length("bcr") == 141530
    assert hdr.get_sequence_length(1) == 178633
    assert hdr.get_sequence_length("nope") == -1
    with pytest.raises(IndexError):
        hdr.id2name(5)


def test_header_from_text_roundtrip(C):
    text = "@HD\tVN:1.4\n@SQ\tSN:c1\tLN:100\n@SQ\tSN:c2\tLN:200\n"
    hdr = C.BamHeader(text)
    assert hdr.num_sequences() == 2
    assert hdr.as_string() == text
    assert C.BamHeader().is_empty()
    assert not hdr.is_empty()


def test_record_manual_construction(C):
    gr = C.GenomicRegion(0, 100, 109, "+")
    r = C.BamRecord("read1", "ACGTACGTAC", gr, C.Cigar("10M"))
    assert r.qname == "read1"
    assert r.sequence() == "ACGTACGTAC"
    assert r.mapq == 60 and r.pos == 100
    assert not r.reverse_flag()
    r2 = C.BamRecord("read2", "acgtacgtac",
                     C.GenomicRegion(0, 100, 109, "-"), "10M")
    assert r2.reverse_flag() and r2.seq == "ACGTACGTAC"


def test_record_manual_construction_validates(C):
    gr = C.GenomicRegion(0, 100, 109, "+")
    with pytest.raises(ValueError):
        C.BamRecord("r", "ACGT", gr, C.Cigar("10M"))
    with pytest.raises(ValueError):
        C.BamRecord("r", "ACGTACGTAC", C.GenomicRegion(0, 100, 105),
                    C.Cigar("10M"))


def test_record_flags(C):
    r = C.BamRecord()
    r.flag = C.FPAIRED | C.FREVERSE
    assert r.paired_flag() and r.reverse_flag()
    assert not r.duplicate_flag()
    assert r.mapped_flag()
    r.set_qc_fail(True)
    assert r.qc_fail_flag()
    r.set_qc_fail(False)
    assert not r.qc_fail_flag()


def test_record_cigar_arithmetic(C):
    r = C.BamRecord()
    r.seq = "A" * 20
    r.cigar = C.Cigar("5S10M2I3S")
    r.pos = 100
    assert r.alignment_position() == 5
    assert r.alignment_end_position() == 17
    assert r.num_soft_clip() == 8
    assert r.num_hard_clip() == 0
    assert r.num_clip() == 8
    assert r.num_match_bases() == 10
    assert r.max_insertion_bases() == 2
    assert r.max_deletion_bases() == 0
    assert r.num_aligned_bases() == 12
    assert r.position_end() == 110


def test_record_pair_orientation(C):
    r = C.BamRecord()
    r.flag = C.FPAIRED | C.FMREVERSE
    r.tid = r.mtid = 0
    r.pos, r.mpos = 100, 300
    r.seq = "A" * 10
    assert r.pair_orientation() == C.FRORIENTATION
    assert r.proper_orientation()
    r.flag = C.FPAIRED
    assert r.pair_orientation() == C.FFORIENTATION
    r.flag = C.FPAIRED | 0x4
    assert r.pair_orientation() == C.UDORIENTATION


def test_record_quality_trim(C):
    r = C.BamRecord()
    r.seq = "ACGTACGTAC"
    r.set_qualities("##IIIIII##", 33)
    assert r.quality_trimmed_sequence(4) == (2, 8)
    r.qual = None
    assert r.quality_trimmed_sequence(4) == (0, -1)


def test_record_tags(C):
    r = C.BamRecord()
    r.add_z_tag("XY", "hello")
    r.add_int_tag("NM", 3)
    assert r.get_z_tag("XY") == "hello"
    assert r.get_int_tag("NM") == 3
    assert r.get_tag("NM") == "3"
    assert r.get_z_tag("ZZ") is None
    r.remove_tag("XY")
    assert r.get_z_tag("XY") is None


def test_record_overlapping_coverage(C):
    a = C.BamRecord()
    a.cigar = C.Cigar("10M")
    a.seq = "A" * 10
    b = C.BamRecord()
    b.cigar = C.Cigar("5S5M")
    b.seq = "A" * 10
    assert a.overlapping_coverage(b) == 5


def test_record_sam_line(C):
    hdr = C.BamHeader([("chr1", 1000)])
    r = C.BamRecord("q1", "ACGTACGTAC", C.GenomicRegion(0, 99, 108, "+"),
                    C.Cigar("10M"))
    r.pos = 99
    f = r.to_sam(hdr).split("\t")
    assert (f[0], f[2], f[3], f[5], f[9]) == \
        ("q1", "chr1", "100", "10M", "ACGTACGTAC")


def test_record_compare_and_sort(C):
    recs = []
    for k, (tid, pos, name) in enumerate([(1, 5, "b"), (0, 9, "a"),
                                          (0, 9, "c"), (0, 2, "d")]):
        r = C.BamRecord()
        r.tid, r.pos, r.qname, r.flag = tid, pos, name, k
        recs.append(r)
    assert [r.qname for r in C.sort_by_position(recs)] == \
        ["d", "a", "c", "b"]
    assert [r.qname for r in C.sort_by_qname(recs)] == ["a", "b", "c", "d"]
    assert recs[1] == recs[2] and recs[3] < recs[1]
    assert hash(recs[1]) != hash(recs[2])
    assert C.BamRecordVector is list and C.UnalignedSequenceVector is list


def test_revcomp(C):
    assert C.revcomp("ACGT") == "ACGT"
    assert C.revcomp("AACG") == "CGTT"
    assert C.revcomp("ACGTN") == "NACGT"


def test_nibbles(C):
    for s in ("", "A", "ACGTN", "=ACMGRSVTWYHKDBN", "acgtx"):
        packed = C.pack_nibbles(s)
        assert packed == jcore.pack_nibbles(s)
        assert C.unpack_nibbles(packed, len(s)) == \
            jcore.unpack_nibbles(packed, len(s))


def test_unaligned_sequence_fastq(C):
    u = C.UnalignedSequence("r1", "ACGT", "IIII")
    assert u.to_fastq() == "@r1\nACGT\n+\nIIII\n"
    assert C.UnalignedSequence("r2", "AC").to_fastq() == "@r2\nAC\n+\nII\n"


def test_append_tag(C):
    r = C.BamRecord()
    r.append_tag("SW", "a")
    assert r.get_z_tag("SW") == "a"
    r.append_tag("SW", "b")
    assert r.get_z_tag("SW") == "axb"


# -- every accessor on 50 records --------------------------------------------

REFS = [("rep1", 1_000_000), ("rep2", 80_000)]

HAND = [
    "p1\t99\trep1\t1001\t60\t5S90M2I3D50M3S\t=\t1301\t450\t"
    + "ACGTTGCA" * 18 + "ACGT\t" + "".join(chr(33 + k % 41) for k in range(148))
    + "\tNM:i:5\tRG:Z:grp1\tXS:f:1.5",
    "p2\t147\trep1\t1301\t37\t10H100M\t=\t1001\t-450\t" + "GATC" * 25
    + "\t*\tAS:i:88\tch:A:x",
    "p3\t83\trep2\t501\t12\t20M1000N20M\trep1\t77\t0\t" + "T" * 40
    + "\t" + "#" * 10 + "I" * 20 + "#" * 10,
    "p4\t163\trep2\t601\t0\t3=1X4=2D5M\trep2\t501\t-140\t" + "ACGTACGTACGTA"
    + "\t*\tsc:i:-3",
    "u1\t4\t*\t0\t0\t*\t*\t0\t0\tNNNACGTNNN\t*",
    "u2\t77\t*\t0\t0\t*\t*\t0\t0\tACGGTA\tIIIIII\tBC:Z:comment text",
    "s1\t2064\trep1\t5001\t9\t60H40M\t*\t0\t0\t" + "C" * 40 + "\t*\tNA:i:2",
    "q1\t1536\trep2\t1\t255\t4M\t*\t0\t0\tACGT\t!!!!\tfl:f:2",
    "e1\t0\trep1\t11\t60\t4M2P4M\t*\t0\t0\tAAAACCCC\t*\tXA:Z:rep2,+5,8M,1;",
    "m1\t137\trep1\t71\t60\t30M\t=\t71\t0\t" + "ACG" * 10 + "\t*\tB0:B:c,1,-2,3",
]


def _lines():
    golden = [l for l in open(os.path.join(HERE, "golden",
                                           "sam_repeat_1k.txt"))
              if not l.startswith("#")]
    picks = golden[::41][:40]
    assert len(picks) == 40
    return [l.rstrip("\n") for l in picks] + HAND


LINES = _lines()


def _norm(v):
    if hasattr(v, "pos1") and hasattr(v, "strand"):
        return ("region", v.chr, v.pos1, v.pos2, v.strand)
    if hasattr(v, "fields") and hasattr(v, "num_query_consumed"):
        return ("cigar", str(v))
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.tolist())
    if isinstance(v, (list, tuple)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _norm(x)) for k, x in v.items()))
    return v


MUTATORS = {"set_qc_fail", "set_pair_mapped_flag", "set_mate_reverse_flag",
            "set_qualities", "set_sequence", "set_qname", "set_cigar",
            "set_position", "set_id", "set_chr_id", "set_chr_id_mate",
            "set_position_mate", "set_map_quality", "add_z_tag",
            "add_int_tag", "add_float_tag", "append_tag", "remove_tag",
            "clear_seq_qual_and_tags"}


def _accessors():
    """Every public method of the JAX BamRecord that changes nothing,
    with the arguments it is called with."""
    calls = []
    for name in sorted(_public(jcore.BamRecord)):
        attr = getattr(jcore.BamRecord, name)
        if name in MUTATORS or not callable(attr):
            continue
        params = list(inspect.signature(attr).parameters.values())[1:]
        if all(p.default is not p.empty for p in params):
            calls.append((name, ()))
    calls += [("chr_name", ("hdr",)), ("to_sam", ("hdr",)),
              ("qualities", (0,)), ("qualities", (64,)),
              ("quality_trimmed_sequence", (10,)),
              ("quality_trimmed_sequence", (30,)),
              ("overlapping_coverage", ("other",))]
    for tag in ("NM", "AS", "XS", "NA", "RG", "XA", "fl", "ch", "sc", "BC",
                "B0", "ZZ"):
        for g in ("get_z_tag", "get_int_tag", "get_float_tag", "get_tag"):
            calls.append((g, (tag,)))
    return calls


ACCESSORS = _accessors()


def _records(pkg):
    core, sam = (jcore, jsam) if pkg == "jax" else (tcore, tsam)
    hdr = core.BamHeader(REFS)
    return hdr, [sam.parse_sam_line(l, hdr) for l in LINES]


def _call(rec, name, args, hdr, other):
    args = tuple(hdr if a == "hdr" else other if a == "other" else a
                 for a in args)
    try:
        return _norm(getattr(rec, name)(*args))
    except Exception as e:          # the same error in both packages
        return ("raises", type(e).__name__)


@pytest.mark.parametrize("name,args", ACCESSORS,
                         ids=[f"{n}{a}" for n, a in ACCESSORS])
def test_accessor_equals_jax(name, args):
    jh, jr = _records("jax")
    th, tr = _records("torch")
    for i, (a, b) in enumerate(zip(jr, tr)):
        j_other, t_other = jr[(i + 1) % len(jr)], tr[(i + 1) % len(tr)]
        assert _call(b, name, args, th, t_other) == \
            _call(a, name, args, jh, j_other), (name, LINES[i][:40])


SETTERS = [
    ("set_qc_fail", (True,)), ("set_qc_fail", (False,)),
    ("set_pair_mapped_flag", (True,)), ("set_mate_reverse_flag", (True,)),
    ("set_sequence", ("acgtn",)), ("set_qname", ("renamed",)),
    ("set_cigar", ("3S2M",)), ("set_position", (77,)), ("set_id", (1,)),
    ("set_chr_id", (0,)), ("set_chr_id_mate", (1,)),
    ("set_position_mate", (9,)), ("set_map_quality", (3,)),
    ("add_z_tag", ("RG", "x")), ("add_int_tag", ("NM", 7)),
    ("add_float_tag", ("XF", 0.25)), ("append_tag", ("RG", "y")),
    ("append_tag", ("XA", "z", ";")), ("remove_tag", ("NM",)),
    ("clear_seq_qual_and_tags", ()), ("set_qualities", ("",)),
]


@pytest.mark.parametrize("name,args", SETTERS,
                         ids=[f"{n}{a}" for n, a in SETTERS])
def test_setter_equals_jax(name, args):
    jh, jr = _records("jax")
    th, tr = _records("torch")
    for a, b in zip(jr, tr):
        ea = _call(a, name, args, jh, None)
        eb = _call(b, name, args, th, None)
        assert eb == ea
        assert b.to_sam(th) == a.to_sam(jh)
        assert repr(b) == repr(a)

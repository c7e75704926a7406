"""The port's interval collections (``seqlib_tpu_torch.intervals``) and
read-filter engine (``seqlib_tpu_torch.filters``) against the JAX
package's.

* ``GRC``: tiling of a header and of one region (with its tail), the
  BED and VCF readers on plain and gzip files, sort, stretch, merge,
  ``shuffle`` under one ``random.seed``, and every overlap query and
  ``count_overlaps_batch`` on 2,000 random intervals; ``IntervalIndex``
  on its own.
* Aho-Corasick: every match on random motifs and texts, and motif files.
* ``ReadFilterCollection``: the decisions on 500 records under eleven
  JSON scripts (flags, ranges and inverted ranges, regions from a string
  and from a BED, mate links, motifs from a file, read group, subsample),
  the counters each rule keeps and the collection's text; the same
  error for a bad script.

The port's outputs equal the JAX package's, as lists (order included).
Inputs come from numpy seeds; tolerance: exact.
"""

import gzip
import json
import random

import numpy as np
import pytest

import seqlib_tpu.core as jcore
import seqlib_tpu.filters as jfilters
import seqlib_tpu.intervals as jintervals
import seqlib_tpu_torch.core as tcore
import seqlib_tpu_torch.filters as tfilters
import seqlib_tpu_torch.intervals as tintervals

PKGS = {"jax": (jcore, jintervals, jfilters),
        "torch": (tcore, tintervals, tfilters)}
CHROMS = (("c1", 50_000), ("c2", 30_000), ("c3", 12_345))


def _both(fn):
    """fn(core, intervals, filters) on each package -> (port, jax)."""
    return fn(*PKGS["torch"]), fn(*PKGS["jax"])


def _hdr(core):
    return core.BamHeader(list(CHROMS))


def _rows(g):
    return [(r.chr, r.pos1, r.pos2, r.strand) for r in g]


def _intervals(n=2000, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        c = int(rng.integers(0, 3))
        p1 = int(rng.integers(0, CHROMS[c][1] - 10))
        w = int(rng.integers(0, 800)) if rng.random() < 0.9 \
            else int(rng.integers(800, 8000))
        out.append((c, p1, min(p1 + w, CHROMS[c][1]),
                    "+-*"[int(rng.integers(0, 3))]))
    return out


def _grc(core, intervals, rows):
    g = intervals.GRC()
    for c, p1, p2, s in rows:
        g.add(core.GenomicRegion(c, p1, p2, s))
    return g


# -- GRC ----------------------------------------------------------------------

@pytest.mark.parametrize("width,ovlp", [(1000, 0), (10_000, 1_000),
                                        (7_777, 333), (60_000, 10)])
def test_tiling_equal(width, ovlp):
    def run(core, intervals, _):
        hdr = _hdr(core)
        whole = _rows(intervals.GRC(width=width, ovlp=ovlp, header=hdr))
        also = _rows(intervals.GRC(hdr, width=width, ovlp=ovlp))
        one = _rows(intervals.GRC(core.GenomicRegion(1, 123, 29_000),
                                  width=width, ovlp=ovlp))
        return whole, also, one
    port, jax = _both(run)
    assert port == jax and port[0] == port[1]
    assert port[2][-1][2] == 29_000            # the region form's tail
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="ovlp"):
            pkg[1].GRC(width=10, ovlp=10, header=_hdr(pkg[0]))


def test_bed_vcf_gzip_readers(tmp_path):
    bed = ("# comment\nc1\t100\t200\nc2 5 5000 name\nshort\t1\n"
           "c9\t1\t10\nc3\tx\t10\ntrack#x\t1\t2\n\nc1\t40000\t40010\n")
    vcf = ("##fileformat=VCFv4.2\n#CHROM\tPOS\n"
           "c1\t1000\t.\tA\tC\nc3\t77\t.\tG\tT\nc4\t5\nc2\t9\n")
    (tmp_path / "a.bed").write_text(bed)
    with gzip.open(tmp_path / "a.bed.gz", "wt") as fh:
        fh.write(bed)
    (tmp_path / "a.vcf").write_text(vcf)
    with gzip.open(tmp_path / "a.vcf.gz", "wt") as fh:
        fh.write(vcf)

    def run(core, intervals, _):
        hdr = _hdr(core)
        out = []
        for name in ("a.bed", "a.bed.gz", "a.vcf", "a.vcf.gz"):
            out.append(_rows(intervals.GRC(str(tmp_path / name),
                                           header=hdr)))
        g = intervals.GRC()
        out.append((g.read_bed(str(tmp_path / "absent.bed"), hdr),
                    g.read_vcf(str(tmp_path / "absent.vcf"), hdr)))
        out.append(_rows(intervals.GRC("c2:1,000-2,000", header=hdr)))
        return out
    port, jax = _both(run)
    assert port == jax
    assert len(port[0]) == 3 and port[0] == port[1] and port[2] == port[3]
    assert port[4] == (False, False)


def test_sort_stretch_merge_shuffle():
    rows = _intervals(300, seed=2)

    def run(core, intervals, _):
        out = []
        g = _grc(core, intervals, rows)
        g.coordinate_sort()
        out.append(_rows(g))
        random.seed(17)
        g.shuffle()
        out.append(_rows(g))
        g.merge_overlapping_intervals()
        out.append(_rows(g))
        out.append((g.total_width(), len(g), g.as_bed_string(_hdr(core))))
        one = _grc(core, intervals, [r for r in rows if r[0] == 1])
        one.sort_and_stretch_right(CHROMS[1][1] + 10)
        out.append(_rows(one))
        one.sort_and_stretch_left(0)
        out.append(_rows(one))
        for call, arg in (("sort_and_stretch_right", 5),
                          ("sort_and_stretch_left", 10 ** 6)):
            with pytest.raises(ValueError):
                getattr(_grc(core, intervals, rows[:20]), call)(arg)
        p = _grc(core, intervals, rows[:50])
        p.pad(25)
        p.concat(_grc(core, intervals, rows[50:60]))
        out.append(_rows(p) + _rows(p.as_genomic_region_vector()))
        return out
    port, jax = _both(run)
    assert port == jax
    assert port[1] != port[0] and sorted(port[1]) == sorted(port[0])


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(4)
    return [(int(c), int(p), int(p + rng.integers(0, 3000)),
             "+-*"[int(rng.integers(0, 3))])
            for c, p in zip(rng.integers(0, 3, 300),
                            rng.integers(0, 30_000, 300))]


def test_overlap_queries_equal(queries):
    rows = _intervals()

    def run(core, intervals, _):
        g = _grc(core, intervals, rows)
        out = [g.count_overlaps(core.GenomicRegion(0, 1, 10))]  # no tree
        with pytest.raises(RuntimeError, match="CreateTreeMap"):
            g.find_overlapped_intervals(core.GenomicRegion(0, 1, 10))
        g.create_tree_map()
        out.append((g.num_tree(), _rows(g)))
        for c, p1, p2, s in queries:
            q = core.GenomicRegion(c, p1, p2, s)
            q2 = core.GenomicRegion(c, p2 - 50, p2 + 700, s)
            out.append((g.count_overlaps(q),
                        g.find_overlapped_intervals(q),
                        g.find_overlapped_intervals(q, False),
                        _rows(g.find_overlaps(q)),
                        _rows(g.find_overlaps(q, False)),
                        g.find_overlap_width(q),
                        g.overlap_same_interval(q, q2)))
        qg = _grc(core, intervals, queries)
        hit, qi, si = qg.find_overlaps(g)
        out.append((_rows(hit), qi, si))
        hit, qi, si = qg.find_overlaps(g, ignore_strand=False)
        out.append((_rows(hit), qi, si))
        out.append(_rows(qg.intersection(g)))
        out.append(_rows(g.intersection(_grc(core, intervals, queries))))
        arr = np.asarray([q[:3] for q in queries])
        out.append(g.count_overlaps_batch(arr[:, 0], arr[:, 1],
                                          arr[:, 2]).tolist())
        return out
    port, jax = _both(run)
    assert port == jax
    counts = [x[0] for x in port[2:2 + len(queries)]]
    assert port[-1] == counts and max(counts) > 3 and min(counts) == 0


def test_interval_index_equal():
    rng = np.random.default_rng(6)
    starts = rng.integers(0, 10_000, 2000)
    ends = starts + rng.integers(0, 500, 2000)
    starts[::50] = 777                           # ties: the stable order
    ids = rng.permutation(2000)
    q1 = rng.integers(0, 10_000, 200)
    q2 = q1 + rng.integers(0, 900, 200)

    def run(_, intervals, __):
        t = intervals.IntervalIndex(starts, ends, ids)
        e = intervals.IntervalIndex([], [])
        out = [len(t), len(e), e.find_overlapping(1, 5).tolist(),
               e.count_overlapping(1, 5)]
        for a, b in zip(q1.tolist(), q2.tolist()):
            out.append((t.find_overlapping(a, b).tolist(),
                        t.find_overlapping_intervals(a, b),
                        t.find_contained(a, b).tolist(),
                        t.count_overlapping(a, b)))
        out.append(t.count_overlapping_batch(q1, q2).tolist())
        return out
    port, jax = _both(run)
    assert port == jax
    assert port[-1] == [x[3] for x in port[4:-1]]
    assert port[-1] == [len(x[0]) for x in port[4:-1]]


# -- Aho-Corasick -------------------------------------------------------------

def test_aho_corasick_equal(tmp_path):
    rng = np.random.default_rng(8)
    motifs = ["".join("ACGT"[c] for c in rng.integers(0, 4, k))
              for k in rng.integers(1, 7, 40)]
    motifs += ["ACGTAC", "ACG", "CG", "GTA", "TTTT", "TT", ""]
    texts = ["".join("ACGT"[c] for c in rng.integers(0, 4, n))
             for n in rng.integers(0, 300, 60)]
    (tmp_path / "m.txt").write_text("\n".join(motifs[:20]) + "\n\n")

    def run(_, __, filters):
        trie = filters.AhoCorasickTrie()
        for m in motifs:
            trie.insert(m)
        aho = filters.AhoCorasick()
        aho.trie_from_file(str(tmp_path / "m.txt"))
        with pytest.raises(RuntimeError, match="Cannot read file"):
            filters.AhoCorasick().trie_from_file(str(tmp_path / "no.txt"))
        return ([trie.parse_text(t) for t in texts], trie.count,
                [aho.query_text(t) for t in texts], aho.count)
    port, jax = _both(run)
    assert port == jax
    brute = [sum(t.count(m) if len(m) == 1 else
                 sum(t.startswith(m, i) for i in range(len(t)))
                 for m in motifs if m) for t in texts]
    assert [len(x) for x in port[0]] == brute


# -- ReadFilterCollection -----------------------------------------------------

def _records(core, n=500, seed=12):
    """Paired, single and unmapped records over CHROMS: clips, indels,
    N bases, NM / RG tags, mates on the same and other chromosomes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = core.BamRecord()
        r.qname = f"q{i:04d}:{int(rng.integers(0, 4))}"
        r.tid = int(rng.integers(0, 3))
        r.pos = int(rng.integers(0, CHROMS[r.tid][1] - 500))
        r.mapq = int(rng.integers(0, 61))
        r.flag = int(rng.choice([0, 16, 4, 99, 147, 83, 163, 97, 145, 65,
                                 129, 113, 177, 1024 | 99, 256 | 16,
                                 2048, 512 | 163, 73, 137]))
        a, b = int(rng.integers(20, 80)), int(rng.integers(0, 60))
        s, k = int(rng.integers(0, 15)), int(rng.integers(1, 6))
        cig = rng.choice([f"{a + b}M", f"{s}S{a + b}M" if s else f"{a}M",
                          f"{a}M{k}I{b + 1}M", f"{a}M{k}D{b + 1}M",
                          f"{k}H{a}M{s + 1}S"])
        r.cigar = core.Cigar(str(cig))
        L = r.cigar.num_query_consumed()
        r.seq = "".join("ACGTN"[c] for c in rng.choice(
            5, L, p=[0.245, 0.245, 0.245, 0.245, 0.02]))
        r.qual = rng.integers(2, 41, L).astype(np.uint8)
        if r.flag & 1:
            r.mtid = r.tid if rng.random() < 0.8 else (r.tid + 1) % 3
            r.mpos = max(0, r.pos + int(rng.integers(-600, 600)))
            r.isize = (r.mpos - r.pos + 100) if r.mtid == r.tid else 0
        if i % 4:
            r.add_int_tag("NM", int(rng.integers(0, 8)))
        if i % 3:
            r.add_z_tag("RG", f"rg{i % 4}")
        out.append(r)
    return out


SCRIPTS = {
    "global_mapq": {"global": {"!anyflag": 1024},
                    "all": {"rules": [{"mapq": [20, 1000]}]}},
    "inverted": {"r": {"rules": [{"mapq": [40, 10]}, {"length": 120},
                                 {"clip": False}]}},
    "named_flags": {"r": {"rules": [{"duplicate": False, "mapped": True,
                                     "fr": True},
                                    {"ic": True}, {"rr": True, "rf": False},
                                    {"mate_mapped": False,
                                     "hardclip": True}]}},
    "masks": {"f": {"rules": [{"allflag": 3, "!anyflag": 256},
                              {"anyflag": 2048}, {"!allflag": 1}]}},
    "regions": {"inc": {"region": "c1:1000-20000", "pad": 100,
                        "rules": [{"clip": [5, 1000]}, {"mapq": [50, 60]}]},
                "exc": {"region": "c1:3000-9000", "exclude": True},
                "wg": {"region": "WG", "rules": [{"isize": [100, 500]}]}},
    "ranges": {"x": {"rules": [{"isize": [100, 500], "nm": [0, 3],
                                "xp": [1, 5]},
                               {"ins": True}, {"del": [2, 10]},
                               {"nbases": [1, 1000]}]}},
    "read_group": {"rg": {"rules": [{"rg": "rg1"}, {"rg": "rg2",
                                                    "mapq": 30}]}},
    "subsample": {"global": {"subsample": 0.3},
                  "s": {"rules": [{}, {"subsample": 0.6}]}},
    "motif": {"m": {"rules": [{"motif": "@MOTIFS@"}]},
              "n": {"region": "c2:1-20000",
                    "rules": [{"!motif": "@MOTIFS@"}]}},
    "bed_matelink": {"b": {"region": "@BED@", "matelink": True,
                           "rules": [{"mapq": [1, 60]}]},
                     "e": {"region": "@BED@", "exclude": True,
                           "rules": [{"dup": True}]}},
    "empty": {},
}


@pytest.fixture(scope="module")
def filter_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("filters")
    rng = np.random.default_rng(3)
    motifs = ["".join("ACGT"[c] for c in rng.integers(0, 4, 5))
              for _ in range(8)]
    (d / "motifs.txt").write_text("\n".join(motifs) + "\n")
    rows = [f"{CHROMS[c][0]}\t{p}\t{p + 2000}\n"
            for c, p in zip(rng.integers(0, 3, 12),
                            rng.integers(0, 10_000, 12))]
    (d / "regions.bed").write_text("# regions\n" + "".join(rows))
    return d


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_read_filter_decisions_equal(name, filter_files):
    text = json.dumps(SCRIPTS[name]) \
        .replace("@MOTIFS@", str(filter_files / "motifs.txt")) \
        .replace("@BED@", str(filter_files / "regions.bed"))
    path = filter_files / f"{name}.json"
    path.write_text(text)

    def run(core, _, filters):
        hdr = _hdr(core)
        recs = _records(core)
        out = []
        for script in (text, str(path)):
            rfc = filters.ReadFilterCollection(script, hdr)
            out.append(([rfc.is_valid(r) for r in recs], repr(rfc),
                         [(rf.m_count, [a.m_count for a in
                                        rf.m_abstract_rules])
                          for rf in rfc.m_regions],
                         _rows(rfc.get_all_regions())))
        return out
    port, jax = _both(run)
    assert port == jax
    assert port[0] == port[1]
    kept = sum(port[0][0])
    assert 0 < kept < 500 or name == "empty"


def test_read_filter_pieces_equal():
    def run(core, _, filters):
        out = [filters.x31_hash(s) for s in ("", "a", "read1", "q" * 50)]
        out += [filters.wang_hash(k) for k in (0, 1, 999, 0xFFFFFFFF)]
        rng = filters.Range()
        out.append((repr(rng), rng.is_valid(-5)))
        for v in ([3, 9], [9, 3], 7, True, False):
            rng = filters.Range()
            rng.parse_json({"k": v}, "k")
            out.append((repr(rng), [rng.is_valid(x) for x in
                                    (0, 1, 3, 5, 9, 10, 2**31 - 1)]))
        with pytest.raises(ValueError, match="range flag"):
            filters.Range().parse_json({"k": "x"}, "k")
        rule = filters.AbstractRule()
        out.append((repr(rule), rule.is_every()))
        rule.parse_json({"rg": "x", "mapq": [1, 5], "subsample": 0.5})
        out.append((repr(rule), rule.id, rule.is_every()))
        rf = filters.ReadFilter()
        rf.add_rule(rule)
        g = PKGS["torch" if core is tcore else "jax"][1].GRC()
        g.add(core.GenomicRegion(0, 1, 100))
        rf.add_regions(g)
        rec = _records(core, 1)[0]
        out.append((repr(rf), rf.is_read_overlapping_region(rec)))
        rfc = filters.ReadFilterCollection()
        rfc.add_read_filter(rf)
        out.append((repr(rfc), rfc.is_valid(rec)))
        return out
    port, jax = _both(run)
    assert port == jax


@pytest.mark.parametrize("bad", ["{not json", "[1, 2]", "3"])
def test_bad_script_same_error(bad):
    msgs = []
    for core, _, filters in (PKGS["torch"], PKGS["jax"]):
        with pytest.raises(ValueError) as e:
            filters.ReadFilterCollection(bad, _hdr(core))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "ERROR: failed to parse JSON script"

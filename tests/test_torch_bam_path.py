"""From the aligner to an indexed ``.bam``, on an index of several
contigs, against the JAX package.

The reference is three contigs cut from one seeded random sequence, with
N runs (a 300 bp run at the start of the second, shorter ones inside);
the 64 reads are 150 bp samples of both strands with substitutions,
reads across the cut between the first two contigs, reads over an N run,
an all-N read and a random one.  The port's CPU ``align_batch_bam``
payload and the JAX package's (one fused call, shared by the module)
go, each through its own package, into

* a sorted, indexed file (``sort_by_position``, ``write_record`` with
  ``enable_indexing``): equal ``.bam`` and ``.bai`` bytes;
* the unsorted payload through ``write_records_bytes``, and a sorted one
  indexed after close by ``build_index``: equal bytes;

and region queries over all three contigs (``BamReader.set_region``,
``fast_bam.fetch_region``) must give each reader's brute-force answer in
both packages.  Tolerance: exact.
"""

import functools
import io
import random

import numpy as np
import pytest
import torch

import seqlib_tpu.core as jcore
import seqlib_tpu.io as jio
from seqlib_tpu.align import BWAAligner as JaxAligner
from seqlib_tpu.index import FMIndex as JaxFMIndex
from seqlib_tpu.io import bam as jbam
from seqlib_tpu.io import fast_bam as jfast
import seqlib_tpu_torch.core as tcore
import seqlib_tpu_torch.io as tio
from seqlib_tpu_torch.align import BWAAligner
from seqlib_tpu_torch.index import FMIndex
from seqlib_tpu_torch.io import bam as tbam
from seqlib_tpu_torch.io import fast_bam as tfast

PKGS = {"jax": (jcore, jio, jbam, jfast), "port": (tcore, tio, tbam, tfast)}
CUT = 30_000                      # chr1 | chr2 in the source sequence


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rc(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGTN", "TGCAN"))


@pytest.fixture(scope="module")
def contigs():
    rng = np.random.default_rng(71)
    src = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 64_000)] \
        .tobytes().decode()
    c1 = src[:CUT]
    c2 = "N" * 300 + src[CUT:48_000]
    c2 = c2[:9_000] + "N" * 50 + c2[9_050:]
    c3 = src[48_000:]
    c3 = c3[:4_000] + "N" * 20 + c3[4_020:12_000] + c3[12_000:13_000].lower() \
        + c3[13_000:]
    return src, [("chr1", c1), ("chr2", c2), ("chr3", c3)]


@pytest.fixture(scope="module")
def reads(contigs):
    src, ctgs = contigs
    rng = np.random.default_rng(73)
    out = []
    for k in range(56):
        name, seq = ctgs[k % 3]
        p = int(rng.integers(0, len(seq) - 150))
        s = list(seq[p:p + 150].upper())
        for q in rng.integers(0, 150, 2):
            if s[q] != "N":
                s[q] = "ACGT"[("ACGT".index(s[q]) + 1) % 4]
        s = "".join(s)
        out.append((f"r{k}_{name}_{p}", _rc(s) if k % 2 else s))
    for k, off in enumerate((120, 75, 30, 140)):        # across chr1 | chr2
        s = src[CUT - off:CUT - off + 150]
        out.append((f"cut{k}_{off}", _rc(s) if k % 2 else s))
    c2 = ctgs[1][1]
    out.append(("overN_chr2", c2[8_950:9_100]))          # over the 50 N run
    out.append(("startN_chr2", c2[250:400]))             # out of the 300 N
    out.append(("allN", "N" * 150))
    out.append(("random", np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, 150)].tobytes().decode()))
    assert len(out) == 64
    return out


@pytest.fixture(scope="module")
def payloads(contigs, reads):
    """(BAM payload, counts) of both packages on the 64 reads: the JAX
    package's from one fused call, the port's on the CPU."""
    _, ctgs = contigs
    ja = JaxAligner(JaxFMIndex.construct(ctgs))
    ti = FMIndex.construct(ctgs)
    seqs, names = [s for _, s in reads], [n for n, _ in reads]
    want = ja.align_batch_bam(seqs, names)
    assert ja.stats["fused_overflow_fallback"] == 0
    got = BWAAligner(ti, device="cpu").align_batch_bam(seqs, names)
    return {"jax": want, "port": got}, ti.header_from_index()


def _decode(payload: bytes, bam) -> list:
    """Serialised records -> BamRecords, through ``bam.read_record``."""
    return list(iter(functools.partial(bam.read_record, io.BytesIO(payload)),
                     None))


def test_payloads_equal_jax(payloads):
    (p, _) = payloads
    assert p["port"][0] == p["jax"][0]
    assert np.array_equal(p["port"][1], p["jax"][1])
    # the all-N and the random read emit no record, in both packages
    assert list(p["port"][1][-2:]) == [0, 0]
    assert int(p["port"][1].sum()) >= 62


@pytest.fixture(scope="module")
def written(payloads, tmp_path_factory):
    """Each package's files, written by its own code."""
    p, hdr_text = payloads
    d = tmp_path_factory.mktemp("bam_path")
    out = {}
    for name, (core, iom, bam, _) in PKGS.items():
        hdr = core.BamHeader(hdr_text.as_string())
        recs = core.sort_by_position(_decode(p[name][0], bam))
        files = dict(sorted=str(d / f"{name}.sorted.bam"),
                     stream=str(d / f"{name}.stream.bam"),
                     after=str(d / f"{name}.after.bam"))
        w = iom.BamWriter(iom.BAM)
        w.open(files["sorted"])
        w.set_header(hdr)
        w.enable_indexing()
        for r in recs:
            w.write_record(r)
        w.close()
        w = iom.BamWriter(iom.BAM)
        w.open(files["stream"])
        w.set_header(hdr)
        w.write_records_bytes(p[name][0])
        w.close()
        w = iom.BamWriter(iom.BAM)
        w.open(files["after"])
        w.set_header(hdr)
        w.write_records_bytes(b"".join(bam.encode_record(r) for r in recs))
        w.close()
        assert w.build_index()
        out[name] = (files, hdr, recs)
    return out


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("kind,ext", [("sorted", ""), ("sorted", ".bai"),
                                      ("stream", ""), ("after", ""),
                                      ("after", ".bai")])
def test_files_equal_jax(written, kind, ext):
    assert _bytes(written["port"][0][kind] + ext) == \
        _bytes(written["jax"][0][kind] + ext)


def test_files_read_back(written, payloads):
    files, hdr, recs = written["port"]
    assert {r.tid for r in recs} == {0, 1, 2}
    want = [r.to_sam(hdr) for r in recs]
    for kind in ("sorted", "after"):
        assert [r.to_sam(hdr) for r in tio.BamReader(files[kind])] == want
        assert [r.to_sam(hdr) for r in tfast.FastBamReader(files[kind])] \
            == want
    stream = [r.to_sam(hdr) for r in _decode(payloads[0]["port"][0], tbam)]
    assert [r.to_sam(hdr) for r in tio.BamReader(files["stream"])] == stream
    assert sorted(stream) == sorted(want)


def _regions(hdr, n=40, seed=79):
    rng = random.Random(seed)
    out = [(1, 1, 400), (1, 8_990, 9_060), (0, CUT - 200, CUT),
           (2, 3_990, 4_030), (2, 1, hdr.get_sequence_length(2))]
    while len(out) < n:
        tid = rng.randrange(3)
        ln = hdr.get_sequence_length(tid)
        beg = rng.randrange(1, ln)
        out.append((tid, beg, min(ln, beg + rng.randrange(1, 6_000))))
    return out


@pytest.mark.parametrize("index", ["sorted", "after"])
def test_region_queries_equal_jax_and_brute_force(written, index):
    """Each package's BamReader (``position_end() > beg``) and
    fetch_region (``pos + max(span, 1) > beg``) on the sorted file, with
    its inline index or the one built after close."""
    files = {name: written[name][0][index] for name in PKGS}
    _, hdr, recs = written["port"]
    for tid, p1, p2 in _regions(hdr):
        beg, end = p1 - 1, p2
        brute = [r.to_sam(hdr) for r in recs if r.tid == tid
                 and r.pos < end and r.position_end() > beg]
        brute_fast = [r.to_sam(hdr) for r in recs if r.tid == tid
                      and r.pos < end and r.pos + max(
                          r.cigar.num_reference_consumed(), 1) > beg]
        for name, (core, iom, _, fast) in PKGS.items():
            rd = iom.BamReader(files[name])
            assert rd.set_region(core.GenomicRegion(tid, p1, p2))
            assert [r.to_sam(hdr) for r in iter(rd.next, None)] == brute, \
                (name, tid, p1, p2)
            b = fast.fetch_region(files[name], tid, beg, end)
            got = [] if b is None else [b.record(i).to_sam(hdr)
                                        for i in range(len(b))]
            assert got == brute_fast, (name, tid, p1, p2)

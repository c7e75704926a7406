"""The port's sharded index, sharded aligner and sharded ``seqtools``
runs against the JAX package's, on the CPU.

The reference is the repeat genome of tests/regen_golden.py cut into
three contigs (N runs at c2's start and inside c3); with
``max_shard_bp`` 80,000 it packs into two shards, c1 and c2 + c3, so
the repeat copies at 20 and 60 kb sit in different shards.  The reads
are 64 of its repeat corpus (every class; IUPAC codes, lower case and
short reads mixed in), paired with 64 more for ``align -2``.

Held exactly: the shard packing, the header, and the manifest and every
shard's index files, byte for byte against the JAX package's; the
sharded aligner's SAM (``align_batch``, ``align_batch_bam``,
``align_stream_bam``) against the JAX package's sharded aligner;
``seqtools index`` past the bound against the JAX CLI; and ``seqtools
align`` / ``align -2`` on a ``.shards`` prefix against what the JAX CLI
writes there, built from the JAX package's records for each end (its
CPU global DP is the costly part: each end runs once).  Against the port's single index, every read's
records agree in the fields the JAX package's sharded test holds (flag,
place, MAPQ, CIGAR, NM, AS), except where its primary is one of several
equal-score hits: the sharded aligner walks regions by global keys,
which order such hits differently, so another of them becomes primary;
such a read must keep the same alignments.  The JAX side runs once per
fixture (its CPU runs are the costly part).
"""

import collections
import contextlib
import copy
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seqlib_tpu.index.sharded as jax_sharded
from regen_golden import make_repeat_genome, make_repeat_reads
from seqlib_tpu import cli as jax_cli
from seqlib_tpu.align import ShardedBWAAligner as JaxShardedAligner
from seqlib_tpu.align import pairing as jpair
from seqlib_tpu.index import ShardedFMIndex as JaxShardedFMIndex
from seqlib_tpu_torch import cli
from seqlib_tpu_torch.align import BWAAligner, ShardedBWAAligner
from seqlib_tpu_torch.core.unaligned import UnalignedSequence
from seqlib_tpu_torch.index import FMIndex, ShardedFMIndex
from seqlib_tpu_torch.index import sharded as port_sharded

SHARD_BP = 80_000
CPU = ["--device", "cpu"]
Read = collections.namedtuple("Read", "name seq")


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
def contigs(genome):
    g = genome
    return [("c1", g[:52_000]), ("c2", "N" * 300 + g[52_300:100_000]),
            ("c3", g[100_000:110_000] + "N" * 150 + g[110_150:])]


@pytest.fixture(scope="module")
def corpus(genome):
    reads = make_repeat_reads(genome)
    picks = [r for c in range(10) for r in reads[100 * c + 20:100 * c + 27]]
    picks = (picks + reads[520:530])[:64]
    out = []
    for k, (name, seq) in enumerate(picks):
        if k % 7 == 2:
            seq = seq[:50] + "RYKM"[k % 4] + seq[51:]
        if k % 11 == 4:
            seq = seq.lower()
        if k % 13 == 7:
            seq = seq[30:130]
        out.append((name, seq))
    return out


@pytest.fixture(scope="module")
def indexes(contigs):
    return (JaxShardedFMIndex.construct(contigs, max_shard_bp=SHARD_BP),
            ShardedFMIndex.construct(contigs, max_shard_bp=SHARD_BP))


def test_construct_packs_in_order(contigs, indexes):
    """Two shards (c1 | c2 + c3), global ids in input order, the single
    index's header; pairs and UnalignedSequences give the same index."""
    js, ts = indexes
    assert ts.n_shards == js.n_shards == 2
    assert ts.first_rid == js.first_rid == [0, 1]
    assert [s.l_pac for s in ts.shards] == [s.l_pac for s in js.shards]
    assert ts.num_sequences() == 3
    assert [ts.chr_id_to_name(i) for i in range(3)] == ["c1", "c2", "c3"]
    single = FMIndex.construct(contigs)
    assert ts.sam_header_text() == single.sam_header_text() \
        == js.sam_header_text()
    assert ts.header_from_index().num_sequences() == 3
    us = ShardedFMIndex.construct(
        [UnalignedSequence(n, s) for n, s in contigs], max_shard_bp=SHARD_BP)
    assert [s.sam_header_text() for s in us.shards] \
        == [s.sam_header_text() for s in ts.shards]
    assert ShardedFMIndex.construct(contigs).n_shards == 1
    assert port_sharded.DEFAULT_MAX_SHARD_BP \
        == jax_sharded.DEFAULT_MAX_SHARD_BP
    with pytest.raises(IndexError):
        ts.chr_id_to_name(3)
    with pytest.raises(ValueError):
        ShardedFMIndex.construct([])


def test_write_load_files_equal_jax(indexes, tmp_path):
    """The .shards manifest and every shard's five files are the JAX
    package's byte for byte; load reads the manifest (or a given
    n_shards) back to the same index, in either package."""
    js, ts = indexes
    ts.write(str(tmp_path / "port"))
    js.write(str(tmp_path / "jax"))
    names = ["port.shards"] + [f"port.shard{k}{e}" for k in range(2)
                               for e in (".bwt", ".sa", ".ann", ".amb",
                                         ".pac")]
    for name in names:
        assert (tmp_path / name).read_bytes() \
            == (tmp_path / name.replace("port", "jax")).read_bytes(), name
    for loaded in (ShardedFMIndex.load(str(tmp_path / "port")),
                   ShardedFMIndex.load(str(tmp_path / "jax"), 2)):
        assert loaded.n_shards == 2 and loaded.first_rid == [0, 1]
        assert loaded.sam_header_text() == ts.sam_header_text()
        assert all(s.sa_full is None for s in loaded.shards)
    assert JaxShardedFMIndex.load(str(tmp_path / "port")).sam_header_text() \
        == ts.sam_header_text()
    (tmp_path / "bad.shards").write_text("{}")
    with pytest.raises(ValueError, match="n_shards"):
        ShardedFMIndex.load(str(tmp_path / "bad"))


@pytest.fixture(scope="module")
def aligners(indexes):
    js, ts = indexes
    return JaxShardedAligner(js), ShardedBWAAligner(ts, devices=["cpu"])


@pytest.fixture(scope="module")
def jax_records(aligners, corpus):
    """The JAX package's sharded aligner on the corpus, once: stage 1 on
    every shard, then its classic finisher (``_finish_batch``: merged
    regions, global DP per shard, records).  For a sharded aligner its
    ``align_batch_bam`` payload is those records serialised in order
    (``_payload_batch`` without columnar hits); the payload here is that
    serialisation."""
    ja = aligners[0]
    enc, lens = ja._encode_batch([s for _, s in corpus])
    s1 = ja._dispatch_stage1(jnp.asarray(enc),
                             jnp.asarray(lens.astype(np.int32)))
    chunk = [Read(n, s) for n, s in corpus]
    recs = [rs for _, rs in
            ja._finish_batch(chunk, enc, lens, s1, False, 0.9, 10)]
    hdr = ja.index.header_from_index()
    sam = [[r.to_sam(hdr) for r in rs] for rs in recs]
    payload = "".join(ln + "\n" for rs in sam for ln in rs).encode()
    return (payload, np.array([len(rs) for rs in recs], np.int32)), sam, recs


def _sam(hdr, recs):
    return [[r.to_sam(hdr) for r in rs] for rs in recs]


@pytest.mark.parametrize("entry", ["align_batch", "align_batch_bam",
                                   "align_stream_bam"])
def test_sharded_aligner_equals_jax(aligners, corpus, jax_records, entry):
    """Each entry point's SAM equals the JAX package's sharded aligner's,
    XA and NA included; some reads have hits in both shards."""
    _, ta = aligners
    want_payload, want_sam, _ = jax_records
    seqs, names = [s for _, s in corpus], [n for n, _ in corpus]
    hdr = ta.index.header_from_index()
    if entry == "align_batch":
        got = _sam(hdr, ta.align_batch(seqs, names))
        assert got == want_sam
        tids = [{ln.split("\t")[2] for ln in rs} for rs in got]
        assert sum({"c1", "c2"} <= t for t in tids) >= 2
    elif entry == "align_batch_bam":
        payload, counts = ta.align_batch_bam(seqs, names, sam=True)
        assert payload == want_payload[0]
        assert np.array_equal(counts, want_payload[1])
    else:
        out = list(ta.align_stream_bam(iter(Read(n, s) for n, s in corpus),
                                       batch_size=64, sam=True))
        assert len(out) == 1 and out[0][1] == want_payload[0]


def _tags(f):
    return tuple(t for t in f[11:] if t[:2] in ("NM", "AS"))


def _hits(recs):
    """(contig, place, strand, CIGAR, NM, AS) of each record."""
    return sorted((f[2], f[3], int(f[1]) & 16, f[5]) + _tags(f)
                  for f in (r.split("\t") for r in recs))


def _fields(recs):
    """The JAX package's sharded-parity fields of each record."""
    return sorted(tuple(f[:6]) + (f[9],) + _tags(f)
                  for f in (r.split("\t") for r in recs))


def test_sharded_equals_single_index(aligners, contigs, corpus):
    """Against the port's single index: the same records in the JAX
    package's sharded-parity fields, but for reads whose primary is one
    of several equal-score hits, which keep the same alignments."""
    _, ta = aligners
    single = BWAAligner(FMIndex.construct(contigs), device="cpu")
    hdr = single.index.header_from_index()
    seqs, names = [s for _, s in corpus], [n for n, _ in corpus]
    got = _sam(hdr, ta.align_batch(seqs, names))
    want = _sam(hdr, single.align_batch(seqs, names))
    moved = 0
    for g, w in zip(got, want):
        if _fields(g) != _fields(w):
            moved += 1
            assert _hits(g) == _hits(w)
            prim = [[f[-1] for f in (r.split("\t") for r in rs)
                     if not int(f[1]) & 0x900] for rs in (g, w)]
            assert prim[0] == prim[1]
    assert moved <= 8 and sum(map(len, got)) > len(corpus)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _write_fastq(path, recs):
    with open(path, "w") as fh:
        for name, seq in recs:
            fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")


@pytest.fixture(scope="module")
def cli_data(indexes, contigs, corpus, genome, tmp_path_factory):
    """ref.fa with the two-shard index written beside it; r.fq (the
    corpus) and its mates, m2.fq (64 more reads of the repeat corpus)."""
    d = tmp_path_factory.mktemp("sharded_cli")
    (d / "ref.fa").write_text("".join(f">{n}\n{s}\n" for n, s in contigs))
    indexes[1].write(str(d / "ref.fa"))
    _write_fastq(d / "r.fq", corpus)
    _write_fastq(d / "m2.fq", make_repeat_reads(genome)[600:664])
    return d


@pytest.fixture(scope="module")
def jax_cli_sam(aligners, cli_data, jax_records):
    """What the JAX CLI writes on the .shards prefix, from the JAX
    package's own records (one run per end): ``align`` writes each
    read's ``align_batch`` records after ``mark_supplementary``; ``align
    -2`` aligns both ends under mate 1's names and, on a sharded index,
    sets flags and mates only (``align_pairs`` with no single 2L text:
    ``mark_supplementary`` and ``pair_up``), pair by pair."""
    ja = aligners[0]
    hdr = ja.index.header_from_index()
    head = ja.index.sam_header_text()
    _, _, recs1 = jax_records
    single = [copy.deepcopy(rs) for rs in recs1]
    for rs in single:
        jpair.mark_supplementary(rs)
    names = [n for n, _ in _read_fastq(cli_data / "r.fq")]
    seqs2 = [s for _, s in _read_fastq(cli_data / "m2.fq")]
    out1 = [copy.deepcopy(rs) for rs in recs1]
    out2 = ja.align_batch(seqs2, names)
    for a, b in zip(out1, out2):
        jpair.mark_supplementary(a)
        jpair.mark_supplementary(b)
        jpair.pair_up(a, b)
    return dict(
        single=head + "".join(r.to_sam(hdr) + "\n" for rs in single
                              for r in rs),
        paired=head + "".join(r.to_sam(hdr) + "\n" for a, b in
                              zip(out1, out2) for r in a + b))


def _read_fastq(path):
    lines = path.read_text().splitlines()
    return [(lines[i][1:], lines[i + 1]) for i in range(0, len(lines), 4)]


@pytest.mark.parametrize("paired", [False, True])
def test_cli_align_on_shards_equals_jax(cli_data, jax_cli_sam, paired):
    """``seqtools align`` (and ``align -2``: flags and mates only, no
    rescue) on the .shards prefix: the port's SAM is what the JAX CLI
    writes there."""
    d = cli_data
    argv = ["align", "-F", str(d / "r.fq")] \
        + (["-2", str(d / "m2.fq")] if paired else []) \
        + ["-G", str(d / "ref.fa")] + CPU
    rc, port, _ = _run(cli.main, argv)
    assert rc == 0
    assert port == jax_cli_sam["paired" if paired else "single"]
    body = [ln.split("\t") for ln in port.splitlines()
            if not ln.startswith("@")]
    assert len(body) >= (128 if paired else 64)
    if paired:
        assert all(int(f[1]) & 0x1 for f in body)


def test_cli_index_shards_past_the_bound(contigs, tmp_path, monkeypatch):
    """Past DEFAULT_MAX_SHARD_BP (patched low in both packages) ``seqtools
    index`` writes a .shards manifest and its shard files, as the JAX
    CLI does; ``align`` opens it; a monolithic index past the bound is
    refused with the JAX package's message."""
    for mod in (port_sharded, jax_sharded):
        monkeypatch.setattr(mod, "DEFAULT_MAX_SHARD_BP", 1000)
    text = "".join(f">{n}\n{s}\n" for n, s in contigs)
    for sub, main in (("port", cli.main), ("jax", jax_cli.main)):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "ref.fa").write_text(text)
        rc, _, err = _run(main, ["index", str(tmp_path / sub / "ref.fa")])
        assert rc == 0 and "1 shards" in err
    for ext in (".shards", ".shard0.bwt", ".shard0.sa", ".shard0.pac",
                ".shard0.ann", ".shard0.amb"):
        assert (tmp_path / "port" / f"ref.fa{ext}").read_bytes() \
            == (tmp_path / "jax" / f"ref.fa{ext}").read_bytes(), ext
    mono = tmp_path / "mono.fa"
    mono.write_text(text)
    FMIndex.construct(contigs).write(str(mono))
    rc, _, err = _run(cli.main, ["align", "-F", str(mono), "-G", str(mono)]
                      + CPU)
    assert rc == 1 and "rebuild it sharded" in err and "1000" in err
    (tmp_path / "bad.fa.shards").write_text("{}")
    rc, _, err = _run(cli.main, ["align", "-F", str(mono), "-G",
                                 str(tmp_path / "bad.fa")] + CPU)
    assert rc == 1 and "n_shards" in err

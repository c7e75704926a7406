"""The port's ``seqtools`` command line (``seqlib_tpu_torch.cli``) on the
CPU, in-process (``main(argv)`` with ``--device cpu``), on a synthetic
reference and reads made from a numpy seed in ``tmp_path``.

``index`` writes files byte-equal to the JAX CLI's; ``align`` (SAM and
BAM) equals the port library's records; ``align -2`` gives proper
pairs; ``align -C`` writes the JAX CLI's CRAM byte for byte; ``bfc
-f`` and ``fml -f`` equal the JAX CLI's output, and so does ``align
-2`` on 32 pairs, line for line; a shard manifest without a count, a
monolithic index past the shard bound and a missing GPU exit 1 with a
message; one fresh interpreter shows the CLI imports no JAX.
Tolerance: exact equality.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from seqlib_tpu import cli as jax_cli
from seqlib_tpu_torch import cli
from seqlib_tpu_torch.align import BWAAligner
from seqlib_tpu_torch.align.pairing import mark_supplementary
from seqlib_tpu_torch.index import FMIndex
from seqlib_tpu_torch.index import sharded as port_sharded
from seqlib_tpu_torch.io import BamReader, FastqReader
from seqlib_tpu_torch.sim import make_genome, simulate_pairs, simulate_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the suite's workers
    share the cores, and idle pool threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_fastq(path, recs):
    with open(path, "w") as fh:
        for name, seq, qual in recs:
            fh.write(f"@{name}\n{seq}\n+\n{qual}\n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """ref.fa (two contigs, an N run at chr2's start) with bwa's files
    written by the port's ``index``, 200 reads of 90 bp, 96 pairs of 70 bp
    and 200 reads of 100 bp over a 2 kb window (assembly)."""
    d = tmp_path_factory.mktemp("cli")
    g = make_genome(40_000, seed=3, n_segments=1, seg_len=300,
                    tandem_copies=3)
    contigs = [("chr1", g[:22_000]), ("chr2", "N" * 40 + g[22_040:])]
    fa = d / "ref.fa"
    fa.write_text("".join(f">{n} synthetic\n{s}\n" for n, s in contigs))
    rng = np.random.default_rng(8)
    reads = simulate_reads(g, 200, seed=5, length=90)
    recs = [(n, s, "".join(chr(33 + q) for q in rng.integers(2, 41, len(s))))
            for n, s in reads]
    _write_fastq(d / "r.fq", recs)
    r1, r2 = simulate_pairs(contigs, 96, read_len=70, dist=300,
                            stdev=30, seed=9)
    _write_fastq(d / "p1.fq", [(u.name, u.seq, u.qual) for u in r1])
    _write_fastq(d / "p2.fq", [(u.name, u.seq, u.qual) for u in r2])
    w1, w2 = simulate_pairs([("win", g[:2000])], 100, read_len=100,
                            error_rate=0.005, seed=7)
    _write_fastq(d / "win.fq", [(u.name, u.seq, u.qual) for u in w1 + w2])
    assert cli.main(["index", str(fa)]) == 0
    return d


def _run(main, argv):
    """main(argv) -> (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_index_equals_jax_cli(data, tmp_path):
    for sub, main in (("port", cli.main), ("jax", jax_cli.main)):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "ref.fa").write_bytes((data / "ref.fa").read_bytes())
        rc, _, err = _run(main, ["index", str(tmp_path / sub / "ref.fa")])
        assert rc == 0 and "indexed" in err
    for ext in (".pac", ".ann", ".amb", ".bwt", ".sa"):
        port = (tmp_path / "port" / f"ref.fa{ext}").read_bytes()
        assert port == (tmp_path / "jax" / f"ref.fa{ext}").read_bytes(), ext
        assert port == (data / f"ref.fa{ext}").read_bytes(), ext


@pytest.fixture(scope="module")
def library_sam(data):
    """What the port library gives for r.fq on the loaded index:
    ``align_batch`` (512 a batch), ``mark_supplementary``, SAM lines."""
    idx = FMIndex.load(str(data / "ref.fa"))
    assert idx.sa_full is None
    aln = BWAAligner(idx, device="cpu")
    reads = list(FastqReader(str(data / "r.fq")))
    recs = aln.align_batch([r.seq for r in reads], [r.name for r in reads],
                           hardclip=False, keep_sec_frac=0.9,
                           max_secondary=10)
    hdr = idx.header_from_index()
    lines = []
    for rs in recs:
        mark_supplementary(rs)
        lines += [r.to_sam(hdr) for r in rs]
    return idx.sam_header_text(), lines


def test_align_sam_equals_library(data, library_sam, tmp_path):
    out = tmp_path / "out.sam"
    rc, _, _ = _run(cli.main, ["align", "-F", str(data / "r.fq"), "-G",
                               str(data / "ref.fa"), "-o", str(out)] + CPU)
    assert rc == 0
    text = out.read_text().splitlines()
    head = [ln for ln in text if ln.startswith("@")]
    assert "\n".join(head) + "\n" == library_sam[0]
    body = [ln for ln in text if not ln.startswith("@")]
    assert body == library_sam[1]
    assert sum(ln.split("\t")[2] != "*" for ln in body) >= 190


def test_align_bam_equals_library(data, library_sam, tmp_path):
    out = tmp_path / "out.bam"
    rc, _, _ = _run(cli.main, ["align", "-b", "-F", str(data / "r.fq"),
                               "-G", str(data / "ref.fa"), "-o", str(out)]
                    + CPU)
    assert rc == 0
    rd = BamReader(str(out))
    hdr = rd.header()
    got = [r.to_sam(hdr) for r in iter(rd.next, None)]
    rd.close()
    assert got == library_sam[1]


def test_align_paired_gives_proper_pairs(data, tmp_path):
    out = tmp_path / "pairs.sam"
    rc, _, _ = _run(cli.main, ["align", "-F", str(data / "p1.fq"), "-2",
                               str(data / "p2.fq"), "-G",
                               str(data / "ref.fa"), "-o", str(out)] + CPU)
    assert rc == 0
    recs = [ln.split("\t") for ln in out.read_text().splitlines()
            if not ln.startswith("@")]
    prim = [r for r in recs if not int(r[1]) & 0x900]
    assert len(prim) == 2 * 96
    proper = sum(1 for r in prim if int(r[1]) & 0x2)
    assert proper >= 0.95 * len(prim)
    assert all(int(r[1]) & 0x1 for r in prim)


@pytest.mark.parametrize("cmd", ["bfc", "fml"])
def test_bfc_fml_fasta_equal_jax_cli(data, cmd):
    argv = [cmd, "-f", "-F", str(data / "win.fq")]
    rc, port, _ = _run(cli.main, argv + CPU)
    jrc, want, _ = _run(jax_cli.main, argv)
    assert rc == jrc == 0
    assert port == want and port.count(">") >= (200 if cmd == "bfc" else 1)


def test_align_cram_equals_jax_cli(data, library_sam, tmp_path):
    """``align -C`` on 64 reads: the port's CRAM (``--device cpu``) is the
    JAX CLI's byte for byte, and decodes to the library's records."""
    fq = tmp_path / "r64.fq"
    _write_fastq(fq, [(r.name, r.seq, r.qual) for r in
                      list(FastqReader(str(data / "r.fq")))[:64]])
    outs = {}
    for sub, main, extra in (("port", cli.main, CPU), ("jax", jax_cli.main,
                                                       [])):
        outs[sub] = tmp_path / f"{sub}.cram"
        rc, _, _ = _run(main, ["align", "-C", "-F", str(fq), "-G",
                               str(data / "ref.fa"), "-o",
                               str(outs[sub])] + extra)
        assert rc == 0
    assert outs["port"].read_bytes() == outs["jax"].read_bytes()
    assert outs["port"].read_bytes()[:4] == b"CRAM"
    rd = BamReader(str(outs["port"]))
    hdr = rd.header()
    got = [r.to_sam(hdr) for r in iter(rd.next, None)]
    rd.close()
    names = {r.name for r in list(FastqReader(str(fq)))}
    want = [ln for ln in library_sam[1] if ln.split("\t")[0] in names]
    assert len(got) == len(want) >= 64

    def fields(ln):        # CRAM keeps a record's tags in sorted order
        f = ln.split("\t")
        return f[:11] + sorted(f[11:])
    assert sorted(map(fields, got)) == sorted(map(fields, want))


def test_refusals_name_the_roadmap_item(data, tmp_path, monkeypatch):
    """What is left of the refusals once sharded indexes are ported: a
    .shards manifest without a shard count, and bwa's files of one
    index past DEFAULT_MAX_SHARD_BP (patched to 1000), exit 1 with a
    message naming the manifest, or the bound and the way out (the JAX
    CLI's ValueError); a FASTA past the bound and ``index`` of it are
    no longer refused, they shard as the JAX CLI does."""
    fq, fa = str(data / "r.fq"), str(data / "ref.fa")
    shard = tmp_path / "big.fa"
    shard.write_bytes((data / "ref.fa").read_bytes())
    (tmp_path / "big.fa.shards").write_text("{}")
    rc, _, err = _run(cli.main, ["align", "-F", fq, "-G", str(shard)] + CPU)
    assert rc == 1 and "n_shards" in err and ".shards" in err
    monkeypatch.setattr(port_sharded, "DEFAULT_MAX_SHARD_BP", 1000)
    rc, _, err = _run(cli.main, ["align", "-F", fq, "-G", fa] + CPU)
    assert rc == 1 and "1000" in err and "seqtools index" in err
    plain = tmp_path / "plain.fa"          # a FASTA without index files
    plain.write_bytes((data / "ref.fa").read_bytes())
    few = tmp_path / "few.fq"
    _write_fastq(few, [(r.name, r.seq, r.qual) for r in
                       list(FastqReader(fq))[:16]])
    rc, out, _ = _run(cli.main, ["align", "-F", str(few), "-G", str(plain)]
                      + CPU)
    body = [ln for ln in out.splitlines() if not ln.startswith("@")]
    assert rc == 0 and len({ln.split("\t")[0] for ln in body}) == 16
    rc, _, err = _run(cli.main, ["index", str(plain)])
    assert rc == 0 and "1 shards" in err
    assert (tmp_path / "plain.fa.shards").exists()


@pytest.fixture(scope="module")
def jax_paired_sam(data, tmp_path_factory):
    """The JAX CLI's ``align -2`` of the first 32 pairs on the loaded
    index, run once (its CPU run is the costly part)."""
    d = tmp_path_factory.mktemp("paired")
    for end in ("p1", "p2"):
        _write_fastq(d / f"{end}.fq", [
            (r.name, r.seq, r.qual) for r in
            list(FastqReader(str(data / f"{end}.fq")))[:32]])
    rc, out, _ = _run(jax_cli.main, ["align", "-F", str(d / "p1.fq"), "-2",
                                     str(d / "p2.fq"), "-G",
                                     str(data / "ref.fa")])
    assert rc == 0
    return d, out


@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_align_paired_equals_jax_cli(data, jax_paired_sam, fmt, tmp_path):
    """``align -2`` of 32 pairs (insert-size inference, mate rescue,
    proper-pair bounds): the port's SAM is the JAX CLI's line for line,
    and its BAM decodes to the same records."""
    d, want = jax_paired_sam
    out = tmp_path / f"pairs.{fmt}"
    rc, _, _ = _run(cli.main, ["align", "-F", str(d / "p1.fq"), "-2",
                               str(d / "p2.fq"), "-G", str(data / "ref.fa"),
                               "-o", str(out)]
                    + (["-b"] if fmt == "bam" else []) + CPU)
    assert rc == 0
    body = [ln for ln in want.splitlines() if not ln.startswith("@")]
    assert len(body) >= 64
    if fmt == "sam":
        assert out.read_text() == want
    else:
        rd = BamReader(str(out))
        hdr = rd.header()
        assert [r.to_sam(hdr) for r in iter(rd.next, None)] == body
        rd.close()


def test_default_device_needs_a_gpu(data):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    rc, _, err = _run(cli.main, ["align", "-F", str(data / "r.fq"), "-G",
                                 str(data / "ref.fa")])
    assert rc == 1 and "--device cuda" in err and "device='cpu'" in err


PROBE = textwrap.dedent("""
    import json, runpy, sys
    sys.path.insert(0, {repo!r})
    rcs = []
    for argv in (["index", {fa!r}],
                 ["align", "-b", "-F", {fq!r}, "-G", {fa!r}, "-o", {out!r},
                  "--device", "cpu"]):
        sys.argv = ["seqtools"] + argv
        try:
            runpy.run_module("seqlib_tpu_torch.cli", run_name="__main__")
        except SystemExit as e:
            rcs.append(e.code)
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.")
                 or m == "seqlib_tpu" or m.startswith("seqlib_tpu."))
    print(json.dumps(dict(rcs=rcs, bad=bad)))
""")


def test_cli_in_a_fresh_interpreter_imports_no_jax(data, tmp_path):
    """``python -m seqlib_tpu_torch.cli`` index then align: both exit 0
    and leave no jax and nothing of seqlib_tpu in sys.modules."""
    fa = tmp_path / "ref.fa"
    fa.write_bytes((data / "ref.fa").read_bytes())
    reads = list(FastqReader(str(data / "r.fq")))[:32]
    _write_fastq(tmp_path / "r.fq", [(r.name, r.seq, r.qual) for r in reads])
    code = PROBE.format(repo=REPO, fa=str(fa), fq=str(tmp_path / "r.fq"),
                        out=str(tmp_path / "o.bam"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == dict(rcs=[0, 0], bad=[])
    assert (tmp_path / "o.bam").stat().st_size > 0

"""The benchmark's C. elegans cell (``celegans-wbcel235.se150``) on the
CPU, at a cut of its deployment: WBcel235's seven contig names, I to X
at 1/200 of their lengths and MtDNA whole.

- The cell loads by name with its seven contigs, its loaded index, its
  mix and the two metrics that read what it adds (the index load and
  the LF walk's share of its roofline).
- A traced harness run of the cut cell, in batches of 64 reads, reads
  ``correct: true`` and reports ``index_load_ms``.
- Reads planted across each of the six contig junctions, at each
  contig's edges and on MtDNA give byte-equal BAM records from the
  port's CPU path on the loaded index, the benchmark's plain reference
  and the JAX package.
- The walk's bound is worked by hand; the reference's count of the
  walk's work equals the port's plain walk on the same ranks; the index
  load reader reads the port's spans and gives nothing where there are
  none.
"""

import json
import os
import re
import types

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.clients import se_stream
from portbench.gen import genome as gen_genome
from portbench.reference import index as ref_index
from portbench.reference import records as ref_records
from portbench.reference.bwamem.ops.fm import DeviceFMIndex as RefFM
from seqlib_tpu.align import BWAAligner as JaxAligner
from seqlib_tpu.align.options import AlignerOptions as JaxOptions
from seqlib_tpu.index import FMIndex as JaxFMIndex
from seqlib_tpu_torch.align import AlignerOptions, BWAAligner
from seqlib_tpu_torch.core.seq import revcomp
from seqlib_tpu_torch.index import FMIndex
from seqlib_tpu_torch.ops import fm as tfm

CELL = "celegans-wbcel235.se150"
NAMES = ["I", "II", "III", "IV", "V", "X", "MtDNA"]
SEED = 2**33 + 17
READ = 150
# MtDNA positions clear of the genome model's tandem block (60 bp units
# from 6,897 to 9,897 on a 13,794 bp contig), where a read has no one
# place
MT_MID, MT_RC = 3000, 11000

walk_roofline = harness.metric_module("walk_roofline")
index_load_ms = harness.metric_module("index_load_ms")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cut(config: dict) -> dict:
    """The configuration with I to X at 1/200 of their lengths and MtDNA
    whole."""
    return dict(config, contigs=[[n, l if n == "MtDNA" else l // 200]
                                 for n, l in config["contigs"]])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The cut genome, the reference's index and bwa's files written from
    it, and the port's index loaded from those files."""
    cfg = cut(harness.load_spec(CELL).config)
    texts = [(n, gen_genome.as_text(c))
             for n, c in gen_genome.make_genome(cfg, SEED)]
    ref = ref_index.build(texts, device="cpu")
    prefix = str(tmp_path_factory.mktemp("celegans") / "index")
    ref_index.write_bwa_files(ref, prefix)
    return dict(cfg=cfg, texts=texts, ref=ref, prefix=prefix,
                port=FMIndex.load(prefix))


# (a) -------------------------------------------------------------------

def test_cell_loads_by_name():
    spec = harness.load_spec(CELL)
    assert [n for n, _ in spec.config["contigs"]] == NAMES
    assert sum(n for _, n in spec.config["contigs"]) == 100_286_401
    assert spec.config["reduced"] == [] and spec.config["sa_interval"] == 32
    with open(os.path.join(harness.ROOT, "portbench", "traffic",
                           "se150.json")) as fh:
        assert spec.traffic == json.load(fh)
    assert spec.traffic["index"] == "loaded"
    assert spec.traffic["batch"] == 65536 and spec.chips == 1
    names = {m["name"] for m in spec.per_layer}
    assert {"walk_roofline", "index_load_ms", "k2_roofline",
            "locate_stream_ms_per_batch"} <= names
    assert {m["name"] for m in spec.end_to_end} == {"reads_per_s",
                                                    "setup_s"}


# (b) -------------------------------------------------------------------

def test_cut_cell_traced_run_is_correct(tmp_path, monkeypatch):
    monkeypatch.setattr(se_stream, "CACHE", str(tmp_path))
    # this suite's conftest loads JAX into every test process; the
    # harness's refusal of a run with JAX loaded is portbench's own test
    monkeypatch.setattr(harness, "forbidden_loaded", lambda: [])
    spec = harness.load_spec(CELL)
    spec.config = cut(spec.config)
    spec.traffic = dict(spec.traffic, batch=64, pool_batches=2, workers=1,
                        check_reads=48, trace_batches=1)
    lines = []
    rc = harness.run(spec, SEED, 1.0, True, torch.device("cpu"),
                     emit=lines.append)
    assert rc == 0 and len(lines) == 1
    line = json.loads(lines[0])
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 64
    assert line["checks"]["reads_differing"] == {"value": 0, "limit": 0}
    # on the CPU the walk kernel never runs: its share has nothing to read
    assert "walk_roofline" not in line["metrics"]
    assert line["metrics"]["index_load_ms"]["value"] > 0


# (c) -------------------------------------------------------------------

def planted(texts) -> list[tuple[str, str]]:
    """Reads across each junction of the concatenated contigs (75/75,
    130/20 reverse-complemented, 20/130), the last READ bases of each
    contig before a junction and the first READ of the next, and four on
    MtDNA (its start, one inside, its end and a reverse-complemented
    one)."""
    whole = "".join(s for _, s in texts)
    offs = np.cumsum([0] + [len(s) for _, s in texts])
    out = []
    for k in range(1, len(texts)):
        o = int(offs[k])
        for left in (75, 130, 20):
            s = whole[o - left:o - left + READ]
            out.append((f"cross{k}_{left}",
                        revcomp(s) if left == 130 else s))
        out.append((f"end{k}", whole[o - READ:o]))
        out.append((f"start{k}", revcomp(whole[o:o + READ])))
    mt = texts[-1][1]
    out += [("mt_start", mt[:READ]), ("mt_mid", mt[MT_MID:MT_MID + READ]),
            ("mt_end", mt[-READ:]),
            ("mt_rc", revcomp(mt[MT_RC:MT_RC + READ]))]
    return out


def _split(payload, counts, n):
    per = ref_records.split_payload(payload, counts, range(n))
    return [per[i] for i in range(n)]


def test_junction_and_mtdna_reads_equal_reference_and_jax(world):
    reads = planted(world["texts"])
    names, seqs = [n for n, _ in reads], [s for _, s in reads]
    opts = world["cfg"]["aligner"]
    port = BWAAligner(world["port"], options=AlignerOptions(**opts),
                      device="cpu")
    got = _split(*port.align_batch_bam(seqs, names), len(reads))
    want = ref_records.reference_records(world["ref"], names, seqs, opts)
    jax = JaxAligner(JaxFMIndex.load(world["prefix"]),
                     options=JaxOptions(**opts))
    jgot = _split(*jax.align_batch_bam(seqs, names), len(reads))
    assert ref_records.compare(got, want) == (0, -1)
    assert ref_records.compare(jgot, want) == (0, -1)

    lens = {n: len(s) for n, s in world["texts"]}
    placed = {}
    for name, recs in zip(names, got):
        for r in recs:
            d = ref_records.decode(r, NAMES)
            span = sum(int(n) for n, op in re.findall(r"(\d+)(\D)",
                                                        d["cigar"])
                       if op in "MD")
            # no record runs past its contig's end
            assert d["pos"] + span <= lens[d["contig"]], (name, d)
            if not d["flag"] & 0x900:
                placed[name] = (d["contig"], d["pos"])
    for k in range(1, len(NAMES)):
        assert placed[f"end{k}"] == (NAMES[k - 1],
                                     lens[NAMES[k - 1]] - READ)
        assert placed[f"start{k}"] == (NAMES[k], 0)
    mt = lens["MtDNA"]
    assert placed["mt_start"] == ("MtDNA", 0)
    assert placed["mt_mid"] == ("MtDNA", MT_MID)
    assert placed["mt_end"] == ("MtDNA", mt - READ)
    assert placed["mt_rc"] == ("MtDNA", MT_RC)


# (d) -------------------------------------------------------------------

# (entries, lanes, LF steps, longest walk, rows touched, row bytes) and
# the bound in ms and its term, worked by hand:
# - inside L2: the benchmark's batch on E. coli (``chip_smoke.py``'s walk
#   phase on an H100); 72,527 rows x 48 B = 3.48 MB sit in 50 MiB,
#   nothing beyond.  HBM
#   16 x 26,214,400 = 419,430,400 B / 3.35e12 = 0.125203 ms; L2
#   (64 x 16,326,895 + 32 x 529,011 + 419,430,400) = 1,481,280,032 B
#   / 7.45e12 = 0.198830 ms; latency 518 x 148.3 ns = 0.076819 ms.
# - outside L2, the same walk on C. elegans' 1,566,977 rows: 75,214,896 B,
#   22,786,096 beyond 52,428,800; HBM 442,216,496 B / 3.35e12 = 0.132005
#   ms; L2 and latency as above: L2 bounds it.
# - outside L2 with few steps: 4,000,000 rows of 64 B, 203,571,200 B
#   beyond; HBM 623,001,600 B / 3.35e12 = 0.185971 ms; L2 (64,000 +
#   3,200 + 419,430,400) = 419,497,600 B / 7.45e12 = 0.056308 ms;
#   latency 10 x 148.3 ns: HBM bounds it.
# - one long walk: 1 lane of 5,000 steps on 4 entries; latency 5,000 x
#   148.3 ns = 0.7415 ms against HBM 64 B and L2 320,096 B.
BOUNDS = [
    ((26_214_400, 529_011, 16_326_895, 518, 72_527, 48),
     1_481_280_032 / 7.45e12 * 1e3, "L2",
     419_430_400 / 3.35e12 * 1e3),
    ((26_214_400, 529_011, 16_326_895, 518, 1_566_977, 48),
     1_481_280_032 / 7.45e12 * 1e3, "L2",
     442_216_496 / 3.35e12 * 1e3),
    ((26_214_400, 100, 1_000, 10, 4_000_000, 64),
     623_001_600 / 3.35e12 * 1e3, "HBM",
     623_001_600 / 3.35e12 * 1e3),
    ((4, 1, 5_000, 5_000, 40, 48),
     5_000 * 148.3e-6, "latency", 64 / 3.35e12 * 1e3),
]


@pytest.mark.parametrize("counts,ms,by,hbm", BOUNDS,
                         ids=["inside_l2", "outside_l2", "hbm", "latency"])
def test_walk_bound_by_hand(counts, ms, by, hbm):
    entries, lanes, steps, longest, rows, row_bytes = counts
    got, got_by, terms = walk_roofline.bound_ms(
        entries, lanes, steps, longest, rows, row_bytes)
    assert got_by == by
    assert got == pytest.approx(ms, rel=1e-12)
    assert terms["HBM"] == pytest.approx(hbm, rel=1e-12)
    assert terms["latency"] == pytest.approx(longest * 148.3e-6, rel=1e-12)
    assert max(terms.values()) == got


def test_walk_count_equals_the_ports_plain_walk(world):
    fm = tfm.DeviceFMIndex.from_host(world["port"], device="cpu")
    assert fm.sa_intv == 32
    rng = np.random.default_rng(3)
    ranks = torch.from_numpy(rng.integers(-1, fm.seq_len + 1, (20, 16)))
    _, steps = tfm._sa_walk(fm, ranks, return_steps=True)
    rows = set()
    for r in ranks.reshape(-1).tolist():
        r = torch.tensor([r])
        while r >= 0 and r % 32 and r != fm.primary:
            rows.add(int((r - (r > fm.primary).long()) >> 7))
            r = tfm._lf(fm, r)
    work = walk_roofline.count_walk(
        RefFM.from_host(world["ref"], device="cpu"), ranks, 32)
    assert work == dict(entries=320, lanes=int((ranks >= 0).sum()),
                        steps=int(steps.sum()), longest=int(steps.max()),
                        rows=len(rows))
    assert work["steps"] > work["lanes"] > 300


def _cell(index="loaded"):
    return types.SimpleNamespace(
        spec=types.SimpleNamespace(traffic={"index": index},
                                   config={"name": "cut"}),
        seed=SEED, options={}, device=torch.device("cpu"))


def test_index_load_reader(world, tmp_path, monkeypatch):
    here = tmp_path / "cut" / str(SEED)
    here.mkdir(parents=True)
    ref_index.write_bwa_files(world["ref"], str(here / "index"))
    monkeypatch.setattr(se_stream, "CACHE", str(tmp_path))
    with index_load_ms.probe(_cell()) as p:
        pass
    spans = {s.name: s for s in p.rec.spans}
    assert set(spans) == {"index.load", "index.read_pac", "index.read_bwt",
                          "index.layout", "index.read_sa", "index.upload",
                          "index.upload_text"}
    port = world["port"]
    assert p.rec.counters == {
        "index.occ_bytes": 48 * (port.bwt_words.shape[0] + 1),
        "index.sa_bytes": 8 * port.sa_samples.size,
        "index.text_bytes": 2 * port.l_pac}
    ctx = types.SimpleNamespace(probes={"index_load_ms": p})
    assert index_load_ms.read(ctx) == pytest.approx(sum(
        spans[k].ms for k in index_load_ms.SPANS))
    # an index built in memory, and a program that records no such span
    with index_load_ms.probe(_cell("constructed")) as q:
        assert q.rec is None
    assert index_load_ms.read(types.SimpleNamespace(
        probes={"index_load_ms": q})) is None
    p.rec = p.rec._replace(spans=[s for s in p.rec.spans
                                  if s.name != "index.load"])
    assert index_load_ms.read(ctx) is None

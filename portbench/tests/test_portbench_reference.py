"""The reference agrees with the port's CPU output, builds the same
index by its own code, and its comparison catches a corrupted record."""

import numpy as np
import pytest
import torch

from portbench.gen import genome, reads, stream
from portbench.reference import index as ref_index
from portbench.reference import records as ref_records
from portbench.reference.bwamem.sa import suffix_array
from seqlib_tpu_torch.align import BWAAligner
from seqlib_tpu_torch.index import FMIndex
from seqlib_tpu_torch.native import suffix_array as port_sa

CFG = {"contigs": [["c1", 120000], ["c_2", 50000]],
       "genome_model": {"segments_per_mbp": 20.0, "seg_len": 2000,
                        "tandem_unit": 60, "tandem_copies": 50}}


@pytest.fixture(scope="module")
def world():
    torch.manual_seed(0)
    ct = genome.make_genome(CFG, 21)
    texts = [(n, genome.as_text(c)) for n, c in ct]
    names, seqs = reads.simulate_reads(ct, 200, stream(21, 2))
    return texts, names, seqs, ref_index.build(texts), \
        FMIndex.construct(texts)


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 30000])
def test_suffix_array_matches_sais(n):
    rng = np.random.default_rng(n)
    t = rng.integers(1, 5, n).astype(np.uint8)
    if n > 5000:
        t[2000:4000] = t[10000:12000]
        t[20000:23000] = np.tile(t[:30], 100)
    assert (suffix_array(t, device="cpu") == port_sa(t)).all()


def test_bwa_files_match_the_ports(world, tmp_path):
    texts, _, _, ref, port = world
    ref_index.write_bwa_files(ref, str(tmp_path / "ref"))
    port.write(str(tmp_path / "port"))
    for ext in ("pac", "ann", "amb", "bwt", "sa"):
        a = (tmp_path / f"ref.{ext}").read_bytes()
        b = (tmp_path / f"port.{ext}").read_bytes()
        assert a == b, ext


def _port_records(index, names, seqs):
    aln = BWAAligner(index, device="cpu")
    payload, counts = aln.align_batch_bam(seqs, names)
    per = ref_records.split_payload(payload, counts, range(len(names)))
    return [per[i] for i in range(len(names))]


def test_reference_equals_port_cpu(world, tmp_path):
    texts, names, seqs, ref, port = world
    want = ref_records.reference_records(ref, names, seqs, {})
    assert ref_records.compare(_port_records(port, names, seqs), want) \
        == (0, -1)
    ref_index.write_bwa_files(ref, str(tmp_path / "idx"))
    loaded = FMIndex.load(str(tmp_path / "idx"))
    assert ref_records.compare(_port_records(loaded, names, seqs), want) \
        == (0, -1)
    placed, total = reads.placement_rate(
        [(d["qname"], d["flag"], d["contig"], d["pos"]) for d in
         (ref_records.decode(r, [n for n, _ in texts])
          for rs in want for r in rs)])
    assert total == 200 and placed >= 180


def test_comparison_catches_a_corrupted_record(world):
    texts, names, seqs, ref, port = world
    got = _port_records(port, names[:40], seqs[:40])
    want = ref_records.reference_records(ref, names[:40], seqs[:40], {})
    assert ref_records.compare(got, want) == (0, -1)
    bad = [list(r) for r in got]
    rec = bytearray(bad[17][0])
    rec[8] ^= 1                       # the position's lowest bit
    bad[17][0] = bytes(rec)
    assert ref_records.compare(bad, want) == (1, 17)
    bad = [list(r) for r in got]
    bad[3] = []                       # a read answered with no record
    assert ref_records.compare(bad, want) == (1, 3)
    d = ref_records.decode(got[0][0], [n for n, _ in texts])
    assert d["qname"] == names[0] and d["cigar"] != ""


def test_split_payload_refuses_a_short_payload(world):
    texts, names, seqs, ref, port = world
    aln = BWAAligner(port, device="cpu")
    payload, counts = aln.align_batch_bam(seqs[:8], names[:8])
    with pytest.raises((ValueError, Exception)):
        ref_records.split_payload(payload[:-3], counts, [0])


def test_reference_index_arrays_match_the_ports(world):
    texts, _, _, ref, port = world
    for k in ("sa_full", "bwt", "cp_counts", "bwt_words", "sa_samples",
              "L2"):
        assert (getattr(ref, k) == getattr(port, k)).all(), k
    assert ref.primary == port.primary and ref.seq_len == port.seq_len

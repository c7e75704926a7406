"""The port's FastqReader (seqlib_tpu_torch.io.fastq) against the JAX
package's (seqlib_tpu.io.fastq) on FASTA, FASTQ and gzip files: the
same records (name, sequence, qualities, comment), in the same order."""

import gzip

import pytest

from seqlib_tpu.io import FastqReader as JaxReader
from seqlib_tpu_torch.io import FastqReader

FASTQ = ("@r1 comment one\nACGTNACGT\n+\nIIIIIIIII\n"
         "\n"
         "@r2\nTTTT\n+r2\n#$%&\n"
         "@r3/1 x:y\nacgt\n+\nABCD\n")
FASTA = (">chr1 first contig\nACGTACGT\nTTGGCCAA\n\nNNNN\n"
         ">chr2\nGATTACA\n"
         ">empty\n"
         ">chr3 last\nAC\nGT")


def _records(reader):
    return [(u.name, u.seq, u.qual, u.com) for u in reader]


@pytest.mark.parametrize("text,suffix", [(FASTQ, ".fq"), (FASTA, ".fa")])
@pytest.mark.parametrize("gz", [False, True])
def test_reader_parity(tmp_path, text, suffix, gz):
    path = tmp_path / f"reads{suffix}{'.gz' if gz else ''}"
    if gz:
        with gzip.open(path, "wt") as fh:
            fh.write(text)
    else:
        path.write_text(text)
    want = _records(JaxReader(str(path)))
    got = _records(FastqReader(str(path)))
    assert got == want and len(got) >= 3
    r = FastqReader()
    assert r.Open(str(path))
    assert (r.GetNextSequence().name, r.get_next_sequence().name) == \
        (want[0][0], want[1][0])


def test_reader_errors(tmp_path):
    with pytest.raises(IOError):
        FastqReader(str(tmp_path / "missing.fq"))
    assert FastqReader().get_next_sequence() is None
    bad = tmp_path / "bad.txt"
    bad.write_text("not a record\n")
    with pytest.raises(ValueError):
        FastqReader(str(bad)).get_next_sequence()

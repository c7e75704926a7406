"""The cases of ``tests/test_io_fuzz.py`` on the port, with the same
seeds: random truncation, bit flips, bad magics and garbage must raise
clean Python errors (ValueError, OSError, EOFError, ...) and never hang,
crash the process or return records past those written.  Each case also
holds the port to the JAX package on the same bytes: the same count of
records, or an error where it raises one.
"""

import io
import random

import pytest

import seqlib_tpu.io as jio
from seqlib_tpu_torch.core import BamHeader
from seqlib_tpu_torch.core.record import BamRecord
from seqlib_tpu_torch.io import BamReader, BamWriter
from seqlib_tpu_torch.io.bgzf import BgzfReader, BgzfWriter, is_bgzf

ACCEPTABLE = (ValueError, OSError, EOFError, KeyError, IndexError,
              StopIteration)


@pytest.fixture(scope="module")
def bam_bytes(tmp_path_factory):
    """A small valid BAM with 50 records."""
    d = tmp_path_factory.mktemp("fuzz")
    path = str(d / "fuzz.bam")
    hdr = BamHeader([("chr1", 10000), ("chr2", 5000)])
    w = BamWriter()
    w.open(path)
    w.set_header(hdr)
    w.write_header()
    rng = random.Random(42)
    for i in range(50):
        r = BamRecord()
        r.qname = f"read{i}"
        r.tid = rng.randrange(2)
        r.pos = rng.randrange(4000)
        r.mapq = 30
        r.seq = "".join(rng.choice("ACGT") for _ in range(100))
        r.set_cigar("100M")
        w.write_record(r)
    w.close()
    with open(path, "rb") as f:
        return f.read()


def _read_all(reader_cls, p: str) -> int:
    n = 0
    r = reader_cls(p)
    while True:
        rec = r.Next()
        if rec is None:
            break
        n += 1
        assert 0 <= len(rec.seq or "") < 1_000_000
    return n


def _outcome(reader_cls, p: str):
    try:
        return _read_all(reader_cls, p)
    except ACCEPTABLE as e:
        return type(e).__name__
    except Exception as e:      # noqa: BLE001  (compared, not swallowed)
        return f"other:{type(e).__name__}"


def _try_read_all(data: bytes, tmp_path, name: str) -> int:
    """Read every record with the port, after checking that the JAX
    package reads these bytes to the same outcome."""
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    assert _outcome(BamReader, p) == _outcome(jio.BamReader, p)
    return _read_all(BamReader, p)


def test_valid_roundtrip(bam_bytes, tmp_path):
    assert _try_read_all(bam_bytes, tmp_path, "ok.bam") == 50


def test_truncation_everywhere(bam_bytes, tmp_path):
    """Truncating at any prefix length either reads a record prefix
    cleanly or raises an acceptable error."""
    rng = random.Random(7)
    cuts = {1, 3, 17, 27, len(bam_bytes) - 1, len(bam_bytes) - 28}
    cuts |= {rng.randrange(len(bam_bytes)) for _ in range(40)}
    for cut in sorted(cuts):
        try:
            n = _try_read_all(bam_bytes[:cut], tmp_path, "t.bam")
            assert 0 <= n <= 50
        except ACCEPTABLE:
            pass


def test_bit_flips(bam_bytes, tmp_path):
    """Single-bit corruption anywhere must not hang or segfault."""
    rng = random.Random(13)
    for _ in range(60):
        i = rng.randrange(len(bam_bytes))
        b = bytearray(bam_bytes)
        b[i] ^= 1 << rng.randrange(8)
        try:
            n = _try_read_all(bytes(b), tmp_path, "flip.bam")
            assert 0 <= n <= 50
        except ACCEPTABLE:
            pass


def test_garbage_inputs(tmp_path):
    rng = random.Random(3)
    cases = [
        b"",
        b"\x00" * 100,
        b"BAM\x01" + b"\x00" * 64,                  # raw BAM, no BGZF
        b"\x1f\x8b" + bytes(rng.randrange(256) for _ in range(200)),
        bytes(rng.randrange(256) for _ in range(1000)),
        b"not a bam file at all, just text\n" * 10,
    ]
    for i, data in enumerate(cases):
        try:
            _try_read_all(data, tmp_path, f"g{i}.bam")
        except ACCEPTABLE:
            pass


def test_bgzf_bad_magic(tmp_path):
    p = str(tmp_path / "bad.bgzf")
    with open(p, "wb") as f:
        f.write(b"\x1f\x8c" + b"\x00" * 30)
    with pytest.raises(ACCEPTABLE):
        BgzfReader(p).read(10)


def test_bgzf_missing_bc_extra(tmp_path):
    import gzip
    p = str(tmp_path / "plain.gz")
    with open(p, "wb") as f:
        f.write(gzip.compress(b"hello world"))
    with pytest.raises(ACCEPTABLE):
        BgzfReader(p).read(10)


def test_bgzf_truncated_block(tmp_path):
    buf = io.BytesIO()
    w = BgzfWriter(buf)
    w.write(b"A" * 100000)
    w.close()
    data = buf.getvalue()
    for cut in (5, 17, 30, len(data) // 2, len(data) - 3):
        p = str(tmp_path / "tr.bgzf")
        with open(p, "wb") as f:
            f.write(data[:cut])
        try:
            r = BgzfReader(p)
            total = 0
            while True:
                chunk = r.read(4096)
                if not chunk:
                    break
                total += len(chunk)
                assert total <= 100000
        except ACCEPTABLE:
            pass


def test_bgzf_corrupt_deflate_payload(tmp_path):
    buf = io.BytesIO()
    w = BgzfWriter(buf)
    w.write(b"ACGT" * 5000)
    w.close()
    data = bytearray(buf.getvalue())
    # corrupt mid-payload of the first block (past the 18-byte header)
    for off in (30, 40, 77):
        b = bytearray(data)
        b[off] ^= 0xFF
        p = str(tmp_path / "c.bgzf")
        with open(p, "wb") as f:
            f.write(bytes(b))
        try:
            BgzfReader(p).read(1 << 20)
        except ACCEPTABLE:
            pass


def test_is_bgzf_on_junk(tmp_path):
    p = str(tmp_path / "junk")
    with open(p, "wb") as f:
        f.write(b"\x00")
    assert is_bgzf(p) is False


def test_native_fast_reader_fuzz(bam_bytes, tmp_path):
    """The native (C++) BGZF/BAM fast path must fail as cleanly as the
    Python codec on truncated and bit-flipped inputs."""
    from seqlib_tpu.io.fast_bam import FastBamReader as JaxFastBamReader
    from seqlib_tpu_torch.io.fast_bam import FastBamReader

    def count(reader_cls, p):
        r = reader_cls(p)
        n = 0
        while True:
            batch = r.read_batch()
            if batch is None:
                break
            n += len(batch)
            assert n <= 50
        r.close()
        return n

    def read_all(data, name):
        p = str(tmp_path / name)
        with open(p, "wb") as f:
            f.write(data)
        outcomes = []
        for cls in (FastBamReader, JaxFastBamReader):
            try:
                outcomes.append(count(cls, p))
            except ACCEPTABLE as e:
                outcomes.append(type(e).__name__)
        assert outcomes[0] == outcomes[1]
        return count(FastBamReader, p)

    assert read_all(bam_bytes, "ok.bam") == 50
    rng = random.Random(5)
    for _ in range(30):
        cut = rng.randrange(len(bam_bytes))
        try:
            read_all(bam_bytes[:cut], "t.bam")
        except ACCEPTABLE:
            pass
    for _ in range(30):
        i = rng.randrange(len(bam_bytes))
        b = bytearray(bam_bytes)
        b[i] ^= 1 << rng.randrange(8)
        try:
            read_all(bytes(b), "f.bam")
        except ACCEPTABLE:
            pass

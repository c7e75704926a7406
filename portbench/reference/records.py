"""BAM records per read, the reference's records for the same reads,
and the comparison that decides ``correct`` for the aligner's cells.

A read's records are compared whole, byte for byte: position, flag,
MAPQ, CIGAR, sequence, qualities and every tag (NM, MD, AS, XS, XA,
...).  A read that the port answered with no record differs from the
reference, which emits at least one (an unmapped record) for every
read."""

from __future__ import annotations

import struct

import numpy as np

from .bwamem.align.aligner import BWAAligner
from .bwamem.align.options import AlignerOptions
from .bwamem.io.bam import encode_record


def split_payload(payload: bytes, counts, want) -> dict[int, list[bytes]]:
    """The records of the reads ``want`` (indices into ``counts``) of one
    batch's concatenated BAM records (``counts`` per read, in order)."""
    want = set(int(w) for w in want)
    out: dict[int, list[bytes]] = {}
    off = 0
    mv = memoryview(payload)
    for i, c in enumerate(np.asarray(counts).tolist()):
        recs = []
        for _ in range(c):
            size = struct.unpack_from("<i", mv, off)[0]
            if i in want:
                recs.append(bytes(mv[off:off + 4 + size]))
            off += 4 + size
        if i in want:
            out[i] = recs
    if off != len(payload):
        raise ValueError(f"payload of {len(payload)} bytes, records cover "
                         f"{off}")
    return out


_CIGAR_OPS = "MIDNSHP=X"


def decode(rec: bytes, contigs: list[str]) -> dict:
    """The fixed fields of one BAM record (with its 4-byte length)."""
    (_, ref_id, pos, l_name, mapq, _, n_cig, flag, l_seq, _, _,
     _) = struct.unpack_from("<iiiBBHHHiiii", rec, 0)
    name = rec[36:36 + l_name - 1].decode()
    c0 = 36 + l_name
    cig = struct.unpack_from(f"<{n_cig}I", rec, c0)
    cigar = "".join(f"{v >> 4}{_CIGAR_OPS[v & 15]}" for v in cig) or "*"
    tags = rec[c0 + 4 * n_cig + (l_seq + 1) // 2 + l_seq:]
    return dict(qname=name, flag=flag, contig=contigs[ref_id]
                if 0 <= ref_id < len(contigs) else "*", pos=pos,
                mapq=mapq, cigar=cigar, tags=tags)


def reference_records(index, names, seqs, options: dict, device="cpu"
                      ) -> list[list[bytes]]:
    """Each read's BAM records by the reference (the classic per-read
    path), on ``device``."""
    aln = BWAAligner(index, options=AlignerOptions(**options), device=device)
    recs = aln.align_batch(list(seqs), list(names))
    return [[encode_record(r) for r in rs] for rs in recs]


def compare(got: list[list[bytes]], want: list[list[bytes]]):
    """(reads whose records differ, index of the first such read or -1)."""
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    return len(bad), (bad[0] if bad else -1)

"""BAI (BAM index) reader and writer (counterpart of
seqlib_tpu/io/bai.py): the SAM spec's hierarchical bins, each a list of
virtual-offset chunks, and a linear index of 16 kb windows."""

from __future__ import annotations

import struct
from collections import defaultdict

from .bam import reg2bin, reg2bins

BAI_MAGIC = b"BAI\x01"
LINEAR_SHIFT = 14


class BaiIndex:
    """In-memory BAI: per-reference {bin: [(chunk_beg, chunk_end), ...]} +
    linear index of 16 kb window start voffsets."""

    def __init__(self, n_ref: int = 0):
        self.bins: list[dict[int, list[tuple[int, int]]]] = [
            defaultdict(list) for _ in range(n_ref)]
        self.linear: list[list[int]] = [[] for _ in range(n_ref)]
        self.n_no_coor = 0

    # -- query --------------------------------------------------------------

    def chunks_for_region(self, tid: int, beg: int, end: int):
        """Candidate (voffset_beg, voffset_end) chunks overlapping
        [beg, end), filtered by the linear index, merged and sorted."""
        if tid < 0 or tid >= len(self.bins):
            return []
        min_off = 0
        lin = self.linear[tid]
        w = beg >> LINEAR_SHIFT
        if lin:
            if w < len(lin):
                min_off = lin[w]
            else:
                min_off = lin[-1]
        chunks = []
        binmap = self.bins[tid]
        for b in reg2bins(beg, end):
            for cb, ce in binmap.get(b, ()):
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
        chunks.sort()
        # merge adjacent/overlapping
        merged = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
            else:
                merged.append((cb, ce))
        return merged

    # -- build --------------------------------------------------------------

    def add_record(self, tid: int, beg: int, end: int,
                   voff_beg: int, voff_end: int, mapped: bool = True) -> None:
        if tid < 0:
            self.n_no_coor += 1
            return
        b = reg2bin(beg, max(end, beg + 1))
        lst = self.bins[tid][b]
        if lst and lst[-1][1] == voff_beg:
            lst[-1] = (lst[-1][0], voff_end)
        else:
            lst.append((voff_beg, voff_end))
        lin = self.linear[tid]
        for w in range(beg >> LINEAR_SHIFT, (max(end, beg + 1) - 1 >> LINEAR_SHIFT) + 1):
            while len(lin) <= w:
                lin.append(0)
            if lin[w] == 0 or voff_beg < lin[w]:
                lin[w] = voff_beg

    # -- serialization ------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "wb") as fh:
            fh.write(BAI_MAGIC)
            fh.write(struct.pack("<i", len(self.bins)))
            for tid in range(len(self.bins)):
                binmap = self.bins[tid]
                fh.write(struct.pack("<i", len(binmap)))
                for b in sorted(binmap):
                    chunks = binmap[b]
                    fh.write(struct.pack("<Ii", b, len(chunks)))
                    for cb, ce in chunks:
                        fh.write(struct.pack("<QQ", cb, ce))
                lin = self.linear[tid]
                # fill zero entries with previous non-zero for seekability
                filled, prev = [], 0
                for v in lin:
                    prev = v if v else prev
                    filled.append(v if v else prev)
                fh.write(struct.pack("<i", len(filled)))
                for v in filled:
                    fh.write(struct.pack("<Q", v))
            fh.write(struct.pack("<Q", self.n_no_coor))

    @classmethod
    def load(cls, path: str) -> "BaiIndex":
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != BAI_MAGIC:
            raise ValueError("not a BAI file")
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off); off += 4
        idx = cls(n_ref)
        for tid in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off); off += 4
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", data, off); off += 8
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", data, off); off += 16
                    chunks.append((cb, ce))
                if b == 37450:  # pseudo-bin with meta data
                    continue
                idx.bins[tid][b] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off); off += 4
            idx.linear[tid] = list(
                struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
        if off + 8 <= len(data):
            (idx.n_no_coor,) = struct.unpack_from("<Q", data, off)
        return idx

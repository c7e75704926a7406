"""Columnar batch BAM reader (counterpart of seqlib_tpu/io/fast_bam.py).

BGZF inflate, the record boundary scan, field extraction and base
unpacking run in ``native/bamio.cpp``; Python sees columnar numpy arrays
per batch and builds a BamRecord only on demand (``BamBatch.record``).
``fetch_region`` answers a BAI region query the same way, keeping the
records with ``pos < end`` and ``pos + max(span, 1) > beg``, where span
is the reference the CIGAR consumes (``BamReader`` keeps
``position_end() > beg``: the two differ on records that consume no
reference).  A native library that cannot be built raises.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .. import native
from ..core.cigar import Cigar
from ..core.header import BamHeader
from ..core.record import BamRecord
from .bai import BaiIndex
from .bam import _decode_aux

CHUNK = 4 << 20  # compressed bytes per read


class BamBatch:
    """Columnar view over n decoded records."""

    def __init__(self, buf: np.ndarray, cols: dict, seq_blob, seq_starts):
        self.buf = buf
        self.cols = cols
        self.seq_blob = seq_blob
        self.seq_starts = seq_starts
        self.n = cols["tid"].size

    def __len__(self):
        return self.n

    # -- columnar accessors (vectorized) --------------------------------

    @property
    def tid(self): return self.cols["tid"]
    @property
    def pos(self): return self.cols["pos"]
    @property
    def flag(self): return self.cols["flag"]
    @property
    def mapq(self): return self.cols["mapq"]

    def sequences_nt4(self) -> tuple[np.ndarray, np.ndarray]:
        """(blob, starts) of the records' ASCII bases, for the aligner's
        encoder without per-record objects."""
        return self.seq_blob, self.seq_starts

    # -- record materialization ------------------------------------------

    def record(self, i: int) -> BamRecord:
        c = self.cols
        r = BamRecord()
        r.tid = int(c["tid"][i])
        r.pos = int(c["pos"][i])
        r.mapq = int(c["mapq"][i])
        r.flag = int(c["flag"][i])
        r.mtid = int(c["mtid"][i])
        r.mpos = int(c["mpos"][i])
        r.isize = int(c["isize"][i])
        qo, ql = int(c["qname_off"][i]), int(c["qname_len"][i])
        r.qname = self.buf[qo:qo + ql].tobytes().decode()
        nc = int(c["n_cigar"][i])
        if nc:
            co = int(c["cigar_off"][i])
            enc = np.frombuffer(self.buf, "<u4", nc, co)
            r.cigar = Cigar.from_bam_encoded(enc)
        L = int(c["lseq"][i])
        s0 = int(self.seq_starts[i])
        r.seq = self.seq_blob[s0:s0 + L].tobytes().decode()
        if L:
            qoff = int(c["qual_off"][i])
            qual = np.frombuffer(self.buf, np.uint8, L, qoff)
            r.qual = None if qual[0] == 0xFF else qual.copy()
        ao, al = int(c["aux_off"][i]), int(c["aux_len"][i])
        if al > 0:
            r.tags = _decode_aux(self.buf[ao:ao + al].tobytes(), 0)
        return r

    def __iter__(self):
        for i in range(self.n):
            yield self.record(i)


def fetch_region(path: str, tid: int, beg: int, end: int,
                 bai=None) -> BamBatch | None:
    """Columnar BAI region query: inflate only the compressed spans the
    index points at, scan them natively, and filter by overlap.

    beg/end are 0-based half-open.  Returns None when the region is
    empty or no index exists."""
    native.get_bamio_lib()
    if bai is None:
        bai_path = path + ".bai"
        if not os.path.exists(bai_path):
            return None
        bai = BaiIndex.load(bai_path)
    chunks = bai.chunks_for_region(tid, beg, end)
    if not chunks:
        return None
    # group chunks whose compressed gap is small into contiguous reads
    # (distant parent-bin chunks would otherwise drag one huge range)
    ranges: list[tuple[int, int, int]] = []   # (co_beg, co_end, within0)
    GAP = 1 << 16
    for cb, ce in chunks:
        co_b, w0, co_e = cb >> 16, cb & 0xFFFF, ce >> 16
        if ranges and co_b - ranges[-1][1] <= GAP:
            ranges[-1] = (ranges[-1][0], max(ranges[-1][1], co_e),
                          ranges[-1][2])
        else:
            ranges.append((co_b, co_e, w0))

    parts = []
    with open(path, "rb") as fh:
        for co_beg, co_end, within0 in ranges:
            fh.seek(co_beg)
            comp = fh.read(co_end - co_beg + (1 << 16))
            # trim to complete members
            p = 0
            while p + 18 <= len(comp):
                xlen = struct.unpack_from("<H", comp, p + 10)[0]
                xp, bsize = p + 12, None
                while xp + 4 <= p + 12 + xlen:
                    slen = struct.unpack_from("<H", comp, xp + 2)[0]
                    if comp[xp] == 66 and comp[xp + 1] == 67 and slen == 2:
                        bsize = struct.unpack_from("<H", comp, xp + 4)[0] + 1
                        break
                    xp += 4 + slen
                if bsize is None or p + bsize > len(comp):
                    break
                p += bsize
            if p == 0:
                continue
            buf = native.bgzf_inflate_all(comp[:p])
            if buf is None:
                continue
            view = buf[within0:]
            cap = int(view.size // 36 + 2)
            n, cols, _ = native.bam_scan_records(view, cap)
            if n == 0:
                continue
            spans = native.bam_ref_spans(view, cols["cigar_off"],
                                         cols["n_cigar"])
            rec_end = cols["pos"] + np.maximum(spans, 1)
            keep = (cols["tid"] == tid) & (cols["pos"] < end) \
                & (rec_end > beg)
            idx = np.flatnonzero(keep)
            if idx.size:
                parts.append((view, {k: v[idx] for k, v in cols.items()}))
    if not parts:
        return None
    if len(parts) == 1:
        view, sub = parts[0]
    else:
        # splice the views into one buffer, offsetting per-part offsets
        offs = np.cumsum([0] + [v.size for v, _ in parts])
        view = np.concatenate([v for v, _ in parts])
        subs = []
        for (v, c), off in zip(parts, offs[:-1]):
            c = dict(c)
            for key in ("qname_off", "cigar_off", "seq_off", "qual_off",
                        "aux_off", "offsets"):
                c[key] = c[key] + off
            subs.append(c)
        sub = {k: np.concatenate([c[k] for c in subs])
               for k in subs[0]}
    seq_blob, seq_starts = native.bam_unpack_seqs(
        view, sub["seq_off"], sub["lseq"])
    return BamBatch(view, sub, seq_blob, seq_starts)


class FastBamReader:
    """Streaming batch reader over ``native/bamio.cpp``."""

    def __init__(self, path: str):
        native.get_bamio_lib()
        self._fh = open(path, "rb")
        self._tail = np.empty(0, np.uint8)
        self._cursor = 0
        self.header = self._read_header()

    def _inflate_next(self) -> np.ndarray | None:
        data = self._fh.read(CHUNK)
        if not data:
            return None
        # BGZF members must not be split: backtrack to the last
        # complete member boundary by walking BSIZE fields
        p = 0
        last = 0
        while p + 18 <= len(data):
            xlen = struct.unpack_from("<H", data, p + 10)[0]
            xp, bsize = p + 12, None
            while xp + 4 <= p + 12 + xlen:
                si1, si2 = data[xp], data[xp + 1]
                slen = struct.unpack_from("<H", data, xp + 2)[0]
                if si1 == 66 and si2 == 67 and slen == 2:
                    bsize = struct.unpack_from("<H", data, xp + 4)[0] + 1
                    break
                xp += 4 + slen
            if bsize is None or p + bsize > len(data):
                break
            p += bsize
            last = p
        if last == 0:
            if len(data) < 28:
                return None  # trailing garbage shorter than EOF member
            raise ValueError("BGZF: no complete member in chunk")
        self._fh.seek(last - len(data), 1)
        out = native.bgzf_inflate_all(data[:last])
        if out is None:
            raise ValueError("BGZF inflate failed")
        return out

    def _read_header(self) -> BamHeader:
        buf = self._inflate_next()
        if buf is None or buf[:4].tobytes() != b"BAM\x01":
            raise ValueError("not a BAM file")
        (l_text,) = struct.unpack_from("<i", buf, 4)
        text = buf[8:8 + l_text].tobytes().split(b"\x00", 1)[0].decode()
        off = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", buf, off)
        off += 4
        seqs = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack_from("<i", buf, off)
            name = buf[off + 4:off + 4 + l_name - 1].tobytes().decode()
            (l_ref,) = struct.unpack_from("<i", buf, off + 4 + l_name)
            seqs.append((name, l_ref))
            off += 8 + l_name
        self._tail = buf[off:].copy()
        hdr = BamHeader(text) if text.strip() else BamHeader(seqs)
        if hdr.num_sequences() == 0 and seqs:
            hdr = BamHeader(seqs)
        return hdr

    def read_batch(self, max_records: int = 65536) -> BamBatch | None:
        """The next batch of at most ``max_records``, ``None`` at the end.
        The inflated buffer is consumed by advancing an offset: copying
        its tail per batch would be quadratic when a chunk inflates to
        many batches."""
        while True:
            view = self._tail[self._cursor:]
            n, cols, consumed = native.bam_scan_records(view, max_records)
            if n > 0:
                seq_blob, seq_starts = native.bam_unpack_seqs(
                    view, cols["seq_off"], cols["lseq"])
                batch = BamBatch(view, cols, seq_blob, seq_starts)
                self._cursor += consumed
                return batch
            nxt = self._inflate_next()
            if nxt is None:
                return None
            rest = self._tail[self._cursor:]
            self._tail = np.concatenate([rest, nxt]) if rest.size \
                else nxt
            self._cursor = 0

    def __iter__(self):
        while True:
            b = self.read_batch()
            if b is None:
                return
            yield from b

    def close(self):
        self._fh.close()

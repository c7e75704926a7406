"""SAM text codec, read and write (counterpart of seqlib_tpu/io/sam.py)."""

from __future__ import annotations

import numpy as np

from ..core.cigar import Cigar
from ..core.header import BamHeader
from ..core.record import BamRecord


def parse_sam_line(line: str, hdr: BamHeader) -> BamRecord:
    f = line.rstrip("\n").split("\t")
    rec = BamRecord()
    rec.qname = f[0] if f[0] != "*" else ""
    rec.flag = int(f[1])
    rec.tid = hdr.name2id(f[2]) if f[2] != "*" else -1
    rec.pos = int(f[3]) - 1
    rec.mapq = int(f[4])
    rec.cigar = Cigar(f[5]) if f[5] != "*" else Cigar()
    if f[6] == "=":
        rec.mtid = rec.tid
    elif f[6] == "*":
        rec.mtid = -1
    else:
        rec.mtid = hdr.name2id(f[6])
    rec.mpos = int(f[7]) - 1
    rec.isize = int(f[8])
    rec.seq = f[9] if f[9] != "*" else ""
    if f[10] != "*":
        rec.qual = (np.frombuffer(f[10].encode("latin1"), dtype=np.uint8)
                    - 33).astype(np.uint8)
    for tagf in f[11:]:
        tag, typ, val = tagf.split(":", 2)
        if typ == "i":
            rec.tags[tag] = ("i", int(val))
        elif typ == "f":
            rec.tags[tag] = ("f", float(val))
        elif typ == "B":
            sub = val[0]
            vals = val[2:].split(",") if len(val) > 1 else []
            conv = float if sub == "f" else int
            rec.tags[tag] = ("B", (sub, [conv(v) for v in vals]))
        else:
            rec.tags[tag] = (typ, val)
    return rec


def format_sam_line(rec: BamRecord, hdr: BamHeader) -> str:
    return rec.to_sam(hdr)

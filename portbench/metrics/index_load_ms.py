"""Milliseconds that set-up takes to load a cell's bwa index and put it
on the device, read from the port's tracer: the spans ``index.load``
(``FMIndex.load`` of bwa's files), ``index.upload``
(``DeviceFMIndex.from_host``: the checkpoint rows and the SA samples)
and ``index.upload_text`` (the aligner's 2L text), summed.

The probe repeats that part of set-up before the traced pass: with the
tracer on it loads the cell's cached files again and builds a
``BWAAligner`` on them, takes what the tracer recorded, and frees the
copy.  The children of ``index.load`` (``index.read_pac``,
``index.read_bwt``, ``index.layout``, ``index.read_sa``) and the bytes
put on the device (``index.occ_bytes``, ``index.sa_bytes``,
``index.text_bytes``) go to standard error.  A cell whose index is
built in memory has no files to load, and a program without these
spans gives nothing to read: the reader returns None then."""

from __future__ import annotations

import contextlib
import gc
import os

from . import _spans

SPANS = ("index.load", "index.upload", "index.upload_text")
CHILDREN = ("index.read_pac", "index.read_bwt", "index.layout",
            "index.read_sa")


class Probe:
    def __init__(self):
        self.rec = None         # the tracer's records of the load


def _load_again(cell):
    """The tracer's records of loading the cell's files and building an
    aligner on them."""
    import torch

    from seqlib_tpu_torch import profiling
    from seqlib_tpu_torch.align import AlignerOptions, BWAAligner
    from seqlib_tpu_torch.index import FMIndex

    from ..clients import se_stream

    prefix = os.path.join(se_stream.CACHE, cell.spec.config["name"],
                          str(cell.seed), "index")
    with profiling.tracing():
        index = FMIndex.load(prefix)
        aligner = BWAAligner(index, options=AlignerOptions(**cell.options),
                             device=cell.device)
    if cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)
    rec = profiling.take()
    del aligner, index
    gc.collect()
    return rec


@contextlib.contextmanager
def probe(cell):
    p = Probe()
    if cell.spec.traffic.get("index") == "loaded":
        p.rec = _load_again(cell)
    yield p


def read(ctx):
    rec = ctx.probes["index_load_ms"].rec
    if rec is None:
        return None
    ms = {}
    for s in rec.spans:
        ms[s.name] = ms.get(s.name, 0.0) + s.ms
    if "index.load" not in ms or "index.upload" not in ms:
        return None
    _spans.log("index_load_ms: " + ", ".join(
        f"{k} {ms[k]:.1f} ms" for k in SPANS + CHILDREN if k in ms)
        + "; bytes put on the device: " + (", ".join(
            f"{k} {v}" for k, v in sorted(rec.counters.items())
            if k.endswith("_bytes")) or "none"))
    return sum(ms.get(k, 0.0) for k in SPANS)

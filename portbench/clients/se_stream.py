"""Single-end reads streamed through ``BWAAligner.align_stream_bam``.

Set-up: the configuration's genome from the seed; the index, either
loaded (the port reads bwa's files with ``FMIndex.load``) or
constructed by the port in memory (``FMIndex.construct``, the full SA);
a pool of ``pool_batches`` batches of simulated reads; one warm-up
batch of the cell's shape.  The files of a loaded index are what ``bwa
index`` would have left on a user's disk (SA sampled every 32 ranks):
the reference builds its own index and writes them once per checkout
and seed into ``cache/<config>/<seed>/``, outside ``setup_s`` (a user
of a loaded index does not pay ``bwa index`` per run); the cache keeps
one seed per configuration.

The window: one client streams the pool, cycling, into
``align_stream_bam(batch_size, workers, sam=False)`` (a closed loop:
the stream takes a batch when it has room).  ``reads_per_s`` is the
reads whose records were yielded inside the window over the time from
its start to the last such yield.  The batches in flight when the
window closes are drained and checked, not counted.

The check: a sample of the yielded reads, drawn from the seed, aligned
again by the plain reference (its own index, bwa mem's classic per-read
path on the CPU: ``reference/``) and compared
record for record, byte for byte (a read answered with no record
differs).  ``failed`` adds the yielded reads outside the sample that
have no record."""

from __future__ import annotations

import collections
import gc
import os
import shutil
import time

import numpy as np
import torch

from seqlib_tpu_torch.align import AlignerOptions, BWAAligner
from seqlib_tpu_torch.index import FMIndex

from ..gen import genome as gen_genome
from ..gen import reads as gen_reads
from ..gen import stream
from ..reference import index as ref_index
from ..reference import records as ref_records

Read = collections.namedtuple("Read", "name seq")
CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cache")


def read_pool(traffic: dict, seed: int, contigs) -> list:
    """The mix's pool of reads (``pool_batches`` batches) from ``seed``."""
    n = int(traffic["pool_batches"]) * int(traffic["batch"])
    names, seqs = gen_reads.simulate_reads(contigs, n, stream(seed, 2),
                                           **traffic["reads"])
    return [Read(a, b) for a, b in zip(names, seqs)]


class Cell:
    def __init__(self, spec, seed: int, device, log, control=False):
        self.spec, self.seed, self.device, self.log = spec, seed, device, log
        cfg, tr = spec.config, spec.traffic
        self.batch = int(tr["batch"])
        self.workers = int(tr["workers"])
        self.options = dict(cfg.get("aligner", {}))
        parts = self.setup_parts = {}
        self.untimed = {}       # the reference's work inside set-up
        t = time.perf_counter()
        contigs = gen_genome.make_genome(cfg, seed)
        self.texts = [(n, gen_genome.as_text(c)) for n, c in contigs]
        parts["genome"] = time.perf_counter() - t

        t = time.perf_counter()
        self.pool = read_pool(tr, seed, contigs)
        del contigs
        parts["reads"] = time.perf_counter() - t

        self.ref = None
        on_card = device.type == "cuda"
        if control:
            # the check's control in the port's place (control.py)
            from ..control import ControlAligner
            t = time.perf_counter()
            self.ref = ref_index.build(self.texts)
            self.untimed["reference_index"] = time.perf_counter() - t
            self.aligner = ControlAligner(self.ref, self.options, device)
            self.index = None
        else:
            self._set_up_port(cfg, tr, parts, on_card)
        # what set-up made lives to the end: the collector need not walk it
        gc.collect()
        gc.freeze()
        self.kept = []          # (first pool index, payload, counts)
        self._next = 0          # the pool batch the stream takes next

    def _index_files(self, cfg) -> str:
        """The prefix of bwa's files of this configuration and seed,
        written by the reference unless a finished copy is cached."""
        top = os.path.join(CACHE, cfg["name"])
        here = os.path.join(top, str(self.seed))
        prefix = os.path.join(here, "index")
        t = time.perf_counter()
        if not os.path.exists(prefix + ".done"):
            if os.path.isdir(top):
                for old in os.listdir(top):
                    shutil.rmtree(os.path.join(top, old), ignore_errors=True)
            os.makedirs(here, exist_ok=True)
            self.ref = ref_index.build(self.texts)
            ref_index.write_bwa_files(self.ref, prefix)
            open(prefix + ".done", "w").close()
        self.untimed["bwa_index_files"] = time.perf_counter() - t
        return prefix

    def _set_up_port(self, cfg, tr, parts, on_card) -> None:
        device = self.device
        if tr["index"] == "loaded":
            prefix = self._index_files(cfg)
            if on_card:
                torch.cuda.init()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            t = time.perf_counter()
            self.index = FMIndex.load(prefix)
            parts["load"] = time.perf_counter() - t
        elif tr["index"] == "constructed":
            t = time.perf_counter()
            self.index = FMIndex.construct(self.texts)
            parts["construct"] = time.perf_counter() - t
        else:
            raise ValueError(f"unknown index mode {tr['index']!r}")

        t = time.perf_counter()
        self.aligner = BWAAligner(self.index,
                                  options=AlignerOptions(**self.options),
                                  device=device)
        for _ in self.aligner.align_stream_bam(
                iter(self.pool[:self.batch]), batch_size=self.batch,
                workers=self.workers, sam=False):
            pass
        if on_card:
            torch.cuda.synchronize(device)
        self.aligner.reset_stats()
        parts["aligner_and_warmup"] = time.perf_counter() - t

    # -- driving the stream ----------------------------------------------

    def _feed(self, stop):
        """The pool, cycled, a batch at a time, until ``stop()``."""
        nb = len(self.pool) // self.batch
        while not stop():
            b = self._next
            self._next = (b + 1) % nb
            yield from self.pool[b * self.batch:(b + 1) * self.batch]

    def _keep(self, chunk, payload, counts) -> None:
        first = int(chunk[0].name[1:].split("_", 1)[0])
        if len(chunk) != self.batch or len(counts) != len(chunk) \
                or first % self.batch:
            raise RuntimeError(f"the stream yielded a batch of {len(chunk)}"
                               f" reads with {len(counts)} counts")
        self.kept.append((first, payload, np.asarray(counts)))

    def window(self, seconds: float) -> dict:
        """The measured window: {"reads_per_s": ...}."""
        done = [False]
        gaps = []
        t0 = time.perf_counter()
        n_in, t_last = 0, t0
        for chunk, payload, counts in self.aligner.align_stream_bam(
                self._feed(lambda: done[0]), batch_size=self.batch,
                workers=self.workers, sam=False):
            t = time.perf_counter()
            self._keep(chunk, payload, counts)
            if t - t0 <= seconds:
                n_in += len(chunk)
                gaps.append(t - t_last)
                t_last = t
            else:
                done[0] = True
        if n_in == 0:
            raise RuntimeError(f"no batch finished inside {seconds} s")
        q = np.quantile(gaps[1:], [0, 0.25, 0.5, 0.75, 1]) if len(gaps) > 1 \
            else []
        self.log(f"window: {n_in} reads in {t_last - t0:.3f} s, first yield "
                 f"at {gaps[0]:.3f} s, then yields every (min, quartiles, "
                 f"max) {', '.join(f'{x:.3f}' for x in q)} s; "
                 f"{len(self.kept)} batches yielded with the drain; "
                 f"stats {self.aligner.stats}")
        return {"reads_per_s": n_in / (t_last - t0)}

    def run_batches(self, n: int) -> None:
        """Exactly ``n`` batches through the stream (traced passes)."""
        fed = [0]

        def stop():
            fed[0] += 1
            return fed[0] > n

        for chunk, payload, counts in self.aligner.align_stream_bam(
                self._feed(stop), batch_size=self.batch,
                workers=self.workers, sam=False):
            self._keep(chunk, payload, counts)

    # -- after the window ------------------------------------------------

    def release(self) -> None:
        """Free the port's state (its index on the card)."""
        self.aligner = None
        self.index = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self):
        """The reference's own index (built now for a constructed one)."""
        if self.ref is None:
            self.ref = ref_index.build(self.texts)
        return self.ref

    def check(self):
        """({name: (value, limit)}, attempted, failed)."""
        tr = self.spec.traffic
        counts = np.concatenate([c for _, _, c in self.kept])
        attempted = int(counts.size)
        unanswered = int((counts == 0).sum())
        rng = stream(self.seed, 4)
        pick = np.sort(rng.choice(attempted, min(int(tr["check_reads"]),
                                                 attempted), replace=False))
        got, pool_ids = [], []
        for k, (first, payload, cnt) in enumerate(self.kept):
            js = pick[(pick >= k * self.batch)
                      & (pick < (k + 1) * self.batch)] - k * self.batch
            if js.size == 0:
                continue
            recs = ref_records.split_payload(payload, cnt, js)
            for j in js.tolist():
                got.append(recs[j])
                pool_ids.append(first + j)
        uniq = sorted(set(pool_ids))
        t = time.perf_counter()
        ref = self.reference()
        t_idx = time.perf_counter() - t
        t = time.perf_counter()
        want_u = ref_records.reference_records(
            ref, [self.pool[i].name for i in uniq],
            [self.pool[i].seq for i in uniq], self.options)
        at = {p: i for i, p in enumerate(uniq)}
        want = [want_u[at[p]] for p in pool_ids]
        differ, first_bad = ref_records.compare(got, want)
        names = [n for n, _ in self.texts]
        placed = gen_reads.placement_rate(
            [(d["qname"], d["flag"], d["contig"], d["pos"]) for d in
             (ref_records.decode(r, names) for rs in got for r in rs)])
        self.log(f"reference: {len(uniq)} reads in "
                 f"{time.perf_counter() - t:.1f} s (its index "
                 f"{t_idx:.1f} s); placed within 5 bp {placed[0]} of "
                 f"{placed[1]} sampled primaries")
        if first_bad >= 0:
            for side, recs in (("port", got[first_bad]),
                               ("reference", want[first_bad])):
                self.log(f"first differing read, {side}: " + "; ".join(
                    str({k: v for k, v in ref_records.decode(
                        r, names).items() if k != "tags"}) for r in recs))
        self.log(f"reads answered with no record: {unanswered} of "
                 f"{attempted}")
        empty_sampled = sum(1 for g in got if not g)
        return {"reads_differing": (differ, 0)}, attempted, \
            differ + unanswered - empty_sampled

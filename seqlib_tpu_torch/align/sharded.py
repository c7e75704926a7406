"""Aligner over a sharded index (counterpart of seqlib_tpu/align/sharded.py).

``ShardedBWAAligner`` runs stage 1 (seed, locate, chain, extend:
``device_pipeline.seed_chain_extend``) once per shard of a
:class:`~seqlib_tpu_torch.index.ShardedFMIndex`, each shard on its own
sub-aligner, then merges the regions of every shard into one list per
read before dedup, primary marking and MAPQ, so a read's records have
whole-reference semantics: its best hit wins whichever shard holds it,
and secondaries across shards are marked and filtered together.

Cross-shard overlap tests use global pseudo-2L keys: a forward-strand
region maps to [0, G) (G the total forward length) by its shard's
forward offset, a reverse-strand one to [G, 2G) through the mirror
``2 * l_pac - coord``, clamped to the shard's own strand range
(``_global_key``).  rb/re stay shard-local: they index that shard's
text for the global DP.  Each region takes the largest repeat fraction
any shard reported for its read; records get their shard's contig-id
offset, and NA counts the read's regions across shards.

Sub-aligners are placed round-robin over ``devices`` (torch devices;
default one CUDA device): shard s on ``devices[s % len(devices)]``.
Stage 1 (``_dispatch_stage1``) and the global DP (``_regions_to_hits``)
run each entry of ``devices`` on a host thread of its own, under its
device's guard, all at once (``device.run_on_devices``); the shards of
one entry run in shard order.  The records equal a run of the shards
one after another.  A sharded aligner has no fused program and
no single 2L text: every entry point goes through the classic path
(``_collect_regions``, ``_regions_to_hits``, the object API), long
reads included, and paired alignment sets flags and mates only, as in
the JAX package.
"""

from __future__ import annotations

import collections
import threading

import numpy as np

from ..device import resolve_device, run_on_devices
from ..index.sharded import ShardedFMIndex
from .aligner import AlnReg, BWAAligner, _merge_cols, _take_cols
from .options import AlignerOptions

_Read = collections.namedtuple("_Read", "name seq")


class ShardedBWAAligner(BWAAligner):
    """BWAAligner over a ShardedFMIndex: the same entry points and
    records, with region generation fanned out over the shards and the
    regions merged."""

    def __init__(self, index: ShardedFMIndex,
                 options: AlignerOptions | None = None,
                 devices: list | None = None):
        # no single device index or text: BWAAligner.__init__ is not run
        self.index = index
        self.options = options or AlignerOptions()
        self.devices = [resolve_device(d) for d in (devices or ["cuda"])]
        self.device = self.devices[0]
        self._copy_comment = False
        self.stats = dict(seeds_at_cap=0, occ_clipped=0, chains_at_cap=0,
                          regs_truncated=0, regions_widened=0,
                          regions_dropped_wide=0)
        self._stats_lock = threading.Lock()
        self.subs = [BWAAligner(fmi, self.options,
                                device=self.devices[s % len(self.devices)])
                     for s, fmi in enumerate(index.shards)]
        self._names = [index.chr_id_to_name(i)
                       for i in range(index.num_sequences())]
        self._ref_blob_cache = None
        self._fwd_off = []
        g = 0
        for sub in self.subs:
            self._fwd_off.append(g)
            g += sub.index.l_pac
        self._g_total = g

    # ------------------------------------------------------------------

    def _per_shard(self, fn) -> list:
        """``fn(s, sub)`` for every shard: each entry of ``devices`` on a
        host thread of its own, its shards in order, all entries at once;
        the results in shard order."""
        n = len(self.devices)
        slots = range(min(n, len(self.subs)))
        groups = [(self.devices[k],
                   [(lambda s=s: fn(s, self.subs[s]))
                    for s in range(k, len(self.subs), n)]) for k in slots]
        out: list = [None] * len(self.subs)
        for k, res in zip(slots, run_on_devices(groups)):
            out[k::n] = res
        return out

    def _dispatch_stage1(self, enc: np.ndarray, lens: np.ndarray) -> list:
        """Stage 1 on every shard, each on its sub-aligner's device, the
        devices at once."""
        return self._per_shard(lambda s, sub: sub._dispatch_stage1(enc, lens))

    def _dispatch_full(self, enc: np.ndarray, lens: np.ndarray) -> list:
        return self._dispatch_stage1(enc, lens)

    def _hits_cols_from_full(self, enc, lens, res):
        """No columnar hits: records go through the object API."""
        return None

    def _global_key(self, sub_idx: int, r: AlnReg) -> tuple[int, int]:
        # clamped to the shard's own strand range, so a region across the
        # forward/reverse midpoint (dropped later at the contig-boundary
        # test) cannot reach another shard's keys and mask a region there
        lp = self.subs[sub_idx].index.l_pac
        off = self._fwd_off[sub_idx]
        if r.rb >= lp:
            re_c = min(r.re, 2 * lp)
            return (self._g_total + off + (2 * lp - re_c),
                    self._g_total + off + (2 * lp - r.rb))
        return off + r.rb, off + min(r.re, lp)

    def _collect_regions(self, enc: np.ndarray, lens: np.ndarray,
                         dedup: bool = True, stage1: list | None = None
                         ) -> list[list[AlnReg]]:
        """Every shard's regions of each read, merged; deduped and
        primary-marked on the global keys."""
        B = enc.shape[0]
        if stage1 is None:
            stage1 = self._dispatch_stage1(enc, lens)
        regions: list[list[AlnReg]] = [[] for _ in range(B)]
        frac_rep = np.zeros(B)
        for s, (sub, s1) in enumerate(zip(self.subs, stage1)):
            per = sub._collect_regions(enc, lens, dedup=False, stage1=s1)
            for b in range(B):
                for r in per[b]:
                    r.shard = s
                    r.gb, r.ge = self._global_key(s, r)
                    regions[b].append(r)
                    frac_rep[b] = max(frac_rep[b], r.frac_rep)
        if dedup:
            for b in range(B):
                for r in regions[b]:
                    r.frac_rep = frac_rep[b]
                regions[b] = self._dedup_and_mark(
                    regions[b], key=lambda r: (r.gb, r.ge))
        return regions

    def _regions_to_hits(self, enc, lens, regions):
        """Each shard's global DP and columnar hits of its own regions,
        merged: contig ids offset to the global numbering, NA counting
        every shard's regions, each read's hits in shard order."""
        parts = self._per_shard(lambda s, sub: sub._regions_to_hits(
            enc, lens, [[r for r in rs if r.shard == s] for rs in regions]))
        for s, cols in enumerate(parts):
            cols["rid"] = cols["rid"] + self.index.first_rid[s]
        cols = _merge_cols(parts)
        cols = _take_cols(cols, np.argsort(cols["read_idx"], kind="stable"))
        cols["n_regs"] = np.array([len(rs) for rs in regions],
                                  np.int32)[cols["read_idx"]]
        return cols

    def _finish_batch(self, chunk, enc, lens, res, hardclip,
                      keep_sec_frac, max_secondary):
        """Yields (read, records) for each read of ``chunk`` from the
        shards' stage-1 results ``res``."""
        regions = self._collect_regions(enc, lens, stage1=res)[:len(chunk)]
        if keep_sec_frac < 0.0 or keep_sec_frac > 1.0:
            regions = [[r for r in rs if r.secondary < 0] for rs in regions]
        hits = self._cols_to_hit_dicts(
            self._regions_to_hits(enc, lens, regions), len(regions))
        for b, r in enumerate(chunk):
            yield r, self._assemble_records(r.seq, r.name, hits[b], hardclip,
                                            keep_sec_frac, max_secondary)

    def align_batch(self, seqs: list[str], names: list[str],
                    hardclip: bool = False, keep_sec_frac: float = 0.9,
                    max_secondary: int = 10):
        """Per-read BamRecord lists, as ``BWAAligner.align_batch`` (every
        read length through the classic path)."""
        if not seqs:
            return []
        chunk = [_Read(n, s) for n, s in zip(names, seqs)]
        enc, lens = self._encode_batch(seqs)
        return [recs for _, recs in self._finish_batch(
            chunk, enc, lens, self._dispatch_stage1(enc, lens), hardclip,
            keep_sec_frac, max_secondary)]

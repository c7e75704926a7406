"""String-graph (overlap) assembly into unitigs (counterpart of
seqlib_tpu/assembly/fermi.py).

Reads -> error correction (BFC) -> the k-mer read filter (on the
device, ``ops/kmer.py``) -> suffix/prefix overlap detection (sort-join
on seed keys, host numpy) -> best-overlap string graph -> non-branching
path merge -> unitigs with per-base coverage, and GFA 1.0 export.
API parity: SeqLib/SeqLib/FermiAssembler.h:20-149 (option
setters, AddRead(s), CorrectReads, PerformAssembly, DirectAssemble,
WriteGFA).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import torch

from ..core.seq import decode_nt4, encode_nt4, revcomp
from ..core.unaligned import UnalignedSequence
from ..device import resolve_device
from ..ops.kmer import (canonical_kmers_device, count_kmers_device,
                        weak_reads_device)
from . import sgraph
from .bfc import BFC, auto_kmer, canonical_kmers, encode_reads
from .overlap import find_overlaps


@dataclass
class AssemblyOptions:
    """fml_opt_t analog (defaults mirror fml_opt_init)."""
    min_asm_ovlp: int = 33
    min_merge_len: int = 0
    ec_k: int = 0               # 0 = auto
    min_cnt: int = 4
    max_cnt: int = 8
    n_threads: int = 1
    # mag_opt (fermi-lite magopt_init defaults)
    aggressive: bool = False
    simplify_bubble: bool = True
    min_dratio1: float = 0.7
    min_elen: int = 300
    min_ensr: int = 4          # min supporting reads, end-unitig
    min_insr: int = 3          # min supporting reads, internal


@dataclass
class Unitig:
    """fml_utg_t analog; links mirror fml_ovlp_t entries (populated
    from the final unitig graph, not by re-scanning sequences)."""
    seq: str
    nsr: int                    # number of supporting reads
    cov: str                    # per-base coverage, ASCII 33-based
    links: list[tuple[int, str, int, str, int]] = field(
        default_factory=list)   # (from, fromo, to, too, ovlp)


class FermiAssembler:
    """API parity: SeqLib/SeqLib/FermiAssembler.h:20-149.  The
    k-mer stages run on ``device`` ("cuda" by default; "cpu" runs the
    plain PyTorch path)."""

    def __init__(self, opt: AssemblyOptions | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.opt = opt or AssemblyOptions()
        self.m_seqs: list[str] = []
        self.m_quals: list[str] = []
        self.m_names: list[str] = []
        self.m_utgs: list[Unitig] = []

    # -- reads ----------------------------------------------------------

    def add_read(self, r) -> None:
        """UnalignedSequence or BamRecord
        (parity: AddRead FermiAssembler.cpp:41-87)."""
        if isinstance(r, UnalignedSequence):
            if not r.seq:
                raise ValueError("FermiAssembler: empty sequence")
            self.m_seqs.append(r.seq.upper())
            self.m_quals.append(r.qual)
            self.m_names.append(r.name)
        else:  # BamRecord
            self.m_seqs.append(r.seq.upper())
            self.m_quals.append(r.qualities())
            self.m_names.append(r.qname)

    def add_reads(self, rs) -> None:
        for r in rs:
            self.add_read(r)

    def num_sequences(self) -> int:
        return len(self.m_seqs)

    def clear_reads(self) -> None:
        self.m_seqs = []
        self.m_quals = []
        self.m_names = []

    def clear_contigs(self) -> None:
        self.m_utgs = []

    def get_sequences(self):
        return [UnalignedSequence(n, s, q) for n, s, q in
                zip(self.m_names, self.m_seqs, self.m_quals)]

    # -- option setters (FermiAssembler.h:78-103) ------------------------

    def set_min_overlap(self, m: int) -> None:
        self.opt.min_asm_ovlp = int(m)

    def get_min_overlap(self) -> int:
        return self.opt.min_asm_ovlp

    def set_aggressive_trim(self) -> None:
        self.opt.aggressive = True

    def set_simplify_bubble(self) -> None:
        self.opt.simplify_bubble = True

    def set_drop_overlap_ratio(self, ratio: float) -> None:
        self.opt.min_dratio1 = ratio

    def set_kmer_min_threshold(self, v: int) -> None:
        self.opt.min_cnt = v

    def set_kmer_max_threshold(self, v: int) -> None:
        self.opt.max_cnt = v

    # -- correction ------------------------------------------------------

    def correct_reads(self) -> None:
        """(parity: CorrectReads -> fml_correct).  The trained k-mer
        table is cached for the assembly's read filter so a
        CorrectReads -> PerformAssembly flow counts k-mers once."""
        bfc = BFC(device=self.device)
        if self.opt.ec_k:
            bfc.set_kmer(self.opt.ec_k)
        for s, q, n in zip(self.m_seqs, self.m_quals, self.m_names):
            bfc.add_sequence(s, q, n)
        bfc.train()
        bfc.error_correct()
        self.m_seqs = list(bfc.m_seqs)
        # retraining on the corrected reads keeps the cached table
        # consistent with what _kmer_filter would compute
        bfc.train()
        self._flt_cache = (hash(tuple(self.m_seqs)), bfc._dev, bfc.kmer)

    def correct_and_filter_reads(self) -> None:
        """(parity: CorrectAndFilterReads -> fml_fltuniq): correct, then
        drop reads containing k-mers seen only once."""
        self.correct_reads()
        bfc = BFC(device=self.device)
        for s in self.m_seqs:
            bfc.add_sequence(s)
        bfc.train()
        k = bfc.kmer
        keep = []
        for i, s in enumerate(self.m_seqs):
            if len(s) < k:
                continue
            cnt = bfc.table.lookup(canonical_kmers(encode_nt4(s), k))
            if (cnt >= 2).all():
                keep.append(i)
        self.m_seqs = [self.m_seqs[i] for i in keep]
        self.m_quals = [self.m_quals[i] for i in keep]
        self.m_names = [self.m_names[i] for i in keep]

    # -- assembly --------------------------------------------------------

    def perform_assembly(self) -> None:
        """(parity: PerformAssembly -> fml_assemble)"""
        self.m_utgs = self._assemble(self.m_seqs)

    def direct_assemble(self, kcov: float = 0.0) -> None:
        """Assembly without correction (parity: DirectAssemble
        FermiAssembler.cpp:24-39: min_ensr = max(min_ensr,
        kcov * MAG_MIN_NSR_COEF), min_insr = min_ensr - 1)."""
        old = (self.opt.min_ensr, self.opt.min_insr)
        if kcov > 0:
            self.opt.min_ensr = max(self.opt.min_ensr,
                                    int(kcov * 0.1 + 0.499))
            self.opt.min_insr = self.opt.min_ensr - 1
        self.m_utgs = self._assemble(self.m_seqs)
        self.opt.min_ensr, self.opt.min_insr = old

    def get_contigs(self) -> list[str]:
        return [u.seq for u in self.m_utgs]

    def get_unitigs(self) -> list[Unitig]:
        return self.m_utgs

    # -- core overlap assembler -----------------------------------------

    def _kmer_filter(self, seqs: list[str]) -> list[str]:
        """fml_assemble's pre-graph uniq-kmer read filter: drop reads
        carrying k-mers below threshold (errors make graph bubbles).
        Counting + lookup run on the device (ops/kmer.py); a table
        cached by ``correct_reads`` for these reads is used as is."""
        if len(seqs) <= 50:
            return seqs
        total = sum(len(x) for x in seqs)
        k = self.opt.ec_k or auto_kmer(total)
        cache = getattr(self, "_flt_cache", None)
        cached_dev = None
        if cache is not None and cache[0] == hash(tuple(seqs)):
            cached_dev, k = cache[1], cache[2]
        reads_np, lens_np = encode_reads(seqs)
        rj = torch.from_numpy(reads_np).to(self.device)
        lj = torch.from_numpy(lens_np).to(self.device)
        if cached_dev is not None:
            keys, cnt = cached_dev
        else:
            keys, cnt = count_kmers_device(
                *canonical_kmers_device(rj, lj, k))
        thr = max(2, min(3, self.opt.min_cnt - 1))
        weak = weak_reads_device(rj, lj, keys, cnt, k, thr).cpu().numpy()
        ok = ~weak & (lens_np >= k)
        kept = [seqs[i] for i in np.flatnonzero(ok)]
        return kept if len(kept) >= 0.5 * len(seqs) else seqs

    def _assemble(self, seqs: list[str], flt_uniq: bool = True
                  ) -> list[Unitig]:
        """reads -> unitigs: sort-join overlap detection
        (assembly/overlap.py), reciprocal drop-ratio pruning,
        transitive reduction, chain condensation, and mag-style
        tip/bubble cleaning rounds (assembly/sgraph.py) — the roles of
        fml_fmi2mag / fml_mag_clean / fml_mag2utg
        (SeqLib/src/FermiAssembler.cpp:24-39)."""
        opt = self.opt
        min_ovlp = opt.min_asm_ovlp
        if flt_uniq:
            seqs = self._kmer_filter(seqs)
        # dedup with multiplicity in CANONICAL orientation (a read and
        # its reverse complement are the same molecule — fermi's FMD
        # index is strand-symmetric); drop reads too short or with Ns
        counts: dict[str, int] = {}
        for x in seqs:
            if len(x) >= min_ovlp + 1 and "N" not in x:
                key = min(x, revcomp(x))
                counts[key] = counts.get(key, 0) + 1
        uniq = sorted(counts)                  # deterministic
        U = len(uniq)
        if U == 0:
            return []
        # oriented nodes: 2u = fwd, 2u+1 = rc
        N = 2 * U
        L = max(len(x) for x in uniq)
        codes = np.full((N, L), 4, np.uint8)
        lens = np.zeros(N, np.int64)
        mult = np.zeros(N, np.int64)
        for u, x in enumerate(uniq):
            e = encode_nt4(x)
            codes[2 * u, :e.size] = e
            codes[2 * u + 1, :e.size] = 3 - e[::-1]
            lens[2 * u] = lens[2 * u + 1] = e.size
            mult[2 * u] = mult[2 * u + 1] = counts[x]

        src, dst, olen, contained = find_overlaps(codes, lens, min_ovlp)
        alive = ~(contained | contained[np.arange(N) ^ 1])
        keep_e = alive[src] & alive[dst]
        src, dst, olen = src[keep_e], dst[keep_e], olen[keep_e]
        src, dst, olen = sgraph.prune_edges(
            src, dst, olen, N, opt.min_dratio1)
        keep = sgraph.transitive_reduction(src, dst, olen, lens)
        src, dst, olen = src[keep], dst[keep], olen[keep]

        seq_list = [codes[v, :lens[v]] for v in range(N)]
        cov_list = [np.full(int(lens[v]), mult[v], np.int32)
                    for v in range(N)]
        nsr_list = [int(mult[v]) for v in range(N)]
        twin = np.arange(N) ^ 1
        utgs, usrc, udst, uolen = sgraph.condense(
            N, seq_list, cov_list, nsr_list,
            src.astype(np.int64), dst.astype(np.int64),
            olen.astype(np.int64), alive, twin)
        for _ in range(3):
            changed = sgraph.clean_unitigs(
                utgs, usrc, udst, uolen,
                min_elen=opt.min_elen, min_ensr=opt.min_ensr,
                min_insr=opt.min_insr,
                simplify_bubble=opt.simplify_bubble,
                aggressive=opt.aggressive)
            if not changed:
                break
            seq2, cov2, nsr2, s2, d2, o2, tw2 = sgraph.reexpand(
                utgs, usrc, udst, uolen)
            utgs, usrc, udst, uolen = sgraph.condense(
                len(seq2), seq2, cov2, nsr2, s2, d2, o2,
                np.ones(len(seq2), bool), np.asarray(tw2, np.int64))

        # emit canonical unitigs (each rc pair once, deterministic)
        live = [i for i, u in enumerate(utgs) if u.alive]
        emit: dict[int, tuple[int, str]] = {}    # utg id -> (idx, orient)
        out: list[Unitig] = []
        seen: dict[bytes, int] = {}
        order = sorted(live, key=lambda i: (-len(utgs[i].seq),
                                            utgs[i].seq.tobytes()))
        for i in order:
            u = utgs[i]
            fwd = u.seq.tobytes()
            rc = (3 - u.seq[::-1]).tobytes()
            key = min(fwd, rc)
            if key in seen:
                emit[i] = (seen[key], "+" if fwd <= rc else "-")
                continue
            idx = len(out)
            seen[key] = idx
            emit[i] = (idx, "+")
            out.append(Unitig(
                seq=decode_nt4(u.seq), nsr=u.nsr,
                cov="".join(chr(min(int(c), 92) + 33) for c in u.cov)))
        # links from the final unitig graph (fml_ovlp_t analog)
        for a, b, o in zip(usrc.tolist(), udst.tolist(),
                           uolen.tolist()):
            if a not in emit or b not in emit:
                continue
            ia, oa = emit[a]
            ib, ob = emit[b]
            out[ia].links.append((ia, oa, ib, ob, int(o)))
        return out

    # -- GFA export (parity: WriteGFA FermiAssembler.h:120-140) ----------

    def write_gfa(self, out) -> None:
        """Reference-format GFA 1.0: S lines with LN/RC/PD tags; L
        lines from the unitig graph's overlap records (printed once per
        edge pair, from < to, like the reference's loop)."""
        out.write("H\tVN:Z:1.0\n")
        for i, u in enumerate(self.m_utgs):
            out.write(f"S\t{i}\t{u.seq}\tLN:i:{len(u.seq)}\t"
                      f"RC:i:{u.nsr}\tPD:Z:{u.cov}\n")
            for fr, fo, to, too, o in u.links:
                if fr < to:
                    out.write(f"L\t{fr}\t{fo}\t{to}\t{too}\t{o}M\n")

    # reference-style aliases
    AddRead = add_read
    AddReads = add_reads
    ClearReads = clear_reads
    ClearContigs = clear_contigs
    CorrectReads = correct_reads
    CorrectAndFilterReads = correct_and_filter_reads
    PerformAssembly = perform_assembly
    DirectAssemble = direct_assemble
    GetContigs = get_contigs
    GetSequences = get_sequences
    NumSequences = num_sequences
    SetMinOverlap = set_min_overlap
    GetMinOverlap = get_min_overlap
    SetAggressiveTrim = set_aggressive_trim
    SetSimplifyBubble = set_simplify_bubble
    SetDropOverlapRatio = set_drop_overlap_ratio
    SetKmerMinThreshold = set_kmer_min_threshold
    SetKmerMaxThreshold = set_kmer_max_threshold
    WriteGFA = write_gfa

# Frozen copy of seqlib_tpu_torch/align/options.py for the benchmark's reference
# (plain PyTorch path only): later changes to the port do not reach it.
"""Aligner scoring options, bwa's mem_opt_t (counterpart of
seqlib_tpu/align/options.py): ``mem_opt_init`` defaults and the
validated setters, including ``set_a_score``'s rescaling of every
penalty.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class AlignerOptions:
    # scoring (bwa mem_opt_init defaults)
    a: int = 1                 # match score
    b: int = 4                 # mismatch penalty
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    # NOTE: the reference mem_opt_t also carries pen_unpaired and
    # max_matesw, but its library surface is single-end only
    # (alignSequence, BWAAligner.cpp:89-252 — mem_align1, never
    # mem_sam_pe), so paired-scoring knobs are unreachable there; we
    # omit them rather than expose dead options.  Our paired-end CLI
    # path scores pairs by proper-orientation rescue, not bwa's
    # mate-SW.
    pen_clip5: int = 5
    pen_clip3: int = 5
    w: int = 100               # band width
    zdrop: int = 100
    T: int = 30                # minimum output score
    # seeding / chaining
    min_seed_len: int = 19
    split_factor: float = 1.5  # reseed trigger
    split_width: int = 10
    max_occ: int = 500
    max_mem_intv: int = 20     # 3rd-pass seeding (bwt_seed_strategy1); 0 off
    max_chain_gap: int = 10000
    min_chain_weight: int = 0
    max_chain_extend: int = 1 << 30
    mask_level: float = 0.50
    drop_ratio: float = 0.50
    XA_drop_ratio: float = 0.80
    max_XA_hits: int = 5       # bwa mem_opt_init; XA omitted beyond this
    mask_level_redun: float = 0.95
    mapQ_coef_len: int = 50
    # behavior flags
    softclip_all: bool = True  # MEM_F_SOFTCLIP set by the reference ctor

    @property
    def mapQ_coef_fac(self) -> float:
        return math.log(self.mapQ_coef_len)

    @property
    def split_len(self) -> int:
        """Re-seed length trigger: round(min_seed_len * split_factor)
        — bwa mem_collect_intv's split_len."""
        return int(self.min_seed_len * self.split_factor + 0.499)

    # -- setters (parity: BWAAligner.cpp:14-87) -----------------------------

    def set_gap_open(self, gap_open: int) -> None:
        if gap_open < 0:
            raise ValueError("SetGapOpen: gap_open must be >= 0")
        self.o_ins = self.o_del = gap_open

    def set_gap_extension(self, gap_ext: int) -> None:
        if gap_ext < 0:
            raise ValueError("SetGapExtension: gap_ext must be >= 0")
        self.e_ins = self.e_del = gap_ext

    def set_mismatch_penalty(self, mismatch: int) -> None:
        if mismatch < 0:
            raise ValueError("SetMismatchPenalty: mismatch must be >= 0")
        self.b = mismatch

    def set_zdropoff(self, zdrop: int) -> None:
        if zdrop < 0:
            raise ValueError("SetZDropoff: zdrop must be >= 0")
        self.zdrop = zdrop

    def set_a_score(self, a: int) -> None:
        """Scale every penalty by a (parity: SetAScore
        BWAAligner.cpp:44-59)."""
        if a < 0:
            raise ValueError("SetAScore: a must be >= 0")
        self.a = a
        self.b *= a
        self.T *= a
        self.o_ins *= a
        self.o_del *= a
        self.e_ins *= a
        self.e_del *= a
        self.zdrop *= a
        self.pen_clip5 *= a
        self.pen_clip3 *= a

    def set_3prime_clipping_penalty(self, p: int) -> None:
        if p < 0:
            raise ValueError("Set3primeClippingPenalty: penalty must be >= 0")
        self.pen_clip3 = p

    def set_5prime_clipping_penalty(self, p: int) -> None:
        if p < 0:
            raise ValueError("Set5primeClippingPenalty: penalty must be >= 0")
        self.pen_clip5 = p

    def set_bandwidth(self, bw: int) -> None:
        if bw < 0:
            raise ValueError("SetBandwidth: bandwidth must be >= 0")
        self.w = bw

    def set_reseed_trigger(self, t: float) -> None:
        if t < 0:
            raise ValueError("SetReseedTrigger: trigger must be >= 0")
        self.split_factor = t

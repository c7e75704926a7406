"""Read filtering engine with the JSON filter-script DSL (counterpart
of seqlib_tpu/filters/readfilter.py).

SeqLib's four-level hierarchy: ``Flag`` (on/off/NA tri-state) ->
``FlagRule`` (16 named flags + all/any masks) -> ``AbstractRule``
(Range filters + read group + subsample + motif) -> ``ReadFilter``
(rule list + region) -> ``ReadFilterCollection`` (include/exclude
regions, global rule inheritance), with SeqLib's JSON keys.  A
``ReadFilter`` passes a read on its first passing rule and counts it
there, so the counters depend on the rules' order.
"""

from __future__ import annotations

import copy
import json
import os

from ..core.record import (BamRecord, FRORIENTATION, FFORIENTATION,
                           RFORIENTATION, RRORIENTATION)
from ..core.region import GenomicRegion
from ..core.header import BamHeader
from ..intervals.collection import GRC
from .ahocorasick import AhoCorasick

INT_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# hashing (khash's, for subsampling)
# ---------------------------------------------------------------------------

def x31_hash(s: str) -> int:
    h = 0
    for ch in s:
        h = ((h << 5) - h + ord(ch)) & 0xFFFFFFFF
    return h


def wang_hash(key: int) -> int:
    key = (key + (~(key << 15) & 0xFFFFFFFF)) & 0xFFFFFFFF
    key ^= key >> 10
    key = (key + ((key << 3) & 0xFFFFFFFF)) & 0xFFFFFFFF
    key ^= key >> 6
    key = (key + (~(key << 11) & 0xFFFFFFFF)) & 0xFFFFFFFF
    key ^= key >> 16
    return key & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Flag / Range
# ---------------------------------------------------------------------------

class Flag:
    """Tri-state flag requirement."""

    __slots__ = ("on", "off", "na")

    def __init__(self):
        self.on = False
        self.off = False
        self.na = True

    def set_na(self): self.on = self.off = False; self.na = True
    def set_on(self): self.on, self.off, self.na = True, False, False
    def set_off(self): self.on, self.off, self.na = False, True, False
    def is_na(self): return self.na
    def is_on(self): return self.on
    def is_off(self): return self.off

    def parse_json(self, value: dict, name: str) -> bool:
        if name in value:
            self.set_on() if bool(value[name]) else self.set_off()
            return True
        return False


class Range:
    """[min, max] requirement, invertible."""

    def __init__(self, mn: int = 0, mx: int = 0, inverted: bool = False,
                 every: bool = True):
        self.min = mn
        self.max = mx
        self.inverted = inverted
        self.every = every

    def is_every(self) -> bool:
        return self.every

    def is_valid(self, val: int) -> bool:
        if self.every:
            return True
        if not self.inverted:
            return self.min <= val <= self.max
        return val < self.min or val > self.max

    def parse_json(self, value: dict, name: str) -> None:
        """Scalar -> [v, INT_MAX]; [a,b] array; bool true -> [1,MAX],
        false -> inverted [1,MAX]."""
        if name not in value:
            return
        v = value[name]
        self.every = False
        self.inverted = False
        if isinstance(v, list):
            if len(v) > 2:
                return
            self.min, self.max = int(v[0]), int(v[1])
        elif isinstance(v, bool):
            self.min = 1 if v else INT_MAX
            self.max = INT_MAX if v else 1
        elif isinstance(v, (int, float)):
            self.min, self.max = int(v), INT_MAX
        else:
            raise ValueError(f"Unexpected type for range flag: {name}")
        if self.min > self.max:
            self.inverted = True
            self.min, self.max = self.max, self.min

    def __repr__(self):
        if self.every:
            return "all"
        inv = "NOT " if self.inverted else ""
        return f"{inv}[{self.min},{self.max}]"


# ---------------------------------------------------------------------------
# FlagRule
# ---------------------------------------------------------------------------

_NAMED_FLAGS = [
    ("dup", "duplicate"), ("supp", "supplementary"), ("qcfail", "qcfail"),
    ("hardclip", "hardclip"), ("fwd_strand", "fwd_strand"),
    ("mate_rev_strand", "mate_rev"), ("mate_fwd_strand", "mate_fwd"),
    ("mate_mapped", "mate_mapped"), ("mapped", "mapped"),
    ("ff", "ff"), ("fr", "fr"), ("rf", "rf"), ("rr", "rr"), ("ic", "ic"),
]


class FlagRule:
    """Flag masks and named flags, pair orientation included."""

    def __init__(self):
        for attr, _ in _NAMED_FLAGS:
            setattr(self, attr, Flag())
        self.m_all_on_flag = 0
        self.m_all_off_flag = 0
        self.m_any_on_flag = 0
        self.m_any_off_flag = 0
        self.every = True

    def is_every(self) -> bool:
        return self.every and not (self.m_all_on_flag or self.m_all_off_flag
                                   or self.m_any_on_flag
                                   or self.m_any_off_flag)

    def parse_json(self, value: dict) -> None:
        if "allflag" in value:
            self.m_all_on_flag = int(value["allflag"])
        if "!allflag" in value:
            self.m_all_off_flag = int(value["!allflag"])
        if "anyflag" in value:
            self.m_any_on_flag = int(value["anyflag"])
        if "!anyflag" in value:
            self.m_any_off_flag = int(value["!anyflag"])
        for attr, key in _NAMED_FLAGS:
            if getattr(self, attr).parse_json(value, key):
                self.every = False

    def is_valid(self, r: BamRecord) -> bool:
        if self.is_every():
            return True
        f = r.flag
        if self.m_all_on_flag and (f & self.m_all_on_flag) != self.m_all_on_flag:
            return False
        if self.m_all_off_flag and (f & self.m_all_off_flag) == self.m_all_off_flag:
            return False
        if self.m_any_on_flag and not (f & self.m_any_on_flag):
            return False
        if self.m_any_off_flag and (f & self.m_any_off_flag):
            return False

        def chk(flag: Flag, val: bool) -> bool:
            """False => record fails."""
            if flag.is_na():
                return True
            return not ((flag.is_off() and val) or (flag.is_on() and not val))

        if not chk(self.dup, r.duplicate_flag()):
            return False
        # SeqLib's "supplementary" flag tests SecondaryFlag; so does this
        if not chk(self.supp, r.secondary_flag()):
            return False
        if not chk(self.qcfail, r.qc_fail_flag()):
            return False
        if not chk(self.mapped, r.mapped_flag()):
            return False
        if not chk(self.mate_mapped, r.mate_mapped_flag()):
            return False
        if not self.hardclip.is_na() and len(r.cigar) > 1:
            if not chk(self.hardclip, r.num_hard_clip() > 0):
                return False
        ocheck = not (self.ff.is_na() and self.fr.is_na() and self.rf.is_na()
                      and self.rr.is_na() and self.ic.is_na())
        if ocheck:
            if not r.pair_mapped_flag():
                return False
            bic = r.interchromosomal()
            po = r.pair_orientation()
            if not bic:
                for orient, flag in ((FRORIENTATION, self.fr),
                                     (RRORIENTATION, self.rr),
                                     (RFORIENTATION, self.rf),
                                     (FFORIENTATION, self.ff)):
                    if (po == orient and flag.is_off()) or \
                            (po != orient and flag.is_on()):
                        return False
            if (bic and self.ic.is_off()) or (not bic and self.ic.is_on()):
                return False
        return True


# ---------------------------------------------------------------------------
# AbstractRule
# ---------------------------------------------------------------------------

class AbstractRule:
    """One rule: ranges, flags, read group, subsample and motif, tested
    in SeqLib's order."""

    def __init__(self):
        self.fr = FlagRule()
        self.isize = Range()
        self.mapq = Range()
        self.len = Range()
        self.clip = Range()
        self.nbases = Range()
        self.ins = Range()
        self.dele = Range()
        self.nm = Range()
        self.xp = Range()
        self.read_group = ""
        self.subsam_frac = 1.0
        self.subsam_seed = 999
        self.aho = AhoCorasick()
        self.id = ""
        self.m_count = 0

    def is_every(self) -> bool:
        return (self.isize.is_every() and self.mapq.is_every()
                and self.len.is_every() and self.clip.is_every()
                and self.nbases.is_every() and self.ins.is_every()
                and self.dele.is_every() and self.nm.is_every()
                and self.fr.is_every() and self.subsam_frac >= 1
                and self.xp.is_every() and not self.aho.count
                and not self.read_group)

    def set_subsample_rate(self, s: float) -> None:
        self.subsam_frac = s

    def add_motif_rule(self, path: str, inverted: bool = False) -> None:
        self.aho.trie_from_file(path)
        self.aho.inv = inverted

    def parse_json(self, value: dict) -> None:
        if "rg" in value:
            self.read_group = str(value["rg"])
        self.id += "".join(f"{k};" for k in value.keys())
        self.fr.parse_json(value)
        self.isize.parse_json(value, "isize")
        self.mapq.parse_json(value, "mapq")
        self.len.parse_json(value, "length")
        self.clip.parse_json(value, "clip")
        self.nbases.parse_json(value, "nbases")
        self.ins.parse_json(value, "ins")
        self.dele.parse_json(value, "del")
        self.nm.parse_json(value, "nm")
        self.xp.parse_json(value, "xp")
        if "subsample" in value:
            self.subsam_frac = float(value["subsample"])
        if "motif" in value:
            self.add_motif_rule(str(value["motif"]), False)
        elif "!motif" in value:
            self.add_motif_rule(str(value["!motif"]), True)

    def __repr__(self):
        """SeqLib's operator<< text."""
        if self.is_every():
            return "  Rule:   ALL"
        parts = []
        if self.read_group:
            parts.append(f"Read Group: {self.read_group}")
        for name, rng in (("isize", self.isize), ("mapq", self.mapq),
                          ("length", self.len), ("clip", self.clip),
                          ("nm", self.nm), ("xp", self.xp),
                          ("nbases", self.nbases), ("ins", self.ins),
                          ("del", self.dele)):
            if not rng.is_every():
                parts.append(f"{name}:{rng!r}")
        if self.subsam_frac < 1:
            parts.append(f"sub:{self.subsam_frac}")
        if self.aho.count:
            parts.append(f"motif: {self.aho.file}")
        return "  Rule: " + " -- ".join(parts)

    def is_valid(self, r: BamRecord) -> bool:
        if self.is_every():
            return True
        # subsample via Wang hash of qname
        if self.subsam_frac < 1:
            k = wang_hash(x31_hash(r.qname) ^ self.subsam_seed)
            if (k & 0xFFFFFF) / 0x1000000 >= self.subsam_frac:
                return False
        if not self.isize.is_valid(r.full_insert_size()):
            return False
        if self.read_group:
            rg = r.parse_read_group()
            if rg and rg != self.read_group:
                return False
        if not self.mapq.is_every() and not self.mapq.is_valid(r.mapq):
            return False
        if not self.fr.is_valid(r):
            return False
        if not self.ins.is_every() or not self.dele.is_every():
            if not self.ins.is_valid(r.max_insertion_bases()):
                return False
            if not self.dele.is_valid(r.max_deletion_bases()):
                return False
        tseq = r.seq
        if self.aho.count:
            hits = self.aho.query_text(tseq)
            ok = hits > 0
            if self.aho.inv:
                ok = not ok
            if not ok:
                return False
        if not self.nm.is_every():
            nm_val = r.get_int_tag("NM") or 0
            if not self.nm.is_valid(nm_val):
                return False
        if not self.nbases.is_every():
            if not self.nbases.is_valid(r.count_n_bases()):
                return False
        if not self.len.is_valid(len(tseq)):
            return False
        new_clipnum = r.num_clip() - (r.length() - len(tseq))
        if not self.clip.is_valid(new_clipnum):
            return False
        return True


# ---------------------------------------------------------------------------
# ReadFilter / ReadFilterCollection
# ---------------------------------------------------------------------------

class ReadFilter:
    """Region + rule list."""

    def __init__(self):
        self.m_grv = GRC()
        self.m_abstract_rules: list[AbstractRule] = []
        self.m_applies_to_mate = False
        self.excluder = False
        self.id = ""
        self.m_count = 0

    def add_rule(self, ar: AbstractRule) -> None:
        self.m_abstract_rules.append(ar)

    def set_regions(self, g: GRC) -> None:
        self.m_grv = g
        self.m_grv.create_tree_map()

    def add_regions(self, g: GRC) -> None:
        self.m_grv.concat(g)
        self.m_grv.merge_overlapping_intervals()
        self.m_grv.create_tree_map()

    def is_read_overlapping_region(self, r: BamRecord) -> bool:
        """True without regions; else the read (or, with matelink, its
        mate) overlaps one."""
        if not len(self.m_grv):
            return True
        if self.m_grv.count_overlaps(
                GenomicRegion(r.tid, r.pos, max(r.position_end(), r.pos))):
            return True
        if not self.m_applies_to_mate:
            return False
        if r.mtid >= 0 and self.m_grv.count_overlaps(
                GenomicRegion(r.mtid, r.mpos, r.mpos + r.length())):
            return True
        return False

    def __repr__(self):
        head = (f"Region: {self.id or 'WG'}"
                + (" (excluder)" if self.excluder else "")
                + f" seen-pass:{self.m_count}")
        return "\n".join([head] + [repr(r) for r in self.m_abstract_rules])

    def is_valid(self, r: BamRecord) -> bool:
        """Read passes if ANY rule passes; empty rules = pass."""
        if not self.m_abstract_rules:
            return True
        for rule in self.m_abstract_rules:
            if rule.is_valid(r):
                rule.m_count += 1
                self.m_count += 1
                return True
        return False


class ReadFilterCollection:
    """Top-level filter set parsed from a JSON script (a string or a
    file path)."""

    def __init__(self, script: str = "", hdr: BamHeader | None = None):
        self.m_regions: list[ReadFilter] = []
        self.rule_all = AbstractRule()
        self.m_count = 0
        self.m_count_seen = 0
        if script == "" and hdr is None:
            return
        self._parse(script, hdr or BamHeader())

    def _parse(self, script: str, hdr: BamHeader) -> None:
        text = script
        if os.path.isfile(script):
            with open(script) as fh:
                text = fh.read()
        try:
            root = json.loads(text) if text.strip() else {}
        except json.JSONDecodeError as e:
            if not script:
                return
            raise ValueError("ERROR: failed to parse JSON script") from e
        if not isinstance(root, dict):
            raise ValueError("ERROR: failed to parse JSON script")

        glob = root.pop("global", None)
        if glob is not None:
            self.rule_all.parse_json(glob)

        level = 1
        for _, region in root.items():
            mr = ReadFilter()
            mr.m_applies_to_mate = bool(region.get("matelink", False))
            pad = int(region.get("pad", 0))
            reg = str(region.get("region", ""))
            if reg:
                mr.id += reg
            if reg and reg != "WG":
                regr = GRC(reg, header=hdr)
                regr.pad(pad)
                mr.set_regions(regr)
            mr.excluder = bool(region.get("exclude", False))
            if mr.excluder:
                mr.id += "_exclude"
            for rule in region.get("rules", []):
                if rule is not None:
                    ar = copy.deepcopy(self.rule_all)
                    ar.parse_json(rule)
                    mr.m_abstract_rules.append(ar)
            if not mr.m_abstract_rules:
                mr.m_abstract_rules.append(copy.deepcopy(self.rule_all))
            mr.id = str(level)
            level += 1
            self.m_regions.append(mr)
        self._check_has_includer()

    def _check_has_includer(self) -> None:
        if not any(not rf.excluder for rf in self.m_regions):
            mr = ReadFilter()
            mr.m_abstract_rules.append(copy.deepcopy(self.rule_all))
            mr.id = "WG_includer"
            self.m_regions.append(mr)

    def add_read_filter(self, rf: ReadFilter) -> None:
        self.m_regions.append(rf)

    def is_valid(self, r: BamRecord) -> bool:
        """Every region filter the read overlaps is tried; the read passes
        if one passes and no excluder passes."""
        self.m_count_seen += 1
        if not self.m_regions:
            return True
        is_valid = False
        exclude_hit = False
        for rf in self.m_regions:
            if not rf.is_read_overlapping_region(r):
                continue
            if rf.is_valid(r):
                if rf.excluder:
                    exclude_hit = True
                is_valid = True
        if is_valid and not exclude_hit:
            self.m_count += 1
            return True
        return False

    def get_all_regions(self) -> GRC:
        out = GRC()
        for rf in self.m_regions:
            out.concat(rf.m_grv)
        return out

    def __repr__(self):
        return (f"ReadFilterCollection: seen={self.m_count_seen} "
                f"passed={self.m_count}\n"
                + "\n".join(repr(rf) for rf in self.m_regions))

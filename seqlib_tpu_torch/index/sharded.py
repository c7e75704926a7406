"""Sharded FM-index (counterpart of seqlib_tpu/index/sharded.py).

Contigs are packed greedily, in their input order, into shards whose
forward length stays under ``max_shard_bp``; each shard is a complete,
independent :class:`FMIndex`, and ``first_rid[s] + local_rid`` is a
contig's global id (a shard never splits a contig).  ``write`` keeps
each shard in bwa's five files as ``<prefix>.shard<k>.*`` beside a
``<prefix>.shards`` JSON manifest, byte for byte as the JAX package
writes them, so either package loads the other's index.  The aligner
over it is ``align.sharded.ShardedBWAAligner``.
"""

from __future__ import annotations

import json

from ..core.header import BamHeader
from .fmindex import FMIndex

# one shard's forward strand; the CLI shards a reference past it
DEFAULT_MAX_SHARD_BP = 1_000_000_000


class ShardedFMIndex:
    """Ordered list of FMIndex shards presenting one global reference."""

    def __init__(self, shards: list[FMIndex], first_rid: list[int]):
        self.shards = shards
        self.first_rid = first_rid

    @classmethod
    def construct(cls, seqs, max_shard_bp: int = DEFAULT_MAX_SHARD_BP
                  ) -> "ShardedFMIndex":
        """Build from ``[(name, seq)]`` pairs or objects with ``.name``
        and ``.seq``: contigs first-fit in order, a new shard when the
        next contig would take the current one past ``max_shard_bp``
        (a contig longer than that gets a shard of its own)."""
        pairs = [(s.name, s.seq) if hasattr(s, "name") else (s[0], s[1])
                 for s in seqs]
        if not pairs:
            raise ValueError(
                "ShardedFMIndex::construct - empty sequence list")
        groups: list[list[tuple[str, str]]] = []
        cur: list[tuple[str, str]] = []
        cur_bp = 0
        for name, seq in pairs:
            if cur and cur_bp + len(seq) > max_shard_bp:
                groups.append(cur)
                cur, cur_bp = [], 0
            cur.append((name, seq))
            cur_bp += len(seq)
        groups.append(cur)
        first_rid, n = [], 0
        for g in groups:
            first_rid.append(n)
            n += len(g)
        return cls([FMIndex.construct(g) for g in groups], first_rid)

    # -- the global reference (FMIndex's names) --------------------------

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def num_sequences(self) -> int:
        return sum(s.num_sequences() for s in self.shards)

    def _locate_shard(self, rid: int) -> tuple[int, int]:
        if rid < 0 or rid >= self.num_sequences():
            raise IndexError(
                f"ShardedFMIndex - contig id {rid} out of bounds")
        s = self.n_shards - 1
        while self.first_rid[s] > rid:
            s -= 1
        return s, rid - self.first_rid[s]

    def chr_id_to_name(self, i: int) -> str:
        s, local = self._locate_shard(i)
        return self.shards[s].chr_id_to_name(local)

    def sam_header_text(self) -> str:
        return "".join(s.sam_header_text() for s in self.shards)

    def header_from_index(self) -> BamHeader:
        return BamHeader(self.sam_header_text())

    def write(self, prefix: str) -> None:
        """Each shard as ``<prefix>.shard<k>.{bwt,sa,ann,amb,pac}``, and
        the ``<prefix>.shards`` manifest (shard count, forward lengths,
        first global ids)."""
        for k, s in enumerate(self.shards):
            s.write(f"{prefix}.shard{k}")
        with open(prefix + ".shards", "w") as fh:
            json.dump({
                "n_shards": self.n_shards,
                "shard_bp": [s.l_pac for s in self.shards],
                "first_rid": self.first_rid,
            }, fh)

    @classmethod
    def load(cls, prefix: str, n_shards: int | None = None
             ) -> "ShardedFMIndex":
        """Load a sharded index; ``n_shards`` comes from the
        ``<prefix>.shards`` manifest when omitted."""
        if n_shards is None:
            with open(prefix + ".shards") as fh:
                manifest = json.load(fh)
            if not isinstance(manifest, dict) or "n_shards" not in manifest:
                raise ValueError(f"{prefix}.shards: no n_shards in the "
                                 "manifest")
            n_shards = int(manifest["n_shards"])
        shards = [FMIndex.load(f"{prefix}.shard{k}")
                  for k in range(n_shards)]
        first_rid, n = [], 0
        for s in shards:
            first_rid.append(n)
            n += s.num_sequences()
        return cls(shards, first_rid)

"""The multi-device parity checks (counterpart of ``dryrun_multichip`` in
the repository's ``__graft_entry__.py``, its hermetic form).

``dryrun_multichip(n)`` runs the real aligner over an n-entry mesh and
the sharded index over min(n, 2) devices, on a synthetic 4 kb reference
cut into two contigs and reads simulated from it with one substitution
each, and holds both against the single-device aligner: the mesh's
records exactly, the sharded index's up to equal-score ties (its global
keys order such hits differently, so another of them may be primary;
such a read must keep the same alignments).  Reads across the junction
of the two contigs are left out of the sharded check and counted: the
single index drops a region that crosses a contig boundary, while the
shard that holds the second contig aligns the read's part there with a
clip (the JAX package's own dry run fails its exact sharded check on
these reads).
"""

from __future__ import annotations

import numpy as np
import torch


def _tiny_ref(n_bp: int = 4096) -> str:
    rng = np.random.default_rng(0)
    return "".join(rng.choice(list("ACGT"), n_bp))


def _tiny_reads(refseq: str, n_reads: int, read_len: int = 64):
    """(reads, their start positions)."""
    rng = np.random.default_rng(1)
    reads, starts = [], []
    bases = "ACGT"
    for _ in range(n_reads):
        p = int(rng.integers(0, len(refseq) - read_len))
        s = list(refseq[p:p + read_len])
        q = int(rng.integers(0, read_len))
        s[q] = bases[int(rng.integers(0, 4))]
        reads.append("".join(s))
        starts.append(p)
    return reads, starts


def _records(aligner, reads) -> list:
    out = aligner.align_batch(reads, [f"r{i}" for i in range(len(reads))])
    return [[(r.qname, r.flag, r.tid, r.pos, r.mapq, str(r.cigar),
              r.get_int_tag("NM"), r.get_int_tag("AS")) for r in recs]
            for recs in out]


def _equal_up_to_ties(got: list, want: list) -> int:
    """Reads whose records differ only in which of several equal-score
    hits is primary (raises on any other difference)."""
    moved = 0
    for g, w in zip(got, want, strict=True):
        if sorted(g) == sorted(w):
            continue

        def hits(rs):
            return sorted((r[2], r[3], r[1] & 16, r[5], r[6], r[7])
                          for r in rs)

        def primary_as(rs):
            return [r[7] for r in rs if not r[1] & 0x900]

        if hits(g) != hits(w) or primary_as(g) != primary_as(w):
            raise AssertionError(f"sharded-index output != single-index: "
                                 f"{g} against {w}")
        moved += 1
    return moved


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The aligner over an ``n_devices``-entry mesh
    (``make_mesh(n_devices, device=device)``: the first n cards on
    "cuda", n entries of one device on "cpu" or "cuda:k") and the
    sharded index over its first min(n, 2) entries, each held against
    the single-device aligner on the mesh's first device.  Returns the
    counts it checked; raises on any difference."""
    from ..align import BWAAligner, ShardedBWAAligner
    from ..index import FMIndex, ShardedFMIndex
    from .mesh import make_mesh

    mesh = make_mesh(n_devices, device=device)
    refseq = _tiny_ref()
    cut = 2048
    seqs = [("a", refseq[:cut]), ("b", refseq[cut:])]
    reads, starts = _tiny_reads(refseq, max(64, 2 * n_devices))
    across = [p < cut < p + len(r) for p, r in zip(starts, reads)]

    single = BWAAligner(FMIndex.construct(seqs), device=mesh.devices[0])
    want = _records(single, reads)
    n_want = sum(len(r) for r in want)
    if n_want < len(reads) // 2:
        raise AssertionError("single-device aligner mapped too few reads")

    # (a) data parallel: every batch split over the mesh
    dp = BWAAligner(FMIndex.construct(seqs), mesh=mesh)
    if _records(dp, reads) != want:
        raise AssertionError("mesh data-parallel output != single-device")

    # (b) the sharded index, one shard per device
    sh_idx = ShardedFMIndex.construct(seqs, max_shard_bp=cut)
    if sh_idx.n_shards < 2:
        raise AssertionError("the dry run must exercise more than one shard")
    sh = ShardedBWAAligner(sh_idx,
                           devices=list(mesh.devices[:min(n_devices, 2)]))
    got_sh = _records(sh, reads)
    inside = [i for i, a in enumerate(across) if not a]
    moved = _equal_up_to_ties([got_sh[i] for i in inside],
                              [want[i] for i in inside])
    res = dict(n_devices=n_devices, devices=[str(d) for d in mesh.devices],
               reads=len(reads), records=n_want,
               sharded_records=sum(len(got_sh[i]) for i in inside),
               shards=sh_idx.n_shards, primaries_moved=moved,
               across_junction=len(reads) - len(inside))
    print(f"dryrun_multichip({n_devices}): ok - mesh parity on {n_want} "
          f"records, sharded index over {sh_idx.n_shards} shards equal up "
          f"to {moved} equal-score ties on {len(inside)} of {len(reads)} "
          f"reads ({res['across_junction']} across the contig junction "
          "left out)")
    return res


if __name__ == "__main__":
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    dryrun_multichip(n) if n else dryrun_multichip(2, device="cpu")

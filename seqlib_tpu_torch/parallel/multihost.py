"""Several processes (hosts) over one read set (counterpart of
seqlib_tpu/parallel/multihost.py).

Each process
1. calls :func:`init_multihost` (``torch.distributed`` over gloo),
2. builds or loads the same FMIndex (each process holds its own copy),
3. reads its share of the input (:func:`host_shard`, round robin by
   rank),
4. aligns it through ``BWAAligner(mesh=...)`` over its own cards,
5. writes a BAM part of its own (:func:`part_path`; records are
   independent, so parts concatenate or merge by coordinate),
6. sums its counters with every process's (:func:`allreduce_stats`).

Only host counters cross processes (the JAX package's "DCN psum"), so
the group is gloo, over TCP: ranks need no card of their own, and two
ranks may share one card.  Nothing inside a batch is exchanged.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _rank_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> tuple[int, int]:
    """Join ``num_processes`` processes (when more than one) into the
    default ``torch.distributed`` group, over gloo at
    ``coordinator_address`` ("host:port" or "tcp://host:port", rank 0
    listening there), as rank ``process_id``.  Returns (rank, world
    size); (0, 1) for a single process."""
    if num_processes and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("init_multihost: a coordinator address and a "
                             "process id are needed for several processes")
        if not dist.is_initialized():
            addr = coordinator_address if "://" in coordinator_address \
                else f"tcp://{coordinator_address}"
            dist.init_process_group("gloo", init_method=addr,
                                    world_size=int(num_processes),
                                    rank=int(process_id))
    return _rank_world()


def host_shard(items, process_id: int | None = None,
               num_processes: int | None = None):
    """This process's round-robin share of an input list or iterator."""
    rank, world = _rank_world()
    pid = rank if process_id is None else process_id
    n = world if num_processes is None else num_processes
    for i, x in enumerate(items):
        if i % n == pid:
            yield x


def allreduce_stats(values: dict[str, float]) -> dict[str, float]:
    """Sum small host counters over every process of the default group
    (float64, on the CPU); a copy of ``values`` in a single process."""
    if _rank_world()[1] == 1:
        return dict(values)
    keys = sorted(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return {k: float(v) for k, v in zip(keys, t.tolist())}


def part_path(output: str, process_id: int | None = None) -> str:
    """A process's output part: out.bam -> out.part0003.bam."""
    pid = _rank_world()[0] if process_id is None else process_id
    if "." in output.split("/")[-1]:
        stem, ext = output.rsplit(".", 1)
        return f"{stem}.part{pid:04d}.{ext}"
    return f"{output}.part{pid:04d}"


def run_rank(argv=None) -> dict:
    """One rank of a multi-process alignment on a simulated read set:
    join the group, build the reference (``sim.make_genome``, seed 7) and
    its index, align this rank's ``host_shard`` of the first ``--take``
    of ``--reads`` simulated reads (seed 11) through ``align_stream_bam``
    on a mesh of ``--mesh`` entries of ``--device`` into
    ``part_path(--out)``, then
    sum the counters over the group.  Returns (and prints, as the last
    line, in JSON) this rank's numbers: local and total records and
    reads, the stream's wall time, reads/s, its start and end (host
    clock), peak device memory and the kernel launches of the stream.

        python -m seqlib_tpu_torch.parallel.multihost --coordinator \\
            localhost:29500 --rank 0 --world 2 --out out.bam"""
    import argparse
    import collections
    import json
    import time

    from ..align import BWAAligner
    from ..index import FMIndex
    from ..io import BAM, BamWriter
    from ..ops import cuda_lib
    from ..sim import make_genome, simulate_reads
    from .mesh import make_mesh

    ap = argparse.ArgumentParser(prog="seqlib_tpu_torch.parallel.multihost")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", type=int, default=1)
    ap.add_argument("--genome-bp", type=int, default=4_600_000)
    ap.add_argument("--reads", type=int, default=32_768)
    ap.add_argument("--take", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=4096)
    a = ap.parse_args(argv)

    rank, world = init_multihost(a.coordinator, a.world, a.rank)
    genome = make_genome(a.genome_bp, seed=7)
    reads = simulate_reads(genome, a.reads, seed=11)[:a.take]
    idx = FMIndex.construct([("sim_chr", genome)])
    aln = BWAAligner(idx, mesh=make_mesh(a.mesh, device=a.device))
    Read = collections.namedtuple("Read", "name seq")
    mine = [Read(n, s) for n, s in host_shard(reads, rank, world)]
    on_card = aln.device.type == "cuda"
    if on_card:
        # warm-up: the kernels' first launches and the allocator
        aln.align_batch_bam([r.seq for r in mine[:64]],
                            [r.name for r in mine[:64]])
        torch.cuda.synchronize(aln.device)
        torch.cuda.reset_peak_memory_stats(aln.device)
    cuda_lib.reset_launches()
    out = part_path(a.out, rank)
    w = BamWriter(BAM)
    w.open(out)
    w.set_header(idx.header_from_index())
    w.write_header()
    n_records = 0
    t0 = time.time()
    for _, payload, counts in aln.align_stream_bam(iter(mine),
                                                   batch_size=a.batch):
        w.write_records_bytes(payload)
        n_records += int(counts.sum())
    if on_card:
        torch.cuda.synchronize(aln.device)
    t1 = time.time()
    w.close()
    launches = dict(cuda_lib.LAUNCHES)
    totals = allreduce_stats({"records": float(n_records),
                              "reads": float(len(mine))})
    res = dict(
        rank=rank, world=world, part=out, local_records=n_records,
        local_reads=len(mine), total_records=int(totals["records"]),
        total_reads=int(totals["reads"]), wall_s=t1 - t0,
        reads_s=len(mine) / (t1 - t0), t_start=t0, t_end=t1,
        peak_mib=torch.cuda.max_memory_allocated(aln.device) / 2**20
        if on_card else None,
        device=str(aln.device), launches=launches)
    if world > 1:
        dist.barrier()
        dist.destroy_process_group()
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    run_rank()

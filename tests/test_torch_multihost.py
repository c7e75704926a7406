"""Two processes of the port joined by ``torch.distributed`` (gloo) on
the CPU: each takes its round-robin share of 64 simulated reads, aligns
it on a 2-entry CPU mesh, writes a BAM part and sums the counters over
the group (``python -m seqlib_tpu_torch.parallel.multihost``, which
imports the port only, never JAX).  Both ranks must print the same
totals, the totals must equal the sum of the parts, and the parts'
records, merged by read name, must equal one process's records.
"""

import collections
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from seqlib_tpu_torch.align import BWAAligner
from seqlib_tpu_torch.index import FMIndex
from seqlib_tpu_torch.io import BamReader
from seqlib_tpu_torch.sim import make_genome, simulate_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = dict(genome_bp=100_000, reads=64, batch=32)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _argv(rank: int, port: int, out: str) -> list:
    argv = [sys.executable, "-m", "seqlib_tpu_torch.parallel.multihost",
            "--coordinator", f"127.0.0.1:{port}", "--rank", str(rank),
            "--world", "2", "--out", out, "--device", "cpu", "--mesh", "2"]
    for k, v in ARGS.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return argv


def test_two_ranks_equal_one_process(tmp_path):
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    out = str(tmp_path / "out.bam")
    procs = [subprocess.Popen(_argv(r, port, out), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=REPO) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:                   # a hung rank fails, not waits
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = [json.loads(log.strip().splitlines()[-1]) for log in logs]
    assert [r["rank"] for r in res] == [0, 1]
    assert all(r["world"] == 2 and r["device"] == "cpu" for r in res)
    # both ranks agree on the summed totals, which equal the parts' sums
    totals = {(r["total_records"], r["total_reads"]) for r in res}
    assert len(totals) == 1
    total_records, total_reads = totals.pop()
    assert total_reads == sum(r["local_reads"] for r in res) == 64
    assert total_records == sum(r["local_records"] for r in res)
    assert [r["local_reads"] for r in res] == [32, 32]

    genome = make_genome(ARGS["genome_bp"], seed=7)
    reads = simulate_reads(genome, ARGS["reads"], seed=11)
    idx = FMIndex.construct([("sim_chr", genome)])
    hdr = idx.header_from_index()
    parts = collections.defaultdict(list)
    n_part = 0
    for r in res:
        assert r["part"] == str(tmp_path / f"out.part{r['rank']:04d}.bam")
        rd = BamReader(r["part"])
        for rec in iter(rd.next, None):
            parts[rec.qname].append(rec.to_sam(hdr))
            n_part += 1
    assert n_part == total_records
    torch.set_num_threads(1)
    payload, counts = BWAAligner(idx, device="cpu").align_batch_bam(
        [s for _, s in reads], [n for n, _ in reads], sam=True)
    want = collections.defaultdict(list)
    for line in payload.decode().splitlines():
        want[line.split("\t", 1)[0]].append(line)
    assert int(np.sum(counts)) == total_records
    assert dict(parts) == dict(want)
    assert len(want) >= 60

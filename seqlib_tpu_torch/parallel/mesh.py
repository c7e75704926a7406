"""Data parallelism over the cards of one host (counterpart of
seqlib_tpu/parallel/mesh.py).

A :class:`Mesh` is a tuple of torch devices on one axis, ``"dp"``.  Read
batches split on dim 0 into contiguous equal slices, slice k on entry
k's device, and the FM-index is copied once to each distinct device
(``DeviceFMIndex.to``); each entry runs its slice on a host thread of
its own under that device's guard (``device.run_on_devices``), all at
once.  The JAX package's ``psum`` over the axis becomes a sum over the
slices on the host, and its ``shard_map`` outputs, sharded on dim 0,
are the slices' outputs concatenated on the mesh's first device.

Entries may repeat a device: that is how a CPU test, or one card, gets
a mesh of n (n replicas of the work on one device).  Only host counters
cross processes (``parallel.multihost``); inside a process nothing is
exchanged between cards but the slices' outputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, run_on_devices
from ..ops import sw_cuda
from ..ops.fm import DeviceFMIndex, collect_seeds

SEED_KEYS = ("qbeg", "qend", "intv_l", "intv_sz", "n_seeds")
EXT_KEYS = ("score", "qle", "tle", "gscore", "gtle")


class Mesh:
    """Devices along one named axis (the JAX package's 1-D ``Mesh``):
    ``devices`` (torch devices, repeats allowed), ``axis_name`` and
    ``shape[axis_name]``, the number of entries."""

    def __init__(self, devices, axis: str = "dp"):
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("Mesh: no devices")
        self.axis_name = axis
        self.shape = {axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> list[torch.device]:
        """The mesh's devices, each once, in entry order."""
        return list(dict.fromkeys(self.devices))

    def run(self, thunks) -> list:
        """``thunks[k]()`` for every entry k, each on a host thread of its
        own under entry k's device guard, all at once; their results in
        entry order (the first exception raised is raised here)."""
        if len(thunks) != self.size:
            raise ValueError(f"Mesh.run: {len(thunks)} thunks for "
                             f"{self.size} entries")
        out = run_on_devices([(d, [fn]) for d, fn in
                              zip(self.devices, thunks)])
        return [r[0] for r in out]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_name!r})"


def make_mesh(n_devices: int | None = None, axis: str = "dp",
              device="cuda") -> Mesh:
    """A mesh of ``n_devices`` entries.  ``device="cuda"``: the first n
    cards of the host, one entry each (every visible card by default);
    it raises when fewer cards exist than asked for (no CPU fallback).
    A device with an index (``"cuda:0"``) or ``"cpu"``: n entries of
    that one device (n default 1), replicas on one device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)              # raises without a card
        have = torch.cuda.device_count()
        n = have if n_devices is None else int(n_devices)
        if not 1 <= n <= have:
            raise RuntimeError(f"make_mesh: {n} cards asked for, this host "
                               f"has {have}")
        return Mesh([torch.device("cuda", i) for i in range(n)], axis)
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"make_mesh: {n} entries")
    return Mesh([dev] * n, axis)


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def shard_batch(mesh: Mesh, arrays: dict) -> dict[str, list]:
    """Each array (numpy or tensor) cut on dim 0 into ``mesh.size``
    contiguous equal slices, slice k on entry k's device: {name: [slice
    per entry]}.  Raises when dim 0 does not divide."""
    n = mesh.size
    out = {}
    for k, v in arrays.items():
        v = _as_tensor(v)
        if v.shape[0] % n:
            raise ValueError(f"shard_batch: {k} has {v.shape[0]} rows, not "
                             f"a multiple of the mesh's {n} entries")
        b = v.shape[0] // n
        out[k] = [v[i * b:(i + 1) * b].to(d)
                  for i, d in enumerate(mesh.devices)]
    return out


def _slices(mesh: Mesh, names, arrays) -> list[dict]:
    """Per-entry dicts of the step's inputs: ``arrays`` are whole batches
    (cut by ``shard_batch``) or lists of per-entry slices already."""
    whole = {k: a for k, a in zip(names, arrays)
             if not isinstance(a, (list, tuple))}
    cut = shard_batch(mesh, whole) if whole else {}
    per = [{} for _ in range(mesh.size)]
    for k, a in zip(names, arrays):
        parts = cut[k] if k in cut else list(a)
        if len(parts) != mesh.size:
            raise ValueError(f"{k}: {len(parts)} slices for a mesh of "
                             f"{mesh.size}")
        for i, (p, d) in enumerate(zip(parts, mesh.devices)):
            per[i][k] = _as_tensor(p).to(d)
    return per


def _gather(mesh: Mesh, outs: list[dict], keys) -> dict:
    """The slices' outputs concatenated on dim 0 on the first device."""
    first = mesh.devices[0]
    return {k: torch.cat([o[k].to(first) for o in outs]) for k in keys}


def sharded_seed_step(fm: DeviceFMIndex, mesh: Mesh, max_seeds: int = 16,
                      min_seed_len: int = 19):
    """Data-parallel greedy seed scan (``ops.fm.collect_seeds``).

    Returns fn(reads [B, L], lens [B]) -> (seeds, stats): each entry
    scans its slice with the index copied to its device; seeds (qbeg,
    qend, intv_l, intv_sz [B, max_seeds], n_seeds [B]) on the mesh's
    first device; stats int64 [2] = (seeds emitted, query bases they
    cover), summed over the slices (the JAX package's ``psum``).  B must
    divide by the mesh size; reads and lens may be given as per-entry
    slices (``shard_batch``)."""
    fms = {d: fm.to(d) for d in mesh.distinct()}

    def step(reads, lens):
        per = _slices(mesh, ("reads", "lens"), (reads, lens))
        outs = mesh.run([
            (lambda x=x, d=d: collect_seeds(
                fms[d], x["reads"], x["lens"], max_seeds=max_seeds,
                min_seed_len=min_seed_len))
            for x, d in zip(per, mesh.devices)])
        stats = torch.tensor(
            [sum(int(o["n_seeds"].sum()) for o in outs),
             sum(int((o["qend"] - o["qbeg"]).sum()) for o in outs)],
            dtype=torch.int64, device=mesh.devices[0])
        return _gather(mesh, outs, SEED_KEYS), stats

    return step


def sharded_extend_step(mesh: Mesh, **sw_kwargs):
    """Data-parallel batched seed extension (the JAX package's
    ``extend_batch`` under ``shard_map``).

    Returns fn(q [M, Lq], ql, t [M, Lt], tl, h0 [M]) -> (out, total):
    each entry extends its slice of lanes, with ``extend_batch``'s
    options ``sw_kwargs``; ``out`` (score, qle, tle, gscore, gtle [M])
    on the mesh's first device and ``total``, the scores' sum over the
    slices.  On a card the slice goes through a kernel: K1
    (``sw_cuda.extend_batch_banded``) at ``band > 0``, K3
    (``sw_cuda.extend_batch_rect``, the full rectangle that
    ``extend_batch`` computes at the default ``band=0``) otherwise; a
    shape neither takes raises.  On the CPU the same wrappers run their
    plain versions.  M must divide by the mesh size."""
    kw = dict(sw_kwargs)
    band = int(kw.pop("band", 0))

    def extend(q, ql, t, tl, h0):
        if band > 0:
            return sw_cuda.extend_batch_banded(q, ql, t, tl, h0, band=band,
                                               **kw)
        return sw_cuda.extend_batch_rect(q, ql, t, tl, h0, **kw)

    def step(q, ql, t, tl, h0):
        names = ("q", "ql", "t", "tl", "h0")
        per = _slices(mesh, names, (q, ql, t, tl, h0))
        outs = mesh.run([(lambda x=x: extend(*(x[k] for k in names)))
                         for x in per])
        total = torch.tensor(sum(int(o["score"].sum()) for o in outs),
                             dtype=torch.int64, device=mesh.devices[0])
        return _gather(mesh, outs, EXT_KEYS), total

    return step

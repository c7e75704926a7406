"""Device selection shared by every entry point of the port, and the
host threads that run work on several devices at once."""

from __future__ import annotations

import contextlib
import threading

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` -> torch.device, refusing a CUDA device that is absent.

    A CUDA device comes back with its index (``"cuda"`` is the current
    card), so two names of one card compare equal.  The port never falls
    back to the CPU on its own: a caller who wants the plain PyTorch
    path asks for it with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"seqlib_tpu_torch: unsupported device {dev}")
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "seqlib_tpu_torch: CUDA device requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path")
    n = torch.cuda.device_count()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= n:
        raise RuntimeError(f"seqlib_tpu_torch: {dev} requested but this "
                           f"host has {n} CUDA device(s)")
    return torch.device("cuda", index)


# groups on the CPU take turns: PyTorch's CPU ops of one group already
# use the cores, and groups issuing small ops at once only contend for
# the interpreter lock (four such groups ran 4x slower than in turn)
_cpu_turn = threading.Lock()
_in_turn = threading.local()      # set on a thread that holds the turn


def run_on_devices(groups) -> list[list]:
    """Run ``groups`` ([(device, [thunk, ...]), ...]) at the same time,
    each group on a host thread of its own, its thunks in order under
    ``torch.cuda.device(device)`` for a card (the thread's current
    device), groups on the CPU in turns; returns each
    group's results in order.  One group runs on the calling thread.
    Every thread is joined; then the first group's exception that any
    thunk raised is raised here."""
    results: list[list] = [[] for _ in groups]
    errors: list = [None] * len(groups)

    def work(g: int, inline: bool) -> None:
        dev, thunks = groups[g]
        takes_turn = dev.type == "cpu" and not inline
        turn = _cpu_turn if takes_turn else contextlib.nullcontext()
        guard = torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext()
        try:
            with turn, guard:
                if takes_turn:              # a worker thread of its own
                    _in_turn.held = True
                for fn in thunks:
                    results[g].append(fn())
        except BaseException as e:      # re-raised on the caller's thread
            errors[g] = e

    if len(groups) == 1 or getattr(_in_turn, "held", False):
        # one group, or a call from inside a CPU turn: in order, here
        for g in range(len(groups)):
            work(g, inline=True)
    else:
        threads = [threading.Thread(target=work, args=(g, False),
                                    daemon=True)
                   for g in range(len(groups))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for e in errors:
        if e is not None:
            raise e
    return results

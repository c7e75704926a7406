# Frozen copy of seqlib_tpu_torch/device.py for the benchmark's reference
# (device selection only): later changes to the port do not reach it.
"""Device selection."""

from __future__ import annotations

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

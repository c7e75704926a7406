"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` -> torch.device, refusing a CUDA device that is absent.

    The port never falls back to the CPU on its own: a caller who wants
    the plain PyTorch path asks for it with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "seqlib_tpu_torch: CUDA device requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"seqlib_tpu_torch: unsupported device {dev}")
    return dev

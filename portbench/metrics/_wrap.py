"""Wrapping a function of the port for a traced pass, and restoring it."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(owner, attr: str, make):
    """``owner.attr`` replaced by ``make(original)`` inside the block."""
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def sync(t) -> None:
    """Wait for the card that holds tensor ``t`` (nothing on the CPU)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)

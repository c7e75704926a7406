"""Suffix array by prefix doubling in plain PyTorch: the reference's own
construction, independent of the port's SA-IS (``native/sais.cpp``).

Each round sorts the suffixes by the pair (rank of the first h symbols,
rank of the next h) and doubles h, until every rank is distinct.  On a
card a round over a 200 Mbp text is a few sorts of 64-bit keys; on the
CPU it serves the tests' small texts."""

from __future__ import annotations

import numpy as np
import torch


def suffix_array(text: np.ndarray, device=None) -> np.ndarray:
    """Suffix array of ``text`` (uint8 codes >= 1) with an implicit
    terminal sentinel: int64 [len(text) + 1], SA[0] == len(text).  Runs
    on ``device``, by default the card where there is one."""
    t = np.asarray(text, dtype=np.uint8)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return suffix_array_t(torch.from_numpy(t).to(device)).cpu().numpy()


def suffix_array_t(t: torch.Tensor) -> torch.Tensor:
    """``suffix_array`` of a uint8 tensor, on its device, as a tensor."""
    if t.numel() and int(t.min()) < 1:
        raise ValueError("suffix_array: symbols must be >= 1")
    device = t.device
    n = t.numel()
    # ranks: the sentinel 1, a symbol c its c + 1; past the end 0
    rank = torch.empty(n + 1, dtype=torch.int64, device=device)
    rank[:n] = t.to(torch.int64) + 1
    rank[n] = 1
    top = 257
    h = 1
    while True:
        nxt = torch.zeros_like(rank)
        if h <= n:
            nxt[:n + 1 - h] = rank[h:]
        key = rank * (top + 1) + nxt
        del nxt
        key, order = torch.sort(key)
        new = torch.ones(n + 1, dtype=torch.int64, device=device)
        new[1:] += torch.cumsum((key[1:] != key[:-1]).to(torch.int64), 0)
        del key
        top = int(new[-1])
        rank = torch.empty_like(new)
        rank[order] = new
        del new
        if top == n + 1:
            return order
        h *= 2

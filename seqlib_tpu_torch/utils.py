"""Small utilities mirroring SeqLib's SeqLibUtils.h free functions
(counterpart of seqlib_tpu/utils.py)."""

from __future__ import annotations

import os
import time


def add_commas(x: int) -> str:
    """An integer with thousands separators (``SeqLib::AddCommas``)."""
    return f"{x:,}"


def percent_calc(numer: int, denom: int) -> int:
    """Integer percentage numer / denom x 100, 0 when denom <= 0
    (``SeqLib::percentCalc``)."""
    if denom <= 0:
        return 0
    return int(100.0 * numer / denom)


def scrub_string(s: str, to_scrub: str) -> str:
    """``s`` without any occurrence of ``to_scrub``
    (``SeqLib::scrubString``)."""
    if not to_scrub:
        return s
    return s.replace(to_scrub, "")


def read_access_test(path: str) -> bool:
    """True if ``path`` exists and is readable
    (``SeqLib::read_access_test``)."""
    return os.access(path, os.R_OK)


class RuntimeTimer:
    """CPU and wall time since construction, as ``SeqLib::displayRuntime``
    prints them."""

    def __init__(self) -> None:
        self.wall0 = time.time()
        self.cpu0 = time.process_time()

    def display(self) -> str:
        wall = time.time() - self.wall0
        cpu = time.process_time() - self.cpu0
        h, rem = divmod(int(wall), 3600)
        m, s = divmod(rem, 60)
        return f"CPU: {cpu:.1f}s Wall: {h:d}:{m:02d}:{s:02d}"


class ReadCount:
    """Kept / total progress counter (``SeqLib::ReadCount``)."""

    def __init__(self) -> None:
        self.keep = 0
        self.total = 0

    def percent(self) -> int:
        return percent_calc(self.keep, self.total)

    def total_string(self) -> str:
        return add_commas(self.total)

    def keep_string(self) -> str:
        return add_commas(self.keep)

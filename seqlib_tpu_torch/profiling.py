"""Stage timers and device traces (counterpart of seqlib_tpu/profiling.py).

``StageTimer`` accumulates wall time per named stage of a pipeline;
``device_trace`` records a ``torch.profiler`` trace of a block (CPU
activity always, CUDA activity where a GPU is present) and writes it as
a Chrome trace into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class StageTimer:
    """Accumulates wall time per named stage."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        total = sum(self.totals.values()) or 1e-12
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:24s} {t:8.3f}s {t / total * 100:5.1f}% "
                         f"(n={self.counts[name]})")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record a torch.profiler trace of the enclosed block into
    ``logdir``/trace_<pid>_<ns>.json (Chrome trace format)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))

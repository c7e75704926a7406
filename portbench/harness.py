"""One run of one cell: read its definition, check for the card, set up,
measure, trace, check, and print the result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration (``configs/<config>.json``) and traffic mix
(``traffic/<traffic>.json``); the mix names its client
(``clients/<client>.py``, which knows how to set up the system under
test and load it); each per-layer metric is ``metrics/<name>.py``.
Adding a cell, a mix, a configuration or a metric adds files and edits
none."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time
from contextlib import ExitStack
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# top-level modules that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "seqlib_tpu")


class NoCard(RuntimeError):
    """The cell needs more cards than this host has."""


@dataclass
class Spec:
    """One cell: its entry in BENCHMARK.json, configuration and mix, and
    the metrics it reports."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(cell: str, root: str = ROOT) -> Spec:
    """The cell ``cell`` of ``root``/BENCHMARK.json, with its files."""
    bench = _load_json(root, "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == cell]
    if not found:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    w = found[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = _load_json(root, cfg_entry["file"])
    traffic = _load_json(root, "portbench", "traffic",
                         w["traffic"] + ".json")
    return Spec(name=cell, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, cell)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, cell)])


def card(chips: int):
    """The first card, after checking that ``chips`` are there."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: this benchmark "
                     "runs on the card only")
    n = torch.cuda.device_count()
    if n < chips:
        raise NoCard(f"the cell needs {chips} card(s), this host has {n}")
    return torch.device("cuda", 0)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi not readable"


def card_state() -> str:
    """The card's clocks, power, temperature and active throttle reasons
    as nvidia-smi reports them."""
    q = ("clocks.sm,clocks.max.sm,clocks.mem,power.draw,temperature.gpu,"
         "clocks_throttle_reasons.active")
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi not readable"


def python_ms() -> float:
    """Milliseconds that a fixed loop of the interpreter takes: how fast
    this host runs one Python thread now (the stream's dispatching
    thread is such a thread, issuing launches)."""
    t0 = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x += i & 7
    return 1e3 * (time.perf_counter() - t0)


def _thread_cpu() -> dict:
    """CPU seconds of each of this process's threads, by thread id."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    try:
        for tid in os.listdir("/proc/self/task"):
            with open(f"/proc/self/task/{tid}/stat") as fh:
                f = fh.read().rsplit(")", 1)[1].split()
            out[int(tid)] = (int(f[11]) + int(f[12])) / tick
    except (OSError, ValueError, IndexError):
        pass
    return out


class HostClock:
    """What the host did while a stretch of wall time passed: the
    process's CPU seconds (all its threads, and its busiest threads),
    the whole machine's CPU time by kind (/proc/stat: busy, idle, and
    steal, the time the hypervisor gave this machine's cores to others)
    and the load average."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.p0 = os.times()
        self.s0 = self._stat()
        self.th0 = _thread_cpu()

    @staticmethod
    def _stat():
        try:
            with open("/proc/stat") as fh:
                f = [int(x) for x in fh.readline().split()[1:]]
            return f + [0] * (8 - len(f))
        except (OSError, ValueError):
            return None

    def report(self) -> str:
        wall = time.perf_counter() - self.t0
        p1 = os.times()
        cpu = (p1.user - self.p0.user) + (p1.system - self.p0.system)
        out = f"wall {wall:.3f} s, process CPU {cpu:.3f} s ({cpu / wall:.2f}" \
              f" cores)"
        th1 = _thread_cpu()
        busy = sorted(((th1[k] - self.th0.get(k, 0.0), k) for k in th1),
                      reverse=True)[:3]
        main = os.getpid()
        out += "; busiest threads " + ", ".join(
            f"{'main' if k == main else k} {v / wall:.2f}" for v, k in busy)
        s1 = self._stat()
        if self.s0 is not None and s1 is not None:
            d = [b - a for a, b in zip(self.s0, s1)]
            tot = max(sum(d[:8]), 1)
            busy = d[0] + d[1] + d[2] + d[5] + d[6]
            out += (f"; machine busy {100 * busy / tot:.1f}%, iowait "
                    f"{100 * d[4] / tot:.1f}%, steal {100 * d[7] / tot:.1f}%")
        try:
            with open("/proc/loadavg") as fh:
                out += f"; loadavg {' '.join(fh.read().split()[:3])}"
        except OSError:
            pass
        return out


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: seqlib_tpu_torch is not seqlib_tpu)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def metric_module(name: str):
    """``metrics/<name>.py``, loaded by its path (a metric's name may hold
    dots)."""
    import importlib.util
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_traced(cell, spec: Spec, device) -> tuple[dict, dict, dict]:
    """The traced passes: the profiler with the metrics' probes that do
    not synchronise, then (if any metric asks) a pass with those that do.
    Returns (per-layer values, device fields, breakdown)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace as tr

    mods = {m["name"]: metric_module(m["name"]) for m in spec.per_layer}
    nb = int(spec.traffic.get("trace_batches", 2))
    probes = {}
    for sync in (False, True):
        names = [n for n, m in mods.items()
                 if hasattr(m, "probe") and getattr(m, "SYNC", False) == sync]
        if sync and not names:
            break
        with ExitStack() as stack:
            for n in names:
                probes[n] = stack.enter_context(mods[n].probe(cell))
            if not sync:
                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if device.type == "cuda" else [])
                prof = stack.enter_context(profile(activities=acts))
                stack.enter_context(record_function(tr.MAIN_SPAN))
            _sync(device)
            t0 = time.perf_counter()
            cell.run_batches(nb)
            _sync(device)
            wall = time.perf_counter() - t0
        if not sync:
            t_read = time.perf_counter()
            summary = tr.summarize(prof, wall)
            del prof
            log(f"trace: {nb} batches in {wall:.3f} s, profiler read in "
                f"{time.perf_counter() - t_read:.1f} s")
    if summary is None:
        if device.type == "cuda":
            raise RuntimeError("the profiler recorded no device events")
        summary = tr.Trace(window_s=wall)
    ctx = Ctx(cell=cell, trace=summary, batches=nb, probes=probes)
    values = {}
    for n, m in mods.items():
        v = m.read(ctx)
        if v is None:
            log(f"metric {n}: nothing to read in this run, left out")
            continue
        values[n] = v
    dev = dict(busy_s=summary.busy_s, window_s=summary.window_s)
    return values, dev, dict(device_ops=summary.device_ops,
                             idle_gaps=summary.idle_gaps)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Ctx:
    """What a per-layer metric's reader sees."""
    cell: object
    trace: object
    batches: int
    probes: dict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        spec = load_spec(args.workload)
    except (OSError, KeyError, IndexError, ValueError) as e:
        log(f"portbench: cannot read cell {args.workload!r}: {e!r}")
        return 2
    try:
        device = card(spec.chips)
    except NoCard as e:
        log(f"portbench: {e}")
        return 3
    return run(spec, args.seed, args.seconds, bool(args.trace), device)


def run(spec: Spec, seed: int, seconds: float, trace: bool, device,
        emit=print, control: bool = False) -> int:
    """Set up, measure (or trace), check and print one run of ``spec``.
    Exits non-zero, printing no result, when a forbidden module is
    loaded; ``emit`` receives the result line.  With ``control`` the
    check's control (``control.py``) takes the port's place and streams
    ``control_batches`` batches instead of the window."""
    import torch
    client = importlib.import_module(
        f"portbench.clients.{spec.traffic['client']}")
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    log(f"cell {spec.name} seed {seed} seconds {seconds} trace "
        f"{int(trace)} on {kind} ({power_limit() if on_card else 'cpu'})")
    log(f"host: a fixed Python loop takes {python_ms():.1f} ms")
    t0 = time.perf_counter()
    cell = client.Cell(spec, seed, device, log, control=control)
    # the reference's own work (its index, bwa's files written from it)
    # is not the system's set-up
    setup_s = time.perf_counter() - t0 - sum(cell.untimed.values())
    log(f"setup_s {setup_s:.3f}: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in cell.setup_parts.items())
        + "; not counted: " + (", ".join(
            f"{k} {v:.3f} s" for k, v in cell.untimed.items()) or "none"))
    metrics, dev_extra, breakdown = {}, {}, None
    if control:
        hc = HostClock()
        cell.run_batches(int(spec.traffic.get("control_batches", 1)))
        log(f"control: {hc.report()}")
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    elif trace:
        values, dev_extra, breakdown = run_traced(cell, spec, device)
        for m in spec.per_layer:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        hc = HostClock()
        rates = cell.window(seconds)
        log(f"host over the window and its drain: {hc.report()}; a fixed "
            f"Python loop takes {python_ms():.1f} ms")
        if on_card:
            log(f"card after the window: {card_state()}")
        for m in spec.end_to_end:
            v = setup_s if m["name"] == "setup_s" else rates[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    cell.release()
    checks, attempted, failed = cell.check()
    correct = all(v <= lim for v, lim in checks.values())
    bad = forbidden_loaded()
    if bad:
        log(f"portbench: forbidden modules loaded: {', '.join(bad)}")
        return 4
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v} (limit {lim})")
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics,
            "device": dict(platform="gpu" if on_card else "cpu", kind=kind,
                           count=spec.chips, memory_peak_bytes=peak,
                           **dev_extra)}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    emit(json.dumps(line))
    return 0

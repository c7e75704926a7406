"""Build, load and count the hand-written CUDA kernels of the port.

Each ``csrc/<name>.cu`` (with the shared ``csrc/*.cuh`` headers) has a
plain C interface and is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into ``seqlib_tpu_torch/build/lib<name>.so`` at first use,
then loaded with ctypes: pointers go in as ``c_void_p``, the stream is
PyTorch's current stream, and every C entry returns
``cudaGetLastError()``.  ``build_all`` starts one nvcc per source at
once.  ``LAUNCHES`` counts launches per kernel (one counter per C
entry point that launches one); it is the evidence that a run went
through a kernel.  ``MAIN_PATH`` names the kernels the aligner runs on
every index; ``sa_walk`` runs on a loaded one (a sampled SA) only, and
the rectangle kernels K3-K5 only on the extension bench path
(``bench_sw``).  Launches come from several host threads on a mesh
(one per device), so every counter of the kernels' modules moves under
one lock (``bump``, ``reset_launches``), and a library is loaded under
another.  A wrapper launches under ``on_device(dev)``: the C entry
points ask the CUDA runtime for the calling thread's current device,
which must be the tensors' own.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import tempfile
import threading

from ..native import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures (argument types) of each library's entry points
SIGNATURES = {
    "sw_extend": {
        "sw_extend_banded": [_VP] * 6 + [_CI] * 11 + [_VP],
        "sw_extend_max_band": [],
    },
    "smem_machine": {
        "smem_machine": [_VP] * 6 + [_CI] * 3 + [ctypes.POINTER(_CI)]
        + [_CI] * 7 + [_VP] * 11 + [_VP],
        "smem_machine_wide": [_VP] * 6 + [_CI] * 2 + [_CL]
        + [ctypes.POINTER(_CL)] + [_CI] * 7 + [_VP] * 11 + [_VP],
        "smem_machine_max_stack": [],
        "smem_load_chase": [_VP, _CI, _CI, _VP, _VP],
    },
    "sa_walk": {
        "sa_walk": [_VP] * 3 + [_CL, _CI, _CL, _CI, ctypes.POINTER(_CI)]
        + [_VP] * 4,
        "sa_walk_wide": [_VP] * 3 + [_CL] * 4 + [ctypes.POINTER(_CL)]
        + [_VP] * 4,
        "sa_l2_read": [_VP, _CL, _CI, _CI, _VP, _VP],
    },
    "sw_rect": {
        "sw_extend_rect": [_VP] * 6 + [_CI] * 10 + [_VP],
        "sw_extend_rect_blocked": [_VP] * 6 + [_CI] * 10 + [_VP],
        "sw_extend_rect_interleaved": [_VP] * 6 + [_CI] * 11 + [_VP],
        "sw_rect_max_width": [],
        "sw_rect_pipe_last": [_CI] * 3,
        "sw_rect_k3_shape": [_CI] * 3,
    },
    # a measurement of the DPX instructions, not a kernel of the port
    "dpx_probe": {
        "dpx_probe": [_VP, _VP] + [_CI] * 5 + [_VP],
        "dpx_semantics": [_VP, _VP],
    },
}
LIBRARIES = tuple(SIGNATURES)
MAIN_PATH = ("sw_extend", "smem_machine")
LAUNCHES = {name: 0 for name in MAIN_PATH + (
    "sa_walk", "sw_extend_rect", "sw_extend_rect_blocked",
    "sw_extend_rect_interleaved")}

_libs: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_counts_lock = threading.Lock()


def reset_launches() -> None:
    with _counts_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def bump(counter: dict, key: str) -> None:
    """``counter[key] += 1`` under the counters' lock (``LAUNCHES``,
    ``sw_cuda.ADAPTIVE_BRANCHES``)."""
    with _counts_lock:
        counter[key] += 1


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("seqlib_tpu_torch: nvcc not found; the CUDA kernels "
                       "are built on the machine with the GPU")


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _start_build(name: str):
    """Start nvcc for one source; returns (Popen, tmp path) or None when
    the library is already up to date."""
    src = os.path.join(CSRC, f"{name}.cu")
    so = _so_path(name)
    newest = max(os.path.getmtime(os.path.join(CSRC, f))
                 for f in os.listdir(CSRC) if f == f"{name}.cu"
                 or f.endswith(".cuh"))
    if os.path.exists(so) and os.path.getmtime(so) >= newest:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT), tmp


def _finish_build(name: str, job) -> str:
    """Wait for nvcc; install the library; return nvcc's report."""
    proc, tmp = job
    out = proc.communicate(timeout=900)[0].decode(errors="replace")
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, _so_path(name))
    return out


def build_all() -> dict[str, str]:
    """Build every kernel library in parallel; returns nvcc's
    ``-Xptxas -v`` report per library built now ("" if up to date)."""
    jobs = {n: _start_build(n) for n in LIBRARIES}
    return {n: _finish_build(n, job) if job is not None else ""
            for n, job in jobs.items()}


_TYPE_ARGS = {"i": "int32", "l": "int64"}


def kernel_name(mangled: str) -> str:
    """kernel or kernel<S, ...> from an Itanium-mangled entry name: the
    last <length><identifier> of its (nested) name, then its int32 /
    int64 type and int and bool value template arguments if it has
    any."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while (m := re.match(r"\d+", mangled[pos:])):
        pos += m.end()
        name = mangled[pos:pos + int(m.group())]
        pos += len(name)
    tm = re.match(r"I((?:[il]|L[ib]\d+E)+)E", mangled[pos:])
    args = [_TYPE_ARGS.get(t, v) for t, v in
            re.findall(r"([il])|L[ib](\d+)E", tm.group(1))] if tm else []
    return name + (f"<{', '.join(args)}>" if args else "")


def ptxas_report(text: str) -> list[tuple[str, int, int, int, int]]:
    """(kernel, registers, stack-frame bytes, spill-store bytes,
    spill-load bytes) per entry function of nvcc's ``-Xptxas -v``
    output; a template instance is named kernel<S>."""
    out, name, spill = [], None, (0, 0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_name(m.group(1))
            spill = (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            spill = tuple(int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spill))
            name = None
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library (built on first use)."""
    with _load_lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start_build(name)
            if job is not None:
                _finish_build(name, job)
            lib = ctypes.CDLL(_so_path(name))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _CI
            _libs[name] = lib
    return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {rc})")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def on_device(name: str, dev, *tensors):
    """The device guard of one launch: raises unless every tensor lies
    on ``dev``, a CUDA device, and returns ``torch.cuda.device(dev)``,
    which makes ``dev`` the calling thread's current device for the
    launch."""
    import torch
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on a CUDA device, not "
                         f"{dev}")
    for t in tensors:
        if torch.is_tensor(t) and t.device != dev:
            raise ValueError(f"{name}: a tensor on {t.device}, the call's "
                             f"other inputs on {dev}")
    return torch.cuda.device(dev)

"""Import hygiene of the PyTorch/CUDA port, and its device policy.

In a fresh interpreter, importing every module of ``seqlib_tpu_torch``
and ``chip_smoke.py``'s module-level code must pull in neither ``jax``
nor anything of the JAX package ``seqlib_tpu``.  Entry points default
to the GPU and raise without one; ``chip_smoke.py`` fails without a GPU
and outside a checkout of the repository.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = textwrap.dedent("""
    import importlib, importlib.util, json, pkgutil, sys
    sys.path.insert(0, {repo!r})
    import seqlib_tpu_torch
    mods = ["seqlib_tpu_torch"]
    for m in pkgutil.walk_packages(seqlib_tpu_torch.__path__,
                                   "seqlib_tpu_torch."):
        importlib.import_module(m.name)
        mods.append(m.name)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_probe", {smoke!r})
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.")
                 or m == "seqlib_tpu" or m.startswith("seqlib_tpu."))
    print(json.dumps(dict(mods=mods, bad=bad)))
""")


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax_nor_jax_package():
    code = PROBE.format(repo=REPO,
                        smoke=os.path.join(REPO, "chip_smoke.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO, env=_clean_env())
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for m in ("seqlib_tpu_torch.ops.fm_cuda", "seqlib_tpu_torch.ops.sw_cuda",
              "seqlib_tpu_torch.ops.sw_variants", "seqlib_tpu_torch.bench_sw",
              "seqlib_tpu_torch.align.aligner", "seqlib_tpu_torch.native",
              "seqlib_tpu_torch.core.cigar", "seqlib_tpu_torch.core.header",
              "seqlib_tpu_torch.core.record",
              "seqlib_tpu_torch.core.unaligned", "seqlib_tpu_torch.io.bam",
              "seqlib_tpu_torch.sim", "seqlib_tpu_torch.ops.kmer",
              "seqlib_tpu_torch.assembly", "seqlib_tpu_torch.assembly.bfc",
              "seqlib_tpu_torch.assembly.overlap",
              "seqlib_tpu_torch.assembly.sgraph",
              "seqlib_tpu_torch.assembly.fermi", "seqlib_tpu_torch.io.fastq",
              "seqlib_tpu_torch.core.region", "seqlib_tpu_torch.core.seq",
              "seqlib_tpu_torch.io.bgzf", "seqlib_tpu_torch.io.bai",
              "seqlib_tpu_torch.io.sam", "seqlib_tpu_torch.io.bam_reader",
              "seqlib_tpu_torch.io.bam_writer",
              "seqlib_tpu_torch.io.threadpool",
              "seqlib_tpu_torch.io.refgenome",
              "seqlib_tpu_torch.io.fast_bam",
              "seqlib_tpu_torch.index.bwa_files", "seqlib_tpu_torch.cli",
              "seqlib_tpu_torch.profiling", "seqlib_tpu_torch.utils",
              "seqlib_tpu_torch.io.cram", "seqlib_tpu_torch.io.cram_codecs",
              "seqlib_tpu_torch.intervals",
              "seqlib_tpu_torch.intervals.collection",
              "seqlib_tpu_torch.filters",
              "seqlib_tpu_torch.filters.readfilter",
              "seqlib_tpu_torch.stats", "seqlib_tpu_torch.stats.coverage",
              "seqlib_tpu_torch.plot", "seqlib_tpu_torch.plot.seqplot",
              "seqlib_tpu_torch.index.sharded",
              "seqlib_tpu_torch.align.sharded",
              "seqlib_tpu_torch.parallel", "seqlib_tpu_torch.parallel.mesh",
              "seqlib_tpu_torch.parallel.multihost",
              "seqlib_tpu_torch.parallel.scaling",
              "seqlib_tpu_torch.parallel.dryrun"):
        assert m in res["mods"], m


def test_entry_points_default_to_cuda():
    from seqlib_tpu_torch.align import BWAAligner
    from seqlib_tpu_torch.assembly import BFC, FermiAssembler
    from seqlib_tpu_torch.index import FMIndex
    from seqlib_tpu_torch.ops.fm import DeviceFMIndex
    idx = FMIndex.construct([("c", "ACGT" * 300 + "GATTACA" * 50)])
    if torch.cuda.is_available():
        assert BWAAligner(idx).device.type == "cuda"
        assert BFC().device.type == "cuda"
        assert FermiAssembler().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BWAAligner(idx)
    with pytest.raises(RuntimeError):
        DeviceFMIndex.from_host(idx)
    for entry in (BFC, FermiAssembler):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
        assert entry(device="cpu").device.type == "cpu"
    assert BWAAligner(idx, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs for real there")
    # no GPU: exit non-zero and no result line
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO, env=_clean_env())
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory: the port cannot be imported
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env=_clean_env())
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

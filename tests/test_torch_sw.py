"""The port's affine DP against the JAX package, and the adaptive-band
wrapper's three branches.

``extend_batch`` (the plain version of kernel K1) and ``global_batch``
/ ``global_and_traceback`` get the same numpy inputs as their JAX
counterparts; all outputs are integers and must be exactly equal.  The
strict-band scalar oracle of tests/test_sw_banded.py pins the banded
score independently, also past 4096 query rows, where the JAX package's
int32 packed maxima no longer hold (two tests pin what it returns there:
past row 4095, and past column 2047 under z-drop).  On CPU tensors
``extend_batch_adaptive`` runs the plain banded DP in each pass, so these
tests drive all of its branches and hold it to
``extend_batch(band=...)``.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqlib_tpu.align import device_pipeline as jdp
from seqlib_tpu.ops import sw as jsw
from seqlib_tpu_torch import profiling
from seqlib_tpu_torch.align import device_pipeline as tdp
from seqlib_tpu_torch.bench_sw import set_k1_edges
from seqlib_tpu_torch.ops import sw as tsw
from seqlib_tpu_torch.ops import cuda_lib, sw_cuda
from global_dp_rows import global_dp_rows, runs_of_codes
from test_sw_banded import _scalar_banded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once: one intra-op
    thread per process keeps torch's CPU thread pools from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KEYS = ("score", "qle", "tle", "gscore", "gtle")


def _lanes(seed, M, Lq, Lt, near=0.5, empty=0.05):
    """Random lanes, near-identical lanes (few substitutions and an
    occasional short indel) and qlen = 0 lanes."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (M, Lq)).astype(np.int8)
    t = rng.integers(0, 5, (M, Lt)).astype(np.int8)
    ql = rng.integers(1, Lq + 1, M).astype(np.int32)
    tl = np.minimum(ql + rng.integers(0, Lt - Lq + 1, M), Lt).astype(np.int32)
    h0 = rng.integers(1, 60, M).astype(np.int32)
    kind = rng.random(M)
    for m in np.flatnonzero(kind < near):
        n = int(ql[m])
        t[m, :n] = q[m, :n]
        for p in rng.integers(0, n, int(rng.integers(0, 4))):
            t[m, p] = (t[m, p] + 1) % 4
        if rng.random() < 0.3:
            cut = int(rng.integers(1, max(n, 2)))
            t[m, cut:] = np.roll(t[m, cut:], int(rng.integers(-4, 5)))
    ql[kind > 1.0 - empty] = 0
    return q, ql, t, tl, h0


def _both(fn_j, fn_t, arrays, **kw):
    want = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw)
    return want, got


@pytest.mark.parametrize("band,zdrop", [
    (0, 0), (0, 100), (8, 0), (12, 23), (32, 100), (100, 0), (100, 100),
    # kernel K1's edges: the narrowest band and the widest it takes
    (1, 0), (1, 100), (128, 0), (128, 100),
])
def test_extend_batch_equals_jax(band, zdrop):
    """extend_batch == the JAX package's, on random, near-identical and
    qlen = 0 lanes; with band > 0 also on kernel K1's edge lanes
    (``set_k1_edges``)."""
    Lq = 96 if band >= 32 else 48
    arrays = _lanes(band * 100 + zdrop, 96, Lq, Lq + max(band, 16) + 1)
    if band > 0:
        q, ql, t, tl, h0 = arrays
        set_k1_edges(ql, tl, h0, band, t.shape[1],
                     np.random.default_rng(band + zdrop))
    want, got = _both(jsw.extend_batch, tsw.extend_batch, arrays,
                      band=band, zdrop=zdrop)
    for k in KEYS:
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k


def test_extend_batch_vs_scalar_oracle():
    q, ql, t, tl, h0 = _lanes(3, 16, 40, 64, near=0.5, empty=0.0)
    w = 10
    got = tsw.extend_batch(*(torch.from_numpy(a) for a in (q, ql, t, tl, h0)),
                           band=w)
    for b in range(16):
        want, _ = _scalar_banded(q[b], t[b], int(ql[b]), int(tl[b]),
                                 int(h0[b]), 6, 1, 6, 1, 1, 4, w)
        assert int(got["score"][b]) == want, b


def _copy_lane(Lq: int, seed: int, subs=(), h0: int = 19):
    """One lane whose target is its query with substitutions at
    ``subs``: its best cell lies on the main diagonal, in the last rows."""
    q = np.random.default_rng(seed).integers(0, 4, (1, Lq)).astype(np.int8)
    t = q.copy()
    for p in subs:
        t[0, p] = (t[0, p] + 1) % 4
    n = np.array([Lq], np.int32)
    return q, n, t, n.copy(), np.array([h0], np.int32)


@pytest.mark.parametrize("Lq,zdrop", [(4095, 0), (4096, 0), (4096, 100)])
def test_extend_batch_equals_jax_up_to_4096_rows(Lq, zdrop):
    """The int64 running maxima change nothing where the JAX package's
    int32 packing (12 bits of row) holds: lanes of up to 4096 rows."""
    q, ql, t, tl, h0 = _lanes(Lq + zdrop, 6, Lq, Lq + 101, near=0.7,
                              empty=0.0)
    ql[:3] = Lq                                   # rows to the last one
    arrays = (q, ql, t, tl, h0)
    want, got = _both(jsw.extend_batch, tsw.extend_batch, arrays,
                      band=100, zdrop=zdrop)
    for k in KEYS:
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k


@pytest.mark.parametrize("Lq", [4097, 5000])
def test_extend_batch_vs_scalar_oracle_past_4096_rows(Lq):
    """Past 4096 rows the port keeps bwa's tie-break (highest score, then
    the earliest row): the strict-band scalar oracle's best score and
    last row (gscore, gtle) agree, and the best cell is on the last row."""
    w = 100
    q, ql, t, tl, h0 = _copy_lane(Lq, Lq, subs=(17, Lq // 2, Lq - 40))
    got = tsw.extend_batch(*(torch.from_numpy(a) for a in (q, ql, t, tl, h0)),
                           band=w)
    best, last = _scalar_banded(q[0], t[0], Lq, Lq, 19, 6, 1, 6, 1, 1, 4, w)
    assert int(got["score"][0]) == best
    assert int(got["gscore"][0]) == int(last.max())
    assert int(got["gtle"][0]) == int(np.argmax(last))
    assert (int(got["qle"][0]), int(got["tle"][0])) == (Lq, Lq)


# the JAX package's extend_batch on exact-copy lanes (h0 19, band 100,
# zdrop 100): past row 4095 its packed (score, 4095 - row) borrows from
# the score, so score drops by one and qle wraps; gscore is right
JAX_ROW_PACK = {4100: (4118, 4), 5000: (5018, 904)}


@pytest.mark.parametrize("Lq", sorted(JAX_ROW_PACK))
def test_jax_extend_batch_past_4096_rows_is_another_function(Lq):
    arrays = _copy_lane(Lq, seed=1)
    want, got = _both(jsw.extend_batch, tsw.extend_batch, arrays,
                      band=100, zdrop=100)
    assert (int(want["score"][0]), int(want["qle"][0])) == JAX_ROW_PACK[Lq]
    assert (int(got["score"][0]), int(got["qle"][0])) == (Lq + 19, Lq)
    assert int(want["gscore"][0]) == int(got["gscore"][0]) == Lq + 19


def test_jax_zdrop_past_column_2047_is_another_function():
    """The JAX package packs the z-drop row max as (score, 2047 - column):
    past column 2047 the decoded column is off by 2048, the drop test's
    diagonal penalty becomes huge and the lane never stops.  A copy of
    2040 bases, 200 mismatched bases and 1500 more copied bases: bwa (and
    the port, and kernel K1) stop in the mismatches with the first
    copy's score; the JAX package runs on into the second copy."""
    rng = np.random.default_rng(3)
    a1 = rng.integers(0, 4, 2040)
    junk_q = rng.integers(0, 4, 200)
    junk_t = (junk_q + rng.integers(1, 4, 200)) % 4       # all mismatches
    a2 = rng.integers(0, 4, 1500)
    q = np.concatenate([a1, junk_q, a2]).astype(np.int8)[None]
    t = np.concatenate([a1, junk_t, a2]).astype(np.int8)[None]
    n = np.array([q.shape[1]], np.int32)
    arrays = (q, n, t, n.copy(), np.array([19], np.int32))
    want, got = _both(jsw.extend_batch, tsw.extend_batch, arrays,
                      band=100, zdrop=100)
    assert (int(got["score"][0]), int(got["qle"][0])) == (2059, 2040)
    assert int(want["qle"][0]) == 3740
    assert int(want["score"][0]) > 2059


@pytest.mark.parametrize("branch,near,zdrop", [
    ("narrow_only", 1.0, 100),
    ("compact_rerun", 1.0, 100),
    ("full_rerun", 0.0, 100),
    ("full_band", 0.5, 20),     # 0 < zdrop <= min gap bound: no narrow pass
])
def test_adaptive_branches(branch, near, zdrop):
    """Each branch of extend_batch_adaptive returns exactly
    extend_batch(band=100), the JAX package's CPU extension."""
    M, Lq, w = 64, 96, 100
    q, ql, t, tl, h0 = _lanes(7, M, Lq, Lq + w + 1, near=near, empty=0.05)
    if near == 1.0:                                 # exact lanes, no N
        q = np.where(q == 4, 0, q).astype(np.int8)
        t[:, :Lq] = q
        tl = ql.copy()
    if branch == "compact_rerun":                   # 8 lanes fail pass 1
        t[:8] = np.random.default_rng(8).integers(0, 4, t[:8].shape)
        ql[:8] = Lq
    before = dict(sw_cuda.ADAPTIVE_BRANCHES)
    arrays = (q, ql, t, tl, h0)
    got = sw_cuda.extend_batch_adaptive(
        *(torch.from_numpy(a) for a in arrays), band=w, zdrop=zdrop,
        rerun_cap=16)
    moved = [k for k in before if sw_cuda.ADAPTIVE_BRANCHES[k] != before[k]]
    assert moved == [branch], moved
    plain = tsw.extend_batch(*(torch.from_numpy(a) for a in arrays),
                             band=w, zdrop=zdrop)
    want = jsw.extend_batch(*(jnp.asarray(a) for a in arrays), band=w,
                            zdrop=zdrop)
    for k in KEYS:
        assert torch.equal(got[k], plain[k]), k
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k


def test_global_batch_and_traceback_equal_jax():
    rng = np.random.default_rng(11)
    M, Lq, Lt = 48, 64, 96
    q = rng.integers(0, 4, (M, Lq)).astype(np.uint8)
    t = np.full((M, Lt), 4, np.uint8)
    ql = rng.integers(0, Lq + 1, M).astype(np.int32)
    tl = np.zeros(M, np.int32)
    for m in range(M):
        s = list(q[m, :ql[m]])
        for _ in range(int(rng.integers(0, 4))):          # edits
            if not s:
                break
            p = int(rng.integers(0, len(s)))
            op = rng.integers(0, 3)
            if op == 0:
                s[p] = (s[p] + 1) % 4
            elif op == 1:
                del s[p]
            else:
                s.insert(p, int(rng.integers(0, 4)))
        s = s[:Lt]
        t[m, :len(s)] = s
        tl[m] = len(s)
    q[np.arange(Lq)[None, :] >= ql[:, None]] = 4
    arrays = (q, ql, t, tl)
    for band in (8, 208):
        ws, wd = jsw.global_batch(*(jnp.asarray(a) for a in arrays),
                                  band=band)
        gs, gd = tsw.global_batch(*(torch.from_numpy(a) for a in arrays),
                                  band=band)
        assert np.array_equal(np.asarray(ws), gs.numpy())
        assert np.array_equal(np.asarray(wd), gd.numpy())
        want = jdp.global_and_traceback(*(jnp.asarray(a) for a in arrays),
                                        band=band)
        got = tdp.global_and_traceback(*(torch.from_numpy(a)
                                         for a in arrays), band=band)
        _assert_runs_equal_jax(want, got, band)


def _assert_runs_equal_jax(want, got, what):
    """The port's (score, nm, run_off, runs) against the JAX package's
    (score, packed codes, nm), its codes decoded into runs by the tests'
    own decoder (``runs_of_codes``)."""
    off, runs = runs_of_codes(want[1])
    for a, b, name in ((want[0], got[0], "score"), (want[2], got[1], "nm"),
                       (off, got[2], "run_off"), (runs, got[3], "runs")):
        assert np.array_equal(np.asarray(a), b.numpy()), (what, name)
    assert got[2].dtype == torch.int64 and got[3].dtype == torch.int32
    assert runs.size > 0


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA launchers never run a CPU tensor (no quiet fallback)."""
    from seqlib_tpu_torch.ops import fm_cuda
    q, ql, t, tl, h0 = (torch.from_numpy(a)
                        for a in _lanes(1, 4, 16, 33, near=0.5))
    with pytest.raises(ValueError):
        sw_cuda.extend_batch_banded_cuda(q, ql, t, tl, h0, band=16)
    with pytest.raises(ValueError):
        fm_cuda.smem_machine_cuda(None, q.to(torch.uint8), ql, ql, ql,
                                  ql > 0, 4, 19, 8, 1, 40)


@pytest.mark.parametrize("band", [8, 208])
def test_global_and_traceback_edge_rows_equal_jax(band):
    """The plain route on the rows the kernel's tests use
    (``global_dp_rows``: edited and random windows, ql = 0, tl = 0,
    both, all-N windows, an end cell outside the band) equals the JAX
    package: score, NM, and CIGAR runs equal to those decoded from its
    packed codes; the rows with no walk (ql = tl = 0) have no runs."""
    arrays = global_dp_rows(40, 48, 80, seed=band, band=band)
    want = jdp.global_and_traceback(*(jnp.asarray(a) for a in arrays),
                                    band=band)
    got = tdp.global_and_traceback(*(torch.from_numpy(a) for a in arrays),
                                   band=band)
    _assert_runs_equal_jax(want, got, band)
    assert int(arrays[1][4]) + band >= 80 or int(got[0][4]) == tsw.NEG
    off = got[2].numpy()
    empty = (arrays[1] == 0) & (arrays[3] == 0)
    assert empty.any() and (np.diff(off)[empty] == 0).all()


def test_global_and_traceback_cpu_takes_the_plain_route():
    """CPU tensors run the plain route (its device reads and all) and
    launch, load and build no kernel."""
    arrays = [torch.from_numpy(a) for a in global_dp_rows(24, 32, 60,
                                                          seed=3, band=12)]
    n0 = dict(cuda_lib.LAUNCHES)
    profiling.take()
    with profiling.tracing():
        got = tdp.global_and_traceback(*arrays, band=12)
    counters = profiling.take().counters
    want = tdp.global_and_traceback_plain(*arrays, band=12)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert cuda_lib.LAUNCHES == n0
    assert "global_dp" not in cuda_lib._libs
    assert counters["sync.traceback.live"] >= 1
    assert counters["sync.sw.rows_to_run"] == 1
    assert counters["traceback.steps"] % 8 == 0
    assert counters["traceback.runs"] == int(got[2][-1]) == got[3].numel()


def test_global_and_traceback_groups_equal_one_call(monkeypatch):
    """With ``GLOBAL_DP_BYTES`` cut to 7 rows of direction matrix, 25
    rows go through in four calls (7, 7, 7, 4) whose score, NM and runs,
    joined with their offsets rebased, equal one ungrouped call's."""
    arrays = [torch.from_numpy(a) for a in global_dp_rows(25, 32, 60,
                                                          seed=5, band=12)]
    plain = tdp.global_and_traceback_plain
    calls = []

    def counted(q, *args, **kw):
        calls.append(q.shape[0])
        return plain(q, *args, **kw)

    monkeypatch.setattr(tdp, "global_and_traceback_plain", counted)
    want = tdp.global_and_traceback(*arrays, band=12)
    assert calls == [25]
    monkeypatch.setattr(tdp, "GLOBAL_DP_BYTES", 7 * 32 * (60 + 1) + 5)
    got = tdp.global_and_traceback(*arrays, band=12)
    assert calls == [25, 7, 7, 7, 4]
    for g, w, name in zip(got, want, ("score", "nm", "run_off", "runs")):
        assert torch.equal(g, w), name
    assert int(want[2][-1]) == want[3].numel() > 0


def test_global_dp_launcher_refuses_cpu_tensors():
    """The global DP kernel's launcher never runs a CPU tensor."""
    arrays = [torch.from_numpy(a) for a in global_dp_rows(4, 16, 24)]
    n0 = cuda_lib.LAUNCHES["global_dp"]
    with pytest.raises(ValueError):
        sw_cuda.global_traceback_cuda(*arrays, band=8)
    assert cuda_lib.LAUNCHES["global_dp"] == n0


def test_global_dp_kernel_module_imports_without_a_gpu():
    """Without nvcc or a card the launcher's modules import, the kernel's
    library is declared (its source beside the others) but not built,
    and the aligner's dispatch runs the plain route."""
    code = textwrap.dedent("""
        import os, torch
        from seqlib_tpu_torch.ops import cuda_lib, sw_cuda
        from seqlib_tpu_torch.align import device_pipeline as dp
        assert not torch.cuda.is_available()
        assert "global_dp" in cuda_lib.MAIN_PATH
        assert set(cuda_lib.SIGNATURES["global_dp"]) == {
            "global_dp", "global_dp_plan", "global_dp_gather"}
        assert os.path.exists(os.path.join(cuda_lib.CSRC, "global_dp.cu"))
        g = torch.Generator().manual_seed(0)
        q = torch.randint(0, 5, (6, 20), generator=g, dtype=torch.uint8)
        t = torch.randint(0, 5, (6, 30), generator=g, dtype=torch.uint8)
        ql = torch.randint(0, 21, (6,), generator=g)
        s, n, off, runs = dp.global_and_traceback(q, ql, t, ql + 5, band=8)
        assert s.shape == (6,) and n.shape == (6,) and off.shape == (7,)
        assert runs.shape == (int(off[-1]),)
        assert cuda_lib._libs == {} and cuda_lib.LAUNCHES["global_dp"] == 0
        assert cuda_lib.LAUNCHES["global_dp_gather"] == 0
        print("ok")
    """)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PATH=os.pathsep.join(p for p in os.environ.get("PATH", "")
                                    .split(os.pathsep)
                                    if not os.path.exists(
                                        os.path.join(p, "nvcc"))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")

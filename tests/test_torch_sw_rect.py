"""The port's rectangle-extension functions (kernels K3, K4, K5) against
the JAX package's TPU kernels run in interpret mode on the CPU.

On CPU tensors ``sw_cuda.extend_batch_rect`` (K3), ``sw_variants.extend_v3``
(K4) and ``sw_variants.extend_v4`` (K5) run their plain version
``ops.sw.extend_rect``.  The same numpy inputs go to
``seqlib_tpu.ops.sw_pallas.extend_batch_pallas(interpret=True)`` and to
``scripts/sw_variant_sweep.py``'s ``extend_v3`` / ``extend_v4`` (loaded
with importlib, each call in a fresh ``force_tpu_interpret_mode``).
Tolerance 0 on every output, with one stated rule: a gscore at or below
-16000 is "dead" (the last query row was never computed) and two dead
gscores compare equal, as tests/test_ops.py holds K3 to extend_batch.

The stop-row lanes (``bench_sw.rect_stop_inputs``: z-drop stops on rows
0, 1, P - 2 .. P and 2P of each pipeline depth P of K4 and K5 and on the
last row, ties, empty and oversized lanes) run each TPU kernel once, at
zdrop 0, 7, 100 and 10^6 between them.  One reference fact is kept
apart: the JAX TPU kernels pad the query with N rows to a multiple of
16 and, at zdrop 0, compute a lane with qlen > Lq on those rows, where
the JAX package's ``extend_batch`` (and the port) report its last row
dead; such lanes are held to ``extend_batch``.
"""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from seqlib_tpu.ops.sw import extend_batch as jax_extend_batch
from seqlib_tpu.ops.sw_pallas import extend_batch_pallas
from seqlib_tpu_torch.bench_sw import STOP_ROWS, rect_stop_inputs
from seqlib_tpu_torch.ops import sw_cuda, sw_variants
from seqlib_tpu_torch.ops.sw import RECT_MAX_LT, extend_rect

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("score", "qle", "tle", "gscore", "gtle")
B, LQ, LT = 256, 40, 60
DEAD = -16000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sweep():
    """scripts/sw_variant_sweep.py as a module; its top level edits
    sys.path and the environment, which are restored."""
    path, env = list(sys.path), dict(os.environ)
    spec = importlib.util.spec_from_file_location(
        "sw_variant_sweep", os.path.join(REPO, "scripts",
                                         "sw_variant_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
        os.environ.clear()
        os.environ.update(env)
    return mod


@pytest.fixture(scope="module")
def lanes():
    """Random lanes (codes 0-4), near-identical lanes, short lanes and
    empty lanes (qlen 0, tlen 0)."""
    rng = np.random.default_rng(7)
    q = rng.integers(0, 5, (B, LQ)).astype(np.int8)
    t = rng.integers(0, 5, (B, LT)).astype(np.int8)
    ql = rng.integers(1, LQ + 1, B).astype(np.int32)
    tl = rng.integers(1, LT + 1, B).astype(np.int32)
    h0 = rng.integers(0, 60, B).astype(np.int32)
    kind = rng.random(B)
    for m in np.flatnonzero(kind < 0.4):
        n = int(ql[m])
        t[m, :n] = q[m, :n]
        tl[m] = max(int(tl[m]), n)
        for p in rng.integers(0, n, int(rng.integers(0, 3))):
            t[m, p] = (t[m, p] + 1) % 4
    ql[(kind >= 0.4) & (kind < 0.55)] = rng.integers(1, 6)
    ql[kind >= 0.93] = 0
    tl[(kind >= 0.88) & (kind < 0.93)] = 0
    return q, ql, t, tl, h0


@pytest.fixture(scope="module")
def stop_lanes():
    """The stop-row lanes at 64 lanes, Lq 72 (stops up to row 2 * 32 and
    on row 71), Lt 60."""
    return tuple(a.numpy() for a in rect_stop_inputs(
        torch.device("cpu"), M=64, Lq=72, Lt=LT))


def _jax(fn, lanes, **kw):
    with pltpu.force_tpu_interpret_mode():
        out = fn(*(jnp.asarray(a) for a in lanes), **kw)
        return {k: np.asarray(v) for k, v in out.items()}


def _assert_equal(got: dict, want: dict):
    for k in KEYS:
        g = got[k].numpy()
        w = want[k]
        if k == "gscore":
            dead = (g <= DEAD) & (w <= DEAD)
            assert ((g == w) | dead).all(), k
        else:
            assert np.array_equal(g, w), k


@pytest.mark.parametrize("kernel,zdrop", [
    ("K3", 0), ("K3", 100), ("K4", 0), ("K4", 100), ("K5/2", 100),
    ("K5/3", 100),
    ("K3@stop", 0), ("K3@stop", 7), ("K3@stop", 100), ("K3@stop", 10**6),
    ("K4@stop", 7), ("K5/2@stop", 100), ("K5/3@stop", 10**6)])
def test_rect_equals_jax_kernel(sweep, lanes, stop_lanes, kernel, zdrop):
    kernel, _, inputs = kernel.partition("@")
    if inputs:
        lanes = stop_lanes
    t = [torch.from_numpy(a) for a in lanes]
    if kernel == "K3":
        got = sw_cuda.extend_batch_rect(*t, zdrop=zdrop)
        want = _jax(extend_batch_pallas, lanes, zdrop=zdrop, interpret=True)
    elif kernel == "K4":
        got = sw_variants.extend_v3(*t, zdrop=zdrop)
        want = _jax(sweep.extend_v3, lanes, BL=128, blocked_scan=True,
                    zdrop=zdrop)
    else:
        nch = int(kernel[-1])
        got = sw_variants.extend_v4(*t, nch=nch, zdrop=zdrop)
        want = _jax(sweep.extend_v4, lanes, NCH=nch, zdrop=zdrop)
    if inputs:
        past = lanes[1] > lanes[0].shape[1]
        assert past.sum() >= 2
        if zdrop == 0:
            # the TPU kernel computes some of them on its N padding
            assert (want["gscore"][past] > DEAD).any()
            ref = {k: np.asarray(v) for k, v in jax_extend_batch(
                *(jnp.asarray(a) for a in lanes), zdrop=0).items()}
            for k in KEYS:
                want[k] = np.where(past, ref[k], want[k])
        _assert_equal(got, want)
        rows = extend_rect(*t, zdrop=zdrop, return_rows=True)["rows"]
        if zdrop > 0:
            assert set(STOP_ROWS) | {71} <= set((rows - 1).tolist())
        return
    _assert_equal(got, want)
    assert (got["score"] > 0).sum() > B // 4
    assert (got["gscore"] <= DEAD).sum() > 0


def test_extend_v4_rejects_zdrop_zero(lanes):
    t = [torch.from_numpy(a) for a in lanes]
    for zdrop in (0, -1):
        with pytest.raises(ValueError, match="zdrop"):
            sw_variants.extend_v4(*t, zdrop=zdrop)
    with pytest.raises(ValueError, match="nch"):
        sw_variants.extend_v4(*t, nch=4)


def test_jax_k5_at_zdrop_zero_is_another_function(sweep, lanes):
    """Why ``extend_v4`` refuses zdrop <= 0: the sweep's K5 runs its
    z-drop test unconditionally (a lane stops once its row max is <= 0),
    so at zdrop = 0 it is not ``extend_batch``, which the port computes.
    The counts of differing lanes are the ones ROADMAP.md records."""
    t = [torch.from_numpy(a) for a in lanes]
    want = {k: v.numpy() for k, v in extend_rect(*t, zdrop=0).items()}
    got = _jax(sweep.extend_v4, lanes, NCH=2, zdrop=0)
    assert (got["score"] != want["score"]).sum() == 57
    assert (got["gscore"] != want["gscore"]).sum() == 236


def test_rect_dead_row_convention(lanes):
    """A lane whose last row is never computed reports (-2^30, 0); a
    computed last row always has a live column 0."""
    t = [torch.from_numpy(a) for a in lanes]
    out = extend_rect(*t, zdrop=100, return_rows=True)
    ql = t[1]
    dead = out["gscore"] <= DEAD
    assert torch.equal(dead, (out["rows"] < ql) | (ql == 0))
    assert (out["gscore"][dead] == -2**30).all()
    assert (out["gtle"][dead] == 0).all()
    assert (out["gscore"][~dead] > -2 * LQ - LT).all()


def test_cuda_launcher_refuses_cpu_tensors(lanes):
    t = [torch.from_numpy(a) for a in lanes]
    for entry in ("sw_extend_rect", "sw_extend_rect_blocked"):
        with pytest.raises(ValueError, match="CUDA"):
            sw_cuda.launch_rect(entry, *t)
    one = torch.ones(1, dtype=torch.int32)
    for Lq, Lt in ((4096, 8), (8, RECT_MAX_LT + 1)):
        with pytest.raises(ValueError, match=f"Lt <= {RECT_MAX_LT}"):
            extend_rect(torch.zeros((1, Lq), dtype=torch.int8), one,
                        torch.zeros((1, Lt), dtype=torch.int8), one, one)


# scorings at the edges of what the rectangle kernels take: large
# scores, a large match, large gap penalties, a mismatch of 1
EXTREME_SCORES = {
    "default": {}, "match 110": dict(match=110),
    "large penalties": dict(o_del=40, e_del=20, o_ins=40, e_ins=20,
                            mismatch=10),
    "mismatch 1": dict(mismatch=1)}


@pytest.mark.parametrize("zdrop", [0, 100])
@pytest.mark.parametrize("score", EXTREME_SCORES)
def test_rect_extreme_scores_equal_jax(lanes, score, zdrop):
    """K3's function on CPU tensors == the JAX package's extend_batch
    (band 0) on lanes whose best scores reach 32767 and pass it (h0 +
    match * min(qlen, tlen) = 32767 on the first half of the lanes,
    32768 on the second), under each EXTREME_SCORES scoring; tolerance 0 with the
    dead-gscore rule."""
    kw = EXTREME_SCORES[score]
    q, ql, t, tl, _ = lanes
    g = kw.get("match", 1) * np.minimum(ql, tl)
    h0 = (32767 + (np.arange(B) >= B // 2) - g).astype(np.int32)
    src = (q, ql, t, tl, h0)
    got = sw_cuda.extend_batch_rect(*(torch.from_numpy(a) for a in src),
                                    zdrop=zdrop, **kw)
    want = {k: np.asarray(v) for k, v in jax_extend_batch(
        *(jnp.asarray(a) for a in src), zdrop=zdrop, **kw).items()}
    _assert_equal(got, want)
    assert {32767, 32768} <= set(got["score"].tolist())

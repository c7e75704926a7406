"""The port's device pipeline stages against the JAX package.

A 64-read batch of the hermetic repeat corpus (every class, including
the repeat classes that exercise re-seeding, pass 3, multi-chain reads
and the per-seed second extension) goes through ``seed_and_locate``,
``chain_device``, ``seed_chain_extend`` and ``align_full`` in both
packages on the CPU, with the aligner's default options.  Every output
is an integer array and must be exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from global_dp_rows import runs_of_codes
from regen_golden import make_repeat_genome, make_repeat_reads
from seqlib_tpu.align import device_full as jfull
from seqlib_tpu.align import device_pipeline as jdp
from seqlib_tpu.index import FMIndex as JaxFMIndex
from seqlib_tpu.ops.fm import DeviceFMIndex as JaxDeviceFMIndex
from seqlib_tpu_torch.align import device_full as tfull
from seqlib_tpu_torch.align import device_pipeline as tdp
from seqlib_tpu_torch.align.options import AlignerOptions
from seqlib_tpu_torch.core.seq import encode_nt4
from seqlib_tpu_torch.index import FMIndex, both_strands
from seqlib_tpu_torch.ops.fm import DeviceFMIndex


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once: one intra-op
    thread per process keeps torch's CPU thread pools from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OPT = AlignerOptions()
SEED_KW = dict(max_seeds=16, min_seed_len=OPT.min_seed_len,
               max_occ=OPT.max_occ, k_occ=16, split_len=OPT.split_len,
               split_width=OPT.split_width, max_mem_intv=OPT.max_mem_intv)
CHAIN_KW = dict(band=OPT.w, max_chain_gap=OPT.max_chain_gap,
                drop_ratio=OPT.drop_ratio, max_chains=4)
EXT_KW = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins,
              e_ins=OPT.e_ins, match=OPT.a, mismatch=OPT.b,
              pen_clip5=OPT.pen_clip5, pen_clip3=OPT.pen_clip3, w=OPT.w,
              zdrop=OPT.zdrop)


def _eq(a, b, msg=""):
    a = np.asarray(a)
    b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, (msg, a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), msg


@pytest.fixture(scope="module")
def setup():
    genome = make_repeat_genome()
    reads = make_repeat_reads(genome)
    picks = [r for c in range(10) for r in reads[100 * c + 30:100 * c + 36]]
    picks += reads[990:994]
    enc = np.full((len(picks), 160), 4, np.uint8)
    lens = np.zeros(len(picks), np.int32)
    for i, (_, s) in enumerate(picks):
        e = encode_nt4(s)
        enc[i, :e.size] = e
        lens[i] = e.size
    ji = JaxFMIndex.construct([("rep1", genome)])
    ti = FMIndex.construct([("rep1", genome)])
    text = both_strands(ti.ref.codes)
    jax_side = (JaxDeviceFMIndex.from_host(ji), jnp.asarray(text),
                jnp.asarray(enc), jnp.asarray(lens))
    torch_side = (DeviceFMIndex.from_host(ti, device="cpu"),
                  torch.from_numpy(text), torch.from_numpy(enc),
                  torch.from_numpy(lens))
    return ti.l_pac, enc, lens, jax_side, torch_side


def test_seed_and_locate_and_chain_equal_jax(setup):
    l_pac, _, _, (jf, _, jr, jl), (tf, _, tr, tl) = setup
    want = jdp.seed_and_locate(jf, jr, jl, **SEED_KW)
    got = tdp.seed_and_locate(tf, tr, tl, **SEED_KW)
    for k in ("qbeg", "qend", "pos", "rep_cov", "occ_clip", "seeds_full"):
        _eq(want[k], got[k], k)
    assert int((np.asarray(want["pos"]) >= 0).sum()) > 0
    wc = jdp.chain_device(want["qbeg"], want["qend"], want["pos"], l_pac,
                          **CHAIN_KW)
    gc = tdp.chain_device(got["qbeg"], got["qend"], got["pos"], l_pac,
                          **CHAIN_KW)
    for k in ("anchor_q", "anchor_len", "anchor_r", "weight", "keep",
              "n_seg"):
        _eq(wc[k], gc[k], k)


def test_seed_chain_extend_equals_jax(setup):
    l_pac, _, _, (jf, jt, jr, jl), (tf, tt, tr, tl) = setup
    kw = dict(l_pac=l_pac, **SEED_KW, **CHAIN_KW, **EXT_KW)
    want = jdp.seed_chain_extend(jf, jt, jr, jl, **kw)
    got = tdp.seed_chain_extend(tf, tt, tr, tl, **kw)
    for k in ("qb", "qe", "rb", "re", "score", "weight", "keep", "anchor_q",
              "anchor_len", "anchor_r", "rep_cov", "occ_clip", "seeds_full",
              "n_seg", "esc_over"):
        _eq(want[k], got[k], k)
    assert int(np.asarray(want["n_dp"])[0]) == got["n_dp"]
    # the batch reaches the per-seed second extension
    assert int(np.asarray(want["keep"])[:, 4:].sum()) > 0


def test_align_full_equals_jax(setup):
    l_pac, enc, lens, (jf, jt, _, _), (tf, tt, _, _) = setup
    enc_lens = np.concatenate(
        [enc, lens.astype("<u4").view(np.uint8).reshape(-1, 4)], axis=1)
    kw = dict(l_pac=l_pac, **SEED_KW, **CHAIN_KW, **EXT_KW, T=OPT.T,
              mask_level=OPT.mask_level,
              mask_level_redun=OPT.mask_level_redun, glob_band=2 * OPT.w + 8)
    want = jfull.align_full(jf, jt, jnp.asarray(enc_lens), **kw)
    got = tfull.align_full(tf, tt, torch.from_numpy(enc_lens), **kw)
    for a, b, name in zip(want, got, ("regions", "snm")):
        _eq(a, b, name)
    # the CIGAR runs: those decoded from the JAX package's packed codes
    off, runs = runs_of_codes(want[2])
    _eq(off, got[2], "run_off")
    _eq(runs, got[3][:int(got[2][-1])], "runs")
    assert off.size == tdp.dp_rows(enc.shape[0]) + 1 and runs.size > 0
    flags = np.asarray(want[0])[:, :7 * jfull.NFIELD].reshape(
        -1, 7, jfull.NFIELD)[:, :, jfull.F_FLAGS]
    assert (flags & jfull.FLAG_EMIT).any() and (flags & jfull.FLAG_PERFECT
                                                 ).any()

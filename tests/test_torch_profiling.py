"""The port's tracer (``seqlib_tpu_torch.profiling``) on its main path.

A small genome, a loaded index (so the LF walk runs) and 16 reads of
32 bp in two batches of 8 go through ``align_stream_bam`` on the CPU
three times: under torch.profiler with the tracer off, under it with
the tracer on, and with the tracer on alone.  The tracer must record
nothing while off, change no record, give each batch one
``stream.batch`` root with its children and the finish's spans the same
batch id on a worker thread, link parents into a tree, stamp spans on
the profiler's clock, add no read of a device value (the profiler's
``aten::_local_scalar_dense`` and ``aten::nonzero`` calls, which equal
the ``sync.*`` counters inside ``align.full``) and count the same twice.
Loading bwa's files and putting the index on the device record the
``index.*`` spans and the bytes put there while the tracer is on,
nothing while it is off, and load the same index either way.

The ``gpu`` test runs on a card only (``--noconftest``: this file does
not import JAX):

    python -m pytest -m gpu --noconftest tests/test_torch_profiling.py
"""

import bisect
import collections
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from seqlib_tpu_torch import profiling
from seqlib_tpu_torch.align import AlignerOptions, BWAAligner
from seqlib_tpu_torch.index import FMIndex
from seqlib_tpu_torch.ops.fm import DeviceFMIndex
from seqlib_tpu_torch.sim import make_genome, simulate_reads

Read = collections.namedtuple("Read", "name seq")
BATCH = 8
STAGES = {"seed", "locate", "chain", "extend", "dedup_mark", "global_dp",
          "pack"}
BATCH_CHILDREN = {"stream.read", "stream.encode", "align.full"}
FINISH_CHILDREN = {"finish.fetch", "finish.cols", "finish.encode"}
HOST_READS = ("aten::_local_scalar_dense", "aten::nonzero")
# CUDA runtime calls in which the host waits for the device
WAIT_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize", "cudaMemcpy")


def _reads(genome: str, n: int, seed: int, length: int = 32) -> list:
    """Reads cut from ``genome``: exact, with a substitution, a deletion
    or an insertion three quarters along (past one seed's length), every
    other one reverse-complemented."""
    rng = np.random.default_rng(seed)
    comp = str.maketrans("ACGT", "TGCA")
    out = []
    for i in range(n):
        p = int(rng.integers(0, len(genome) - length - 1))
        s = genome[p:p + length + 1]
        mid = 3 * length // 4
        kind = i % 4
        if kind == 0:
            s = s[:length]
        elif kind == 1:
            s = s[:mid] + ("A" if s[mid] != "A" else "C") + s[mid + 1:length]
        elif kind == 2:
            s = s[:mid] + s[mid + 1:]
        else:
            s = s[:mid] + "T" + s[mid:length - 1]
        if i % 2:
            s = s.translate(comp)[::-1]
        out.append(Read(f"r{i}_{p}", s))
    return out


def _stream(aln, reads) -> list:
    return [(bytes(payload), list(np.asarray(counts)))
            for _, payload, counts in aln.align_stream_bam(
                iter(reads), batch_size=BATCH, workers=2)]


def _events(prof) -> list:
    """The profiler's host events as (name, start_ns, end_ns, thread)."""
    cpu = torch.autograd.DeviceType.CPU
    return [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cpu]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        genome = make_genome(60_000, seed=3, n_segments=2, seg_len=1000)
        prefix = str(tmp_path_factory.mktemp("profiling") / "ref")
        FMIndex.construct([("c1", genome)]).write(prefix)
        aln = BWAAligner(FMIndex.load(prefix), options=AlignerOptions(T=20),
                         device="cpu")
        reads = _reads(genome, 2 * BATCH, seed=5)
        profiling.take()
        with profile(activities=[ProfilerActivity.CPU]) as p_off:
            off = _stream(aln, reads)
        left = profiling.take()
        with profile(activities=[ProfilerActivity.CPU]) as p_on, \
                profiling.tracing():
            on = _stream(aln, reads)
        rec = profiling.take()
        with profiling.tracing():
            again = _stream(aln, reads)
        rec2 = profiling.take()
        return dict(off=off, left=left, on=on, rec=rec, again=again,
                    rec2=rec2, ev_off=_events(p_off), ev_on=_events(p_on))
    finally:
        torch.set_num_threads(n_threads)


def _children(spans) -> dict:
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    return kids


def test_tracing_off_records_nothing(runs):
    assert runs["left"].spans == [] and runs["left"].counters == {}
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b") \
        is profiling.sync("c") is profiling.upload("d")
    profiling.count("e", 3)
    assert profiling.take() == ([], {})


def test_records_identical_with_tracing_on_and_off(runs):
    assert runs["off"] and sum(len(p) for p, _ in runs["off"]) > 0
    assert runs["on"] == runs["off"] and runs["again"] == runs["off"]


def test_each_batch_has_one_root_with_its_children(runs):
    spans = runs["rec"].spans
    kids = _children(spans)
    roots = [s for s in spans if s.name == "stream.batch"]
    assert len(roots) == 2 and all(s.parent is None for s in roots)
    assert len({s.batch for s in roots}) == 2
    main = {s.thread for s in roots}
    assert len(main) == 1
    for root in roots:
        names = [k.name for k in kids[root.id]]
        assert BATCH_CHILDREN <= set(names)
        assert names.count("align.full") == 1
        full = [k for k in kids[root.id] if k.name == "align.full"][0]
        stages = [k.name for k in kids[full.id] if k.name in STAGES]
        assert sorted(stages) == sorted(STAGES)
        finish = [s for s in spans if s.name == "stream.finish"
                  and s.batch == root.batch]
        assert len(finish) == 1 and finish[0].parent is None
        assert finish[0].thread not in main
        assert FINISH_CHILDREN <= {k.name for k in kids[finish[0].id]}
        assert all(k.batch == root.batch for k in kids[finish[0].id])
    # both batches are handed over after the reads run out
    for name in ("stream.wait", "stream.caller"):
        handed = [s for s in spans if s.name == name]
        assert sorted(s.batch for s in handed) == \
            sorted(s.batch for s in roots)
    # no CUDA device: no span is timed on one
    assert not any("stream_ms" in s.attrs for s in spans)


def test_parent_links_form_a_tree(runs):
    spans = runs["rec"].spans
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.start_ns <= s.end_ns
        seen = set()
        p = s
        while p.parent is not None:
            assert p.id not in seen
            seen.add(p.id)
            up = by_id[p.parent]
            assert up.thread == p.thread and up.batch == p.batch
            assert up.start_ns <= p.start_ns and p.end_ns <= up.end_ns
            p = up


def test_spans_share_the_profilers_clock(runs):
    """Each span of the dispatching thread starts within 1 ms of its
    record_function range in the profiler's trace: one clock for spans
    and the trace.  (The profiler records the thread that started it;
    the stream's workers are threads of their own.)"""
    ev = runs["ev_on"]
    main = {e[3] for e in ev if e[0] == "stream.batch"}
    by_name = collections.defaultdict(list)
    for name, start, _, thread in ev:
        if thread in main:
            by_name[name].append(start)
    roots = {s.thread for s in runs["rec"].spans if s.name == "stream.batch"}
    spans = collections.defaultdict(list)
    for s in runs["rec"].spans:
        if s.thread in roots:
            spans[s.name].append(s.start_ns)
    assert {"align.full", "seed", "sync.locate.keep"} <= set(spans)
    for name, starts in spans.items():
        ev = sorted(by_name[name])
        assert len(ev) == len(starts), name
        for a, b in zip(sorted(starts), ev):
            assert abs(a - b) < 1_000_000, (name, a, b)


def test_tracing_adds_no_host_read(runs):
    def reads(ev):
        return collections.Counter(e[0] for e in ev if e[0] in HOST_READS)
    off, on = reads(runs["ev_off"]), reads(runs["ev_on"])
    assert off == on and off["aten::_local_scalar_dense"] > 0


def test_sync_counters_equal_the_profilers_host_reads(runs):
    """The ``sync.*`` counters equal the profiler's host reads on the
    dispatching thread inside ``align.full``."""
    ev = runs["ev_on"]
    full = [e for e in ev if e[0] == "align.full"]
    main = {e[3] for e in ev if e[0] == "stream.batch"}
    assert len(full) == 2 and len(main) == 1
    inside = sum(1 for e in ev if e[0] in HOST_READS and e[3] in main
                 and any(f[1] <= e[1] <= f[2] for f in full))
    counters = runs["rec"].counters
    assert sum(v for k, v in counters.items()
               if k.startswith("sync.")) == inside
    for site in ("sync.locate.lanes", "sync.extend.rows",
                 "sync.global_dp.rows", "sync.traceback.live"):
        assert counters[site] >= 2, site


def test_counters_repeat_and_come_from_the_host(runs):
    a, b = runs["rec"].counters, runs["rec2"].counters
    assert a == b
    assert a["locate.lanes"] > 0 and a["locate.rounds"] > 0
    assert a["locate.lane_steps"] >= a["locate.lanes"]
    assert a["global_dp.rows"] > 0 and a["traceback.steps"] > 0
    assert a["extend.rows"] > 0
    assert a["global_dp.dp_rows_run"] > 0


def test_device_counters_of_a_cpu_tensor_add_at_once():
    """``count_device`` adds nothing while the tracer is off, and a CPU
    tensor's values at once while it is on; the walk's counters come
    from the plain loop on the CPU and from the kernel's totals on a
    card (``tests/test_torch_gpu.py``)."""
    profiling.take()
    values = torch.tensor([2, 0, 5], dtype=torch.int64)
    profiling.count_device(("a", "b", "c"), values)
    assert profiling.take().counters == {}
    with profiling.tracing():
        profiling.count_device(("a", "b", "c"), values)
        profiling.count_device(("a", "b", "c"), values)
    assert profiling.take().counters == {"a": 4, "b": 0, "c": 10}


def test_stage_timer_sums_spans(runs):
    spans = runs["rec"].spans
    t = profiling.StageTimer().add(spans)
    n = collections.Counter(s.name for s in spans)
    assert dict(t.counts) == dict(n)
    assert abs(t.totals["align.full"]
               - sum(s.ms for s in spans if s.name == "align.full") / 1e3) \
        < 1e-9
    assert t.report().splitlines()[0].startswith("stream.batch")


def test_device_trace_writes_spans_beside_the_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        with profiling.span("outer"):
            with profiling.sync("site"):
                torch.arange(10).sum().item()
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 2 and files[0].startswith("spans_") \
        and files[1].startswith("trace_")
    saved = json.loads((tmp_path / files[0]).read_text())
    assert [s["name"] for s in saved["spans"]] == ["sync.site", "outer"]
    assert saved["spans"][0]["parent"] == saved["spans"][1]["id"]
    assert saved["counters"] == {"sync.site": 1}
    assert "outer" in (tmp_path / files[1]).read_text()
    assert profiling.take() == ([], {})


def test_tracer_under_threads():
    """Counters and spans from many threads at once lose nothing, and
    nested entries are counted."""
    n_threads, n = 24, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.tracing():
            with profiling.tracing():
                pass
            assert profiling.enabled()

            def work():
                with profiling.span("t"):
                    for _ in range(n):
                        profiling.count("c")
                        with profiling.span("u"):
                            pass

            ts = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert not profiling.enabled()
    rec = profiling.take()
    assert rec.counters == {"c": n_threads * n}
    names = collections.Counter(s.name for s in rec.spans)
    assert names == {"t": n_threads, "u": n_threads * n}
    outer = {s.id: s.thread for s in rec.spans if s.name == "t"}
    assert all(outer[s.parent] == s.thread for s in rec.spans
               if s.name == "u")


@pytest.fixture(scope="module")
def loads(tmp_path_factory):
    """bwa's files of a small two-contig index, loaded and put on the
    device with the tracer off, then on: (off, on, records)."""
    genome = make_genome(20_000, seed=9, n_segments=1, seg_len=1000)
    prefix = str(tmp_path_factory.mktemp("index_spans") / "ref")
    FMIndex.construct([("a", genome[:12_000]),
                       ("b", genome[12_000:])]).write(prefix)
    profiling.take()
    off = FMIndex.load(prefix)
    off_fm = DeviceFMIndex.from_host(off, device="cpu")
    off_aln = BWAAligner(off, device="cpu")
    left = profiling.take()
    with profiling.tracing():
        on = FMIndex.load(prefix)
        on_fm = DeviceFMIndex.from_host(on, device="cpu")
    rec = profiling.take()
    with profiling.tracing():
        on_aln = BWAAligner(on, device="cpu")
    rec_aln = profiling.take()
    return dict(off=(off, off_fm, off_aln), on=(on, on_fm, on_aln),
                left=left, rec=rec, rec_aln=rec_aln)


def test_index_load_and_upload_spans(loads):
    """``FMIndex.load`` records ``index.load`` and its four children,
    ``from_host`` ``index.upload`` with the bytes of the tables it put on
    the device, and the aligner ``index.upload_text`` with the text's;
    nothing while the tracer is off."""
    assert loads["left"] == ([], {})
    idx, fm, aln = loads["on"]
    spans = {s.name: s for s in loads["rec"].spans}
    assert len(spans) == len(loads["rec"].spans) == 6
    load = spans.pop("index.load")
    upload = spans.pop("index.upload")
    assert set(spans) == {"index.read_pac", "index.read_bwt",
                          "index.layout", "index.read_sa"}
    assert all(s.parent == load.id for s in spans.values())
    assert load.parent is None and upload.parent is None
    assert load.start_ns <= min(s.start_ns for s in spans.values()) \
        and max(s.end_ns for s in spans.values()) <= load.end_ns
    assert load.end_ns <= upload.start_ns
    assert loads["rec"].counters == {
        "index.occ_bytes": fm.blocks.numel() * 4,
        "index.sa_bytes": 8 * idx.sa_samples.size}
    assert fm.blocks.shape == (idx.bwt_words.shape[0] + 1, 12)
    assert [s.name for s in loads["rec_aln"].spans] == [
        "index.upload", "index.upload_text"]
    assert loads["rec_aln"].counters == {
        "index.occ_bytes": fm.blocks.numel() * 4,
        "index.sa_bytes": 8 * idx.sa_samples.size,
        "index.text_bytes": 2 * idx.l_pac}
    assert aln.text_t.numel() == 2 * idx.l_pac


def test_index_load_same_with_tracing_on_and_off(loads):
    (a, fa, la), (b, fb, lb) = loads["off"], loads["on"]
    for k in ("bwt", "cp_counts", "bwt_words", "sa_samples", "L2"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert (a.primary, a.seq_len, a.sa_intv, a.sa_full) == \
        (b.primary, b.seq_len, b.sa_intv, b.sa_full)
    assert np.array_equal(a.ref.codes, b.ref.codes)
    assert a.ref.anns == b.ref.anns and a.ref.holes == b.ref.holes
    for k in ("blocks", "sa", "L2"):
        assert torch.equal(getattr(fa, k), getattr(fb, k)), k
    assert (fa.L2_host, fa.primary, fa.seq_len, fa.l_pac, fa.sa_intv) == \
        (fb.L2_host, fb.primary, fb.seq_len, fb.l_pac, fb.sa_intv)
    assert torch.equal(la.text_t, lb.text_t)
    assert torch.equal(la.fm.blocks, lb.fm.blocks)


@pytest.mark.gpu
def test_stage_device_times_on_the_card(tmp_path):
    """Every stage span of ``align_full`` has a ``stream_ms`` >= 0, their
    sum is within the batch's ``align.full`` device interval, and the
    ``sync.*`` counters equal the profiler's host reads of a device value
    on the dispatching thread inside ``align.full``: the
    ``aten::_local_scalar_dense`` and ``aten::nonzero`` calls that wait
    in a synchronising CUDA call.  (Setting an element of a CUDA tensor
    to a Python number, ``src[:, 0] = DIR_F`` in the global DP, calls
    ``aten::item`` on a CPU scalar inside ``aten::fill_``: a host read
    of a host value, which does not wait.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    genome = make_genome(200_000, seed=3, n_segments=2, seg_len=2000)
    prefix = str(tmp_path / "ref")
    FMIndex.construct([("c1", genome)]).write(prefix)
    aln = BWAAligner(FMIndex.load(prefix), device="cuda")
    reads = [Read(n, s) for n, s in simulate_reads(genome, 8192, seed=9)]

    def stream():
        return [(bytes(p), list(np.asarray(c))) for _, p, c in
                aln.align_stream_bam(iter(reads), batch_size=4096,
                                     workers=2)]

    off = stream()
    profiling.take()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof, profiling.tracing():
        on = stream()
    torch.cuda.synchronize()
    rec = profiling.take()
    assert on == off
    kids = _children(rec.spans)
    fulls = [s for s in rec.spans if s.name == "align.full"]
    assert len(fulls) == 2
    # the loaded index's walk: one kernel launch a batch, its device
    # totals added by the finish's device_times, and no device read
    c = rec.counters
    assert c["locate.walk_launches"] == 2
    assert c["locate.lane_steps"] > 0 and c["locate.lanes"] > 0
    assert not any(k.startswith("sync.locate.") for k in c)
    for full in fulls:
        stages = [k for k in kids[full.id] if k.name in STAGES]
        assert sorted(k.name for k in stages) == sorted(STAGES)
        assert all(k.attrs["stream_ms"] >= 0 for k in stages)
        assert sum(k.attrs["stream_ms"] for k in stages) \
            <= full.attrs["stream_ms"] + 1e-3
    ev = _events(prof)
    waits = sorted((e[1], e[2]) for e in ev
                   if e[0] in WAIT_CALLS)
    assert waits, "the profiler recorded no synchronising CUDA call"
    starts = [a for a, _ in waits]
    main = {e[3] for e in ev if e[0] == "stream.batch"}
    spans = [e for e in ev if e[0] == "align.full" and e[3] in main]
    reads_ = [e for e in ev if e[0] in HOST_READS and e[3] in main
              and any(f[1] <= e[1] <= f[2] for f in spans)]

    def waits_in(e):
        k = bisect.bisect_left(starts, e[1])
        return k < len(waits) and waits[k][1] <= e[2]

    device_reads = [e for e in reads_ if waits_in(e)]
    counted = sum(v for k, v in rec.counters.items()
                  if k.startswith("sync."))
    assert counted == len(device_reads), (
        counted, len(reads_), collections.Counter(e[0] for e in reads_))

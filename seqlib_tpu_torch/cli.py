"""``seqtools`` command line (counterpart of seqlib_tpu/cli.py).

    python -m seqlib_tpu_torch.cli index ref.fa
    python -m seqlib_tpu_torch.cli align -F reads.fq -G ref.fa -b -o out.bam
    python -m seqlib_tpu_torch.cli align -F r1.fq -2 r2.fq -G ref.fa
    python -m seqlib_tpu_torch.cli bfc -f -F reads.fq
    python -m seqlib_tpu_torch.cli fml -f -F reads.fq

``bfc`` streams reads (BAM/SAM, or FASTA/FASTQ with ``-F``),
BFC-corrects them, and writes FASTA (``-f``) or realigns them to a
reference (``-G``) into SAM/BAM; ``fml`` assembles the corrected reads
into contigs before that; ``align`` maps reads as bwa mem does (pairs
with ``-2``); ``index`` writes bwa's five index files beside a FASTA,
and ``align -G`` loads them when they are there.  The flags are the JAX
package's.

``--device`` (default ``cuda``) is where the aligner, BFC and the
assembler run; without a GPU the default fails, and ``--device cpu``
runs the plain PyTorch versions of the kernels.  ``-b`` writes BAM,
``-C`` reference-free CRAM, and SAM otherwise.

A reference over ``index.sharded.DEFAULT_MAX_SHARD_BP`` bases is
sharded, as the JAX CLI does: ``index`` writes ``<ref>.shard<k>.*`` and
a ``<ref>.shards`` manifest, ``align -G`` opens a ``.shards`` prefix (or
builds a sharded index from such a FASTA) with ``ShardedBWAAligner``,
whose pairs get flags and mates only (no mate rescue), and a
monolithic index of bwa's files past the bound is refused.  Errors
print ``seqtools: error: ...`` and exit 1.
"""

from __future__ import annotations

import argparse
import os
import sys

from .align import BWAAligner, ShardedBWAAligner
from .align.pairing import mark_supplementary
from .assembly import BFC, FermiAssembler
from .core.unaligned import UnalignedSequence
from .device import resolve_device
from .index import FMIndex, ShardedFMIndex
from .index import sharded as _sharded
from .index.bwa_files import read_ann
from .io import BAM, CRAM, SAM, BamReader, BamWriter, FastqReader


def _read_input(args) -> list[UnalignedSequence]:
    if args.infasta:
        return list(FastqReader(args.infasta))
    path = args.input or "-"
    if path != "-" and path.endswith(".bam"):
        # native columnar reader; a file it cannot parse (ValueError)
        # goes to BamReader, a native library that cannot be built raises
        from .io.fast_bam import FastBamReader
        try:
            return [UnalignedSequence(r.qname, r.seq, r.qualities())
                    for r in FastBamReader(path)]
        except ValueError:
            pass
    rd = BamReader()
    if not rd.open(path):
        raise OSError(f"cannot open input {args.input}")
    return [UnalignedSequence(r.qname, r.seq, r.qualities())
            for r in iter(rd.next, None)]


def _open_writer(args, hdr) -> BamWriter:
    fmt = BAM if args.bam else (CRAM if args.cram else SAM)
    w = BamWriter(fmt)
    if not w.open(args.output or "-"):
        raise OSError(f"cannot open output {args.output}")
    w.set_header(hdr)
    w.write_header()
    return w


def _emit(seqs, names, args, tag: str, quals=None) -> None:
    """FASTA out, or realign to the reference into SAM/BAM: batches of
    512 through ``align_batch``, ``mark_supplementary``, then the input
    qualities back where the lengths agree."""
    if args.fasta or not args.reference:
        out = sys.stdout
        for name, s in zip(names, seqs):
            out.write(f">{name}\n{s}\n")
        return
    idx, aln = _open_aligner(args.reference, args.device)
    w = _open_writer(args, idx.header_from_index())
    B = 512
    n = 0
    for i in range(0, len(seqs), B):
        chunk = seqs[i:i + B]
        results = aln.align_batch(chunk, names[i:i + B], hardclip=False,
                                  keep_sec_frac=0.9, max_secondary=10)
        for k, recs in enumerate(results):
            mark_supplementary(recs)
            for r in recs:
                if quals is not None and quals[i + k] \
                        and len(quals[i + k]) == len(r.seq):
                    r.set_qualities(quals[i + k])
                w.write_record(r)
                n += 1
        if args.verbose:
            print(f"...aligned {i + len(chunk)} sequences",
                  file=sys.stderr)
    w.close()
    if args.verbose:
        print(f"{tag}: wrote {n} records", file=sys.stderr)


def _has_index(prefix: str) -> bool:
    return all(os.path.exists(prefix + e)
               for e in (".bwt", ".pac", ".sa", ".ann", ".amb"))


def _open_aligner(reference: str, device):
    """(index, aligner) for a reference: a sharded index when a
    ``.shards`` manifest is beside it, else bwa's index files, else an
    index built from the FASTA (sharded past the bound)."""
    bound = _sharded.DEFAULT_MAX_SHARD_BP
    if os.path.exists(reference + ".shards"):
        sidx = ShardedFMIndex.load(reference)
        return sidx, ShardedBWAAligner(sidx, devices=[device])
    if _has_index(reference):
        l_pac = read_ann(reference + ".ann")[0]
        if l_pac > bound:
            raise ValueError(
                f"index {reference} spans {l_pac} bp > device bound "
                f"{bound}; rebuild it sharded with 'seqtools index' "
                "(writes a .shards manifest)")
        idx = FMIndex.load(reference)
        return idx, BWAAligner(idx, device=device)
    seqs = _load_fasta(reference)
    if sum(len(s) for _, s in seqs) > bound:
        sidx = ShardedFMIndex.construct(seqs)
        return sidx, ShardedBWAAligner(sidx, devices=[device])
    idx = FMIndex.construct(seqs)
    return idx, BWAAligner(idx, device=device)


def _load_fasta(path: str):
    """(name, seq) pairs of a FASTA."""
    return [(r.name, r.seq) for r in FastqReader(path)]


def run_bfc(args) -> None:
    """Correct reads with BFC; FASTA out or realigned."""
    seqs = _read_input(args)
    b = BFC(device=args.device)
    for u in seqs:
        b.add_sequence(u.seq, u.qual, u.name)
    if args.verbose:
        print(f"...loaded {b.num_sequences()} sequences", file=sys.stderr)
    b.train()
    b.error_correct()
    if args.verbose:
        print(f"...corrected (k={b.get_kmer()}, kcov={b.get_kcov():.1f})",
              file=sys.stderr)
    corrected, names = [], []
    b.reset_get_sequence()
    while (nxt := b.get_sequence()) is not None:
        corrected.append(nxt[0])
        names.append(nxt[1])
    _emit(corrected, names, args, "bfc", quals=b.m_quals)


def run_fml(args) -> None:
    """Correct and assemble reads; contigs as FASTA or realigned."""
    f = FermiAssembler(device=args.device)
    f.add_reads(_read_input(args))
    if args.verbose:
        print(f"...loaded {f.num_sequences()} sequences", file=sys.stderr)
    f.correct_reads()
    f.perform_assembly()
    contigs = f.get_contigs()
    if args.verbose:
        print(f"...assembled {len(contigs)} contigs", file=sys.stderr)
    _emit(contigs, [f"contig_{i}" for i in range(len(contigs))], args,
          "fml")


def run_align(args) -> None:
    """bwa mem-style alignment; pairs with -2."""
    if args.infasta2:
        _run_align_paired(args)
        return
    seqs = _read_input(args)
    _emit([u.seq for u in seqs], [u.name for u in seqs], args, "align")


def _run_align_paired(args) -> None:
    """Pairs in batches of 512 through ``align_pairs``: insert-size
    inference carried from batch to batch, mate rescue, proper-pair
    bounds."""
    from .align.pairing import align_pairs
    r1 = list(FastqReader(args.infasta))
    r2 = list(FastqReader(args.infasta2))
    if len(r1) != len(r2):
        sys.exit("paired inputs have different read counts")
    idx, aln = _open_aligner(args.reference, args.device)
    w = _open_writer(args, idx.header_from_index())
    B = 512
    n = 0
    stats = None
    rescue_capable = hasattr(aln, "text")   # sharded: flags only
    for i in range(0, len(r1), B):
        out1, out2, stats = align_pairs(
            aln, [u.seq for u in r1[i:i + B]], [u.seq for u in r2[i:i + B]],
            [u.name for u in r1[i:i + B]], stats=stats,
            rescue=rescue_capable)
        for recs1, recs2 in zip(out1, out2):
            for r in recs1 + recs2:
                w.write_record(r)
                n += 1
    w.close()
    if args.verbose:
        print(f"align(paired): wrote {n} records", file=sys.stderr)


def run_index(args) -> None:
    """Build the FM-index of a FASTA and write bwa's five files beside
    it; past the bound, a sharded index and its manifest."""
    seqs = _load_fasta(args.fasta_file)
    total = sum(len(s) for _, s in seqs)
    if total > _sharded.DEFAULT_MAX_SHARD_BP:
        sidx = ShardedFMIndex.construct(seqs)
        sidx.write(args.fasta_file)
        print(f"indexed {args.fasta_file} ({sidx.num_sequences()} "
              f"sequences, {total} bp, {sidx.n_shards} shards)",
              file=sys.stderr)
        return
    idx = FMIndex.construct(seqs)
    idx.write(args.fasta_file)
    print(f"indexed {args.fasta_file} "
          f"({idx.num_sequences()} sequences, {idx.l_pac} bp)",
          file=sys.stderr)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="seqtools",
        description="seqtools on PyTorch/CUDA: error correction, assembly, "
                    "alignment")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("-v", "--verbose", action="store_true")
        sp.add_argument("-f", "--fasta", action="store_true",
                        help="output FASTA (no realignment)")
        sp.add_argument("-b", "--bam", action="store_true",
                        help="output BAM (not SAM)")
        sp.add_argument("-C", "--cram", action="store_true",
                        help="output CRAM (not SAM)")
        sp.add_argument("-F", "--infasta",
                        help="input FASTA/FASTQ instead of BAM/SAM")
        sp.add_argument("-2", "--infasta2", dest="infasta2",
                        help="read-2 FASTQ for paired-end alignment")
        sp.add_argument("-G", "--reference",
                        help="reference genome (fasta or index prefix)")
        sp.add_argument("-T", "--target",
                        help="input target sequence")
        sp.add_argument("-o", "--output", default="-")
        sp.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
        sp.add_argument("input", nargs="?", default="-")

    for name, fn in (("bfc", run_bfc), ("fml", run_fml),
                     ("align", run_align)):
        sp = sub.add_parser(name)
        common(sp)
        sp.set_defaults(func=fn)
    sp = sub.add_parser("index")
    sp.add_argument("fasta_file")
    sp.set_defaults(func=run_index)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if hasattr(args, "device"):
            try:
                resolve_device(args.device)
            except RuntimeError as e:
                raise RuntimeError(f"--device {args.device}: {e}") from e
        args.func(args)
    except (OSError, ValueError, RuntimeError) as e:
        print(f"seqtools: error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

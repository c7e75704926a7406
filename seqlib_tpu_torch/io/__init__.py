"""SAM/BAM file I/O, BGZF, BAI, FASTA/FASTQ input and FASTA random access
(counterpart of seqlib_tpu.io, without CRAM)."""

from .bai import BaiIndex
from .bam import encode_record  # noqa: F401
from .bam_reader import BamReader
from .bam_writer import BamWriter, BAM, SAM, CRAM
from .bgzf import BgzfReader, BgzfWriter, is_bgzf
from .fastq import FastqReader
from .refgenome import RefGenome, build_faidx
from .threadpool import PooledBgzfWriter, ThreadPool

__all__ = ["BaiIndex", "BamReader", "BamWriter", "BAM", "SAM", "CRAM",
           "BgzfReader", "BgzfWriter", "is_bgzf", "FastqReader",
           "RefGenome", "build_faidx", "PooledBgzfWriter", "ThreadPool"]

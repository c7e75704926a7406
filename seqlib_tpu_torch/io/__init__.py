"""Record serialisation and FASTA/FASTQ input (counterpart of
seqlib_tpu.io)."""

from .bam import encode_record  # noqa: F401
from .fastq import FastqReader  # noqa: F401
